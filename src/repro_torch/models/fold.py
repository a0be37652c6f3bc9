"""Fold calibrated float params + activation maxima into the integer serving
form (paper Eq. 4/5): packed-int4 weights, int32 biases, Q15 fixed-point
multipliers, integer LN constants, LUT index multipliers.

Same float32 arithmetic as the reference ``models/fold.py`` (whose
``jax.vmap`` over reps is a loop here), so the folded integers are equal.
Every site scale is ``s(site) = 127 / amax[site]`` rounded to 8 significant
bits; each grid change is an explicit (M, shift) rescale.

``folded_from_numpy`` / ``params_from_numpy`` take the reference's trees
after ``jax.tree.map(np.asarray, ...)`` — the only bridge between the two
packages, and one that needs no JAX here.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsoftmax import LUT_DELTA
from repro_torch.models import transformer as T

F32 = torch.float32


def _scale8(s, policy: QuantPolicy):
    """8-significant-bit scale quantization (Table II 'scale')."""
    if not policy.quantize_scale:
        return s
    e = torch.floor(fxp.log2_f32(torch.clamp(s, min=1e-30))) - 7.0
    return torch.round(s * fxp.exp2_f32(-e)) * fxp.exp2_f32(e)


def site_scale(amax_val, policy: QuantPolicy):
    s = q.rdiv(q.qmax(policy.a_bits), torch.clamp(amax_val.to(F32), min=1e-8))
    return _scale8(s, policy)


def fold_linear_t(w, b, s_a, s_y, policy: QuantPolicy) -> Dict:
    """Fold y = x@w + b into {packed int4 w, int32 b, M, sh}."""
    if policy.w_bits != 4:
        raise NotImplementedError("w_bits=8 folding is not ported: ROADMAP Open items §1")
    w = w.to(F32)
    qm = q.qmax(policy.w_bits)
    s_w = _scale8(q.rdiv(qm, torch.clamp(q.per_tensor_max(w), min=1e-8)), policy)
    codes = torch.clamp(torch.round(w * s_w), -qm, qm).to(torch.int8)
    bias = torch.zeros((w.shape[1],), dtype=F32, device=w.device) if b is None else b.to(F32)
    bias_i = torch.clamp(torch.round(bias * (s_a * s_w)), -(2.0**31 - 1),
                         2.0**31 - 1).to(torch.int32)
    M, sh = fxp.quantize_multiplier_array(s_y / (s_a * s_w))
    return {"w": packing.pack_int4_planar(codes, axis=0), "b": bias_i, "M": M, "sh": sh}


def fold_norm_t(p_norm, s_y) -> Dict:
    gamma = p_norm["gamma"].to(F32)
    beta = p_norm.get("beta")
    s_g = q.rdiv(q.qmax(8), torch.clamp(q.per_tensor_max(gamma), min=1e-8))
    gamma_i = torch.clamp(torch.round(gamma * s_g), -127, 127).to(torch.int8)
    acc_scale = float(1 << 14) * s_g
    if beta is not None:
        beta_al = torch.clamp(torch.round(beta.to(F32) * acc_scale), -(2.0**30),
                              2.0**30).to(torch.int32)
    else:
        beta_al = torch.zeros_like(gamma_i, dtype=torch.int32)
    M, sh = fxp.quantize_multiplier_array(s_y / acc_scale)
    return {"gamma_i": gamma_i, "beta_al": beta_al, "M": M, "sh": sh}


def fold_rescale(s_from, s_to) -> Dict:
    M, sh = fxp.quantize_multiplier_array(s_to / s_from)
    return {"M": M, "sh": sh}


def _codes(device):
    return torch.arange(-128, 128, dtype=F32, device=device)


def make_silu_lut(s_in, s_out) -> torch.Tensor:
    """int8 -> int8 elementwise LUT for SiLU (256 entries)."""
    x = _codes(s_in.device) / s_in
    y = x * torch.sigmoid(x)
    return torch.clamp(torch.round(y * s_out), -127, 127).to(torch.int8)


def make_gelu_lut(s_in, s_out) -> torch.Tensor:
    x = _codes(s_in.device) / s_in
    y = 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x**3)))
    return torch.clamp(torch.round(y * s_out), -127, 127).to(torch.int8)


def fold_slot(cfg: ModelConfig, mixer: str, ffn: str, p: Dict, a: Dict, s_res_in):
    """Fold one attention + dense super-block slot of one rep.  Returns
    (folded dict, scale of the outgoing residual grid)."""
    if mixer != "attn" or ffn not in ("dense", "none"):
        raise NotImplementedError(f"folding {mixer}/{ffn} slots is not ported: "
                                  "ROADMAP Open items §1")
    pol = cfg.quant
    f: Dict = {}
    s = lambda name: site_scale(a[name], pol)  # noqa: E731
    pa = p["attn"]
    s_in, s_q, s_k, s_v = s("attn_in"), s("q"), s("k"), s("v")
    s_qp, s_kp = s("q_pre"), s("k_pre")
    s_ctx, s_ra = s("attn_out_in"), s("resid_a")
    f["ln1"] = fold_norm_t(p["norm1"], s_in)
    f["wq"] = fold_linear_t(pa["wq"], pa.get("bq"), s_in, s_qp, pol)
    f["wk"] = fold_linear_t(pa["wk"], pa.get("bk"), s_in, s_kp, pol)
    f["wv"] = fold_linear_t(pa["wv"], pa.get("bv"), s_in, s_v, pol)
    f["wo"] = fold_linear_t(pa["wo"], pa.get("bo"), s_ctx, s_ra, pol)
    s_logit = math.sqrt(cfg.hd) * s_q * s_k  # codes per real logit
    M_idx, sh_idx = fxp.quantize_multiplier_array(1.0 / (s_logit * LUT_DELTA))
    M_pv, sh_pv = fxp.quantize_multiplier_array(s_ctx / (128.0 * s_v))
    f["attn_q"] = {
        "M_idx": M_idx, "sh_idx": sh_idx,
        "inv_s_logit": 1.0 / s_logit,
        "out_scale": s_ctx / s_v,          # q7 attention fp epilogue
        "M_pv": M_pv, "sh_pv": sh_pv,      # q8 row path integer P@V requant
        "inv_s_qp": 1.0 / s_qp, "inv_s_kp": 1.0 / s_kp,  # rope island in
        "s_q": s_q, "s_k": s_k,                          # rope island out
    }
    f["res_a"] = fold_rescale(s_res_in, s_ra)
    s_res = s_ra
    if ffn == "dense":
        s_mi, s_rm = s("mlp_in"), s("resid_m")
        f["ln2"] = fold_norm_t(p["norm2"], s_mi)
        pm = p["mlp"]
        if cfg.act == "swiglu":
            s_gp, s_g, s_u, s_h = s("g_pre"), s("g_out"), s("u_out"), s("h_in")
            f["wg"] = fold_linear_t(pm["wg"], None, s_mi, s_gp, pol)
            f["wu"] = fold_linear_t(pm["wu"], None, s_mi, s_u, pol)
            f["silu_lut"] = make_silu_lut(s_gp, s_g)
            f["prod"] = fold_rescale(s_g * s_u, s_h)
            f["wd"] = fold_linear_t(pm["wd"], None, s_h, s_rm, pol)
        else:
            s_hp, s_g, s_h = s("h_pre"), s("g_out"), s("h_in")
            f["w1"] = fold_linear_t(pm["w1"], pm.get("b1"), s_mi, s_hp, pol)
            f["gelu_lut"] = make_gelu_lut(s_hp, s_g)
            f["gelu_rescale"] = fold_rescale(s_g, s_h)
            f["w2"] = fold_linear_t(pm["w2"], pm.get("b2"), s_h, s_rm, pol)
        f["res_m"] = fold_rescale(s_res, s_rm)
        s_res = s_rm
    return f, s_res


@torch.no_grad()
def fold_params(cfg: ModelConfig, params: Dict, amax: Dict) -> Dict:
    """Whole-model fold, keeping the stacked (n_reps, ...) block layout."""
    T.check_ported(cfg)
    pol = cfg.quant
    kinds = T.slot_kinds(cfg)
    s_emb = site_scale(amax["embed_out"], pol)
    emb = params["embed"]["tokens"].to(F32)
    folded: Dict = {"embed": {"tokens_i8": torch.clamp(torch.round(emb * s_emb), -127, 127
                                                       ).to(torch.int8)}}
    if "pos" in params["embed"]:
        folded["embed"]["pos_i8"] = torch.clamp(torch.round(
            params["embed"]["pos"].to(F32) * s_emb), -127, 127).to(torch.int8)
    s_head = site_scale(amax["head_in"], pol)
    reps = []
    for r in range(cfg.n_reps):
        out = {}
        s_res = s_emb
        for i, (mixer, ffn) in enumerate(kinds):
            out[f"slot{i}"], s_res = fold_slot(
                cfg, mixer, ffn, T.tree_index(params["blocks"][f"slot{i}"], r),
                T.tree_index(amax["blocks"][f"slot{i}"], r), s_res)
        out["block_out_rescale"] = fold_rescale(s_res, s_emb)
        reps.append(out)
    folded["blocks"] = T.tree_stack(reps)
    folded["final_norm"] = fold_norm_t(params["final_norm"], s_head)

    w = (params["embed"]["tokens"].T if cfg.tied_embeddings else params["lm_head"]).to(F32)
    qm = q.qmax(pol.w_bits)
    s_w = q.rdiv(qm, torch.clamp(q.per_tensor_max(w), min=1e-8))
    codes = torch.clamp(torch.round(w * s_w), -qm, qm).to(torch.int8)
    folded["lm_head"] = {"w": packing.pack_int4_planar(codes, axis=0),
                         "inv_acc": 1.0 / (s_head * s_w)}
    folded["s_embed"] = s_emb
    folded["s_head"] = s_head
    return folded


# --- the bridge from the reference's trees (numpy leaves) ---------------------

_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def _to_torch(a, device, float_dtype=None):
    a = np.array(a)             # a writable copy; keeps 0-d leaves 0-d
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(device=device, dtype=float_dtype or torch.float32)
    return torch.from_numpy(a).to(device=device, dtype=_TORCH_DTYPE[a.dtype])


def folded_from_numpy(tree: Dict, device="cuda") -> Dict:
    """The reference's folded tree (numpy leaves) -> the port's (tensors)."""
    return T.tree_map(lambda a: _to_torch(a, device), tree)


def params_from_numpy(tree: Dict, device="cuda", dtype=torch.float32) -> Dict:
    """The reference's float params or amax tree (numpy leaves) -> tensors;
    float leaves take ``dtype``."""
    return T.tree_map(lambda a: _to_torch(a, device, dtype), tree)
