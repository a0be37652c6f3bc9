"""Fold calibrated float params + activation maxima into the integer serving
form (paper Eq. 4/5): packed-int4 (at ``w_bits=8`` int8) weights, int32
biases, Q15 fixed-point multipliers, integer LN constants, LUT index
multipliers.

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


def _weight_codes(codes: torch.Tensor, w_bits: int) -> torch.Tensor:
    """Serving layout of (..., K, N) weight codes: plain int8 at ``w_bits=8``
    (the Q8BERT point, served by the bit-split W8A8 kernel), K-planar packed
    int4 otherwise."""
    return codes if w_bits == 8 else packing.pack_int4_planar(codes, axis=-2)


def fold_linear_t(w, b, s_a, s_y, policy: QuantPolicy) -> Dict:
    """Fold y = x@w + b into {w codes (``_weight_codes``), int32 b, M, sh}.
    ``w`` (K, N), or (E, K, N): E stacked linears (a MoE slot's experts),
    each folded under its own weight scale as the reference's ``vmap`` does,
    every leaf with the leading E axis."""
    w = w.to(F32)
    qm = q.qmax(policy.w_bits)
    w_max = torch.amax(torch.abs(w), dim=(-2, -1))
    s_w = _scale8(q.rdiv(qm, torch.clamp(w_max, min=1e-8)), policy)
    codes = torch.clamp(torch.round(w * s_w[..., None, None]), -qm, qm).to(torch.int8)
    bias = torch.zeros(w.shape[:-2] + w.shape[-1:], dtype=F32, device=w.device) \
        if b is None else b.to(F32)
    bias_i = torch.clamp(torch.round(bias * (s_a * s_w)[..., None]), -(2.0**31 - 1),
                         2.0**31 - 1).to(torch.int32)
    s_y = torch.as_tensor(s_y, dtype=F32, device=w.device)
    M, sh = fxp.quantize_multiplier_array(s_y / (s_a * s_w))
    return {"w": _weight_codes(codes, policy.w_bits), "b": bias_i, "M": M, "sh": sh}


def fold_linear_weightonly(w, policy: QuantPolicy) -> Dict:
    """W4-only fold of a (K, N) weight (the SSM inner projections: float
    activations, int4 weights): K-planar packed codes under a per-tensor
    scale without the 8-bit scale rounding, and ``inv_s_w`` = 1 / s_w."""
    w = w.to(F32)
    qm = q.qmax(policy.w_bits)
    s_w = q.rdiv(qm, torch.clamp(q.per_tensor_max(w), min=1e-8))
    codes = torch.clamp(torch.round(w * s_w), -qm, qm).to(torch.int8)
    return {"w": packing.pack_int4_planar(codes, axis=0), "inv_s_w": q.rdiv(1.0, s_w)}


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


EXPERT_OUT_SCALE = 128.0   # an expert's output grid: fixed, Q1.7-like


def fold_expert_group(grp: Dict, a: Dict, prefix: str, s_mi, policy: QuantPolicy) -> Dict:
    """Fold a group of stacked SwiGLU experts ((E, d, f) / (E, f, d)
    weights; ``prefix`` "exp" routed, "shr" shared) into stacked linears
    (every leaf with the leading E axis) and the group's SiLU LUT and
    product rescale; the outputs land on the fixed ``EXPERT_OUT_SCALE``
    grid."""
    s_g, s_u, s_h = (site_scale(a[f"{prefix}_{k}"], policy) for k in ("g", "u", "h"))
    return {"wg": fold_linear_t(grp["wg"], None, s_mi, s_g, policy),
            "wu": fold_linear_t(grp["wu"], None, s_mi, s_u, policy),
            "silu_lut": make_silu_lut(s_g, s_g),
            "prod": fold_rescale(s_g * s_u, s_h),
            "wd": fold_linear_t(grp["wd"], None, s_h, EXPERT_OUT_SCALE, policy),
            "inv_s_out": torch.tensor(1.0 / EXPERT_OUT_SCALE, dtype=F32, device=s_mi.device)}


def _fold_attention(cfg: ModelConfig, p: Dict, s) -> Dict:
    """The attention mixer's folded leaves (ln1, q/k/v/o, the attention
    scalars); ``s(site)`` gives a site's scale."""
    pol = cfg.quant
    f: Dict = {}
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
    if cfg.qk_norm:
        f["attn_q"]["qn"] = pa["qn"].to(F32)
        f["attn_q"]["kn"] = pa["kn"].to(F32)
    return f


_GATES = ("w_ig", "w_fg", "w_og")   # the mLSTM's float gate weights


def _fold_recurrent(cfg: ModelConfig, mixer: str, p: Dict, s) -> Dict:
    """A Mamba / mLSTM / sLSTM mixer's folded leaves: ln1 onto the mixer's
    input grid, ``inv_s_in`` back to float, the inner projections
    weight-only (``fold_linear_weightonly``), every other leaf float32."""
    pol = cfg.quant
    key = {"mamba": "mamba_in", "mlstm": "mlstm_in", "slstm": "slstm_in"}[mixer]
    m = p["mixer"]
    if mixer == "mamba":
        mx = {k: fold_linear_weightonly(m[k], pol) for k in ("w_in", "w_x", "w_out")}
        mx.update({k: m[k].to(F32) for k in ("conv_w", "conv_b", "w_dt")})
        mx.update({k: m[k] for k in ("dt_bias", "A_log", "D")})
    else:
        mx = {k: (fold_linear_weightonly(v, pol)
                  if k.startswith("w") and v.dim() == 2 and k not in _GATES else v.to(F32))
              for k, v in m.items()}
    return {"ln1": fold_norm_t(p["norm1"], s(key)), "inv_s_in": q.rdiv(1.0, s(key)),
            "mx": mx, "s_ra": s("resid_a")}


def fold_slot(cfg: ModelConfig, mixer: str, ffn: str, p: Dict, a: Dict, s_res_in):
    """Fold one super-block slot of one rep: an attention, Mamba, mLSTM or
    sLSTM mixer, then a dense, MoE or no feed-forward.  Returns (folded
    dict, scale of the outgoing residual grid)."""
    pol = cfg.quant
    s = lambda name: site_scale(a[name], pol)  # noqa: E731
    f = _fold_attention(cfg, p, s) if mixer == "attn" else _fold_recurrent(cfg, mixer, p, s)
    s_ra = s("resid_a")
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
    elif ffn == "moe":
        s_mi, s_rm = s("exp_in"), s("resid_m")
        f["ln2"] = fold_norm_t(p["norm2"], s_mi)
        f["router"] = p["moe"]["router"].to(F32)
        f["inv_s_mi"] = 1.0 / s_mi
        f["experts"] = fold_expert_group(p["moe"]["experts"], a, "exp", s_mi, pol)
        if cfg.n_shared_experts:
            f["shared"] = fold_expert_group(p["moe"]["shared"], a, "shr", s_mi, pol)
        f["s_rm"] = s_rm
        f["res_m"] = fold_rescale(s_res, s_rm)
        s_res = s_rm
    return f, s_res


@torch.no_grad()
def fold_params(cfg: ModelConfig, params: Dict, amax: Dict) -> Dict:
    """Whole-model fold, keeping the stacked (n_reps, ...) block layout; an
    audio arch's codebooks at the embedding's scale, several LM heads each
    under its own weight scale (the reference's ``vmap``), stacked."""
    pol = cfg.quant
    kinds = T.slot_kinds(cfg)
    s_emb = site_scale(amax["embed_out"], pol)
    emb = params["embed"]["tokens"].to(F32)
    folded: Dict = {"embed": {"tokens_i8": torch.clamp(torch.round(emb * s_emb), -127, 127
                                                       ).to(torch.int8)}}
    if "pos" in params["embed"]:
        folded["embed"]["pos_i8"] = torch.clamp(torch.round(
            params["embed"]["pos"].to(F32) * s_emb), -127, 127).to(torch.int8)
    if "codebooks" in params["embed"]:
        folded["embed"]["codebooks_i8"] = torch.clamp(torch.round(
            params["embed"]["codebooks"].to(F32) * s_emb), -127, 127).to(torch.int8)
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

    def fold_head(w):
        """An LM head's (d, V) weight: its codes under one per-tensor scale
        and the int32 accumulator's dequant scale (no int8 requant)."""
        w = w.to(F32)
        qm = q.qmax(pol.w_bits)
        s_w = q.rdiv(qm, torch.clamp(q.per_tensor_max(w), min=1e-8))
        codes = torch.clamp(torch.round(w * s_w), -qm, qm).to(torch.int8)
        return {"w": _weight_codes(codes, pol.w_bits), "inv_acc": 1.0 / (s_head * s_w)}

    if cfg.tied_embeddings:
        folded["lm_head"] = fold_head(params["embed"]["tokens"].T)
    elif cfg.n_lm_heads > 1:
        folded["lm_head"] = T.tree_stack([fold_head(w) for w in params["lm_head"]])
    else:
        folded["lm_head"] = fold_head(params["lm_head"])
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
