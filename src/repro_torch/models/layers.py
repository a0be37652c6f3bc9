"""QAT building blocks (calibration forward) for the dense attention/MLP
subset of the reference ``models/layers.py``.

Conventions as in the reference: params are nested dicts of tensors; every
activation the integer path quantizes has a *site* whose EMA max arrives in
``amax[site]`` and whose batch statistic comes back in ``obs[site]``.  The
port only calibrates, so these are plain forwards (run them under
``torch.no_grad()``); rounding is half-to-even like ``jnp.round``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsoftmax import LUT_DELTA

Obs = Dict[str, torch.Tensor]


def _amax_or_obs(amax: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ob = q.per_tensor_max(x).to(torch.float32)
    return torch.where(amax > 0, amax, ob), ob


def fake_quant_act(x, amax, bits, enabled: bool):
    a, ob = _amax_or_obs(amax, x)
    if not enabled:
        return x, ob
    return q.fake_quant(x, a.to(x.dtype), bits), ob


def qdense(x, w, b, amax_in, policy: QuantPolicy):
    """Quantization-aware linear; returns (y, observed max|x|)."""
    x_q, ob = fake_quant_act(x, amax_in, policy.a_bits, policy.quantize_wa)
    if policy.quantize_wa:
        w_m = q.per_channel_max(w, axis=-1) if policy.per_channel_w else q.per_tensor_max(w)
        w = q.fake_quant(w, w_m.to(w.dtype), policy.w_bits)
    y = x_q @ w
    if b is not None:
        y = y + b
    return y, ob


# --- norms -------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-6):
    x32 = x.to(torch.float32)
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (n * gamma.to(torch.float32)).to(x.dtype)


def layernorm(x, gamma, beta, eps=1e-6):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, -1, keepdim=True)
    c = x32 - mu
    n = c * torch.rsqrt(torch.mean(c * c, -1, keepdim=True) + eps)
    return (n * gamma.to(torch.float32) + beta.to(torch.float32)).to(x.dtype)


def qnorm(x, p, policy: QuantPolicy, norm_type: str):
    """Norm with (optionally) fake-quantized 8-bit gamma/beta."""
    gamma = p["gamma"]
    beta = p.get("beta")
    if policy.quantize_layernorm:
        gamma = q.fake_quant(gamma, q.per_tensor_max(gamma).to(gamma.dtype), 8)
        if beta is not None:
            bm = torch.clamp(q.per_tensor_max(beta), min=1e-8)
            beta = q.fake_quant(beta, bm.to(beta.dtype), 8)
    if norm_type == "layernorm":
        return layernorm(x, gamma, beta if beta is not None else torch.zeros_like(gamma))
    return rmsnorm(x, gamma)


# --- rotary embeddings ---------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd_rot, 2, dtype=torch.float32,
                                         device=device) / hd_rot))


def apply_rope(x, pos, theta, partial: float = 1.0):
    """x: (B, S, H, D); pos: (B, S) int32.  Split-half (llama) convention."""
    d = x.shape[-1]
    d_rot = int(d * partial)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)
    ang = pos[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out, xp], -1)


# --- quantized-softmax simulator -----------------------------------------------

def lut_softmax_qat(logits, s_logit, enabled: bool):
    """Simulation of the 256-entry LUT softmax on real-valued logits (mask
    already applied as -1e9); ``s_logit`` = codes per real logit unit."""
    if not enabled:
        return torch.softmax(logits, dim=-1)
    lf = logits.to(torch.float32)
    lq = torch.round(lf * s_logit) / s_logit
    m = torch.amax(lq, -1, keepdim=True)
    idx = torch.clamp(torch.round((m - lq) / LUT_DELTA), 0, 255)
    num = torch.round(torch.exp(-idx * LUT_DELTA) * 255.0) / 255.0
    num = torch.where(idx >= 255, torch.zeros_like(num), num)
    den = torch.clamp(torch.sum(num, -1, keepdim=True), min=1e-9)
    p = torch.round(num / den * 128.0) / 128.0
    return p.to(logits.dtype)


# --- attention ---------------------------------------------------------------

def attention_qat(x, p: Dict, amax: Dict, policy: QuantPolicy, cfg, pos,
                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Obs]:
    """Materialized-score QAT attention.  x (B, S, d); pos (B, S)."""
    if cfg.qk_norm or cfg.mrope_sections is not None or cfg.sliding_window:
        raise NotImplementedError(
            "qk_norm / M-RoPE / sliding-window attention is not ported: "
            "ROADMAP Open items §1")
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    obs: Obs = {}
    qp, obs["attn_in"] = qdense(x, p["wq"], p.get("bq"), amax["attn_in"], policy)
    kp, _ = qdense(x, p["wk"], p.get("bk"), amax["attn_in"], policy)
    vp, _ = qdense(x, p["wv"], p.get("bv"), amax["attn_in"], policy)
    qh = qp.reshape(b, s, nh, hd)
    kh = kp.reshape(b, s, nkv, hd)
    vh = vp.reshape(b, s, nkv, hd)
    qh, obs["q_pre"] = fake_quant_act(qh, amax["q_pre"], policy.a_bits, policy.quantize_wa)
    kh, obs["k_pre"] = fake_quant_act(kh, amax["k_pre"], policy.a_bits, policy.quantize_wa)
    if not cfg.learned_pos:
        qh = apply_rope(qh, pos, cfg.rope_theta, cfg.partial_rotary)
        kh = apply_rope(kh, pos, cfg.rope_theta, cfg.partial_rotary)
    qh, obs["q"] = fake_quant_act(qh, amax["q"], policy.a_bits, policy.quantize_wa)
    kh, obs["k"] = fake_quant_act(kh, amax["k"], policy.a_bits, policy.quantize_wa)
    vh, obs["v"] = fake_quant_act(vh, amax["v"], policy.a_bits, policy.quantize_wa)
    group = nh // nkv
    kg = kh.repeat_interleave(group, dim=2)
    vg = vh.repeat_interleave(group, dim=2)
    a_q, _ = _amax_or_obs(amax["q"], qh)
    a_k, _ = _amax_or_obs(amax["k"], kh)
    s_logit = math.sqrt(hd) * q.rdiv(127.0, a_q) * q.rdiv(127.0, a_k)
    lg = torch.einsum("bqhd,bkhd->bhqk", qh, kg) / math.sqrt(hd)
    if mask is None and cfg.causal:
        ar = torch.arange(s, device=x.device)
        mask = (ar[None, :] <= ar[:, None])[None, None]
    if mask is not None:
        lg = torch.where(mask, lg, torch.full_like(lg, -1e9))
    pr = lut_softmax_qat(lg, s_logit, policy.quantize_softmax)
    ctx = torch.einsum("bhqk,bkhd->bqhd", pr, vg).reshape(b, s, nh * hd)
    out, obs["attn_out_in"] = qdense(ctx, p["wo"], p.get("bo"), amax["attn_out_in"], policy)
    return out, obs


# --- MLPs ---------------------------------------------------------------------

def mlp_qat(x, p, amax, policy, act: str) -> Tuple[torch.Tensor, Obs]:
    obs: Obs = {}
    if act == "swiglu":
        g, obs["mlp_in"] = qdense(x, p["wg"], None, amax["mlp_in"], policy)
        u, _ = qdense(x, p["wu"], None, amax["mlp_in"], policy)
        g, obs["g_pre"] = fake_quant_act(g, amax["g_pre"], policy.a_bits, policy.quantize_wa)
        g, obs["g_out"] = fake_quant_act(F.silu(g), amax["g_out"], policy.a_bits,
                                         policy.quantize_wa)
        u, obs["u_out"] = fake_quant_act(u, amax["u_out"], policy.a_bits, policy.quantize_wa)
        y, obs["h_in"] = qdense(g * u, p["wd"], None, amax["h_in"], policy)
    else:  # gelu (tanh approximation, as jax.nn.gelu)
        h, obs["mlp_in"] = qdense(x, p["w1"], p.get("b1"), amax["mlp_in"], policy)
        h, obs["h_pre"] = fake_quant_act(h, amax["h_pre"], policy.a_bits, policy.quantize_wa)
        h, obs["g_out"] = fake_quant_act(F.gelu(h, approximate="tanh"), amax["g_out"],
                                         policy.a_bits, policy.quantize_wa)
        y, obs["h_in"] = qdense(h, p["w2"], p.get("b2"), amax["h_in"], policy)
    return y, obs


def residual_add(x, delta, amax, policy):
    """int8 residual stream: both operands live on the residual grid."""
    return fake_quant_act(x + delta, amax, policy.a_bits, policy.quantize_wa)
