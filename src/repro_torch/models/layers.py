"""QAT building blocks (calibration and training forward) for the attention
(qk-norm and Qwen2-VL's M-RoPE included) and dense MLP subset of the
reference ``models/layers.py``.

Split over the model axis (Megatron tensor parallelism, the reference's
``model`` rules in ``sharding/partition.py``): where a projection's param is
a dict of model blocks (``{"<model rank>": block}``, this process's ranks
in rank order; ``train/steps.py`` builds them under ``model_compute=
"split"``), ``attention_qat`` and ``mlp_qat`` run each rank's part on its
blocks, in the context's model group (``partition.model_split``): the
column-parallel products (q/k/v, gate/up, ``w1``, their biases) take the
replicated input through ``collectives.copy_to_model`` and give the rank's
output columns (its ``H/m`` query and ``Hkv/m`` KV heads, so rank order is
head order); the row-parallel products (``wo``, ``wd``, ``w2``) give a
partial that ``collectives.reduce_from_model`` sums over the ranks, and the
replicated bias is added once after it.  A site's observed max over a split
tensor, and a per-tensor weight max over a split weight, are the max over
every rank's (``collectives.model_max``); qk-norm's replicated gammas reach
each rank's heads through ``copy_to_model``, so their gradient sums every
rank's.  A norm over a row split over the ranks (xLSTM's ``ln_y``,
``rmsnorm_xla_parts``) takes the whole row's mean square from every rank's
window sums, bit for bit the unsplit one's.  A leaf that is a tensor runs
whole, the same ops as before the split existed.

Conventions as in the reference: params are nested dicts of tensors; every
activation the integer path quantizes has a *site* whose EMA max arrives in
``amax[site]`` and whose batch statistic comes back in ``obs[site]``.
Rounding is half-to-even like ``jnp.round``, through the straight-through
``ste_round``; every maximum the reference takes under ``stop_gradient``
is taken of a detached tensor here (the sites carry a ``detach``), since
``torch.abs`` and ``torch.max(x, dim)`` pass other gradients than
``jnp.abs`` and ``jnp.max`` would at 0 and at ties.  Calibration callers
run these under ``torch.no_grad()``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsoftmax import LUT_DELTA
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt

Obs = Dict[str, torch.Tensor]
ROW_CHUNK = 512  # query rows a chunk of ``attention_qat`` (the reference's)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) when autograd records; a
    plain call otherwise (calibration).  Inside a data rank of a sharded MoE
    step the recomputation replays the routing counts its first forward
    received (``collectives.recompute_contexts``)."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=C.recompute_contexts)
    return fn(*args)


# --- JAX's gate functions -------------------------------------------------------

def sigmoid_grad(y, g):
    """``lax.logistic``'s gradient from its output: ``g * (y * (1 - y))``."""
    return g * (y * (1 - y))


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sigmoid(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return sigmoid_grad(y, g)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``), with its gradient rule
    (``sigmoid_grad``)."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``.  ``torch.nn.functional.silu``
    is another float32 function (an ulp apart on about a quarter of
    inputs), whose largest output moves a site's per-tensor max and with it
    every code of the site (ROADMAP §3)."""
    return x * sigmoid(x)


# --- quantized linears ------------------------------------------------------------

def _amax_or_obs(amax: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ob = q.per_tensor_max(x.detach()).to(torch.float32)
    return torch.where(amax > 0, amax, ob), ob


def fake_quant_act(x, amax, bits, enabled: bool):
    a, ob = _amax_or_obs(amax, x)
    if not enabled:
        return x, ob
    return q.fake_quant(x, a.to(x.dtype), bits), ob


def qdense(x, w, b, amax_in, policy: QuantPolicy):
    """Quantization-aware linear; returns (y, observed max|x|)."""
    (y,), ob = qdense_column([x], w, b, amax_in, policy, None)
    return y, ob


# --- the model axis's split ------------------------------------------------------

def _parts(w) -> list:
    """A leaf's blocks in model-rank order: a model-split leaf's (a dict of
    this process's model ranks' blocks), or the whole leaf alone."""
    return list(w.values()) if isinstance(w, dict) else [w]


def _group(w):
    """The model group a split leaf runs in, or None for a whole leaf."""
    if not isinstance(w, dict):
        return None
    group = Pt.model_group()
    if group is None:
        raise RuntimeError("a model-split param outside a model group "
                           "(partition.model_split sets one)")
    return group


def _amax_or_obs_parts(amax, xs, group):
    ob = C.model_max(group, [q.per_tensor_max(x.detach()).to(torch.float32) for x in xs])
    return torch.where(amax > 0, amax, ob), ob


def fake_quant_parts(xs, amax, bits, enabled: bool, group):
    """``fake_quant_act`` of a tensor split over the model ranks (``xs``:
    this process's parts in rank order; one part, the whole tensor, when
    ``group`` is None): its observed max is every rank's max."""
    a, ob = _amax_or_obs_parts(amax, xs, group)
    if not enabled:
        return xs, ob
    return [q.fake_quant(x, a.to(x.dtype), bits) for x in xs], ob


def _products(xs, w, b, policy: QuantPolicy, group, row: bool):
    """Each rank's ``x @ fake_quant(w)`` (+ b): a per-tensor weight max is
    the max over every rank's block, a per-channel one a rank's own columns'
    (over every rank's rows for a row-parallel weight)."""
    ws = _parts(w)
    if policy.quantize_wa:
        ds = [v.detach() for v in ws]
        if policy.per_channel_w:
            ms = [q.per_channel_max(d, axis=-1) for d in ds]
            if row and group is not None:
                ms = [C.model_max(group, ms)] * len(ms)
        else:
            ms = [C.model_max(group, [q.per_tensor_max(d) for d in ds])] * len(ds)
        ws = [q.fake_quant(v, m.to(v.dtype), policy.w_bits) for v, m in zip(ws, ms, strict=True)]
    ys = [x @ v for x, v in zip(xs, ws, strict=True)]
    if b is not None:
        ys = [y + c for y, c in zip(ys, _parts(b), strict=True)]
    return ys


def qdense_column(xs, w, b, amax_in, policy: QuantPolicy, group):
    """Column-parallel ``qdense`` of a replicated input (``xs``: its view for
    each of this process's model ranks, ``collectives.copy_to_model``'s, so
    that the products of one input share one gradient sum): (each rank's
    output columns, observed max|x|).  Whole (``group`` None, ``xs`` =
    ``[x]``): the one linear of ``qdense``."""
    quantized = [fake_quant_act(x, amax_in, policy.a_bits, policy.quantize_wa) for x in xs]
    return _products([x for x, _ in quantized], w, b, policy, group, row=False), quantized[0][1]


def qdense_row(xs, w, b, amax_in, policy: QuantPolicy, group):
    """Row-parallel ``qdense`` of a tensor split on its last axis (``xs``):
    the ranks' partial products summed over the model ranks, then the
    replicated bias: (y, observed max|x| over every rank)."""
    xs, ob = fake_quant_parts(xs, amax_in, policy.a_bits, policy.quantize_wa, group)
    y = C.reduce_from_model(group, _products(xs, w, None, policy, group, row=True))
    if b is not None:
        y = y + b
    return y, ob


# --- norms -------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-6):
    x32 = x.to(torch.float32)
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (n * gamma.to(torch.float32)).to(x.dtype)


def rmsnorm_xla(x, gamma, eps=1e-6):
    """``rmsnorm`` with the mean square summed in XLA's order
    (``xla_row_sum``: equal to the reference's sum for rows longer than 32)
    and scaled by the float32 reciprocal of the row length, as the jitted
    ``jnp.mean``: qk-norm's, in the calibration forward and in the serving
    RoPE island.  ``rsqrt`` is torch's, an ulp from XLA's on some inputs
    (the qk-norm island, ROADMAP §3)."""
    x32 = x.to(torch.float32)
    ms = xla_row_sum(x32 * x32) * q.recip_f32(x.shape[-1])
    n = x32 * torch.rsqrt(ms + eps)[..., None]
    return (n * gamma.to(torch.float32)).to(x.dtype)


def rmsnorm_xla_parts(xs, gammas, group, eps=1e-6):
    """``rmsnorm_xla`` of rows split over the model ranks (``xs``: this
    process's parts in rank order, ``gammas`` their blocks of the gain):
    the mean square of the whole row from ``xla_row_sum_parts``, bit for bit
    the unsplit one's, then each rank's own columns normalized.  ``group``
    None: the one part, whole (``rmsnorm_xla``)."""
    if group is None:
        return [rmsnorm_xla(xs[0], gammas[0], eps)]
    x32s = [x.to(torch.float32) for x in xs]
    sums = xla_row_sum_parts([t * t for t in x32s], group)
    inv_d = q.recip_f32(xs[0].shape[-1] * group.size)
    return [(x32 * torch.rsqrt(ms * inv_d + eps)[..., None] * g.to(torch.float32)).to(x.dtype)
            for x, x32, ms, g in zip(xs, x32s, sums, gammas, strict=True)]


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
        gamma = q.fake_quant(gamma, q.per_tensor_max(gamma.detach()).to(gamma.dtype), 8)
        if beta is not None:
            bm = torch.clamp(q.per_tensor_max(beta.detach()), min=1e-8)
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


def apply_mrope(x, pos3, theta, sections):
    """Qwen2-VL M-RoPE: ``pos3`` (B, S, 3) holds the (t, h, w) positions; the
    frequency bands split into ``sections`` groups, each rotated by its own
    position stream (the band of frequency i is the number of section ends
    at or below i, as the reference's ``searchsorted(side="right")``).
    With t = h = w it equals ``apply_rope``."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ends = torch.cumsum(torch.tensor(sections, device=x.device), 0)
    band = torch.searchsorted(ends, torch.arange(half, device=x.device), right=True)
    ang = torch.gather(pos3.to(torch.float32), -1, band.expand(*pos3.shape[:2], half)) * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


# --- quantized-softmax simulator -----------------------------------------------

class _XlaRowSum(torch.autograd.Function):
    """The ordered sum of ``xla_row_sum``; its gradient is the upstream
    gradient broadcast over the row, as for any sum (autograd through the
    window chain would build each element's one-hot gradient in full)."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.shape = x.shape
        return _row_sum_ordered(x, window)

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(ctx.shape), None


class _XlaRowSumParts(torch.autograd.Function):
    """``xla_row_sum`` of a row split over the model ranks' parts, each a
    whole number of windows long: each rank sums its own windows, the window
    sums are gathered in rank order (``collectives.model_gather``) and
    reduced as ``_row_sum_ordered`` reduces the unsplit row's, so every rank
    holds the row's sum, bit for bit.  The gradient: the ranks' gradients of
    that sum added in rank order (``collectives.model_sum``), broadcast over
    each part's row."""

    @staticmethod
    def forward(ctx, group, window, *xs):
        ctx.group, ctx.shapes = group, [x.shape for x in xs]
        sums = [_row_sum_ordered(x.reshape(*x.shape[:-1], -1, window), window) for x in xs]
        s = _row_sum_ordered(C.model_gather(group, sums, -1), window)
        return tuple(s.view_as(s) for _ in xs)

    @staticmethod
    def backward(ctx, *grads):
        g = C.model_sum(ctx.group, grads)
        return (None, None, *(g[..., None].expand(sh) for sh in ctx.shapes))


def xla_row_sum_parts(xs, group, window: int = 32) -> list:
    """``xla_row_sum`` of the row that this process's parts ``xs`` (rank
    order) split over the model ranks: the whole row's sum for each part."""
    if xs[0].shape[-1] % window:
        raise ValueError(f"a split row sum needs each part ({xs[0].shape[-1]} long) to be a "
                         f"whole number of {window}-wide windows")
    return list(_XlaRowSumParts.apply(group, window, *xs))


def _row_sum_ordered(x: torch.Tensor, window: int) -> torch.Tensor:
    n = x.shape[-1]
    if n > window:
        pad = -n % window
        x = F.pad(x, (pad // 2, pad - pad // 2))
        return _row_sum_ordered(_row_sum_ordered(x.reshape(*x.shape[:-1], -1, window), window),
                                window)
    s = torch.zeros_like(x[..., 0])
    for i in range(n):
        s = s + x[..., i]
    return s


def xla_row_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """float32 sum over the last axis in the order XLA's CPU backend adds:
    a row longer than ``window`` is zero-padded to a multiple of it (the
    smaller half of the padding in front), each window is summed left to
    right, and the window sums are reduced the same way.

    Exact for rows longer than 32 and up to 17 long.  A row of 18 to 32
    entries stays one reduce that XLA fuses with its producers and lets
    LLVM reassociate (8-lane partial sums), which this order does not
    follow: the softmax simulator's float island (ROADMAP §3)."""
    return _XlaRowSum.apply(x, window)


def lut_softmax_qat(logits, s_logit, enabled: bool):
    """Simulation of the 256-entry LUT softmax on real-valued logits (mask
    already applied as -1e9); ``s_logit`` = codes per real logit unit.

    The reference's float32 result bit for bit, except on rows of 18 to 32
    entries (``xla_row_sum``): its divisions by the constants
    ``LUT_DELTA`` and 255 are multiplications by their float32
    reciprocals, and its row sum follows XLA's order.  A plain ``/`` and
    ``torch.sum`` move ``round(p * 128)`` by one code at ties.  Gradients
    pass the four rounds straight through, as in the reference."""
    if not enabled:
        return torch.softmax(logits, dim=-1)
    lf = logits.to(torch.float32)
    lq = q.ste_round(lf * s_logit) / s_logit
    m = torch.amax(lq.detach(), -1, keepdim=True)
    # the row maximum's gap is 0, on the clip's lower bound: half its gradient
    idx = q.clip(q.ste_round((m - lq) * q.recip_f32(LUT_DELTA)), 0.0, 255.0)
    num = q.ste_round(torch.exp(-idx * LUT_DELTA) * 255.0) * q.recip_f32(255.0)
    num = torch.where(idx >= 255, torch.zeros_like(num), num)
    den = torch.maximum(xla_row_sum(num)[..., None], torch.tensor(1e-9, device=num.device))
    p = q.ste_round(num / den * 128.0) / 128.0
    return p.to(logits.dtype)


# --- attention ---------------------------------------------------------------

def attention_qat(x, p: Dict, amax: Dict, policy: QuantPolicy, cfg, pos,
                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Obs]:
    """Materialized-score QAT attention.  x (B, S, d); pos (B, S), or (B,
    S, 3) for M-RoPE.  The default causal mask keeps, for a sliding-window
    arch, only the keys less than ``cfg.sliding_window`` positions back.
    With model-split projections each rank runs its own heads (module
    docstring)."""
    b, s, _ = x.shape
    group = _group(p["wq"])
    m = 1 if group is None else group.size
    hd, nh, nkv = cfg.hd, cfg.n_heads // m, cfg.n_kv_heads // m
    obs: Obs = {}
    fq = functools.partial(fake_quant_parts, bits=policy.a_bits, enabled=policy.quantize_wa,
                           group=group)
    xs = C.copy_to_model(group, x)
    qs, obs["attn_in"] = qdense_column(xs, p["wq"], p.get("bq"), amax["attn_in"], policy, group)
    ks, _ = qdense_column(xs, p["wk"], p.get("bk"), amax["attn_in"], policy, group)
    vs, _ = qdense_column(xs, p["wv"], p.get("bv"), amax["attn_in"], policy, group)
    qs = [t.reshape(b, s, nh, hd) for t in qs]
    ks = [t.reshape(b, s, nkv, hd) for t in ks]
    vs = [t.reshape(b, s, nkv, hd) for t in vs]
    qs, obs["q_pre"] = fq(qs, amax["q_pre"])
    ks, obs["k_pre"] = fq(ks, amax["k_pre"])
    if cfg.qk_norm:
        qs = [rmsnorm_xla(t, g) for t, g in zip(qs, C.copy_to_model(group, p["qn"]), strict=True)]
        ks = [rmsnorm_xla(t, g) for t, g in zip(ks, C.copy_to_model(group, p["kn"]), strict=True)]
    if cfg.mrope_sections is not None:
        qs = [apply_mrope(t, pos, cfg.rope_theta, cfg.mrope_sections) for t in qs]
        ks = [apply_mrope(t, pos, cfg.rope_theta, cfg.mrope_sections) for t in ks]
    elif not cfg.learned_pos:
        qs = [apply_rope(t, pos, cfg.rope_theta, cfg.partial_rotary) for t in qs]
        ks = [apply_rope(t, pos, cfg.rope_theta, cfg.partial_rotary) for t in ks]
    qs, obs["q"] = fq(qs, amax["q"])
    ks, obs["k"] = fq(ks, amax["k"])
    vs, obs["v"] = fq(vs, amax["v"])
    group_size = nh // nkv
    a_q, _ = _amax_or_obs_parts(amax["q"], qs, group)
    a_k, _ = _amax_or_obs_parts(amax["k"], ks, group)
    s_logit = (math.sqrt(hd) * q.rdiv(127.0, a_q) * q.rdiv(127.0, a_k)).detach()

    def rows(q_rows, kg, vg, row0: int, row_mask):
        """Full-row LUT softmax for a block of query rows (the paper's
        Softmax Core granularity): (B, Cq, H, hd) -> (B, Cq, H*hd)."""
        cq = q_rows.shape[1]
        lg = torch.einsum("bqhd,bkhd->bhqk", q_rows, kg) * q.recip_f32(math.sqrt(hd))
        if row_mask is None and cfg.causal:
            qpos = row0 + torch.arange(cq, device=x.device)[:, None]
            kpos = torch.arange(s, device=x.device)[None, :]
            row_mask = kpos <= qpos
            if cfg.sliding_window:
                row_mask &= kpos > qpos - cfg.sliding_window
            row_mask = row_mask[None, None]
        if row_mask is not None:
            lg = torch.where(row_mask, lg, torch.full_like(lg, -1e9))
        pr = lut_softmax_qat(lg, s_logit, policy.quantize_softmax)
        return torch.einsum("bhqk,bkhd->bqhd", pr, vg).reshape(b, cq, nh * hd)

    ctxs = []
    for qh, kh, vh in zip(qs, ks, vs, strict=True):
        kg = kh.repeat_interleave(group_size, dim=2)
        vg = vh.repeat_interleave(group_size, dim=2)
        # rows are independent (each sees every key), so chunks of query rows
        # give the same result; recomputed in the backward, a chunk's (B, H,
        # ROW_CHUNK, S) float32 chain is all a layer holds at once
        if s > ROW_CHUNK and s % ROW_CHUNK == 0 and mask is None:
            ctxs.append(torch.cat([remat(rows, qh[:, i:i + ROW_CHUNK], kg, vg, i, None)
                                   for i in range(0, s, ROW_CHUNK)], 1))
        else:
            ctxs.append(rows(qh, kg, vg, 0, mask))
    out, obs["attn_out_in"] = qdense_row(ctxs, p["wo"], p.get("bo"), amax["attn_out_in"], policy,
                                         group)
    return out, obs


# --- MLPs ---------------------------------------------------------------------

def mlp_qat(x, p, amax, policy, act: str) -> Tuple[torch.Tensor, Obs]:
    """The dense MLP (SwiGLU, or GELU's tanh approximation as
    ``jax.nn.gelu``); with model-split weights each rank runs its d_ff/m
    columns (module docstring)."""
    obs: Obs = {}
    group = _group(p["wg" if act == "swiglu" else "w1"])
    fq = functools.partial(fake_quant_parts, bits=policy.a_bits, enabled=policy.quantize_wa,
                           group=group)
    xs = C.copy_to_model(group, x)
    if act == "swiglu":
        gs, obs["mlp_in"] = qdense_column(xs, p["wg"], None, amax["mlp_in"], policy, group)
        us, _ = qdense_column(xs, p["wu"], None, amax["mlp_in"], policy, group)
        gs, obs["g_pre"] = fq(gs, amax["g_pre"])
        gs, obs["g_out"] = fq([silu(g) for g in gs], amax["g_out"])
        us, obs["u_out"] = fq(us, amax["u_out"])
        y, obs["h_in"] = qdense_row([g * u for g, u in zip(gs, us, strict=True)], p["wd"], None,
                                    amax["h_in"], policy, group)
    else:
        hs, obs["mlp_in"] = qdense_column(xs, p["w1"], p.get("b1"), amax["mlp_in"], policy, group)
        hs, obs["h_pre"] = fq(hs, amax["h_pre"])
        hs, obs["g_out"] = fq([F.gelu(h, approximate="tanh") for h in hs], amax["g_out"])
        y, obs["h_in"] = qdense_row(hs, p["w2"], p.get("b2"), amax["h_in"], policy, group)
    return y, obs


def residual_add(x, delta, amax, policy):
    """int8 residual stream: both operands live on the residual grid."""
    return fake_quant_act(x + delta, amax, policy.a_bits, policy.quantize_wa)
