"""Mamba-1 selective-SSM block (jamba's hybrid stack) for the calibration
and training forward, and the float pieces the integer forward shares: the
depthwise causal conv, the chunked selective scan and the single-step
recurrence.

A copy in torch of the reference ``models/mamba.py``.  The projections
(in/x/dt/out) are fake-quantized like every linear; the scan runs in
float32.  Within a chunk of ``CHUNK`` rows the scan mirrors
``jax.lax.associative_scan``'s combine tree (pairs, then the recursion on
the odd elements, then the even ones), so the products and sums are the
reference's, in its order; ``exp``, ``log1p`` and ``sigmoid`` are torch's
(a counted float island, ROADMAP §3).  As in the reference the outer loop
over chunks keeps every chunk's activations for the backward (no
recomputation).

Gradient rules kept (JAX's, where torch's autograd would differ):
``softplus`` is ``jax.nn.softplus`` = ``logaddexp(x, 0)`` with
``logaddexp``'s own rule, ``g * exp(x - out)`` (0.5 at x = 0; autograd
through the forward's ``clamp`` and ``abs`` gives 1 there); ``sigmoid``
and ``silu`` are ``layers``' (``lax.logistic``'s rule).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.models.layers import (Obs, _group, _parts, fake_quant_parts,  # noqa: F401
                                       qdense_column, qdense_row, sigmoid, sigmoid_grad, silu)
from repro_torch.sharding import collectives as C

CHUNK = 128
MAMBA_SITES = ("mamba_in", "mamba_conv", "mamba_x", "mamba_out")


def softplus_grad(x, out, g, exp=torch.exp):
    """``logaddexp``'s gradient with respect to x at (x, 0): ``g * exp(x -
    out)``, with an infinite x or out read as 0 (JAX's ``_replace_inf``):
    out is infinite only where x is +inf, and the gradient there is g."""
    return torch.where(x == torch.inf, g, g * exp(x - out))


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return softplus_grad(x, out, g)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``,
    with ``logaddexp``'s gradient rule (``softplus_grad``)."""
    return _Softplus.apply(x)


def mamba_dims(cfg) -> Tuple[int, int]:
    """(d_in, dt_rank): the inner width and the rank of the dt projection."""
    return cfg.mamba_expand * cfg.d_model, max(1, math.ceil(cfg.d_model / 16))


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along axis 1 (``a`` may be one longer)."""
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:], dtype=a.dtype,
                      device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _ssm_combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def associative_scan(fn, elems):
    """Inclusive scan along axis 1 of the tuple of tensors ``elems`` under
    the associative ``fn(left, right)``: ``jax.lax.associative_scan``'s
    tree (combine adjacent pairs, recurse on the half, then fill in the
    even elements), so each element is combined in the reference's order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[:, 0:n - 1:2] for e in elems),
                                  tuple(e[:, 1::2] for e in elems)))
    rest = tuple(e[:, 2::2] for e in elems)
    even = fn(tuple(o[:, :-1] for o in odd) if n % 2 == 0 else odd, rest)
    even = tuple(torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def ssm_chunked(x, dt, B, C, A, D):
    """x, dt (Bt, S, d_in); B, C (Bt, S, N); A (d_in, N); D (d_in,) ->
    y (Bt, S, d_in), with h_t = exp(dt A) h_{t-1} + dt B_t x_t and
    y_t = C_t . h_t + D x_t.  Chunks of ``min(CHUNK, S)`` rows carry the
    state h (Bt, d_in, N) from one to the next; a ragged last chunk is
    zero-padded, as in the reference."""
    bt, s, d_in = x.shape
    n = B.shape[-1]
    chunk = min(CHUNK, s)
    pad = (-s) % chunk
    if pad:
        pz = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))  # noqa: E731
        x, dt, B, C = pz(x), pz(dt), pz(B), pz(C)
    h0 = torch.zeros((bt, d_in, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        xc, dtc, bc, cc = (t[:, c0:c0 + chunk] for t in (x, dt, B, C))
        a = torch.exp(dtc[..., None] * A)                           # (Bt, L, d_in, N)
        u = (dtc * xc)[..., None] * bc[:, :, None, :]
        a_cum, u_cum = associative_scan(_ssm_combine, (a, u))
        h = a_cum * h0[:, None] + u_cum
        ys.append(torch.einsum("bldn,bln->bld", h, cc))
        h0 = h[:, -1]
    y = torch.cat(ys, 1)[:, :s]
    return y + x[:, :s] * D


def ssm_step(x, dt, B, C, A, D, h):
    """The single-step recurrence (S == 1): x, dt (Bt, 1, d_in); B, C
    (Bt, 1, N); h (Bt, d_in, N).  Returns (y (Bt, 1, d_in), new h)."""
    a = torch.exp(dt[:, 0, :, None] * A)
    h = a * h + (dt[:, 0] * x[:, 0])[..., None] * B[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, C[:, 0])[:, None] + x * D
    return y, h


def causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x (B, S, d); w (K, d); ``state`` the last
    K-1 inputs before ``x`` (zeros when None).  Returns y and the last K-1
    inputs of ``[state, x]`` (the decode state)."""
    k = w.shape[0]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device) \
        if state is None else state
    xp = torch.cat([pad, x], 1)
    y = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + x.shape[1]] * w[i]
    return y, xp[:, -(k - 1):]


def mamba_qat(x: torch.Tensor, p: Dict, amax: Dict, policy: QuantPolicy, cfg,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Obs, Optional[Dict]]:
    """The calibration forward of one Mamba mixer: x (B, S, d) -> (out, obs,
    new state).  Without ``state`` the whole sequence runs through the
    chunked scan from a zero state (new state None); with ``state`` {h
    (B, d_in, N), conv (B, K-1, d_in)} one decode step (S == 1).

    With model-split params (``{"<model rank>": block}``, d_in split:
    ``train/steps.py``'s "split", no ``state``) each model rank runs its
    block of d_in channels, in the context's model group: ``w_in`` column-
    parallel, whose column block m holds [x | z]'s columns [2 m d_in / M,
    2 (m + 1) d_in / M), so ``collectives.model_exchange`` hands each rank
    x's and z's block m; the conv, its bias and the ``mamba_conv`` site on
    the rank's channels; ``w_x`` row-parallel, its (dt_r, B, C) summed over
    the ranks and then handed to each rank through ``copy_to_model`` (each
    rank consumes it, so its gradient sums every rank's); ``w_dt``'s,
    ``dt_bias``', ``A_log``'s and ``D``'s blocks; the scan, elementwise over
    d_in, on the rank's channels; ``w_out`` row-parallel."""
    _, dt_rank = mamba_dims(cfg)
    n = cfg.mamba_d_state
    obs: Obs = {}
    group = _group(p["w_in"])
    if group is not None and state is not None:
        raise ValueError("a decode step's state is whole: model-split Mamba params run the "
                         "sequence from a zero state only")
    xs = C.copy_to_model(group, x)
    xzs, obs["mamba_in"] = qdense_column(xs, p["w_in"], None, amax["mamba_in"], policy, group)
    xzs = C.model_exchange(group, xzs, 2)
    xcs, zs, conv_state = [], [], None
    for xz, w, cb in zip(xzs, _parts(p["conv_w"]), _parts(p["conv_b"]), strict=True):
        xi, z = torch.chunk(xz, 2, dim=-1)
        xc, conv_state = causal_conv(xi, w, None if state is None else state["conv"])
        xcs.append(silu(xc + cb))
        zs.append(z)
    xcs, obs["mamba_conv"] = fake_quant_parts(xcs, amax["mamba_conv"], policy.a_bits,
                                              policy.quantize_wa, group)
    prm, obs["mamba_x"] = qdense_row(xcs, p["w_x"], None, amax["mamba_x"], policy, group)
    ys, new_state = [], None
    for prm_r, xc, z, w_dt, dt_bias, a_log, d_skip in zip(
            C.copy_to_model(group, prm), xcs, zs, *(_parts(p[k]) for k in (
                "w_dt", "dt_bias", "A_log", "D")), strict=True):
        dt_r, B_, C_ = torch.split(prm_r.to(torch.float32), [dt_rank, n, n], dim=-1)
        dt = softplus(dt_r @ w_dt.to(torch.float32) + dt_bias)
        A = -torch.exp(a_log.to(torch.float32))
        xf, D = xc.to(torch.float32), d_skip.to(torch.float32)
        if state is None:
            y = ssm_chunked(xf, dt, B_, C_, A, D)
        else:
            y, h = ssm_step(xf, dt, B_, C_, A, D, state["h"])
            new_state = {"h": h, "conv": conv_state}
        ys.append(y.to(x.dtype) * silu(z))
    out, obs["mamba_out"] = qdense_row(ys, p["w_out"], None, amax["mamba_out"], policy, group)
    return out, obs, new_state
