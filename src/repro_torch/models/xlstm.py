"""xLSTM blocks for the calibration forward, and the float cores the integer
forward shares: mLSTM (matrix memory; the stabilized parallel form and the
single-step recurrence) and sLSTM (scalar memory, a sequential loop over
time), per arXiv:2405.04517.

A copy in torch of the reference ``models/xlstm.py``.  The projections are
fake-quantized like every linear; the gates, the recurrences and their
states stay float32.  ``exp``, ``tanh`` and ``sigmoid`` are torch's (a
counted float island, ROADMAP §3); ``log_sigmoid`` follows JAX's
``-softplus(-x)``.

Gradient rules kept, JAX's (the reference has no ``stop_gradient`` here,
so every stabilizer passes gradient): ``log_sigmoid`` through
``mamba.softplus`` (``logaddexp``'s rule) and the gates' ``sigmoid``
through ``layers.sigmoid`` (``lax.logistic``'s); ``jabs`` passes the
gradient whole at 0, as ``jnp.abs`` (``torch.abs`` passes 0 there);
``torch.amax`` and ``torch.maximum`` split a tie evenly, as ``jnp.max``
and ``jnp.maximum`` do.  ``tanh``'s is torch's (an island with its
forward).  The parallel form's row chunks are recomputed in the backward
(``layers.remat``), as the reference's ``jax.checkpoint``; the sLSTM loop
keeps every step, as its ``lax.scan``, each step one autograd node
(``_SlstmStep``).  ``cumsum``'s backward is
autograd's (a reverse sum in another order than XLA's; measured within
the tests' bound).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.layers import (Obs, _group, _parts, fake_quant_parts, qdense_column,
                                       qdense_row, remat, rmsnorm_xla_parts, sigmoid,
                                       sigmoid_grad)
from repro_torch.models.mamba import softplus, softplus_grad
from repro_torch.sharding import collectives as C

MLSTM_SITES = ("mlstm_in", "mlstm_y", "mlstm_out")
SLSTM_SITES = ("slstm_in", "slstm_y", "slstm_out")
PARALLEL_CHUNK = 512
SCAN_BASE = 16


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=1)`` in float32 in XLA's CPU order: a sequential
    sum within blocks of ``SCAN_BASE`` rows (the last block zero-padded),
    plus the exclusive cumulative sum of the block totals, the same way
    (XLA rewrites the cumulative reduce-window so).  ``torch.cumsum`` is
    sequential on the card and accumulates in float64 on the CPU."""
    n = x.shape[1]
    if n <= SCAN_BASE:
        rows = [x[:, 0]]
        for i in range(1, n):
            rows.append(rows[-1] + x[:, i])
        return torch.stack(rows, 1)
    pad = -n % SCAN_BASE
    xp = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    blocks = xp.reshape(x.shape[0] * (n + pad) // SCAN_BASE, SCAN_BASE, *x.shape[2:])
    inner = cumsum(blocks).reshape(x.shape[0], -1, SCAN_BASE, *x.shape[2:])
    outer = cumsum(inner[:, :, -1])
    excl = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], 1)
    return (inner + excl[:, :, None]).reshape(xp.shape)[:, :n]


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jabs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient rule: ``g`` where x >= 0 (0 and -0
    included), ``-g`` elsewhere."""
    return _Abs.apply(x)


def key_scale(e: int) -> float:
    """The keys' ``1 / sqrt(E)`` as the reference's compiled graphs apply
    it: its ``/ sqrt(E)`` sits inside a scanned body, where XLA turns the
    division by a constant into a multiply by the float32 reciprocal
    (exact where sqrt(E) is a power of two, as at E = 64)."""
    return q.recip_f32(math.sqrt(e))


def heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def mlstm_parallel(qh, kh, vh, gi, logf):
    """The stabilized parallel mLSTM: qh/kh/vh (B, S, H, E); gi/logf
    (B, S, H) -> (B, S, H, E).  Rows need only their own cumulative log
    forget gate, so a sequence longer than ``PARALLEL_CHUNK`` rows (and a
    multiple of it) runs in chunks of that many query rows, each recomputed
    in the backward, as in the reference."""
    b, s, nh, _ = qh.shape
    a = cumsum(logf)                                                 # (B, S, H)
    kpos = torch.arange(s, device=qh.device)[None, :]

    def rows(q_rows, a_rows, row0, cq):
        logd = (a_rows[:, :, None, :] - a[:, None, :, :]) + gi[:, None, :, :]
        qpos = row0 + torch.arange(cq, device=qh.device)[:, None]
        logd = torch.where((kpos <= qpos)[None, :, :, None], logd,
                           torch.full_like(logd, -torch.inf))
        m = torch.amax(logd, dim=2, keepdim=True)                    # (B, cq, 1, H)
        dmat = torch.exp(logd - m)
        sc = torch.einsum("bqhe,bkhe->bqkh", q_rows, kh) * dmat
        nrm = torch.maximum(jabs(sc.sum(2)), torch.exp(-m[:, :, 0]))
        return torch.einsum("bqkh,bkhe->bqhe", sc, vh) / nrm[..., None]

    if s > PARALLEL_CHUNK and s % PARALLEL_CHUNK == 0:
        return torch.cat([remat(rows, qh[:, r0:r0 + PARALLEL_CHUNK],
                                a[:, r0:r0 + PARALLEL_CHUNK], r0, PARALLEL_CHUNK)
                          for r0 in range(0, s, PARALLEL_CHUNK)], 1)
    return rows(qh, a, 0, s)


def mlstm_step(qh, kh, vh, gi, logf, state: Dict):
    """The single-step mLSTM recurrence (S == 1): qh/kh/vh (B, 1, H, E),
    gi/logf (B, 1, H); ``state`` {C (B, H, E, E), n (B, H, E), m (B, H)}.
    Returns (y (B, 1, H, E), new state)."""
    qt, kt, vt = qh[:, 0], kh[:, 0], vh[:, 0]
    git, logft = gi[:, 0], logf[:, 0]
    m_new = torch.maximum(logft + state["m"], git)
    fdec = torch.exp(logft + state["m"] - m_new)[..., None]
    iinc = torch.exp(git - m_new)[..., None]
    C = fdec[..., None] * state["C"] + iinc[..., None] * (kt[..., :, None] * vt[..., None, :])
    nvec = fdec * state["n"] + iinc * kt
    num = torch.einsum("bhe,bhef->bhf", qt, C)
    den = torch.maximum(jabs(torch.sum(nvec * qt, -1)), torch.exp(-m_new))
    return (num / den[..., None])[:, None], {"C": C, "n": nvec, "m": m_new}


def _split_group(w, state):
    group = _group(w)
    if group is not None and state is not None:
        raise ValueError("a decode step's state is whole: model-split xLSTM params run the "
                         "sequence from a zero state only")
    return group, 1 if group is None else group.size


def mlstm_qat(x: torch.Tensor, p: Dict, amax: Dict, policy: QuantPolicy, cfg,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Obs, Optional[Dict]]:
    """mLSTM: linear attention with exponential input / forget gates and a
    (E x E) matrix memory per head; the parallel form over a sequence, the
    recurrent one (S == 1) with ``state``.

    With model-split params (``train/steps.py``'s "split", no ``state``)
    each model rank runs its ``H/m`` heads (module docstring of
    ``layers``): q/k/v column-parallel (``heads`` is head-major, so a
    rank's columns are whole heads); the gates from its head columns of the
    replicated ``w_ig`` / ``w_fg`` and its d/m columns of ``w_og``
    (``collectives.model_blocks``) and its blocks of the split biases;
    ``ln_y`` over the whole row from every rank's window sums
    (``layers.rmsnorm_xla_parts``); ``wo`` row-parallel."""
    b, s, d = x.shape
    group, m = _split_group(p["wq"], state)
    nh = cfg.n_heads // m
    obs: Obs = {}
    xs = C.copy_to_model(group, x)
    qs, obs["mlstm_in"] = qdense_column(xs, p["wq"], None, amax["mlstm_in"], policy, group)
    ks, _ = qdense_column(xs, p["wk"], None, amax["mlstm_in"], policy, group)
    vs, _ = qdense_column(xs, p["wv"], None, amax["mlstm_in"], policy, group)
    ys, new_state = [], None
    for x_r, qp, kp, vp, w_ig, b_ig, w_fg, b_fg in zip(
            xs, qs, ks, vs, C.model_blocks(group, p["w_ig"], -1), _parts(p["b_ig"]),
            C.model_blocks(group, p["w_fg"], -1), _parts(p["b_fg"]), strict=True):
        qh = heads(qp, nh).to(torch.float32)
        kh = heads(kp, nh).to(torch.float32) * key_scale(qh.shape[-1])
        vh = heads(vp, nh).to(torch.float32)
        xf = x_r.to(torch.float32)
        gi = xf @ w_ig.to(torch.float32) + b_ig
        logf = log_sigmoid(xf @ w_fg.to(torch.float32) + b_fg)
        if state is None:
            y = mlstm_parallel(qh, kh, vh, gi, logf)
        else:
            y, new_state = mlstm_step(qh, kh, vh, gi, logf, state)
        ys.append(y.reshape(b, s, d // m).to(x.dtype))
    ogs = [sigmoid(x_r @ w + c) for x_r, w, c in zip(
        xs, C.model_blocks(group, p["w_og"], -1), _parts(p["b_og"]), strict=True)]
    ys = [y * og for y, og in zip(
        rmsnorm_xla_parts(ys, C.model_blocks(group, p["ln_y"], -1), group), ogs, strict=True)]
    ys, obs["mlstm_y"] = fake_quant_parts(ys, amax["mlstm_y"], policy.a_bits, policy.quantize_wa,
                                          group)
    out, obs["mlstm_out"] = qdense_row(ys, p["wo"], None, amax["mlstm_out"], policy, group)
    return out, obs, new_state


def _max_split(a, b, g):
    """``jnp.maximum``'s (and ``torch.maximum``'s) gradient of max(a, b):
    (to a, to b), a tie split evenly."""
    half, tie, a_wins = g / 2, a == b, a > b
    return (torch.where(tie, half, torch.where(a_wins, g, 0.0)),
            torch.where(tie, half, torch.where(a_wins, 0.0, g)))


def _recurrent(h, r):
    """``einsum("bhe,hef->bhf", h, r)``, the heads as the batch of a bmm."""
    return torch.bmm(h.transpose(0, 1), r).transpose(0, 1)


class _SlstmStep(torch.autograd.Function):
    """One sLSTM step: (h, the recurrent matrix r, the step's four gate
    pre-activations, c, n, m) -> (c, n, h, m).  The forward is the
    reference's step op for op; the backward is its chain rule written out
    in one call under JAX's rules (``layers.sigmoid_grad``,
    ``mamba.softplus_grad`` for ``log_sigmoid``, ties split evenly;
    ``tanh``'s as torch's autograd), so a step records one autograd node in
    place of some thirty: the loop is host-bound on the card (1,024 steps a
    layer at S = 1,024)."""

    @staticmethod
    def forward(ctx, h, r, zi, ii, ff, oo, c, n, m):
        rz, ri, rf, ro = torch.chunk(_recurrent(h, r), 4, dim=-1)
        z = torch.tanh(zi + rz)
        it = ii + ri
        ft = ff + rf
        o = torch.sigmoid(oo + ro)
        u = -ft
        sp = torch.clamp(u, min=0) + torch.log1p(torch.exp(-torch.abs(u)))
        lm = -sp + m
        m_new = torch.maximum(lm, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lm - m_new)
        c_new = f_p * c + i_p * z
        nn = f_p * n + i_p
        en = torch.exp(-m_new)
        n_new = torch.maximum(nn, en)
        q = c_new / n_new
        h_new = o * q
        ctx.save_for_backward(h, r, z, it, o, u, sp, lm, i_p, f_p, c, n, c_new, nn, en,
                              n_new, q)
        return c_new, n_new, h_new, m_new

    @staticmethod
    def backward(ctx, g_c, g_n, g_h, g_m):
        h, r, z, it, o, u, sp, lm, i_p, f_p, c, n, c_new, nn, en, n_new, q = ctx.saved_tensors
        g_op = sigmoid_grad(o, g_h * q)
        g_q = g_h * o
        g_c = g_c + g_q / n_new
        g_n = g_n + -g_q * c_new / (n_new * n_new)
        g_nn, g_en = _max_split(nn, en, g_n)
        g_m = g_m - g_en * en
        g_fp = g_nn * n + g_c * c
        g_ip = g_nn + g_c * z
        g_zp = g_c * i_p * (1 - z * z)
        g_e = g_ip * i_p
        g_lm = g_fp * f_p
        g_m = g_m - g_e - g_lm
        g_lm_max, g_it_max = _max_split(lm, it, g_m)
        g_lm = g_lm + g_lm_max
        g_it = g_e + g_it_max
        g_ft = softplus_grad(u, sp, g_lm)
        g_rec = torch.cat([g_zp, g_it, g_ft, g_op], -1).transpose(0, 1)     # (H, B, 4 dh)
        g_h = torch.bmm(g_rec, r.transpose(1, 2)).transpose(0, 1)
        g_r = torch.bmm(h.transpose(0, 1).transpose(1, 2), g_rec)
        return g_h, g_r, g_zp, g_it, g_ft, g_op, g_c * f_p, g_nn * f_p, g_lm


def slstm_scan(zi, ii, ff, oo, r, nh: int, state: Optional[Dict] = None):
    """The sLSTM recurrence over time: zi/ii/ff/oo (B, S, d) float32 gate
    pre-activations, r (H, dh, 4 dh) the recurrent matrix; ``state`` {c, n,
    h, m} (B, H, dh) each, zeros when None.  Returns (h per step (B, S, d),
    the final state).  Each step is one ``_SlstmStep``; the gates are split
    into steps once (``unbind``), so their backward writes each step's rows
    once."""
    b, s, d = zi.shape
    dh = d // nh
    if state is None:
        z0 = torch.zeros((b, nh, dh), dtype=torch.float32, device=zi.device)
        c, n, h, m = z0, z0, z0, z0
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for zt, it, ft, ot in zip(*(g.reshape(b, s, nh, dh).unbind(1) for g in (zi, ii, ff, oo))):
        c, n, h, m = _SlstmStep.apply(h, r, zt, it, ft, ot, c, n, m)
        hs.append(h)
    return torch.stack(hs, 1).reshape(b, s, d), {"c": c, "n": n, "h": h, "m": m}


def slstm_qat(x: torch.Tensor, p: Dict, amax: Dict, policy: QuantPolicy, cfg,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Obs, Optional[Dict]]:
    """sLSTM: scalar memory, exponential gating, a per-head recurrent
    matrix, run step by step over the sequence.  With ``state`` the final
    state comes back too.  With model-split params (no ``state``) each
    model rank runs its ``H/m`` heads: the four gates column-parallel with
    their bias blocks, the loop on its heads of the replicated ``r``
    (``collectives.model_blocks``), ``w_out`` row-parallel."""
    group, m = _split_group(p["w_z"], state)
    obs: Obs = {}
    xs = C.copy_to_model(group, x)
    zs, obs["slstm_in"] = qdense_column(xs, p["w_z"], p["b_z"], amax["slstm_in"], policy, group)
    is_, _ = qdense_column(xs, p["w_i"], p["b_i"], amax["slstm_in"], policy, group)
    fs, _ = qdense_column(xs, p["w_f"], p["b_f"], amax["slstm_in"], policy, group)
    os_, _ = qdense_column(xs, p["w_o"], p["b_o"], amax["slstm_in"], policy, group)
    hss, final = [], None
    for zi, ii, ff, oo, r in zip(zs, is_, fs, os_, C.model_blocks(group, p["r"], 0), strict=True):
        hs, final = slstm_scan(*(t.to(torch.float32) for t in (zi, ii, ff, oo)),
                               r.to(torch.float32), cfg.n_heads // m, state)
        hss.append(hs.to(x.dtype))
    ys, obs["slstm_y"] = fake_quant_parts(hss, amax["slstm_y"], policy.a_bits, policy.quantize_wa,
                                          group)
    out, obs["slstm_out"] = qdense_row(ys, p["w_out"], None, amax["slstm_out"], policy, group)
    return out, obs, None if state is None else final
