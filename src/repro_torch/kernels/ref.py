"""Plain PyTorch versions of the kernels (the oracles).

Each function here computes exactly what its CUDA kernel computes and what
the reference package's ``kernels/ref.py`` oracle computes, in the same
accumulation order.  The CPU tests hold them against the JAX oracles, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.

Integer products go through float64 matmuls: torch's ``int8 @ int8``
wraps and CUDA has no int32 matmul, while every product sum here is an
integer far below 2^53, so float64 is exact on both devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.boundary import exact_int_product
from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core import qlayernorm as qln
from repro_torch.core import qsoftmax as qs

NEG_INIT = -(1 << 30)


@exact_int_product(why="integer operands in a float64 carrier, every partial sum an "
                        "integer below 2^53", carrier=torch.float64)
def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (batched) matmul of int8/int32 operands -> int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int4_matmul_ref(x_i8, w_packed, bias_i32, M_q, shift_q):
    """W4A8 integer matmul + bias + fixed-point requantize -> int8 (M, N)."""
    w = packing.unpack_int4_planar(w_packed, axis=0)
    acc = int_matmul(x_i8, w) + bias_i32.to(torch.int32)
    return fxp.requantize(acc, M_q, shift_q, bits=8)


def int8_bitsplit_matmul_ref(x_i8, w_i8, bias_i32, M_q, shift_q):
    """W8A8 as two nibble products + shift-add (the BIM Type-A identity
    w = (w >> 4) * 16 + (w & 15): hi signed, lo unsigned), + bias,
    fixed-point requantize -> int8 (M, N)."""
    w32 = w_i8.to(torch.int32)
    acc_hi = int_matmul(x_i8, w32 >> 4)
    acc_lo = int_matmul(x_i8, w32 & 15)
    acc = (acc_hi << 4) + acc_lo + bias_i32.to(torch.int32)
    return fxp.requantize(acc, M_q, shift_q, bits=8)


def quant_softmax_ref(x_int, M_idx, shift_idx, lut, mask=None, axis=-1):
    return qs.quant_softmax(x_int, M_idx, shift_idx, lut, mask=mask, axis=axis)


def quant_layernorm_ref(x_int, p: qln.QLNParams, eps_codes: int = 1):
    return qln.quant_layernorm(x_int, p, eps_codes)


def _carry(m, den, acc, mb, den_b, pv, inv):
    """The fp32 carry of one block whose integer row max ``mb``, den_b and
    P.V are known: the running max, then the rescale of the running
    denominator and accumulator, in the reference's exact order."""
    m_new = torch.maximum(m, mb)
    f = torch.exp((m - m_new).to(torch.float32) * inv)
    f = torch.where(m == NEG_INIT, torch.zeros_like(f), f)
    return m_new, den * f + den_b.to(torch.float32), acc * f + pv.to(torch.float32)


def _online_update(m, den, acc, s, vb, M_idx, shift_idx, lut32, inv):
    """One page of the fp32 online carry, in the reference's exact order:
    int32 scores (already masked) -> q7 LUT numerators -> int8 P@V -> fp32
    rescale of the running denominator and accumulator."""
    lm = torch.amax(s, dim=-1, keepdim=True)
    m_new = torch.maximum(m, lm)
    idx = torch.clamp(fxp.rescale(m_new - s, M_idx, shift_idx, out_bits=9),
                      0, qs.LUT_SIZE - 1)
    num = lut32[idx.long()]                                  # Q0.7 numerators
    den_b = torch.sum(num, dim=-1, keepdim=True, dtype=torch.int32)
    return _carry(m, den, acc, lm, den_b, int_matmul(num, vb), inv)


def _epilogue(acc, den, out_scale):
    den = torch.clamp(den, min=1.0)
    o = acc / den * out_scale
    return torch.clamp(torch.round(o), -127, 127).to(torch.int8)


def qattention_ref(q_i8, k_i8, v_i8, M_idx, shift_idx, lut, out_scale,
                   causal: bool = True, q_offset: int = 0):
    """Row-wise fully-quantized attention oracle (paper-style, non-flash):
    q (..., H, Sq, D) x k/v (..., Hkv, Skv, D) int8 -> (..., H, Sq, D) int8,
    query row i at position ``q_offset + i`` when ``causal``.  Integer
    datapath: int8 QK^T -> int32 scores -> LUT numerators (Q0.7) -> int32
    P@V; the final division and output projection are the fp32 epilogue
    shared with the flash kernel.  No exp, so it equals the reference's
    ``ref.qattention_ref`` bit for bit."""
    sq = q_i8.shape[-2]
    group = q_i8.shape[-3] // k_i8.shape[-3]
    dev = q_i8.device
    kg = k_i8.repeat_interleave(group, dim=-3)
    vg = v_i8.repeat_interleave(group, dim=-3)
    s = int_matmul(q_i8, kg.transpose(-1, -2))
    if causal:
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(k_i8.shape[-2], device=dev)[None, :]
        s = torch.where(kpos <= qpos, s, s - qs.MASK_OFFSET)
    m = torch.amax(s, dim=-1, keepdim=True)
    idx = torch.clamp(fxp.rescale(m - s, M_idx, shift_idx, out_bits=9), 0, 255)
    num = lut.to(torch.int32)[idx.long()]                      # Q0.7 codes, <= 127
    den = torch.clamp(torch.sum(num, dim=-1, keepdim=True, dtype=torch.int32), min=1)
    pv = int_matmul(num, vg)
    o = pv.to(torch.float32) / den.to(torch.float32)
    y = torch.round(o * out_scale)
    return torch.clamp(y, -127, 127).to(torch.int8)


def paged_decode_qattention_ref(q_i8, k_pool, v_pool, block_tables, lengths,
                                M_idx, shift_idx, lut, inv_s_logit, out_scale):
    """Block-online oracle of the paged decode kernel: q (B, Hkv, G, D),
    pools (n_pages, P, Hkv, D), one page per step through the block table,
    pages at or past ``lengths[b]`` leave the carry untouched."""
    b, hkv, g, d = q_i8.shape
    dev = q_i8.device
    psize = k_pool.shape[1]
    nb = block_tables.shape[1]
    m = torch.full((b, hkv, g, 1), NEG_INIT, dtype=torch.int32, device=dev)
    den = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
    lut32 = lut.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    lengths = lengths.to(torch.int32)
    for k_i in range(nb):
        pg = block_tables[:, k_i].long()
        kb = k_pool[pg].permute(0, 2, 1, 3)                  # (B,Hkv,P,D)
        vb = v_pool[pg].permute(0, 2, 1, 3)
        s = int_matmul(q_i8, kb.transpose(-1, -2))           # (B,Hkv,G,P)
        kpos = k_i * psize + torch.arange(psize, dtype=torch.int32, device=dev)
        s = torch.where(kpos[None, None, None, :] < lengths[:, None, None, None],
                        s, s - qs.MASK_OFFSET)
        m_new, den_n, acc_n = _online_update(m, den, acc, s, vb, M_idx,
                                             shift_idx, lut32, inv)
        live = ((k_i * psize) < lengths)[:, None, None, None]
        den = torch.where(live, den_n, den)
        acc = torch.where(live, acc_n, acc)
        m = torch.where(live, m_new, m)
    return _epilogue(acc, den, out_scale)


def paged_decode_split_ref(q_i8, k_pool, v_pool, block_tables, lengths, M_idx, shift_idx,
                           lut, inv_s_logit, out_scale, span: int = 8):
    """The paged decode as the CUDA kernels split it (csrc/paged_decode.cuh),
    for the tests: (A) every page's masked scores and row maxima at once;
    (B) per page, the running max before it (the maxima of the pages before
    its span of ``span`` pages, then those of the span up to it) and after
    it, the factor f, the numerators, den_b and P.V (numerators as int8);
    (C) the fp32 carry over the pages in order.  Equal to
    ``paged_decode_qattention_ref`` bit for bit."""
    b, hkv, g, d = q_i8.shape
    dev = q_i8.device
    psize = k_pool.shape[1]
    nb = block_tables.shape[1]
    lengths = lengths.to(torch.int32)
    npages = torch.clamp((lengths + psize - 1) // psize, 0, nb)          # (B,)
    kb = k_pool[block_tables.long()].permute(0, 3, 1, 2, 4)              # (B,Hkv,nb,P,D)
    vb = v_pool[block_tables.long()].permute(0, 3, 1, 2, 4)
    # A
    s = int_matmul(q_i8[:, :, None], kb.transpose(-1, -2))              # (B,Hkv,nb,G,P)
    kpos = torch.arange(nb * psize, dtype=torch.int32, device=dev).reshape(nb, 1, psize)
    s = torch.where(kpos < lengths[:, None, None, None, None], s, s - qs.MASK_OFFSET)
    pmax = torch.amax(s, dim=-1)                                         # (B,Hkv,nb,G)
    # B
    m_old = torch.full_like(pmax, NEG_INIT)
    for p in range(1, nb):
        start = p // span * span
        pre = torch.full_like(pmax[:, :, 0], NEG_INIT)
        if start:
            pre = torch.maximum(pre, torch.amax(pmax[:, :, :start], dim=2))
        if p > start:
            pre = torch.maximum(pre, torch.amax(pmax[:, :, start:p], dim=2))
        m_old[:, :, p] = pre
    m_new = torch.maximum(m_old, pmax)
    f = torch.exp((m_old - m_new).to(torch.float32)
                  * torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev))
    f = torch.where(m_old == NEG_INIT, torch.zeros_like(f), f)
    idx = torch.clamp(fxp.rescale(m_new[..., None] - s, M_idx, shift_idx, out_bits=9),
                      0, qs.LUT_SIZE - 1)
    num = lut.to(torch.int32)[idx.long()]
    den_b = torch.sum(num, dim=-1, dtype=torch.int32)                    # (B,Hkv,nb,G)
    pv = int_matmul(num.to(torch.int8), vb)                              # (B,Hkv,nb,G,D)
    # C
    den = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
    for p in range(nb):
        live = (p < npages)[:, None, None, None]
        fp = f[:, :, p, :, None]
        den = torch.where(live, den * fp + den_b[:, :, p, :, None].to(torch.float32), den)
        acc = torch.where(live, acc * fp + pv[:, :, p].to(torch.float32), acc)
    return _epilogue(acc, den, out_scale)


def paged_decode_split_q4_ref(q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale, block_tables,
                              lengths, M_idx, shift_idx, lut, inv_s_logit, out_scale,
                              span: int = 8):
    """``paged_decode_split_ref`` over the int4-packed pool (whole-pool
    dequant first), for the tests."""
    return paged_decode_split_ref(
        q_i8, packing.dequantize_kv_pool(k_pool_u8, k_scale),
        packing.dequantize_kv_pool(v_pool_u8, v_scale), block_tables, lengths,
        M_idx, shift_idx, lut, inv_s_logit, out_scale, span)


def paged_prefill_qattention_ref(q_i8, k_pool, v_pool, block_tables, pos0,
                                 M_idx, shift_idx, lut, inv_s_logit, out_scale):
    """Block-online oracle of the paged chunked-prefill kernel: queries
    (B, H, S, D) at [pos0[b], pos0[b]+S) attend causally over the slot's
    whole block-table chain, one page per step.  The kernel skips pages
    wholly past a q block's causal frontier; that is an exact identity of
    this update (the reference oracle's docstring proves it), so the result
    does not depend on the kernel's q-block size."""
    b, h, sq, d = q_i8.shape
    dev = q_i8.device
    psize = k_pool.shape[1]
    hkv = k_pool.shape[2]
    group = h // hkv
    nb = block_tables.shape[1]
    m = torch.full((b, h, sq, 1), NEG_INIT, dtype=torch.int32, device=dev)
    den = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    lut32 = lut.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    qpos = pos0.to(torch.int32)[:, None] + torch.arange(sq, dtype=torch.int32, device=dev)
    for k_i in range(nb):
        pg = block_tables[:, k_i].long()
        kb = k_pool[pg].permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
        vb = v_pool[pg].permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
        s = int_matmul(q_i8, kb.transpose(-1, -2))           # (B,H,S,P)
        kpos = k_i * psize + torch.arange(psize, dtype=torch.int32, device=dev)
        live = kpos[None, None, None, :] <= qpos[:, None, :, None]
        s = torch.where(live, s, s - qs.MASK_OFFSET)
        m, den, acc = _online_update(m, den, acc, s, vb, M_idx, shift_idx,
                                     lut32, inv)
    return _epilogue(acc, den, out_scale)


def decode_qattention_ref(q_i8, k_i8, v_i8, lengths, M_idx, shift_idx, lut,
                          inv_s_logit, out_scale, bkv: int):
    """Block-online plain version of the contiguous decode kernel: q (B,
    Hkv, G, D) against the cache-native stripe (B, Smax, Hkv, D), one block
    of ``bkv`` keys per step (``bkv`` divides Smax).  The fp32 carry updates
    once per block with the max over the whole block, so the result depends
    on ``bkv``; blocks at or past ``lengths[b]`` leave the carry untouched.
    (The reference's ``ref.decode_qattention_ref`` is row-wise and equals
    this only when one block covers the row.)"""
    b, hkv, g, d = q_i8.shape
    dev = q_i8.device
    smax = k_i8.shape[1]
    assert smax % bkv == 0, (smax, bkv)
    m = torch.full((b, hkv, g, 1), NEG_INIT, dtype=torch.int32, device=dev)
    den = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
    lut32 = lut.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    for k_i in range(smax // bkv):
        kb = k_i8[:, k_i * bkv:(k_i + 1) * bkv].permute(0, 2, 1, 3)    # (B,Hkv,bkv,D)
        vb = v_i8[:, k_i * bkv:(k_i + 1) * bkv].permute(0, 2, 1, 3)
        s = int_matmul(q_i8, kb.transpose(-1, -2))                     # (B,Hkv,G,bkv)
        kpos = k_i * bkv + torch.arange(bkv, dtype=torch.int32, device=dev)
        s = torch.where(kpos[None, None, None, :] < lengths[:, None, None, None],
                        s, s - qs.MASK_OFFSET)
        m_new, den_n, acc_n = _online_update(m, den, acc, s, vb, M_idx,
                                             shift_idx, lut32, inv)
        live = ((k_i * bkv) < lengths)[:, None, None, None]
        den = torch.where(live, den_n, den)
        acc = torch.where(live, acc_n, acc)
        m = torch.where(live, m_new, m)
    return _epilogue(acc, den, out_scale)


def stripe_decode_split_ref(q_i8, k_i8, v_i8, lengths, M_idx, shift_idx, lut, inv_s_logit,
                            out_scale, bkv: int, warps: int = 8, rows: int = 16):
    """The contiguous decode as the CUDA kernels split it
    (csrc/stripe_decode.cuh), for the tests.  Each block of ``bkv`` keys is
    cut into sub-tiles of ``rows`` keys (the last one shorter where ``rows``
    does not divide ``bkv``), ``warps`` of them a span; a span never crosses
    a block end.  (A) The masked scores of every live sub-tile (its first
    row below the slot's length; the others are never read) and each span's
    row maxima.  (B) Per sub-tile, the numerators against the running max
    after the whole block (the maxima of every live span of blocks 0..j),
    as int8, den_b and P.V, summed in int32 over the span.  (C) Per live
    block in order, the spans' sums and maxima, then the fp32 carry.  Equal
    to ``decode_qattention_ref`` bit for bit."""
    b, hkv, g, d = q_i8.shape
    dev = q_i8.device
    smax = k_i8.shape[1]
    assert smax % bkv == 0, (smax, bkv)
    nst = -(-bkv // rows)
    spb = -(-nst // warps)
    lut32 = lut.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    outs = []
    for bb in range(b):
        ln = int(lengths[bb])
        # A
        spans = {}          # (block, span) -> [(t0, scores (Hkv, G, nv))]
        span_max = {}       # (block, span) -> (Hkv, G)
        for j in range(smax // bkv):
            for si in range(spb):
                subs = []
                for i in range(si * warps, min((si + 1) * warps, nst)):
                    t0, nv = j * bkv + i * rows, min(rows, bkv - i * rows)
                    if t0 >= ln:
                        break
                    kb = k_i8[bb, t0:t0 + nv].permute(1, 2, 0)           # (Hkv, D, nv)
                    s = int_matmul(q_i8[bb], kb)                          # (Hkv, G, nv)
                    kpos = t0 + torch.arange(nv, dtype=torch.int32, device=dev)
                    subs.append((t0, torch.where(kpos < ln, s, s - qs.MASK_OFFSET)))
                if subs:
                    spans[j, si] = subs
                    span_max[j, si] = torch.stack([s.amax(-1) for _, s in subs]).amax(0)
        # B
        part = {}
        for (j, si), subs in spans.items():
            m_new = torch.full((hkv, g), NEG_INIT, dtype=torch.int32, device=dev)
            for (j2, _), mx in span_max.items():
                if j2 <= j:
                    m_new = torch.maximum(m_new, mx)
            den_b = torch.zeros((hkv, g), dtype=torch.int32, device=dev)
            pv = torch.zeros((hkv, g, d), dtype=torch.int32, device=dev)
            for t0, s in subs:
                idx = torch.clamp(fxp.rescale(m_new[..., None] - s, M_idx, shift_idx,
                                              out_bits=9), 0, qs.LUT_SIZE - 1)
                num = lut32[idx.long()]
                den_b = den_b + torch.sum(num, dim=-1, dtype=torch.int32)
                vb = v_i8[bb, t0:t0 + s.shape[-1]].permute(1, 0, 2)      # (Hkv, nv, D)
                pv = pv + int_matmul(num.to(torch.int8), vb)
            part[j, si] = (den_b, pv)
        # C
        m = torch.full((hkv, g, 1), NEG_INIT, dtype=torch.int32, device=dev)
        den = torch.zeros((hkv, g, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((hkv, g, d), dtype=torch.float32, device=dev)
        for j in range(smax // bkv):
            live = [si for si in range(spb) if (j, si) in spans]
            if not live:
                break
            mb = torch.stack([span_max[j, si] for si in live]).amax(0)[..., None]
            den_b = torch.stack([part[j, si][0] for si in live]).sum(0, dtype=torch.int32)
            pv = torch.stack([part[j, si][1] for si in live]).sum(0, dtype=torch.int32)
            m, den, acc = _carry(m, den, acc, mb, den_b[..., None], pv, inv)
        outs.append(_epilogue(acc, den, out_scale))
    return torch.stack(outs)


# A KV block wholly below a row's sliding window may be skipped only where
# the reference's carry factor at the row's first live block is exactly
# 0.0f: there the running max jumps from a masked score (at most
# D * 127^2 - 2^30) to a live one (at least -D * 127^2), so the factor is
# exp(x * inv_s_logit) with x <= -(2^30 - 2 D 127^2).  float32's exp is 0
# below about -103.97 (half the smallest denormal); SKIP_EXP_ARG leaves room
# for the roundings of x, of the product and of exp itself.  The CUDA kernel
# takes it as an argument from its wrapper (an int, so both sides compare
# the same double product against the same threshold).
SKIP_EXP_ARG = 128


def window_skip_margin(inv_s_logit: float, d: int) -> float:
    """(2^30 - 2 D 127^2) * inv_s_logit / SKIP_EXP_ARG: above 1, the carry
    factor that would scale a masked prefix away is exactly 0.0f, so a
    windowed flash may start a row tile at its first live block (the CUDA
    kernel evaluates the same inequality per CTA from the same float32
    ``inv_s_logit`` and the same threshold; dividing by a power of two is
    exact, so ``> 1`` here is the kernel's ``> SKIP_EXP_ARG``)."""
    return ((1 << 30) - 2 * d * 127 * 127) * float(inv_s_logit) / SKIP_EXP_ARG


def flash_qattention_tiled_ref(q_i8, k_i8, v_i8, M_idx, shift_idx, lut, inv_s_logit,
                               out_scale, *, q_offset: int = 0, bkv: int = 512,
                               window: int | None = None, rows: int = 16, keys: int = 32):
    """The causal flash as the CUDA kernel tiles it (csrc/flash_qattention.cu),
    for the tests: q (..., H, Sq, D) x k/v (..., Hkv, Skv, D) in tiles of
    ``rows`` query rows.  Per block of ``bkv`` keys up to the tile's causal
    frontier: a first sweep over key steps of ``keys`` keys (counted from the
    block's start, the last one cut at the block end and at the frontier)
    takes the block's row max; a second sweep recomputes the integer scores
    for the numerators and sums den_b and P.V in int32 across the block;
    then the fp32 carry once per block.  With a sliding ``window`` a tile
    starts at the first block live for its first row where
    ``window_skip_margin`` exceeds 1, else at block 0.  Equal to
    ``flash_qattention_torch`` bit for bit."""
    h, sq, d = q_i8.shape[-3:]
    hkv, skv = k_i8.shape[-3], k_i8.shape[-2]
    group = h // hkv
    dev = q_i8.device
    bkv = min(bkv, skv)
    lead = q_i8.shape[:-3]
    lut32 = lut.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    kg = k_i8.repeat_interleave(group, dim=-3)
    vg = v_i8.repeat_interleave(group, dim=-3)
    out = torch.empty_like(q_i8)
    for r0 in range(0, sq, rows):
        qt = q_i8[..., r0:r0 + rows, :]
        nr = qt.shape[-2]
        last = q_offset + r0 + nr - 1
        qpos = q_offset + r0 + torch.arange(nr, dtype=torch.int32, device=dev)[:, None]
        m = torch.full((*lead, h, nr, 1), NEG_INIT, dtype=torch.int32, device=dev)
        den = torch.zeros((*lead, h, nr, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((*lead, h, nr, d), dtype=torch.float32, device=dev)

        def scores(t, e):
            s = int_matmul(qt, kg[..., t:e, :].transpose(-1, -2))
            kpos = torch.arange(t, e, dtype=torch.int32, device=dev)[None, :]
            live = kpos <= qpos
            if window is not None:
                live &= kpos > qpos - window
            return torch.where(live, s, s - qs.MASK_OFFSET)

        jend = min(skv // bkv, last // bkv + 1)
        j0 = 0
        if window is not None and window_skip_margin(inv_s_logit, d) > 1:
            j0 = min(max(0, q_offset + r0 - window + 1) // bkv, jend - 1)
        for j in range(j0, jend):
            end = min((j + 1) * bkv, last + 1)
            steps = [(t, min(t + keys, end)) for t in range(j * bkv, end, keys)]
            mb = torch.stack([scores(t, e).amax(-1) for t, e in steps]).amax(0)[..., None]
            m_new = torch.maximum(m, mb)
            den_b = torch.zeros_like(m)
            pv = torch.zeros((*lead, h, nr, d), dtype=torch.int32, device=dev)
            for t, e in steps:
                idx = torch.clamp(fxp.rescale(m_new - scores(t, e), M_idx, shift_idx,
                                              out_bits=9), 0, qs.LUT_SIZE - 1)
                num = lut32[idx.long()]
                den_b = den_b + torch.sum(num, dim=-1, keepdim=True, dtype=torch.int32)
                pv = pv + int_matmul(num.to(torch.int8), vg[..., t:e, :])
            m, den, acc = _carry(m, den, acc, mb, den_b, pv, inv)
        out[..., r0:r0 + nr, :] = _epilogue(acc, den, out_scale)
    return out


def flash_qdecode_ref(q_i8, k_i8, v_i8, cache_len, M_idx, shift_idx, lut, inv_s_logit,
                      out_scale, *, bkv: int = 512):
    """Plain version of the single-sequence decode kernel: q (Hkv, G, D)
    against the cache (Hkv, Smax, D), keys at or past ``cache_len`` masked,
    one carry update per block of ``bkv`` keys (clipped to Smax).  It is
    ``decode_qattention_ref`` at B = 1 on the cache turned to (1, Smax,
    Hkv, D): the reference also updates the carry on the blocks past
    ``cache_len``, where num = 0 and f = 1 leave it as it was."""
    smax = k_i8.shape[1]
    lengths = torch.as_tensor(cache_len, dtype=torch.int32).to(q_i8.device).reshape(1)
    return decode_qattention_ref(q_i8[None], k_i8.transpose(0, 1)[None],
                                 v_i8.transpose(0, 1)[None], lengths, M_idx, shift_idx, lut,
                                 inv_s_logit, out_scale, min(bkv, smax))[0]


def paged_decode_qattention_q4_ref(q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale,
                                   block_tables, lengths, M_idx, shift_idx, lut,
                                   inv_s_logit, out_scale):
    """Plain version of the int4-packed paged decode kernel: the whole pool
    dequantized with the shared packing formulas, then the int8 paged
    decode.  Every page the kernel reads dequantizes to the same codes."""
    return paged_decode_qattention_ref(
        q_i8, packing.dequantize_kv_pool(k_pool_u8, k_scale),
        packing.dequantize_kv_pool(v_pool_u8, v_scale), block_tables, lengths,
        M_idx, shift_idx, lut, inv_s_logit, out_scale)


def paged_prefill_qattention_q4_ref(q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale,
                                    block_tables, pos0, M_idx, shift_idx, lut,
                                    inv_s_logit, out_scale):
    """Plain version of the int4-packed paged prefill kernel (whole-pool
    dequant, then the int8 paged prefill)."""
    return paged_prefill_qattention_ref(
        q_i8, packing.dequantize_kv_pool(k_pool_u8, k_scale),
        packing.dequantize_kv_pool(v_pool_u8, v_scale), block_tables, pos0,
        M_idx, shift_idx, lut, inv_s_logit, out_scale)


def make_exp_lut_q7() -> np.ndarray:
    """Q0.7 exp table for the attention kernels (max code 127, fits int8)."""
    i = np.arange(qs.LUT_SIZE, dtype=np.float64)
    vals = np.round(np.exp(-i * qs.LUT_DELTA) * 127.0).astype(np.int32)
    vals[-1] = 0
    return vals
