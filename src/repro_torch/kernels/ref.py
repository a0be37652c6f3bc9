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

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core import qlayernorm as qln
from repro_torch.core import qsoftmax as qs

NEG_INIT = -(1 << 30)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (batched) matmul of int8/int32 operands -> int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int4_matmul_ref(x_i8, w_packed, bias_i32, M_q, shift_q):
    """W4A8 integer matmul + bias + fixed-point requantize -> int8 (M, N)."""
    w = packing.unpack_int4_planar(w_packed, axis=0)
    acc = int_matmul(x_i8, w) + bias_i32.to(torch.int32)
    return fxp.requantize(acc, M_q, shift_q, bits=8)


def quant_softmax_ref(x_int, M_idx, shift_idx, lut, mask=None, axis=-1):
    return qs.quant_softmax(x_int, M_idx, shift_idx, lut, mask=mask, axis=axis)


def quant_layernorm_ref(x_int, p: qln.QLNParams, eps_codes: int = 1):
    return qln.quant_layernorm(x_int, p, eps_codes)


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
    pv = int_matmul(num, vb)
    f = torch.exp((m - m_new).to(torch.float32) * inv)
    f = torch.where(m == NEG_INIT, torch.zeros_like(f), f)
    return m_new, den * f + den_b.to(torch.float32), acc * f + pv.to(torch.float32)


def _epilogue(acc, den, out_scale):
    den = torch.clamp(den, min=1.0)
    o = acc / den * out_scale
    return torch.clamp(torch.round(o), -127, 127).to(torch.int8)


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


def make_exp_lut_q7() -> np.ndarray:
    """Q0.7 exp table for the attention kernels (max code 127, fits int8)."""
    i = np.arange(qs.LUT_SIZE, dtype=np.float64)
    vals = np.round(np.exp(-i * qs.LUT_DELTA) * 127.0).astype(np.int32)
    vals[-1] = 0
    return vals
