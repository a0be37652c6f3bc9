"""Blocked causal integer attention over a contiguous KV view (plain torch).

Mirror of the reference's pure-JAX ``flash_qattention_jax``: the same
per-block integer datapath (int8 QK^T -> int32 scores -> q7 LUT numerators
-> int8 P@V) with the fp32 online carry, as a Python loop over KV blocks.
The cache-less causal prefill takes it on every backend; it has no TPU
kernel behind it, so it has no CUDA kernel either.
"""
from __future__ import annotations

import torch

from repro_torch.core import qsoftmax as qs
from repro_torch.kernels.ref import NEG_INIT, _epilogue, _online_update, int_matmul


def divisor_tile(cap: int, n: int) -> int:
    """Largest tile <= ``cap`` that divides ``n`` exactly."""
    cap = min(cap, n)
    while n % cap:
        cap -= 1
    return cap


def flash_qattention_torch(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7,
                           inv_s_logit, out_scale, *, bkv: int = 512):
    """q (H, S, D) x k/v (Hkv, S, D) int8 -> (H, S, D) int8, causal from
    position 0 (no sliding window: SWA archs are not ported)."""
    h, sq, d = q_i8.shape
    hkv, skv, _ = k_i8.shape
    group = h // hkv
    dev = q_i8.device
    bkv = min(bkv, skv)
    assert skv % bkv == 0
    qpos = torch.arange(sq, dtype=torch.int32, device=dev)[:, None]
    m = torch.full((h, sq, 1), NEG_INIT, dtype=torch.int32, device=dev)
    den = torch.zeros((h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((h, sq, d), dtype=torch.float32, device=dev)
    lut32 = lut_q7.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    for k_i in range(skv // bkv):
        kg = k_i8[:, k_i * bkv:(k_i + 1) * bkv].repeat_interleave(group, dim=0)
        vg = v_i8[:, k_i * bkv:(k_i + 1) * bkv].repeat_interleave(group, dim=0)
        s = int_matmul(q_i8, kg.transpose(-1, -2))           # (H, Sq, bkv)
        kpos = k_i * bkv + torch.arange(bkv, dtype=torch.int32, device=dev)[None, :]
        s = torch.where((kpos <= qpos)[None], s, s - qs.MASK_OFFSET)
        m, den, acc = _online_update(m, den, acc, s, vg, M_idx, shift_idx,
                                     lut32, inv)
    return _epilogue(acc, den, out_scale)
