"""Paged chunked-prefill attention: the CUDA kernels
``csrc/paged_prefill_attention.cu`` (int8 pool) and
``csrc/paged_prefill_attention_q4.cu`` (int4-packed pool), and their
wrappers.

Replace the TPU kernels ``paged_prefill_qattention`` and
``paged_prefill_qattention_q4`` of ``repro/kernels/prefill_attention.py``.
On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it computes the plain version in ``kernels/ref.py``.  The kernel reads q
through its strides and writes the output in q's layout, so the serving
forward's (B, S, H, D) projections go in and come out without a copy.  A
block serves 16 query rows of some q heads of one kv head, as many as
``autotune.attn_heads_per_block`` picks (``heads_per_block`` is its
``off`` rule); the result does not depend on that choice.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.boundary import kernel_launch
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.decode_attention import _strided
from repro_torch.kernels.ref import paged_prefill_qattention_q4_ref, paged_prefill_qattention_ref

SOURCE = "src/repro_torch/csrc/paged_prefill_attention.cu"
REPLACES = "src/repro/kernels/prefill_attention.py:128"
Q4_SOURCE = "src/repro_torch/csrc/paged_prefill_attention_q4.cu"
Q4_REPLACES = "src/repro/kernels/prefill_attention.py:214"


MAX_HEADS_PER_BLOCK = 4    # q heads per block, one warp each (csrc/paged_prefill.cuh)
ROWS_PER_BLOCK = 16        # query rows per block


def heads_per_block(group: int, units: int, sms: int) -> int:
    """q heads per block for ``units`` (row tile, slot, kv head) triples
    (the tuner's ``off`` rule): the largest divisor of the group size up to
    4, halved while the grid has fewer blocks than the card has SMs."""
    gh = max(d for d in range(1, MAX_HEADS_PER_BLOCK + 1) if group % d == 0)
    while gh % 2 == 0 and units * (group // gh) < sms:
        gh //= 2
    return gh


def _common(name, q_i8, k_pool, v_pool, block_tables, pos0, lut_q7, M_idx, shift_idx,
            inv_s_logit, out_scale, d_pool, gh):
    """Checks shared by both wrappers; returns q as the kernel reads it, the
    output, the launch's device tensors and its ints.
    ``d_pool`` is the head dim the pool's last axis stands for; ``gh`` the
    heads a block (None: the tuner's pick)."""
    if q_i8.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q_i8.device}")
    b, h, sq, d = q_i8.shape
    _, psize, hkv, _ = k_pool.shape
    if d_pool != d or h % hkv or v_pool.shape != k_pool.shape or d > 128 or d % 16 \
            or not 0 < psize <= 64:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q_i8.shape)}, pool "
                         f"{tuple(k_pool.shape)} (needs D <= 128, D % 16 == 0, P <= 64, "
                         f"H % Hkv == 0)")
    group = h // hkv
    dev = q_i8.device
    if gh is None:
        gh = autotune.attn_heads_per_block(
            group, -(-sq // ROWS_PER_BLOCK) * b * hkv, _build.sm_count(dev),
            shape=(name, b, h, sq, d, hkv, psize, block_tables.shape[1]), device=dev)
    if group % gh or gh > MAX_HEADS_PER_BLOCK:
        raise ValueError(f"{name}: heads_per_block {gh} must divide H / Hkv = {group} "
                         f"and be at most {MAX_HEADS_PER_BLOCK}")
    kp, vp = k_pool.contiguous(), v_pool.contiguous()
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned")
    q = _strided(q_i8)
    out = torch.empty_like(q)      # q's layout where q is dense, else contiguous
    btab = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    p0 = torch.as_tensor(pos0, dtype=torch.int32).to(dev).reshape(-1).expand(b).contiguous()
    lut = lut_q7.to(device=dev, dtype=torch.int32).contiguous()
    if lut.data_ptr() % 16:                 # the kernel copies it in 16-byte pieces
        lut = lut.clone()
    scal = _build.attn_scalars(dev, M_idx, shift_idx, inv_s_logit, out_scale)
    ints = (b, h, sq, hkv, d, psize, block_tables.shape[1], gh, *q.stride()[:3],
            *out.stride()[:3])
    return q, out, kp, vp, btab, p0, lut, scal, ints


def _launch_int8(q_i8, k_pool, v_pool, block_tables, pos0, M_idx, shift_idx, lut_q7,
                 inv_s_logit, out_scale, gh=None):
    """The int8 pool's kernel on checked CUDA operands, ``gh`` heads a block
    (None: the tuner's pick); counts nothing."""
    q, out, kp, vp, btab, p0, lut, scal, ints = _common(
        "paged_prefill_qattention", q_i8, k_pool, v_pool, block_tables, pos0, lut_q7,
        M_idx, shift_idx, inv_s_logit, out_scale, k_pool.shape[-1], gh)
    rc = _build.bind("paged_prefill_attention", "paged_prefill_attention", 11, 14)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), btab.data_ptr(), p0.data_ptr(),
        lut.data_ptr(), *(t.data_ptr() for t in scal), out.data_ptr(), *ints,
        _build.stream_of(q.device))
    _build.check_launch(rc, "paged_prefill_qattention")
    return out


@kernel_launch
def paged_prefill_qattention(q_i8, k_pool, v_pool, block_tables, pos0, M_idx,
                             shift_idx, lut_q7, inv_s_logit, out_scale):
    """q int8 (B, H, S, D) at positions [pos0, pos0+S) x pools int8
    (n_pages, P, Hkv, D) through the block table -> int8 (B, H, S, D), in
    q's layout on the card."""
    if q_i8.device.type == "cpu":
        return paged_prefill_qattention_ref(q_i8, k_pool, v_pool, block_tables, pos0,
                                            M_idx, shift_idx, lut_q7, inv_s_logit,
                                            out_scale)
    if q_i8.dtype != torch.int8 or k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError("paged_prefill_qattention wants int8 q and pools")
    out = _launch_int8(q_i8, k_pool, v_pool, block_tables, pos0, M_idx, shift_idx, lut_q7,
                       inv_s_logit, out_scale)
    paged_prefill_qattention.launches += 1
    return out


paged_prefill_qattention.launches = 0


def _launch_q4(q_i8, k_pool, v_pool, k_scale, v_scale, block_tables, pos0, M_idx, shift_idx,
               lut_q7, inv_s_logit, out_scale, gh=None):
    """The int4-packed pool's kernel on checked CUDA operands, ``gh`` heads
    a block (None: the tuner's pick); counts nothing."""
    q, out, kp, vp, btab, p0, lut, scal, ints = _common(
        "paged_prefill_qattention_q4", q_i8, k_pool, v_pool, block_tables, pos0, lut_q7,
        M_idx, shift_idx, inv_s_logit, out_scale, 2 * k_pool.shape[-1], gh)
    ks = k_scale.to(device=q.device, dtype=torch.float32).contiguous()
    vs = v_scale.to(device=q.device, dtype=torch.float32).contiguous()
    rc = _build.bind("paged_prefill_attention_q4", "paged_prefill_attention_q4", 13, 14)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        btab.data_ptr(), p0.data_ptr(), lut.data_ptr(), *(t.data_ptr() for t in scal),
        out.data_ptr(), *ints, _build.stream_of(q.device))
    _build.check_launch(rc, "paged_prefill_qattention_q4")
    return out


@kernel_launch
def paged_prefill_qattention_q4(q_i8, k_pool, v_pool, k_scale, v_scale, block_tables,
                                pos0, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale):
    """q int8 (B, H, S, D) at positions [pos0, pos0+S) x int4-packed pools
    uint8 (n_pages, P, Hkv, D/2) with fp32 (n_pages,) page scales, through
    the block table -> int8 (B, H, S, D), in q's layout on the card."""
    if q_i8.device.type == "cpu":
        return paged_prefill_qattention_q4_ref(q_i8, k_pool, v_pool, k_scale, v_scale,
                                               block_tables, pos0, M_idx, shift_idx,
                                               lut_q7, inv_s_logit, out_scale)
    if q_i8.dtype != torch.int8 or k_pool.dtype != torch.uint8 \
            or v_pool.dtype != torch.uint8:
        raise TypeError("paged_prefill_qattention_q4 wants int8 q and uint8 packed pools")
    n_pages = k_pool.shape[0]
    if q_i8.shape[-1] % 32 or tuple(k_scale.shape) != (n_pages,) \
            or tuple(v_scale.shape) != (n_pages,):
        raise ValueError(f"paged_prefill_qattention_q4: unsupported shapes q "
                         f"{tuple(q_i8.shape)}, scales {tuple(k_scale.shape)} (needs "
                         f"D % 32 == 0, one scale per page)")
    out = _launch_q4(q_i8, k_pool, v_pool, k_scale, v_scale, block_tables, pos0, M_idx,
                     shift_idx, lut_q7, inv_s_logit, out_scale)
    paged_prefill_qattention_q4.launches += 1
    return out


paged_prefill_qattention_q4.launches = 0
