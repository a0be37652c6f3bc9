"""Public kernel entry points with backend dispatch.

Backends (env ``REPRO_TORCH_KERNELS`` or the per-call ``impl=``):
  * ``ref``  — the plain PyTorch versions (``kernels/ref.py``) and the
               row-exact q8 datapath of the model; mirrors the reference's
               ``ref`` backend, bit for bit.  Default for CPU tensors.
  * ``gpu``  — the hand-written CUDA kernels; mirrors the reference's
               ``pallas`` backend (the q7 paged attention family).  Default
               for CUDA tensors.  Each wrapper launches its kernel for a
               CUDA tensor and computes the plain version only for a CPU
               tensor, so the CPU tests can drive this control flow.
  * ``auto`` — ``gpu`` for CUDA tensors, ``ref`` otherwise (default).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.core.qlayernorm import QLNParams
from repro_torch.core.qlinear import FoldedLinear
from repro_torch.core.qsoftmax import MASK_OFFSET
from repro_torch.kernels import autotune
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import (
    decode_qattention,
    paged_decode_qattention,
    paged_decode_qattention_q4,
)
from repro_torch.kernels.flash_qattention import flash_qattention, flash_qattention_torch
from repro_torch.kernels.int4_matmul import int4_matmul, int8_bitsplit_matmul
from repro_torch.kernels.prefill_attention import (
    paged_prefill_qattention,
    paged_prefill_qattention_q4,
)
from repro_torch.kernels.quant_layernorm import quant_layernorm
from repro_torch.kernels.quant_softmax import quant_softmax

BACKENDS = ("auto", "ref", "gpu")


def backend(override: Optional[str] = None, device=None) -> str:
    b = override or os.environ.get("REPRO_TORCH_KERNELS", "auto")
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend {b!r}; one of {BACKENDS}")
    if b == "auto":
        return "gpu" if device is not None and torch.device(device).type == "cuda" else "ref"
    return b


def linear_w4a8(x_i8: torch.Tensor, f: FoldedLinear, *, impl: Optional[str] = None):
    """y_i8 = requant(x_i8 @ unpack(W4) + b).  x: int8 (..., K) -> (..., N).
    A ``w_bits=8`` linear (plain int8 codes) takes the bit-split W8A8 path."""
    if f.w_bits == 8:
        return linear_w8a8_bitsplit(x_i8, f.w_packed, f.bias_i, f.M, f.shift, impl=impl)
    lead = x_i8.shape[:-1]
    x2 = x_i8.reshape(-1, x_i8.shape[-1])
    if backend(impl, x_i8.device) == "ref":
        y = _ref.int4_matmul_ref(x2, f.w_packed, f.bias_i, f.M, f.shift)
    else:
        y = int4_matmul(x2, f.w_packed, f.bias_i, f.M, f.shift)
    return y.reshape(*lead, -1)


def linear_w8a8_bitsplit(x_i8, w_i8, bias_i, M, shift, *, impl: Optional[str] = None):
    """8x8 matmul as two 8x4 passes (BIM Type-A).  x: int8 (..., K) -> (..., N)."""
    lead = x_i8.shape[:-1]
    x2 = x_i8.reshape(-1, x_i8.shape[-1])
    if backend(impl, x_i8.device) == "ref":
        y = _ref.int8_bitsplit_matmul_ref(x2, w_i8, bias_i, M, shift)
    else:
        y = int8_bitsplit_matmul(x2, w_i8, bias_i, M, shift)
    return y.reshape(*lead, -1)


def layernorm_q(x_i8: torch.Tensor, p: QLNParams, *, eps_codes: int = 1, impl=None):
    if backend(impl, x_i8.device) == "ref":
        return _ref.quant_layernorm_ref(x_i8, p, eps_codes)
    lead = x_i8.shape[:-1]
    n = x_i8.shape[-1]
    y = quant_layernorm(x_i8.reshape(-1, n), p, eps_codes)
    return y.reshape(*lead, n)


def softmax_q(x_int, M_idx, shift_idx, lut, mask=None, *, impl=None):
    """Quantized row softmax over the last axis (int32 codes -> int8);
    ``mask`` bool, True = attend."""
    if backend(impl, x_int.device) == "ref":
        return _ref.quant_softmax_ref(x_int, M_idx, shift_idx, lut, mask=mask)
    if mask is not None:
        x_int = torch.where(mask, x_int, x_int - MASK_OFFSET)
    s = x_int.shape[-1]
    y = quant_softmax(x_int.to(torch.int32).reshape(-1, s), M_idx, shift_idx, lut)
    return y.reshape(x_int.shape)


def paged_decode_attention_q(q_i8, k_pool, v_pool, block_tables, lengths, M_idx,
                             shift_idx, lut_q7, inv_s_logit, out_scale, *, impl=None):
    """(B, Hkv, G, D) grouped queries x (n_pages, P, Hkv, D) int8 pool through
    the (B, max_blocks) block table -> (B, Hkv, G, D) int8 context."""
    args = (q_i8, k_pool, v_pool, block_tables, lengths, M_idx, shift_idx, lut_q7,
            inv_s_logit, out_scale)
    if backend(impl, q_i8.device) == "ref":
        return _ref.paged_decode_qattention_ref(*args)
    return paged_decode_qattention(*args)


def paged_prefill_attention_q(q_i8, k_pool, v_pool, block_tables, pos0, M_idx,
                              shift_idx, lut_q7, inv_s_logit, out_scale, *, impl=None):
    """(B, H, S, D) chunk queries at [pos0, pos0+S) x the paged int8 pool ->
    (B, H, S, D) int8 context over each slot's whole mapped chain."""
    args = (q_i8, k_pool, v_pool, block_tables, pos0, M_idx, shift_idx, lut_q7,
            inv_s_logit, out_scale)
    if backend(impl, q_i8.device) == "ref":
        return _ref.paged_prefill_qattention_ref(*args)
    return paged_prefill_qattention(*args)


def paged_decode_attention_q4(q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale, block_tables,
                              lengths, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale, *,
                              impl=None):
    """``paged_decode_attention_q`` over the int4-packed pool: (n_pages, P,
    Hkv, D/2) uint8 nibble-planar pages with one fp32 scale per page (K and
    V), dequantized page by page inside the kernel."""
    args = (q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale, block_tables, lengths, M_idx,
            shift_idx, lut_q7, inv_s_logit, out_scale)
    if backend(impl, q_i8.device) == "ref":
        return _ref.paged_decode_qattention_q4_ref(*args)
    return paged_decode_qattention_q4(*args)


def paged_prefill_attention_q4(q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale, block_tables,
                               pos0, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale, *,
                               impl=None):
    """``paged_prefill_attention_q`` over the int4-packed pool."""
    args = (q_i8, k_pool_u8, v_pool_u8, k_scale, v_scale, block_tables, pos0, M_idx,
            shift_idx, lut_q7, inv_s_logit, out_scale)
    if backend(impl, q_i8.device) == "ref":
        return _ref.paged_prefill_qattention_q4_ref(*args)
    return paged_prefill_qattention_q4(*args)


def decode_attention_q(q_i8, k_cache, v_cache, lengths, M_idx, shift_idx, lut_q7,
                       inv_s_logit, out_scale, *, bkv: Optional[int] = None, impl=None):
    """(B, Hkv, G, D) grouped queries x the contiguous (B, Smax, Hkv, D) int8
    stripe, each slot masked to ``lengths[b]``, blocks of ``bkv`` keys ->
    (B, Hkv, G, D) int8 context.  ``bkv=None`` asks ``autotune.decode_bkv``
    (the pin or 512).
    The block moves codes: the q7 carry takes each block's max, and the LUT
    numerators follow it (``tests/test_torch_autotune.py::
    test_bkv_moves_codes``), so a caller that must agree with another run
    names its ``bkv``, as the served decode does."""
    if bkv is None:
        b, smax, hkv, d = k_cache.shape
        bkv = autotune.decode_bkv(smax, batch_slots=b, hkv=hkv, hd=d)
    args = (q_i8, k_cache, v_cache, lengths, M_idx, shift_idx, lut_q7, inv_s_logit,
            out_scale)
    if backend(impl, q_i8.device) == "ref":
        return _ref.decode_qattention_ref(*args, bkv)
    return decode_qattention(*args, bkv=bkv)


def flash_attention_q(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale, *,
                      bkv: int, window: Optional[int] = None, impl=None):
    """Causal blocked flash from position 0 over (B, H, S, D) x (B, Hkv, S,
    D) int8, within a sliding ``window`` where one is given, one fp32 carry
    update per block of ``bkv`` keys -> (B, H, S, D) int8: the cache-less
    prefill's attention (the plain version on ``ref``, the kernel on
    ``gpu``)."""
    args = (q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale)
    if backend(impl, q_i8.device) == "ref":
        return flash_qattention_torch(*args, bkv=bkv, window=window)
    return flash_qattention(*args, bkv=bkv, window=window)


def attention_q(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale, *,
                causal: bool = True, q_offset: int = 0, impl=None):
    """Quantized attention, (B, H, Sq, D) x (B, Hkv, Skv, D) -> (B, H, Sq, D).

    ``ref`` = the paper-style row softmax (exact, causal or not); ``gpu`` =
    the online flash kernel at the reference's default blocks (128 keys,
    clipped to Skv), causal only."""
    if backend(impl, q_i8.device) == "ref":
        return _ref.qattention_ref(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, out_scale,
                                   causal=causal, q_offset=q_offset)
    if not causal:
        raise ValueError("the flash kernel is causal-only; the bidirectional (BERT) "
                         "attention uses softmax_q")
    return flash_qattention(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit,
                            out_scale, q_offset=q_offset, bkv=128)
