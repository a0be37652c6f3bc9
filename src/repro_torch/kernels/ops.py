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

Paths the port does not have yet raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.core.qlayernorm import QLNParams
from repro_torch.core.qlinear import FoldedLinear
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import paged_decode_qattention
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.prefill_attention import paged_prefill_qattention
from repro_torch.kernels.quant_layernorm import quant_layernorm

BACKENDS = ("auto", "ref", "gpu")


def backend(override: Optional[str] = None, device=None) -> str:
    b = override or os.environ.get("REPRO_TORCH_KERNELS", "auto")
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend {b!r}; one of {BACKENDS}")
    if b == "auto":
        return "gpu" if device is not None and torch.device(device).type == "cuda" else "ref"
    return b


def not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Open items §1")


def linear_w4a8(x_i8: torch.Tensor, f: FoldedLinear, *, impl: Optional[str] = None):
    """y_i8 = requant(x_i8 @ unpack(W4) + b).  x: int8 (..., K) -> (..., N)."""
    if f.w_bits != 4:
        raise not_ported("w_bits=8 serving (int8_bitsplit_matmul)")
    lead = x_i8.shape[:-1]
    x2 = x_i8.reshape(-1, x_i8.shape[-1])
    if backend(impl, x_i8.device) == "ref":
        y = _ref.int4_matmul_ref(x2, f.w_packed, f.bias_i, f.M, f.shift)
    else:
        y = int4_matmul(x2, f.w_packed, f.bias_i, f.M, f.shift)
    return y.reshape(*lead, -1)


def layernorm_q(x_i8: torch.Tensor, p: QLNParams, *, eps_codes: int = 1, impl=None):
    if backend(impl, x_i8.device) == "ref":
        return _ref.quant_layernorm_ref(x_i8, p, eps_codes)
    lead = x_i8.shape[:-1]
    n = x_i8.shape[-1]
    y = quant_layernorm(x_i8.reshape(-1, n), p, eps_codes)
    return y.reshape(*lead, n)


def softmax_q(x_int, M_idx, shift_idx, lut, mask=None, *, impl=None):
    """Quantized row softmax over the last axis (int32 codes -> int8)."""
    if backend(impl, x_int.device) == "gpu" and x_int.device.type == "cuda":
        raise not_ported("the quant_softmax kernel")
    return _ref.quant_softmax_ref(x_int, M_idx, shift_idx, lut, mask=mask)


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
