"""Quantized linear layer: the QAT (fake-quant) form and the folded-integer
form (paper Eq. 4/5), as in the reference ``core/qlinear.py``.

* **QAT form** (training): float master weights W, bias b; the forward
  fake-quantizes the activation (8-bit, EMA scale) and the weight (4-bit,
  max|W| scale) with straight-through gradients (``qat_linear``).
* **Folded form** (serving): ``w_packed`` uint8 (K//2, N) K-planar
  nibble-packed int4 codes (rows [0, K/2) in the low nibbles, [K/2, K) in
  the high nibbles) — the layout the int4 matmul kernel streams; plain int8
  (K, N) codes at ``w_bits=8`` — with an int32 bias and a Q15 fixed-point
  requantization multiplier.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy, quantize_scale_8bit


class FoldedLinear(NamedTuple):
    w_packed: torch.Tensor
    bias_i: torch.Tensor   # int32 (N,)
    M: torch.Tensor        # int32 requant multiplier
    shift: torch.Tensor    # int32 requant shift
    w_bits: int


def qat_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], a_max,
               policy: QuantPolicy) -> torch.Tensor:
    """QAT forward: fake-quant activations + weights, float matmul.  ``a_max``
    is the EMA max|activation| of the site (0 on the very first step: the
    batch statistic stands in, so calibration bootstraps itself)."""
    if policy.quantize_wa:
        a_max = torch.as_tensor(a_max, device=x.device)
        a_m = torch.where(a_max > 0, a_max, q.per_tensor_max(x.detach()))
        x = q.fake_quant(x, a_m, policy.a_bits)
        w_d = w.detach()
        w_m = q.per_channel_max(w_d, axis=-1) if policy.per_channel_w else q.per_tensor_max(w_d)
        w = q.fake_quant(w, w_m, policy.w_bits)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def observe(x: torch.Tensor) -> torch.Tensor:
    """Batch statistic for the EMA calibrator (Eq. 3)."""
    return q.per_tensor_max(x.detach()).to(torch.float32)


def fold_linear(w, b, s_a: float, s_y: float, policy: QuantPolicy) -> FoldedLinear:
    """Fold a trained float linear layer (numpy or tensor leaves) into the
    integer serving form (CPU tensors), in float64 as the reference folds
    it.  ``s_a``: input activation scale (from the EMA), ``s_y``: output
    scale."""
    w = np.asarray(w, np.float64)
    qm = q.qmax(policy.w_bits)
    s_w = float(qm / max(float(np.max(np.abs(w))), 1e-8))
    if policy.quantize_scale:
        s_w = quantize_scale_8bit(s_w)
        s_a = quantize_scale_8bit(s_a)
        s_y = quantize_scale_8bit(s_y)
    codes = torch.from_numpy(np.clip(np.round(w * s_w), -qm, qm).astype(np.int8))
    if policy.w_bits == 4:
        assert w.shape[0] % 2 == 0, "int4 packing needs even K"
        w_packed = packing.pack_int4_planar(codes, axis=0)
    else:
        w_packed = codes
    if b is not None:
        bias_i = np.round(np.asarray(b, np.float64) * (s_a * s_w)).astype(np.int64)
        bias_i = np.clip(bias_i, -(2**31 - 1), 2**31 - 1).astype(np.int32)
    else:
        bias_i = np.zeros(w.shape[1], np.int32)
    M, shift = fxp.quantize_multiplier(s_y / (s_a * s_w))
    return FoldedLinear(w_packed=w_packed, bias_i=torch.from_numpy(bias_i),
                        M=torch.tensor(M, dtype=torch.int32),
                        shift=torch.tensor(shift, dtype=torch.int32), w_bits=policy.w_bits)


def integer_linear_ref(x_i: torch.Tensor, f: FoldedLinear) -> torch.Tensor:
    """Plain integer forward: int8 codes (..., K) -> int8 codes (..., N) on
    the s_y grid.  The int32 product goes through float64, exact for every
    int8 x int4/int8 sum below 2^53 (torch's ``int8 @ int8`` wraps)."""
    w_codes = (packing.unpack_int4_planar(f.w_packed, axis=0) if f.w_bits == 4
               else f.w_packed)
    acc = torch.matmul(x_i.to(torch.float64), w_codes.to(torch.float64)).to(torch.int32)
    acc = acc + f.bias_i.to(torch.int32)
    return fxp.requantize(acc, f.M, f.shift, bits=8)
