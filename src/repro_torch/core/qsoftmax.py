"""LUT-based fully-quantized softmax — paper §III-B "Softmax Core".

Same fixed-point semantics as the reference ``core/qsoftmax.py``:

  1. m = rowmax(x_I);  2. d = m - x_I;  3. idx = clamp(rescale(d), 0, 255)
  4. num = LUT[idx] (Q0.8);  5. den = sum(num)
  6. p_I = clamp((num*128 + den/2) // den, 0, 127)   (int8, scale 128)

Masked logits sit ``MASK_OFFSET`` below any live one, so their index clips
to 255, whose table entry is forced to 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp

LUT_SIZE = 256
LUT_T = math.log(1024.0)            # table domain: exp(-t), t in [0, ln 1024]
LUT_DELTA = LUT_T / (LUT_SIZE - 1)  # index step in real units
MASK_OFFSET = 1 << 30               # subtracted from masked logit codes
SOFTMAX_OUT_SCALE = 128.0           # p_real = p_I / 128


def make_exp_lut() -> np.ndarray:
    """(256,) int32 table of round(exp(-i*DELTA)*255); LUT[255] forced to 0."""
    i = np.arange(LUT_SIZE, dtype=np.float64)
    vals = np.round(np.exp(-i * LUT_DELTA) * 255.0).astype(np.int32)
    vals[-1] = 0
    return vals


def quant_softmax(x_int: torch.Tensor, M_idx, shift_idx, lut: torch.Tensor,
                  mask=None, axis: int = -1) -> torch.Tensor:
    """Integer softmax over ``axis``: int32 codes -> int8 Q0.7 probabilities.

    ``mask``: optional bool, True = attend, False = masked out.
    """
    x_int = x_int.to(torch.int32)
    if mask is not None:
        x_int = torch.where(mask, x_int, x_int - MASK_OFFSET)
    m = torch.amax(x_int, dim=axis, keepdim=True)
    d = m - x_int
    idx = torch.clamp(fxp.rescale(d, M_idx, shift_idx, out_bits=9), 0, LUT_SIZE - 1)
    num = lut.to(torch.int32)[idx.long()]
    den = torch.clamp(torch.sum(num, dim=axis, keepdim=True, dtype=torch.int32), min=1)
    p = torch.div(num * 128 + torch.div(den, 2, rounding_mode="floor"), den,
                  rounding_mode="floor")
    return torch.clamp(p, 0, 127).to(torch.int8)
