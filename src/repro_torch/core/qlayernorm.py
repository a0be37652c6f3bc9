"""Fully-quantized LayerNorm / RMSNorm — paper §III-B "LN Core".

Stage 1: int32 row sum -> rounded mean (LN only); stage 2: centred sum of
squares -> variance; stage 3: integer Newton rsqrt (mantissa/exponent),
gamma multiply, aligned beta add, fixed-point requantize.  Strictly int32,
bit-for-bit the reference ``core/qlayernorm.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fixedpoint as fxp

FRAC = fxp.RSQRT_FRAC  # Q14 normalized-value domain


@dataclasses.dataclass(frozen=True)
class QLNParams:
    """Folded integer parameters of one quantized LayerNorm."""

    gamma_i: torch.Tensor       # int8 codes, scale s_g
    beta_aligned: torch.Tensor  # int32, pre-aligned into the n*gamma accumulator
    M_out: torch.Tensor         # Q15 fixed-point output multiplier
    shift_out: torch.Tensor
    subtract_mean: bool = True


def _rounded_div(a: torch.Tensor, n: int) -> torch.Tensor:
    """Round-half-away integer divide; ``//`` only ever sees operands >= 0."""
    half = n // 2
    pos = torch.div(a + half, n, rounding_mode="floor")
    neg = -torch.div(-a + half, n, rounding_mode="floor")
    return torch.where(a >= 0, pos, neg)


def quant_layernorm(x_int: torch.Tensor, p: QLNParams, eps_codes: int = 1) -> torch.Tensor:
    """Integer LN over the last axis: int8 (..., N) -> int8 (..., N)."""
    xi = x_int.to(torch.int32)
    n = xi.shape[-1]
    assert n <= 16384, "int32 sum-of-squares budget exceeded"
    if p.subtract_mean:
        s = torch.sum(xi, dim=-1, keepdim=True, dtype=torch.int32)
        c = xi - _rounded_div(s, n)
    else:
        c = xi
    ss = torch.sum(c * c, dim=-1, keepdim=True, dtype=torch.int32)
    var = torch.clamp(_rounded_div(ss, n), min=eps_codes)
    y_m, s_e = fxp.rsqrt_mantexp(var)
    n_q = fxp._rshift_round(c * y_m, s_e + 1)   # Q14 of (x-mu)/sigma
    acc = n_q * p.gamma_i.to(torch.int32) + p.beta_aligned.to(torch.int32)
    y = fxp.rescale(acc, p.M_out, p.shift_out)
    return torch.clamp(y, -127, 127).to(torch.int8)
