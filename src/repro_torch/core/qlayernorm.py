"""Fully-quantized LayerNorm / RMSNorm — paper §III-B "LN Core".

Stage 1: int32 row sum -> rounded mean (LN only); stage 2: centred sum of
squares -> variance; stage 3: integer Newton rsqrt (mantissa/exponent),
gamma multiply, aligned beta add, fixed-point requantize.  Strictly int32,
bit-for-bit the reference ``core/qlayernorm.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import quant as q

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


def fold_layernorm(gamma, beta, s_y: float, subtract_mean: bool = True) -> QLNParams:
    """Quantize gamma/beta (numpy or tensor leaves) to 8 bits and fold every
    scale into integer constants (CPU tensors), in float64 as the reference
    folds them:
    beta is quantized on its own 8-bit grid, then re-aligned into the
    accumulator domain (a constant add)."""
    gamma = np.asarray(gamma, np.float64)
    s_g = float(q.qmax(8)) / max(float(np.max(np.abs(gamma))), 1e-8)
    gamma_i = np.clip(np.round(gamma * s_g), -127, 127).astype(np.int8)
    acc_scale = float(1 << FRAC) * s_g  # accumulator codes per real unit
    if beta is not None:
        beta = np.asarray(beta, np.float64)
        s_b = float(q.qmax(8)) / max(float(np.max(np.abs(beta))), 1e-8)
        beta_i = np.clip(np.round(beta * s_b), -127, 127)
        beta_aligned = np.round(beta_i / s_b * acc_scale).astype(np.int64)
        beta_aligned = np.clip(beta_aligned, -(2**30), 2**30).astype(np.int32)
    else:
        beta_aligned = np.zeros_like(gamma_i, dtype=np.int32)
    M, sh = fxp.quantize_multiplier(s_y / acc_scale)
    return QLNParams(gamma_i=torch.from_numpy(gamma_i),
                     beta_aligned=torch.from_numpy(beta_aligned),
                     M_out=torch.tensor(M, dtype=torch.int32),
                     shift_out=torch.tensor(sh, dtype=torch.int32), subtract_mean=subtract_mean)
