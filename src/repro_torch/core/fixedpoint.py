"""32-bit fixed-point requantization — paper Eq. 5, int32-only arithmetic.

Bit-for-bit mirror of the reference ``core/fixedpoint.py``:

    s_f ~= M * 2^(-shift),  M a Q15 mantissa in [2^14, 2^15),  shift >= 0
    rescale(acc) = ((clamp(acc >>r pre) * M) + rnd) >> (shift - pre)

with ``pre = max(0, shift + out_bits - 30)`` and ``>>r`` the rounding
arithmetic right shift (half away from zero).  Everything is int32 with
two's-complement wrap, as on the TPU; the CUDA kernels (``csrc/common.cuh``)
carry the same functions in device code.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MANT_BITS = 15  # Q15 mantissa
RSQRT_FRAC = 14


def quantize_multiplier(s_f: float) -> Tuple[int, int]:
    """Real multiplier -> (M, shift): s_f ~= M * 2^-shift, M in [2^14, 2^15)."""
    if s_f <= 0:
        return 0, 0
    m, e = np.frexp(np.float64(s_f))  # s_f = m * 2^e, m in [0.5, 1)
    M = int(np.round(m * (1 << MANT_BITS)))
    if M == (1 << MANT_BITS):
        M //= 2
        e += 1
    shift = MANT_BITS - int(e)
    if shift < 0:  # s_f >= 2^15-ish: fold into M (never hits for requant scales)
        M = min(M << (-shift), (1 << 31) - 1)
        shift = 0
    return M, shift


# The reference traces ``jnp.log2`` / ``jnp.exp2``, which XLA lowers to
# float32 ``log(x) * (1 / ln 2)`` and ``exp(ln 2 * x)``: near powers of two
# and at several integer exponents those differ from the exact torch.log2 /
# torch.exp2.  The folded constants depend on them, so the port reproduces
# the lowering (the float32 ``exp`` rounded from float64, which equals XLA's
# over the normal range) to fold the same integers.
_LN2_F32 = float(np.float32(np.log(2.0)))
_INV_LN2_F32 = float(np.float32(1.0) / np.float32(np.log(2.0)))


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.to(torch.float32)) * _INV_LN2_F32


def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    t = x.to(torch.float32) * _LN2_F32
    return torch.exp(t.to(torch.float64)).to(torch.float32)


def quantize_multiplier_array(s_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor version (float32 arithmetic, as the reference's traced one)."""
    s_f = torch.clamp(s_f.to(torch.float32), min=1e-30)
    e = torch.floor(log2_f32(s_f)) + 1.0  # s_f = m * 2^e, m in [0.5, 1)
    m = s_f * exp2_f32(-e)
    M = torch.round(m * (1 << MANT_BITS))
    renorm = M >= (1 << MANT_BITS)
    M = torch.where(renorm, M / 2, M)
    e = torch.where(renorm, e + 1, e)
    shift = MANT_BITS - e
    neg = shift < 0
    M = torch.where(neg, torch.clamp(M * exp2_f32(torch.where(neg, -shift, 0.0)),
                                     max=2.0**31 - 1), M)
    shift = torch.clamp(shift, min=0.0)
    return M.to(torch.int32), shift.to(torch.int32)


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=like.device)


def _rshift_round(x: torch.Tensor, n) -> torch.Tensor:
    """Rounding arithmetic right shift (round half away from zero), n >= 0."""
    n = _i32(n, x)
    bias = torch.where(n > 0, torch.ones_like(n) << torch.clamp(n - 1, min=0),
                       torch.zeros_like(n))
    pos = (x + bias) >> n
    neg = -((-x + bias) >> n)
    return torch.where(x >= 0, pos, neg)


def rescale(acc: torch.Tensor, M, shift, out_bits: int = 8) -> torch.Tensor:
    """round(acc * M * 2^-shift) in pure int32, exact up to output saturation."""
    acc = acc.to(torch.int32)
    M = _i32(M, acc)
    shift = _i32(shift, acc)
    pre = torch.clamp(shift + (out_bits - 30), min=0)
    v = _rshift_round(acc, pre)
    lim = (1 << MANT_BITS) - 1
    v = torch.clamp(v, -lim - 1, lim)
    t = v * M  # |v| <= 2^15, M < 2^15  ->  |t| <= 2^30, no overflow
    return _rshift_round(t, shift - pre)


def requantize(acc: torch.Tensor, M, shift, bits: int = 8) -> torch.Tensor:
    """int32 accumulator -> k-bit code (int8 storage), clamped symmetric."""
    y = rescale(acc, M, shift, out_bits=bits)
    lim = (1 << (bits - 1)) - 1
    return torch.clamp(y, -lim, lim).to(torch.int8)


def rsqrt_mantexp(x: torch.Tensor, iters: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-normalized integer rsqrt: 1/sqrt(x) = (y / 2^15) * 2^-s.

    The exponent comes from float32 ``log2`` exactly as in the reference;
    the CUDA LN kernel takes it from ``31 - clz(x)`` instead, which the
    tests prove identical over the LN variance range [1, 2^16).
    """
    x = torch.clamp(x.to(torch.int32), min=1)
    e = torch.floor(torch.log2(x.to(torch.float32) * (1.0 + 1e-7))).to(torch.int32)
    s = e >> 1
    sh = 14 - 2 * s
    m14 = torch.where(sh >= 0, x << torch.clamp(sh, min=0), x >> torch.clamp(-sh, min=0))
    y = torch.where(m14 < (1 << 15), torch.full_like(x, 27853), torch.full_like(x, 19661))
    three = 3 << 14
    for _ in range(iters):
        y2 = (y * y) >> 15
        t = (m14 * y2) >> 15
        y = (y * (three - t)) >> 15
    return y, s
