"""JAX's default PRNG in numpy, bit for bit: threefry2x32 keys, ``split``,
uniform bits, Gumbel noise and ``categorical`` draws.

The reference's ``LockstepEngine`` samples with ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``, JAX 0.9's default).  The port keeps a
key as a ``uint32`` pair and draws the same numbers on the host:

* ``threefry2x32(key, x1, x2)``: 20 rounds, rotations (13, 15, 26, 6) and
  (17, 29, 16, 24), key schedule ``k1, k2, k1 ^ k2 ^ 0x1BD11BDA`` with the
  round counter added after every fourth round;
* ``key(seed)``: ``[seed >> 32, seed & 0xffffffff]`` (a 32-bit seed has a
  zero high word);
* counters are the 64-bit flat index split into (high, low) words, and 32
  random bits are the two output words XORed (``split`` keeps both words);
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, scaled into [minval, maxval) and clipped below at minval;
* ``gumbel``: ``-log(-log(u))`` with u uniform in [tiny, 1), in float32.

The logarithm is XLA's on the CPU, not the C library's: XLA evaluates the
Cephes polynomial with fused multiply-adds, which differs from a correctly
rounded ``log`` in the last bit for about one input in six.  ``log_f32``
reproduces it (checked against every float32 input the Gumbel draw can
produce, ``tests/test_torch_prng.py``).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
U32 = np.uint32
TINY = np.finfo(F32).tiny
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = U32(0x1BD11BDA)
_MASK32 = 0xFFFFFFFF


_BLOCK = 1 << 15     # counters per pass of the rounds: 3 x 128 KB stay in cache


def threefry2x32(key, x1, x2):
    """The Threefry-2x32 block function of ``key`` (two uint32 words) on the
    counter pairs (x1, x2), elementwise; returns the two output words."""
    k1, k2 = U32(key[0]), U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    out0, out1 = np.array(x1, U32), np.array(x2, U32)
    out0 += ks[0]
    out1 += ks[1]
    flat0, flat1 = out0.reshape(-1), out1.reshape(-1)
    hi = np.empty(min(flat0.size, _BLOCK), U32)
    for s in range(0, flat0.size, _BLOCK):
        x0, x1, h = flat0[s:s + _BLOCK], flat1[s:s + _BLOCK], hi[:flat0.size - s]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:       # in place: x0 += x1; x1 = rotl(x1, r) ^ x0
                x0 += x1
                np.left_shift(x1, U32(r), out=h)
                x1 >>= U32(32 - r)
                x1 |= h
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += U32((int(ks[(i + 2) % 3]) + i + 1) & _MASK32)
    return out0, out1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a uint32 (2,) array."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _MASK32
    return np.array([hi, seed & _MASK32], U32)


def _counters(shape):
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(U32), (idx & np.uint64(_MASK32)).astype(U32)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) uint32 keys."""
    b1, b2 = threefry2x32(k, *_counters((num,)))
    return np.stack([b1, b2], axis=-1)


def random_bits(k, shape) -> np.ndarray:
    """32 random bits per element, uint32 of ``shape``."""
    b1, b2 = threefry2x32(k, *_counters(shape))
    return (b1 ^ b2).reshape(shape)


def uniform(k, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 in [minval, maxval), ``jax.random.uniform``'s recipe."""
    lo, hi = F32(minval), F32(maxval)
    bits = (random_bits(k, shape) >> U32(32 - 23)) | F32(1.0).view(U32)
    floats = bits.view(F32) - F32(1.0)
    scale = hi - lo                           # XLA fuses floats * scale + lo
    # a product by 1 is exact, so the fused sum is a plain one (the Gumbel's)
    return np.maximum(lo, floats + lo if scale == 1 else fma(floats, scale, lo))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once: the product is exact in float64, the
    sum is kept as an exact float64 pair, and a float64 sum that lands on a
    float32 midpoint only by its own rounding is moved off it."""
    a, b, c = (np.asarray(v, F32) for v in (a, b, c))
    s, t = _two_sum(a.astype(np.float64) * b.astype(np.float64), c.astype(np.float64))
    r = s.astype(F32)
    d = s - r.astype(np.float64)
    away = np.nextafter(r, np.where(d > 0, F32(np.inf), F32(-np.inf)))
    tie = (d != 0) & (s == (r.astype(np.float64) + away.astype(np.float64)) / 2)
    return np.where(tie & (t * d > 0), away, r).astype(F32)


_LOG_P = tuple(F32(p) for p in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                                -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                                2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1 = F32(-2.12194440e-4)
_LOG_Q2 = F32(0.693359375)
_SQRTHF = F32(0.707106781186547524)


def log_f32(x) -> np.ndarray:
    """float32 natural log as XLA computes it on the CPU: the mantissa m in
    [sqrt(1/2), sqrt(2)) and exponent e, log(1 + (m - 1)) by the Cephes
    degree-8 polynomial in three fused multiply-add chains, then
    ``x - x^2/2 + y + e * q2`` with ``y = p(x) * x^3 + e * q1``."""
    x = np.asarray(x, F32)
    xc = np.maximum(x, TINY)
    bits = xc.view(U32)
    e = F32(1.0) + ((bits >> U32(23)).astype(np.int32) - 0x7F).astype(F32)
    m = ((bits & U32(~0x7F800000 & _MASK32)) | F32(0.5).view(U32)).view(F32)
    low = m < _SQRTHF
    m = (m - F32(1.0)) + np.where(low, m, F32(0.0))
    e = e - np.where(low, F32(1.0), F32(0.0))
    p = _LOG_P
    m2 = m * m
    m3 = m2 * m
    y = fma(fma(m, p[0], p[1]), m, p[2])
    y1 = fma(fma(m, p[3], p[4]), m, p[5])
    y2 = fma(fma(m, p[6], p[7]), m, p[8])
    y = fma(fma(y, m3, y1), m3, y2)
    y = fma(y, m3, _LOG_Q1 * e)
    out = fma(_LOG_Q2, e, (m - F32(0.5) * m2) + y)
    out = np.where(x == 0, F32(-np.inf), out)
    out = np.where(x == np.inf, F32(np.inf), out)
    return np.where(np.isnan(x) | (x < 0), F32(np.nan), out).astype(F32)


def gumbel(k, shape) -> np.ndarray:
    """float32 Gumbel noise, ``jax.random.gumbel`` in its default ("low")
    mode."""
    u = uniform(k, shape, TINY, 1.0)
    return -log_f32(-log_f32(u))


# A float32 Gumbel value from numpy's log is within a few ulps of XLA's;
# ``categorical`` recomputes exactly every score this far below the row max.
_NEAR = F32(1e-4)


def categorical(k, logits, axis: int = -1) -> np.ndarray:
    """``jax.random.categorical(k, logits, axis)``: argmax of float32 logits
    plus Gumbel noise (the first index among equal maxima).

    The scores are first taken with numpy's float32 log; only those within
    ``_NEAR`` (relative) of their row's maximum, which hold the true
    argmax, go through ``log_f32``, so a draw over a 64,000-entry
    vocabulary costs one threefry pass and two vectorised logs."""
    logits = np.moveaxis(np.asarray(logits, F32), axis, -1)
    u = np.moveaxis(uniform(k, np.moveaxis(logits, -1, axis).shape, TINY, 1.0), axis, -1)
    shape = logits.shape[:-1]
    logits, u = logits.reshape(-1, logits.shape[-1]), u.reshape(-1, u.shape[-1])
    approx = -np.log(-np.log(u)) + logits
    top = approx.max(-1, keepdims=True)
    if not np.isfinite(top).all():
        return np.argmax(-log_f32(-log_f32(u)) + logits, -1).reshape(shape)
    rows, cols = np.nonzero(approx >= top - _NEAR * (F32(1.0) + np.abs(top)))
    exact = np.full(approx.shape, -np.inf, F32)
    exact[rows, cols] = -log_f32(-log_f32(u[rows, cols])) + logits[rows, cols]
    return np.argmax(exact, -1).reshape(shape)
