"""Symmetric linear quantization — the FQ-BERT scheme (paper Eq. 1-3).

    x_c = clamp(x, -MAX, MAX);  s = (2^(k-1) - 1) / MAX
    x_I = round(x_c * s);       x_q = x_I / s

Weights use MAX = max|W| (Eq. 2); activations an EMA of max|A| collected
during training (Eq. 3).  ``fake_quant`` serves calibration and QAT alike:
its round is a straight-through estimator (``ste_round``), half-to-even as
``jnp.round``, and its clip passes the reference's gradient (half at a
bound, see ``fake_quant``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def qmax(bits: int) -> int:
    """Largest positive code of a symmetric k-bit quantizer: 2^(k-1) - 1."""
    return (1 << (bits - 1)) - 1


def storage_dtype(bits: int) -> torch.dtype:
    """Storage dtype for k-bit codes (4-bit rides sign-extended in int8;
    nibble packing lives in packing.py)."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


def compute_scale(max_abs: torch.Tensor, bits: int) -> torch.Tensor:
    """Paper Eq. 2/3: s = (2^(k-1)-1) / MAX.  REAL * s -> code."""
    return rdiv(qmax(bits), torch.clamp(torch.as_tensor(max_abs), min=1e-8))


def quantize(x: torch.Tensor, scale, bits: int) -> torch.Tensor:
    """x -> integer codes (round half to even, clamped to the symmetric range)."""
    q = torch.clamp(torch.round(x * scale), -qmax(bits), qmax(bits))
    return q.to(storage_dtype(bits))


def dequantize(x_int: torch.Tensor, scale) -> torch.Tensor:
    return x_int.to(torch.float32) / scale


def rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` rounded once.  torch computes ``a / t`` for a Python scalar
    ``a`` as ``a * reciprocal(t)``, which rounds twice and lands an ulp away
    from the reference's division on about a quarter of inputs."""
    return torch.div(torch.full_like(t, a), t)


def recip_f32(c: float) -> float:
    """The float32 reciprocal by which XLA replaces a division by the
    constant ``c`` (its algebraic simplifier rewrites ``x / c`` as
    ``x * (1 / c)``, so the reference rounds twice where torch rounds once).
    Wherever the reference divides by a constant inside a jitted graph, the
    port multiplies by this."""
    return float(np.float32(1.0) / np.float32(c))


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.round(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """``torch.round`` (half to even) whose gradient is the identity: the
    straight-through estimator of the reference's ``_ste_round``."""
    return _SteRound.apply(x)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``'s gradient: an element equal to a bound gets half of it
    (``torch.maximum`` / ``torch.minimum`` split ties as ``lax.max`` /
    ``lax.min`` do), where ``torch.clamp`` passes all of it."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def fake_quant(x: torch.Tensor, max_abs, bits: int) -> torch.Tensor:
    """dequantize(quantize(x)) in ``x``'s dtype, with a straight-through
    round.  Values outside [-MAX, MAX] get no gradient; a value on a bound
    gets half of it, as through the reference's ``jnp.clip``: a weight's
    largest element always sits on its own MAX, and a norm gamma of ones
    sits there whole.  ``max_abs`` carries no gradient (every caller passes
    a detached statistic, the reference's ``stop_gradient``)."""
    max_abs = torch.clamp(torch.as_tensor(max_abs, dtype=x.dtype, device=x.device),
                          min=1e-8)
    s = rdiv(qmax(bits), max_abs)
    return ste_round(clip(x, -max_abs, max_abs) * s) / s


def per_tensor_max(x: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(x))


def per_channel_max(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Beyond-paper option: per-output-channel MAX (paper is per-tensor)."""
    axis = axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != axis)
    return torch.amax(torch.abs(x), dim=dims, keepdim=True)


@dataclasses.dataclass(frozen=True)
class EMACalibrator:
    """Paper Eq. 3: exponential moving average of max|A| for the activation
    scales.  Functional: the caller threads the state."""

    decay: float = 0.99

    def init(self, shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def update(self, ema: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The max of ``|x|`` over all of ``x`` (a stacked (n_reps,) leaf of
        observations gives one maximum for every rep, as in the reference);
        the first observation (ema == 0) is adopted as it is."""
        batch_max = per_tensor_max(x).to(torch.float32)
        new = self.decay * ema + (1.0 - self.decay) * batch_max
        return torch.where(ema == 0.0, batch_max, new)


def quantize_bias(bias: torch.Tensor, s_a, s_w) -> torch.Tensor:
    """Paper Eq. 4: bias_I = round(bias * s_a * s_w) -> int32."""
    return torch.round(bias * (s_a * s_w)).to(torch.int32)


def ema_tree_update(ema_tree, obs_tree, decay: float = 0.99):
    """``EMACalibrator.update`` over matching trees of nested dicts."""
    if isinstance(ema_tree, dict):
        return {k: ema_tree_update(ema_tree[k], obs_tree[k], decay) for k in ema_tree}
    return EMACalibrator(decay).update(ema_tree, obs_tree)
