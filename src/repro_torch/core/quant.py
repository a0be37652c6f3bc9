"""Symmetric linear quantization — the FQ-BERT scheme (paper Eq. 1-3).

    x_c = clamp(x, -MAX, MAX);  s = (2^(k-1) - 1) / MAX
    x_I = round(x_c * s);       x_q = x_I / s

Weights use MAX = max|W|; activations an EMA of max|A|.  The port only
calibrates (no training yet), so ``fake_quant`` is the forward of the
reference's straight-through estimator; rounding is half-to-even as in
``jnp.round``.
"""
from __future__ import annotations

import numpy as np
import torch


def qmax(bits: int) -> int:
    """Largest positive code of a symmetric k-bit quantizer: 2^(k-1) - 1."""
    return (1 << (bits - 1)) - 1


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


def fake_quant(x: torch.Tensor, max_abs, bits: int) -> torch.Tensor:
    """dequantize(quantize(x)) in ``x``'s dtype (the QAT forward)."""
    max_abs = torch.clamp(torch.as_tensor(max_abs, dtype=x.dtype, device=x.device),
                          min=1e-8)
    s = rdiv(qmax(bits), max_abs)
    x_c = torch.clamp(x, -max_abs, max_abs)
    return torch.round(x_c * s) / s


def per_tensor_max(x: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(x))


def per_channel_max(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Beyond-paper option: per-output-channel MAX (paper is per-tensor)."""
    axis = axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != axis)
    return torch.amax(torch.abs(x), dim=dims, keepdim=True)
