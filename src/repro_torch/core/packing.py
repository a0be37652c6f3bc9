"""int4 nibble packing — the storage format the kernels stream from memory.

Nibble-planar layout (the paper's Type-A BIM rearrangement): along the
packed axis, the first half of the codes sits in the LOW nibbles and the
second half in the HIGH nibbles, so unpacking yields two contiguous int8
planes with no interleave.  For weights the packed axis is K:
``w_packed[r]`` holds row ``r`` (low) and row ``r + K/2`` (high).
"""
from __future__ import annotations

import torch


def _sign_extend_nibble(u4: torch.Tensor) -> torch.Tensor:
    """uint8 holding a nibble in [0,15] -> signed int8 in [-8,7]: (x ^ 8) - 8."""
    x = u4.to(torch.int8)
    return (x ^ 8) - 8


def pack_int4_planar(codes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """First half of ``axis`` -> low nibbles, second half -> high nibbles."""
    axis = axis % codes.ndim
    assert codes.shape[axis] % 2 == 0
    first, second = torch.chunk(codes, 2, dim=axis)
    lo_u = first.to(torch.uint8) & 0xF
    hi_u = (second.to(torch.uint8) & 0xF) << 4
    return lo_u | hi_u


def unpack_int4_planar(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of ``pack_int4_planar``: concatenates the two nibble planes."""
    lo = _sign_extend_nibble(packed & 0xF)
    hi = _sign_extend_nibble((packed >> 4) & 0xF)
    return torch.cat([lo, hi], dim=axis % packed.ndim)
