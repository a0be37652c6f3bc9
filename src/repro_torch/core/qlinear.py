"""Folded-integer form of a quantized linear layer (paper Eq. 4/5).

``w_packed``: uint8 (K//2, N) K-planar nibble-packed int4 codes (rows
[0, K/2) in the low nibbles, [K/2, K) in the high nibbles) — the layout
the int4 matmul kernel streams.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FoldedLinear(NamedTuple):
    w_packed: torch.Tensor
    bias_i: torch.Tensor   # int32 (N,)
    M: torch.Tensor        # int32 requant multiplier
    shift: torch.Tensor    # int32 requant shift
    w_bits: int
