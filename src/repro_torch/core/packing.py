"""int4 nibble packing — the storage format the kernels stream from memory.

``pack_int4``: the adjacent-pair layout, codes (..., 2i) and (..., 2i+1) in
one byte (low nibble, high nibble).  Nibble-planar layout (the paper's Type-A BIM rearrangement): along the
packed axis, the first half of the codes sits in the LOW nibbles and the
second half in the HIGH nibbles, so unpacking yields two contiguous int8
planes with no interleave.  For weights the packed axis is K:
``w_packed[r]`` holds row ``r`` (low) and row ``r + K/2`` (high).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.boundary import kernel_boundary
from repro_torch.core.quant import recip_f32


def _sign_extend_nibble(u4: torch.Tensor) -> torch.Tensor:
    """uint8 holding a nibble in [0,15] -> signed int8 in [-8,7]: (x ^ 8) - 8."""
    x = u4.to(torch.int8)
    return (x ^ 8) - 8


def pack_int4(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Signed int4 codes (int8 storage, range [-8, 7]) two per uint8 along
    ``axis`` (even length; the packed axis has half of it): low nibble =
    even index, high nibble = odd index."""
    axis = axis % codes.ndim
    assert codes.shape[axis] % 2 == 0, "pack axis must be even-sized"
    c = codes.movedim(axis, -1)
    lo_u = c[..., 0::2].to(torch.uint8) & 0xF
    hi_u = (c[..., 1::2].to(torch.uint8) & 0xF) << 4
    return (lo_u | hi_u).movedim(-1, axis)


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of ``pack_int4``: uint8 -> sign-extended int8 codes, the axis
    doubled."""
    axis = axis % packed.ndim
    lo = _sign_extend_nibble(packed & 0xF)
    hi = _sign_extend_nibble((packed >> 4) & 0xF)
    stacked = torch.stack([lo, hi], dim=axis + 1)  # (..., n, 2, ...)
    shape = list(packed.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def packed_nbytes(shape, axis: int = -1) -> int:
    """Bytes of the packed representation of an int4 tensor of ``shape``."""
    n = 1
    for i, d in enumerate(shape):
        n *= d // 2 if i == axis % len(shape) else d
    return n


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


# --- int4-packed KV pages (one shared fp32 scale per page) ---------------------
#
# At ``kv_bits=4`` every pool page is re-quantized to signed 4-bit codes under
# ONE fp32 scale and nibble-packed planar along the head dim.  The write path
# (models/serve_int.py), the fused-dequant CUDA kernels and the plain versions
# (kernels/ref.py) all share these formulas.

KV4_QMAX = 7  # codes in [-7, 7] at the scale; +-8 stays unused by it


def kv_page_scale(codes_i8: torch.Tensor, dims) -> torch.Tensor:
    """``max(amax|codes|, 1) / 7`` over the page axes ``dims``, fp32.  The
    reference runs this jitted, where XLA turns the division by the constant
    7 into a multiply by float32(1/7); that differs from a true division for
    69 of the 127 values amax can take, so the port multiplies too."""
    amax = codes_i8.to(torch.int32).abs().amax(dim=dims)
    return torch.clamp(amax, min=1).to(torch.float32) * recip_f32(KV4_QMAX)


def quantize_kv_page(codes_i8: torch.Tensor, scale, axis: int = -1) -> torch.Tensor:
    """int8 KV codes -> planar nibble-packed uint8: ``clip(round(c8 / scale),
    -8, 7)`` packed along ``axis`` (a true division, as in the reference)."""
    c4 = torch.clamp(torch.round(codes_i8.to(torch.float32) / scale), -8, 7)
    return pack_int4_planar(c4.to(torch.int8), axis=axis)


def dequant_int4_codes(c4_i8: torch.Tensor, scale) -> torch.Tensor:
    """int4 codes -> int8 codes: ``clip(round(c4 * scale), -127, 127)``, the
    dequant the CUDA kernels fuse into their page load."""
    y = torch.round(c4_i8.to(torch.float32) * scale)
    return torch.clamp(y, -127, 127).to(torch.int8)


def dequantize_kv_page(packed_u8: torch.Tensor, scale, axis: int = -1) -> torch.Tensor:
    """Inverse of ``quantize_kv_page`` (lossy at 4 bits): unpack + dequant."""
    return dequant_int4_codes(unpack_int4_planar(packed_u8, axis=axis), scale)


@kernel_boundary(why="whole-pool int4 dequant of the plain versions; the CUDA kernels "
                     "dequantize page by page in shared memory")
def dequantize_kv_pool(packed_pool_u8: torch.Tensor, page_scales: torch.Tensor) -> torch.Tensor:
    """Whole-pool dequant: (n_pages, P, Hkv, hd/2) uint8 + (n_pages,) fp32 ->
    (n_pages, P, Hkv, hd) int8, for the plain versions only (the kernels
    dequantize page by page in shared memory)."""
    c4 = unpack_int4_planar(packed_pool_u8, axis=-1)
    return dequant_int4_codes(c4, page_scales[:, None, None, None])
