"""Decode attention: the CUDA kernels ``csrc/paged_decode_attention.cu``
(int8 pool), ``csrc/paged_decode_attention_q4.cu`` (int4-packed pool) and
``csrc/decode_attention.cu`` (contiguous stripe), and their wrappers.

Replace the TPU kernels ``paged_decode_qattention``,
``paged_decode_qattention_q4`` and ``decode_qattention`` of
``repro/kernels/decode_attention.py``.  On a CUDA tensor a wrapper
launches its kernel (or raises); on a CPU tensor it computes the plain
version in ``kernels/ref.py``.  All three kernels split each slot's keys
across the SMs in three passes (``csrc/paged_decode.cuh``,
``csrc/stripe_decode.cuh``): scores and maxima, then numerators, den and
P.V on the int8 tensor cores, then the fp32 carry in order, per page for
the pools and per block of ``bkv`` keys for the stripe, exactly as the
plain versions carry it.  The wrappers' ``launches`` count calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.boundary import kernel_launch
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    decode_qattention_ref,
    paged_decode_qattention_q4_ref,
    paged_decode_qattention_ref,
)

SOURCE = "src/repro_torch/csrc/paged_decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:214"
Q4_SOURCE = "src/repro_torch/csrc/paged_decode_attention_q4.cu"
Q4_REPLACES = "src/repro/kernels/decode_attention.py:296"
STRIPE_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
STRIPE_REPLACES = "src/repro/kernels/decode_attention.py:148"

# The paged kernels split each slot's chain into spans of SPAN pages, one
# block each (csrc/paged_decode.cuh kSpan), and make three launches per
# call.
SPAN = 8
# The stripe kernels (csrc/stripe_decode.cuh) cut each bkv block into
# sub-tiles of STRIPE_ROWS rows, one warp each, up to STRIPE_WARPS of them a
# span (one CTA), and also make three launches per call.
STRIPE_ROWS = 16
STRIPE_WARPS = 8


def _i32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _check_device(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def _aligned(name: str, *ts):
    ts = [t.contiguous() for t in ts]
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: K/V must be 16-byte aligned")
    return ts


def _q16(q: torch.Tensor) -> torch.Tensor:
    """q contiguous at a 16-byte aligned address (a copy only if it is not)."""
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when a kernel can read it in place (D contiguous, every
    stride and the base a multiple of 16 bytes, strides below 2^31), else a
    fresh contiguous copy."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
        and all(s % 16 == 0 and s < 2**31 for s in t.stride()[:-1])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _stripe_call(name: str, q_i8, k, v, lengths, lut_q7, scalars, b, hkv, g, d, smax, bkv,
                 strides, lead=()):
    """Launch the stripe decode library ``name``: its C entry takes the
    pointers, the workspace, then ``lead`` (the batch, where it has one), the
    shape and the K/V ``strides``; returns the output."""
    dev = q_i8.device
    q = _q16(q_i8)
    lut = _i32(lut_q7, dev)
    scal = _build.attn_scalars(dev, *scalars)
    out = torch.empty_like(q)
    size = _build.load(name).stripe_decode_ws
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    ws = torch.empty(int(size(b, hkv, g, smax, bkv)), dtype=torch.int32, device=dev)
    ints = (*lead, hkv, g, d, smax, bkv, *strides)
    rc = _build.bind(name, name, 11, len(ints))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), lut.data_ptr(),
        *(t.data_ptr() for t in scal), out.data_ptr(), ws.data_ptr(), *ints,
        _build.stream_of(dev))
    _build.check_launch(rc, name)
    return out


def _same_strides(k: torch.Tensor, v: torch.Tensor):
    """K and V as the stripe kernels read them: in place where both can be,
    through one set of strides."""
    k, v = _strided(k), _strided(v)
    return (k, v) if k.stride() == v.stride() else (k.contiguous(), v.contiguous())


def _workspace(name: str, b, hkv, g, psize, nb, dev) -> torch.Tensor:
    """The split kernels' int32 workspace (page maxima, scores, carry
    factors and den sums, P.V partials), from the caching allocator; its
    size comes from the kernel library."""
    fn = _build.load(name).paged_decode_ws
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return torch.empty(int(fn(b, hkv, g, psize, nb)), dtype=torch.int32, device=dev)


@kernel_launch
def paged_decode_qattention(q_i8, k_pool, v_pool, block_tables, lengths, M_idx,
                            shift_idx, lut_q7, inv_s_logit, out_scale):
    """q int8 (B, Hkv, G, D) x pools int8 (n_pages, P, Hkv, D) through the
    block table, masked to ``lengths`` -> int8 (B, Hkv, G, D)."""
    if q_i8.device.type == "cpu":
        return paged_decode_qattention_ref(q_i8, k_pool, v_pool, block_tables, lengths,
                                           M_idx, shift_idx, lut_q7, inv_s_logit,
                                           out_scale)
    _check_device("paged_decode_qattention", q_i8)
    b, hkv, g, d = q_i8.shape
    _, psize, hkv_p, d_p = k_pool.shape
    nb = block_tables.shape[1]
    if q_i8.dtype != torch.int8 or k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError("paged_decode_qattention wants int8 q and pools")
    if (hkv_p, d_p) != (hkv, d) or v_pool.shape != k_pool.shape \
            or g > 16 or d > 128 or d % 16 or psize > 64:
        raise ValueError(f"paged_decode_qattention: unsupported shapes q {tuple(q_i8.shape)},"
                         f" pool {tuple(k_pool.shape)} (needs G <= 16, D <= 128, "
                         f"D % 16 == 0, P <= 64)")
    dev = q_i8.device
    q = _q16(q_i8)
    kp, vp = _aligned("paged_decode_qattention", k_pool, v_pool)
    btab = _i32(block_tables, dev)
    lens = _i32(lengths, dev)
    lut = _i32(lut_q7, dev)
    scal = _build.attn_scalars(dev, M_idx, shift_idx, inv_s_logit, out_scale)
    out = torch.empty_like(q)
    ws = _workspace("paged_decode_attention", b, hkv, g, psize, nb, dev)
    rc = _build.bind("paged_decode_attention", "paged_decode_attention", 12, 6)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), btab.data_ptr(), lens.data_ptr(),
        lut.data_ptr(), *(t.data_ptr() for t in scal), out.data_ptr(), ws.data_ptr(),
        b, hkv, g, d, psize, nb, _build.stream_of(dev))
    _build.check_launch(rc, "paged_decode_qattention")
    paged_decode_qattention.launches += 1
    return out


paged_decode_qattention.launches = 0


@kernel_launch
def paged_decode_qattention_q4(q_i8, k_pool, v_pool, k_scale, v_scale, block_tables,
                               lengths, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale):
    """q int8 (B, Hkv, G, D) x int4-packed pools uint8 (n_pages, P, Hkv, D/2)
    with fp32 (n_pages,) page scales, through the block table, masked to
    ``lengths`` -> int8 (B, Hkv, G, D)."""
    if q_i8.device.type == "cpu":
        return paged_decode_qattention_q4_ref(q_i8, k_pool, v_pool, k_scale, v_scale,
                                              block_tables, lengths, M_idx, shift_idx,
                                              lut_q7, inv_s_logit, out_scale)
    _check_device("paged_decode_qattention_q4", q_i8)
    b, hkv, g, d = q_i8.shape
    n_pages, psize, hkv_p, dh = k_pool.shape
    nb = block_tables.shape[1]
    if q_i8.dtype != torch.int8 or k_pool.dtype != torch.uint8 \
            or v_pool.dtype != torch.uint8:
        raise TypeError("paged_decode_qattention_q4 wants int8 q and uint8 packed pools")
    if (hkv_p, 2 * dh) != (hkv, d) or v_pool.shape != k_pool.shape \
            or tuple(k_scale.shape) != (n_pages,) or tuple(v_scale.shape) != (n_pages,) \
            or g > 16 or d > 128 or d % 32 or psize > 64:
        raise ValueError(f"paged_decode_qattention_q4: unsupported shapes q "
                         f"{tuple(q_i8.shape)}, pool {tuple(k_pool.shape)}, scales "
                         f"{tuple(k_scale.shape)} (needs G <= 16, D <= 128, D % 32 == 0, "
                         f"P <= 64, one scale per page)")
    dev = q_i8.device
    q = _q16(q_i8)
    kp, vp = _aligned("paged_decode_qattention_q4", k_pool, v_pool)
    ks = k_scale.to(device=dev, dtype=torch.float32).contiguous()
    vs = v_scale.to(device=dev, dtype=torch.float32).contiguous()
    btab = _i32(block_tables, dev)
    lens = _i32(lengths, dev)
    lut = _i32(lut_q7, dev)
    scal = _build.attn_scalars(dev, M_idx, shift_idx, inv_s_logit, out_scale)
    out = torch.empty_like(q)
    ws = _workspace("paged_decode_attention_q4", b, hkv, g, psize, nb, dev)
    rc = _build.bind("paged_decode_attention_q4", "paged_decode_attention_q4", 14, 6)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        btab.data_ptr(), lens.data_ptr(), lut.data_ptr(), *(t.data_ptr() for t in scal),
        out.data_ptr(), ws.data_ptr(), b, hkv, g, d, psize, nb, _build.stream_of(dev))
    _build.check_launch(rc, "paged_decode_qattention_q4")
    paged_decode_qattention_q4.launches += 1
    return out


paged_decode_qattention_q4.launches = 0


def _launch_stripe(q_i8, k_cache, v_cache, lengths, M_idx, shift_idx, lut_q7, inv_s_logit,
                   out_scale, *, bkv: int):
    """The contiguous decode's kernel on checked CUDA operands; counts
    nothing (the tuner races through it)."""
    b, hkv, g, d = q_i8.shape
    kc, vc = _same_strides(k_cache, v_cache)
    return _stripe_call("decode_attention", q_i8, kc, vc, _i32(lengths, q_i8.device), lut_q7,
                        (M_idx, shift_idx, inv_s_logit, out_scale), b, hkv, g, d,
                        k_cache.shape[1], bkv, (kc.stride(0), kc.stride(2), kc.stride(1)),
                        lead=(b,))


@kernel_launch
def decode_qattention(q_i8, k_cache, v_cache, lengths, M_idx, shift_idx, lut_q7,
                      inv_s_logit, out_scale, *, bkv: int):
    """q int8 (B, Hkv, G, D) x the contiguous stripe int8 (B, Smax, Hkv, D),
    masked to ``lengths``, the carry updated once per block of ``bkv`` keys
    (``bkv`` divides Smax) -> int8 (B, Hkv, G, D).  On the card the stripe
    is read in place through its strides (a copy only where they are not
    multiples of 16 bytes); three CUDA launches per call."""
    if q_i8.device.type == "cpu":
        return decode_qattention_ref(q_i8, k_cache, v_cache, lengths, M_idx, shift_idx,
                                     lut_q7, inv_s_logit, out_scale, bkv)
    _check_device("decode_qattention", q_i8)
    b, hkv, g, d = q_i8.shape
    b_c, smax, hkv_c, d_c = k_cache.shape
    if q_i8.dtype != torch.int8 or k_cache.dtype != torch.int8 \
            or v_cache.dtype != torch.int8:
        raise TypeError("decode_qattention wants int8 q and caches")
    if (b_c, hkv_c, d_c) != (b, hkv, d) or v_cache.shape != k_cache.shape \
            or g > 16 or d > 128 or d % 16 or not 0 < bkv <= 512 or smax % bkv:
        raise ValueError(f"decode_qattention: unsupported shapes q {tuple(q_i8.shape)}, "
                         f"cache {tuple(k_cache.shape)}, bkv {bkv} (needs G <= 16, "
                         f"D <= 128, D % 16 == 0, bkv <= 512 dividing Smax)")
    out = _launch_stripe(q_i8, k_cache, v_cache, lengths, M_idx, shift_idx, lut_q7,
                         inv_s_logit, out_scale, bkv=bkv)
    decode_qattention.launches += 1
    return out


decode_qattention.launches = 0
