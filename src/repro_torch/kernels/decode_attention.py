"""Paged continuous-batching decode attention: the CUDA kernel
``csrc/paged_decode_attention.cu`` and its wrapper.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::paged_decode_qattention``.  On a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it
computes the plain version ``ref.paged_decode_qattention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_qattention_ref

SOURCE = "src/repro_torch/csrc/paged_decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:214"


def _i32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


def paged_decode_qattention(q_i8, k_pool, v_pool, block_tables, lengths, M_idx,
                            shift_idx, lut_q7, inv_s_logit, out_scale):
    """q int8 (B, Hkv, G, D) x pools int8 (n_pages, P, Hkv, D) through the
    block table, masked to ``lengths`` -> int8 (B, Hkv, G, D)."""
    if q_i8.device.type == "cpu":
        return paged_decode_qattention_ref(q_i8, k_pool, v_pool, block_tables, lengths,
                                           M_idx, shift_idx, lut_q7, inv_s_logit,
                                           out_scale)
    if q_i8.device.type != "cuda":
        raise ValueError(f"paged_decode_qattention: unsupported device {q_i8.device}")
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
    q = q_i8.contiguous()
    kp = k_pool.contiguous()
    vp = v_pool.contiguous()
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged_decode_qattention: pools must be 16-byte aligned")
    btab = _i32(block_tables, dev)
    lens = _i32(lengths, dev)
    lut = _i32(lut_q7, dev)
    scal = [_build.device_scalar(M_idx, torch.int32, dev),
            _build.device_scalar(shift_idx, torch.int32, dev),
            _build.device_scalar(inv_s_logit, torch.float32, dev),
            _build.device_scalar(out_scale, torch.float32, dev)]
    out = torch.empty_like(q)
    rc = _build.bind("paged_decode_attention", "paged_decode_attention", 11, 6)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), btab.data_ptr(), lens.data_ptr(),
        lut.data_ptr(), *(t.data_ptr() for t in scal), out.data_ptr(),
        b, hkv, g, d, psize, nb, _build.stream_of(dev))
    _build.check_launch(rc, "paged_decode_qattention")
    paged_decode_qattention.launches += 1
    return out


paged_decode_qattention.launches = 0
