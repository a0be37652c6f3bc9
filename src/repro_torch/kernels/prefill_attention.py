"""Paged chunked-prefill attention: the CUDA kernel
``csrc/paged_prefill_attention.cu`` and its wrapper.

Replaces the TPU kernel
``repro/kernels/prefill_attention.py::paged_prefill_qattention``.  On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor it
computes the plain version ``ref.paged_prefill_qattention_ref``.  The result
does not depend on the kernel's q-block size ``bq``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_prefill_qattention_ref

SOURCE = "src/repro_torch/csrc/paged_prefill_attention.cu"
REPLACES = "src/repro/kernels/prefill_attention.py:128"


def paged_prefill_qattention(q_i8, k_pool, v_pool, block_tables, pos0, M_idx,
                             shift_idx, lut_q7, inv_s_logit, out_scale):
    """q int8 (B, H, S, D) at positions [pos0, pos0+S) x pools int8
    (n_pages, P, Hkv, D) through the block table -> int8 (B, H, S, D)."""
    if q_i8.device.type == "cpu":
        return paged_prefill_qattention_ref(q_i8, k_pool, v_pool, block_tables, pos0,
                                            M_idx, shift_idx, lut_q7, inv_s_logit,
                                            out_scale)
    if q_i8.device.type != "cuda":
        raise ValueError(f"paged_prefill_qattention: unsupported device {q_i8.device}")
    b, h, sq, d = q_i8.shape
    _, psize, hkv, d_p = k_pool.shape
    nb = block_tables.shape[1]
    if q_i8.dtype != torch.int8 or k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError("paged_prefill_qattention wants int8 q and pools")
    if d_p != d or h % hkv or v_pool.shape != k_pool.shape or d > 128 or d % 16 \
            or psize > 64:
        raise ValueError(f"paged_prefill_qattention: unsupported shapes q "
                         f"{tuple(q_i8.shape)}, pool {tuple(k_pool.shape)} (needs "
                         f"D <= 128, D % 16 == 0, P <= 64, H % Hkv == 0)")
    dev = q_i8.device
    q = q_i8.contiguous()
    kp = k_pool.contiguous()
    vp = v_pool.contiguous()
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged_prefill_qattention: pools must be 16-byte aligned")
    btab = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    p0 = torch.as_tensor(pos0, dtype=torch.int32).to(dev).reshape(-1).expand(b).contiguous()
    lut = lut_q7.to(device=dev, dtype=torch.int32).contiguous()
    scal = [_build.device_scalar(M_idx, torch.int32, dev),
            _build.device_scalar(shift_idx, torch.int32, dev),
            _build.device_scalar(inv_s_logit, torch.float32, dev),
            _build.device_scalar(out_scale, torch.float32, dev)]
    bq = min(64, 8192 // d)
    out = torch.empty_like(q)
    rc = _build.bind("paged_prefill_attention", "paged_prefill_attention", 11, 8)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), btab.data_ptr(), p0.data_ptr(),
        lut.data_ptr(), *(t.data_ptr() for t in scal), out.data_ptr(),
        b, h, sq, hkv, d, psize, nb, bq, _build.stream_of(dev))
    _build.check_launch(rc, "paged_prefill_qattention")
    paged_prefill_qattention.launches += 1
    return out


paged_prefill_qattention.launches = 0
