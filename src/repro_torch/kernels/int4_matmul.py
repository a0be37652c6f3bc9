"""W4A8 integer matmul: the CUDA kernel ``csrc/int4_matmul.cu`` and its
wrapper.

Replaces the TPU kernel ``repro/kernels/int4_matmul.py::int4_matmul``.  On
a CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor
it computes the plain version ``ref.int4_matmul_ref``.  ``launches`` counts
kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int4_matmul_ref

SOURCE = "src/repro_torch/csrc/int4_matmul.cu"
REPLACES = "src/repro/kernels/int4_matmul.py:71"


def int4_matmul(x_i8: torch.Tensor, w_packed: torch.Tensor, bias_i32: torch.Tensor,
                M_q, shift_q) -> torch.Tensor:
    """x int8 (M, K) @ unpack(w uint8 (K/2, N)) + bias, requantized -> int8 (M, N)."""
    if x_i8.device.type == "cpu":
        return int4_matmul_ref(x_i8, w_packed, bias_i32, M_q, shift_q)
    if x_i8.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x_i8.device}")
    m, k = x_i8.shape
    k2, n = w_packed.shape
    if x_i8.dtype != torch.int8 or w_packed.dtype != torch.uint8 \
            or bias_i32.dtype != torch.int32:
        raise TypeError("int4_matmul wants int8 x, uint8 w_packed, int32 bias")
    if k != 2 * k2 or k2 % 32 or n % 4 or bias_i32.shape != (n,):
        raise ValueError(f"int4_matmul: unsupported shapes x {tuple(x_i8.shape)}, "
                         f"w {tuple(w_packed.shape)} (needs K/2 % 32 == 0, N % 4 == 0)")
    dev = x_i8.device
    x = x_i8.contiguous()
    w = w_packed.contiguous()
    bias = bias_i32.contiguous()
    if x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError("int4_matmul: x and w must be 4-byte aligned")
    Mq = _build.device_scalar(M_q, torch.int32, dev)
    shq = _build.device_scalar(shift_q, torch.int32, dev)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m == 0:
        return out
    rc = _build.bind("int4_matmul", "int4_matmul", 6, 3)(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), Mq.data_ptr(), shq.data_ptr(),
        out.data_ptr(), m, k, n, _build.stream_of(dev))
    _build.check_launch(rc, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
