"""The integer GEMMs: W4A8 (``csrc/int4_matmul.cu``) and W8A8
(``csrc/int8_bitsplit_matmul.cu``), and their wrappers.

Replace the TPU kernels ``repro/kernels/int4_matmul.py::int4_matmul`` and
``::int8_bitsplit_matmul``.  On a CUDA tensor a wrapper launches its kernel
(or raises); on a CPU tensor it computes the plain version
(``ref.int4_matmul_ref``, ``ref.int8_bitsplit_matmul_ref``).  ``launches``
counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int4_matmul_ref, int8_bitsplit_matmul_ref

SOURCE = "src/repro_torch/csrc/int4_matmul.cu"
REPLACES = "src/repro/kernels/int4_matmul.py:71"
BITSPLIT_SOURCE = "src/repro_torch/csrc/int8_bitsplit_matmul.cu"
BITSPLIT_REPLACES = "src/repro/kernels/int4_matmul.py:141"
# (x@hi << 4) + x@lo and x@w are the same int32 value, with no wrap on
# either side, while K * 128 * 128 < 2^31 (every int8 code has |c| <= 128)
BITSPLIT_MAX_K = (2**31 - 1) // (128 * 128)


def _launch(fn, x_i8, w, bias_i32, M_q, shift_q, n: int) -> torch.Tensor:
    """Launch the GEMM kernel named like its wrapper ``fn`` on CUDA operands
    whose types and shapes the wrapper checked -> int8 (M, N); counts the
    launch on ``fn``."""
    name = fn.__name__
    dev = x_i8.device
    x = x_i8.contiguous()
    w = w.contiguous()
    bias = bias_i32.contiguous()
    if x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError(f"{name}: x and w must be 4-byte aligned")
    Mq = _build.device_scalar(M_q, torch.int32, dev)
    shq = _build.device_scalar(shift_q, torch.int32, dev)
    m, k = x.shape
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if m == 0:
        return out
    rc = _build.bind(name, name, 6, 3)(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), Mq.data_ptr(), shq.data_ptr(),
        out.data_ptr(), m, k, n, _build.stream_of(dev))
    _build.check_launch(rc, name)
    fn.launches += 1
    return out


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
    return _launch(int4_matmul, x_i8, w_packed, bias_i32, M_q, shift_q, n)


int4_matmul.launches = 0


def int8_bitsplit_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, bias_i32: torch.Tensor,
                         M_q, shift_q) -> torch.Tensor:
    """x int8 (M, K) @ w int8 (K, N) + bias, requantized -> int8 (M, N): the
    bit-split W8A8 product, computed by the kernel as one exact int8 GEMM."""
    if x_i8.device.type == "cpu":
        return int8_bitsplit_matmul_ref(x_i8, w_i8, bias_i32, M_q, shift_q)
    if x_i8.device.type != "cuda":
        raise ValueError(f"int8_bitsplit_matmul: unsupported device {x_i8.device}")
    m, k = x_i8.shape
    k_w, n = w_i8.shape
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8 or bias_i32.dtype != torch.int32:
        raise TypeError("int8_bitsplit_matmul wants int8 x, int8 w, int32 bias")
    if k != k_w or k % 64 or k > BITSPLIT_MAX_K or n % 4 or bias_i32.shape != (n,):
        raise ValueError(f"int8_bitsplit_matmul: unsupported shapes x {tuple(x_i8.shape)}, "
                         f"w {tuple(w_i8.shape)} (needs K % 64 == 0, K <= {BITSPLIT_MAX_K}, "
                         "N % 4 == 0)")
    return _launch(int8_bitsplit_matmul, x_i8, w_i8, bias_i32, M_q, shift_q, n)


int8_bitsplit_matmul.launches = 0
