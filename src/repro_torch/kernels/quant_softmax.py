"""Integer LUT row softmax: the CUDA kernel ``csrc/quant_softmax.cu`` and its
wrapper.

Replaces the TPU kernel ``repro/kernels/quant_softmax.py::quant_softmax``.
On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it computes the plain version ``ref.quant_softmax_ref``.
``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.boundary import kernel_launch
from repro_torch.core.qsoftmax import LUT_SIZE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_softmax_ref

SOURCE = "src/repro_torch/csrc/quant_softmax.cu"
REPLACES = "src/repro/kernels/quant_softmax.py:44"


@kernel_launch
def quant_softmax(x_int: torch.Tensor, M_idx, shift_idx, lut: torch.Tensor) -> torch.Tensor:
    """int32 (R, S) pre-masked logit codes -> int8 (R, S) Q0.7 probabilities
    through the 256-entry q8 table ``lut``."""
    if x_int.device.type == "cpu":
        return quant_softmax_ref(x_int, M_idx, shift_idx, lut)
    if x_int.device.type != "cuda":
        raise ValueError(f"quant_softmax: unsupported device {x_int.device}")
    if x_int.dtype != torch.int32 or x_int.dim() != 2:
        raise TypeError(f"quant_softmax wants int32 (R, S) codes, got {x_int.dtype} "
                        f"{tuple(x_int.shape)}")
    if lut.shape != (LUT_SIZE,):
        raise ValueError(f"quant_softmax: the table must have {LUT_SIZE} entries")
    dev = x_int.device
    r, s = x_int.shape
    x = x_int.contiguous()
    table = lut.to(device=dev, dtype=torch.int32).contiguous()
    Mq = _build.device_scalar(M_idx, torch.int32, dev)
    shq = _build.device_scalar(shift_idx, torch.int32, dev)
    out = torch.empty((r, s), dtype=torch.int8, device=dev)
    rc = _build.bind("quant_softmax", "quant_softmax", 5, 3)(
        x.data_ptr(), table.data_ptr(), Mq.data_ptr(), shq.data_ptr(), out.data_ptr(),
        r, s, _build.sm_count(dev), _build.stream_of(dev))
    _build.check_launch(rc, "quant_softmax")
    quant_softmax.launches += 1
    return out


quant_softmax.launches = 0
