"""Integer LayerNorm / RMSNorm: the CUDA kernel ``csrc/quant_layernorm.cu``
and its wrapper.

Replaces the TPU kernel ``repro/kernels/quant_layernorm.py::quant_layernorm``.
On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it computes the plain version ``ref.quant_layernorm_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.boundary import kernel_launch
from repro_torch.core.qlayernorm import QLNParams
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_layernorm_ref

SOURCE = "src/repro_torch/csrc/quant_layernorm.cu"
REPLACES = "src/repro/kernels/quant_layernorm.py:44"


@kernel_launch
def quant_layernorm(x_i8: torch.Tensor, p: QLNParams, eps_codes: int = 1) -> torch.Tensor:
    """int8 (R, N) rows -> int8 (R, N) on the folded output grid."""
    if x_i8.device.type == "cpu":
        return quant_layernorm_ref(x_i8, p, eps_codes)
    if x_i8.device.type != "cuda":
        raise ValueError(f"quant_layernorm: unsupported device {x_i8.device}")
    r, n = x_i8.shape
    if x_i8.dtype != torch.int8 or p.gamma_i.dtype != torch.int8 \
            or p.beta_aligned.dtype != torch.int32:
        raise TypeError("quant_layernorm wants int8 x/gamma and int32 beta")
    if n > 16384 or p.gamma_i.shape != (n,) or p.beta_aligned.shape != (n,):
        raise ValueError(f"quant_layernorm: unsupported shapes x {tuple(x_i8.shape)}")
    dev = x_i8.device
    x = x_i8.contiguous()
    gamma = p.gamma_i.contiguous()
    beta = p.beta_aligned.contiguous()
    Mq = _build.device_scalar(p.M_out, torch.int32, dev)
    shq = _build.device_scalar(p.shift_out, torch.int32, dev)
    out = torch.empty_like(x)
    rc = _build.bind("quant_layernorm", "quant_layernorm", 6, 5)(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), Mq.data_ptr(), shq.data_ptr(),
        out.data_ptr(), r, n, int(p.subtract_mean), int(eps_codes), _build.sm_count(dev),
        _build.stream_of(dev))
    _build.check_launch(rc, "quant_layernorm")
    quant_layernorm.launches += 1
    return out


quant_layernorm.launches = 0
