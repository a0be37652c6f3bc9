"""FQ-BERT core: the paper's fully-quantized datapath as PyTorch functions."""
from repro_torch.core.policy import (  # noqa: F401
    QuantPolicy,
    POLICY_FP32,
    POLICY_WA,
    POLICY_WA_SCALE,
    POLICY_WA_SCALE_SM,
    POLICY_FQ,
    POLICY_W8A8,
    TABLE2_ROWS,
)
from repro_torch.core import quant, packing, fixedpoint, qsoftmax, qlayernorm, qlinear  # noqa: F401
