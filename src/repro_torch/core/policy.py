"""Quantization policy — which parts of the model are quantized, at what width.

The flags mirror the rows of paper Table II exactly, so the ablation benchmark
is just a sweep over policies:

    row 1: POLICY_FP32          (nothing quantized)
    row 2: w/a                  (weights 4b + activations 8b)
    row 3: w/a + scale          (+ scale factors to 8-significant-bit fixed pt)
    row 4: w/a + scale + softmax(+ LUT softmax)
    row 5: FULL (paper FQ-BERT) (+ integer layernorm)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    quantize_wa: bool = True        # weights + activations
    quantize_scale: bool = True     # scale factors to 8-bit precision
    quantize_softmax: bool = True   # LUT softmax
    quantize_layernorm: bool = True # integer LN / RMSNorm
    w_bits: int = 4
    a_bits: int = 8
    kv_bits: int = 8                # quantized KV cache (beyond paper: serving)
    per_channel_w: bool = False     # beyond-paper option; paper = per-tensor
    ema_decay: float = 0.99
    grad_compress_bits: int = 0     # 0 = off; 8 = int8 DP gradient all-reduce

    @property
    def any_quant(self) -> bool:
        return self.quantize_wa or self.quantize_softmax or self.quantize_layernorm


POLICY_FP32 = QuantPolicy(False, False, False, False)
POLICY_WA = QuantPolicy(True, False, False, False)
POLICY_WA_SCALE = QuantPolicy(True, True, False, False)
POLICY_WA_SCALE_SM = QuantPolicy(True, True, True, False)
POLICY_FQ = QuantPolicy()                      # full FQ-BERT (paper row 5)
POLICY_W8A8 = QuantPolicy(w_bits=8)            # Q8BERT-style comparison point

TABLE2_ROWS = [
    ("fp32", POLICY_FP32),
    ("w/a", POLICY_WA),
    ("w/a+scale", POLICY_WA_SCALE),
    ("w/a+scale+softmax", POLICY_WA_SCALE_SM),
    ("full (FQ-BERT)", POLICY_FQ),
]


def quantize_scale_8bit(s: float) -> float:
    """Model the paper's 8-bit scale factors: keep 8 significant bits.

    s -> nearest value of form m * 2^e with m an 8-bit integer.  Applied to
    s_a/s_w/s_y when policy.quantize_scale is on, so the requantization
    multiplier carries only 8 bits of precision (Table II row 3).
    """
    import math

    if s <= 0:
        return s
    e = math.floor(math.log2(s)) - 7
    m = round(s / (2.0**e))
    return m * (2.0**e)
