"""xLSTM-1.3B  [arXiv:2405.04517] — 7:1 mLSTM:sLSTM, no separate FFN."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    block_pattern=("s", "x", "x", "x", "x", "x", "x", "x"),
    norm_type="layernorm", param_dtype="bfloat16",
))
