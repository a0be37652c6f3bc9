"""Llama-3.1 405B  [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53_248, vocab_size=128_256,
    rope_theta=500_000.0, param_dtype="bfloat16",
))
