"""Qwen3-4B  [hf:Qwen/Qwen3-8B family] — qk_norm, GQA."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151_936, qk_norm=True,
    rope_theta=1_000_000.0, param_dtype="bfloat16",
))
