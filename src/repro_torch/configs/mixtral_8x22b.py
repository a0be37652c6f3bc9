"""Mixtral 8x22B  [arXiv:2401.04088] — 8 experts top-2, SWA per task spec."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab_size=32_768,
    n_experts=8, top_k=2, moe_d_ff=16_384, moe_period=1,
    sliding_window=4096,
    rope_theta=1_000_000.0, param_dtype="bfloat16",
))
