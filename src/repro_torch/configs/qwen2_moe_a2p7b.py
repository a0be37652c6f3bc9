"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151_936,
    n_experts=60, top_k=4, n_shared_experts=4, moe_d_ff=1408,
    moe_period=1, moe_offset=0,
    rope_theta=1_000_000.0, param_dtype="bfloat16",
))
