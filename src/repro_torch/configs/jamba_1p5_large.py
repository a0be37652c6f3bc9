"""Jamba-1.5-Large 398B  [arXiv:2403.19887] — Mamba:attn 7:1, MoE 16e top-2
every other layer (attn at slot 4 of each 8-layer super-block)."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24_576, vocab_size=65_536,
    n_experts=16, top_k=2, moe_d_ff=24_576, moe_period=2, moe_offset=1,
    block_pattern=("m", "m", "m", "m", "a", "m", "m", "m"),
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    param_dtype="bfloat16",
))
