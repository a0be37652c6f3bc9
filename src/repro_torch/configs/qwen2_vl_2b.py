"""Qwen2-VL-2B  [arXiv:2409.12191] — M-RoPE; vision frontend is a stub that
feeds precomputed patch embeddings (per task spec)."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151_936,
    mrope_sections=(16, 24, 24), tied_embeddings=True,
    rope_theta=1_000_000.0, frontend="vision_stub", param_dtype="bfloat16",
))
