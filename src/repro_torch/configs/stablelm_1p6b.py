"""StableLM-2 1.6B  [hf:stabilityai/stablelm-2-1_6b] — LayerNorm + partial RoPE."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100_352,
    norm_type="layernorm", partial_rotary=0.25,
    rope_theta=10_000.0, param_dtype="bfloat16",
))
