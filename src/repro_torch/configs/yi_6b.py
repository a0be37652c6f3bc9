"""Yi-6B  [arXiv:2403.04652] — llama-arch GQA."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11_008, vocab_size=64_000,
    rope_theta=5_000_000.0, param_dtype="bfloat16",
))
