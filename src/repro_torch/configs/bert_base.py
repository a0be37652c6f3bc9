"""BERT-base — the paper's own model (SST-2/MNLI operating point)."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="bert-base", family="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=30_522,
    causal=False, learned_pos=True, max_position=512,
    norm_type="layernorm", act="gelu",
))
