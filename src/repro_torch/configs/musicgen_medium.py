"""MusicGen-medium  [arXiv:2306.05284] — decoder over 4 EnCodec codebooks
(delay pattern); codebook embeddings summed, 4 parallel LM heads."""
from repro_torch.configs.base import ModelConfig, register

CFG = register(ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    norm_type="layernorm", act="gelu", learned_pos=True, max_position=32_768,
    frontend="audio_codebooks", n_codebooks=4, n_lm_heads=4,
    param_dtype="bfloat16",
))
