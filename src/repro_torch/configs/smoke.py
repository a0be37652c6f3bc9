"""Reduced same-family configs for CPU smoke tests."""
import dataclasses

from repro_torch.configs.base import get_config


def smoke_config(name: str, **extra):
    cfg = get_config(name)
    pat = cfg.pattern
    nh = min(cfg.n_heads, 4)
    nkv = max(1, min(cfg.n_kv_heads, nh))
    over = dict(
        n_layers=len(pat) * (2 if len(pat) == 1 else 1),
        d_model=128,
        n_heads=nh,
        n_kv_heads=nkv,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        max_position=512,
        param_dtype="float32",
        remat=False,
    )
    if cfg.n_experts:
        over.update(n_experts=4, top_k=min(cfg.top_k, 2),
                    moe_d_ff=128,
                    n_shared_experts=min(cfg.n_shared_experts, 2))
    if cfg.family == "hybrid":
        over.update(mamba_d_state=8)
    if cfg.family == "ssm":
        over.update(n_heads=2, n_kv_heads=2, head_dim=64)
    if cfg.sliding_window:
        over.update(sliding_window=16)
    over.update(extra)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **over)
