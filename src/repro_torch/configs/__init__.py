"""Per-architecture configs (exact published dims) + smoke reductions."""
from repro_torch.configs import (  # noqa: F401
    qwen2_moe_a2p7b, mixtral_8x22b, llama3_405b, qwen3_4b, yi_6b,
    stablelm_1p6b, jamba_1p5_large, xlstm_1p3b, qwen2_vl_2b,
    musicgen_medium, bert_base,
)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, SHAPES, get_config, list_configs,
    cell_is_runnable, LONG_CONTEXT_OK,
)
from repro_torch.configs.smoke import smoke_config  # noqa: F401
