"""Model configuration system.

One ``ModelConfig`` describes any architecture in the zoo; per-arch files in
this package instantiate the exact published dimensions and register them.
``--arch <id>`` anywhere in the launchers resolves through ``get_config``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.policy import QuantPolicy, POLICY_FQ


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|vlm|audio|encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention flavour
    causal: bool = True
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0      # fraction of head_dim rotated (stablelm: 0.25)
    qk_norm: bool = False            # qwen3
    sliding_window: Optional[int] = None  # mixtral SWA
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE (t,h,w)
    learned_pos: bool = False        # BERT
    max_position: int = 1 << 20

    # norm / mlp
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1              # MoE on layers where i % period == offset
    moe_offset: int = 0

    # layer pattern for hybrid/ssm stacks; None -> all-attention
    # e.g. jamba: ('m','m','m','m','a','m','m','m'); xlstm: ('s','m7',...)
    block_pattern: Optional[Tuple[str, ...]] = None
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # modality frontend (stub per task spec)
    frontend: str = "none"           # none | vision_stub | audio_codebooks
    n_codebooks: int = 4             # musicgen
    n_lm_heads: int = 1              # musicgen: one head per codebook

    tied_embeddings: bool = False
    param_dtype: str = "float32"     # float32 | bfloat16
    quant: QuantPolicy = POLICY_FQ
    remat: bool = True               # checkpoint each super-block in training
    remat_groups: int = 0            # >1: two-level (sqrt-L) checkpointing —
                                     # saves residuals only at group
                                     # boundaries; ~(g + L/g)/L of the
                                     # activation memory for ~+1 forward

    # --- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("a",)

    @property
    def n_reps(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def is_moe_layer(self, global_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return global_idx % self.moe_period == self.moe_offset

    @property
    def dtype(self):
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32

    @property
    def n_params_estimate(self) -> int:
        """Rough dense-equivalent parameter count (for roofline MODEL_FLOPS)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        mlp_dense = (3 if self.act == "swiglu" else 2) * d * ff
        total = 0
        for i in range(self.n_layers):
            blk = self.pattern[i % len(self.pattern)]
            if blk == "a":
                total += attn
            elif blk == "m":  # mamba block
                d_in = self.mamba_expand * d
                total += 2 * d * d_in + d_in * d + d_in * (2 * self.mamba_d_state + 2)
            elif blk == "x":  # mLSTM block: q,k,v,o + output gate
                total += 5 * d * d
            elif blk == "s":  # sLSTM block: z,i,f,o + recurrent + out
                total += 6 * d * d
            if blk in ("a", "m"):
                if self.is_moe_layer(i):
                    total += 3 * self.n_experts * d * self.moe_d_ff \
                        + 3 * self.n_shared_experts * d * self.moe_d_ff
                elif ff:
                    total += mlp_dense
        total += self.vocab_size * d * (1 if self.tied_embeddings else 2)
        return total

    def active_params_estimate(self) -> int:
        """Active (per-token) params — MoE counts only routed top-k experts."""
        if self.n_experts == 0:
            return self.n_params_estimate
        full = self.n_params_estimate
        moe_layers = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        all_exp = 3 * self.n_experts * self.d_model * self.moe_d_ff * moe_layers
        act_exp = 3 * self.top_k * self.d_model * self.moe_d_ff * moe_layers
        return full - all_exp + act_exp


# --- registry ----------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch registration)

    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_configs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


# --- input shapes (the assigned shape set) -----------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
    "paper_128": ShapeConfig("paper_128", 128, 1, "prefill"),  # the paper's op point
}

# archs for which long_500k is runnable (sub-quadratic attention):
# mixtral (SWA ring buffer), jamba (hybrid), xlstm (ssm).  Pure full-attention
# archs skip it — see DESIGN.md §4.
LONG_CONTEXT_OK = {"mixtral-8x22b", "jamba-1.5-large-398b", "xlstm-1.3b"}


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True
