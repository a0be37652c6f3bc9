"""Config-driven model stack for calibration: embeddings -> super-blocks ->
final norm -> LM head, for the all-attention architectures with a dense or
MoE feed-forward (qk-norm and the sliding window included).

Params and amax state keep the reference's stacked layout, (n_reps, ...)
on the leading axis, so the fold and the tests see the same trees; depth
is a Python loop over reps in place of ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as Moe

ATTN_SITES = ("attn_in", "q_pre", "k_pre", "q", "k", "v", "attn_out_in", "resid_a")
MLP_SITES_SWIGLU = ("mlp_in", "g_pre", "g_out", "u_out", "h_in", "resid_m")
MLP_SITES_GELU = ("mlp_in", "h_pre", "g_out", "h_in", "resid_m")


def slot_kinds(cfg: ModelConfig):
    """[(mixer, ffn)] per slot in the super-block pattern."""
    out = []
    for i, blk in enumerate(cfg.pattern):
        mixer = {"a": "attn", "m": "mamba", "s": "slstm", "x": "mlstm"}[blk]
        if cfg.family == "ssm":
            ffn = "none"
        elif cfg.n_experts and i % cfg.moe_period == cfg.moe_offset:
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        out.append((mixer, ffn))
    return out


def check_ported(cfg: ModelConfig):
    """The port serves all-attention archs (dense or MoE feed-forward,
    qk-norm or not, a sliding window or not) with token frontends and one
    LM head."""
    kinds = slot_kinds(cfg)
    if any(m != "attn" for m, _ in kinds) or cfg.frontend != "none" \
            or cfg.n_lm_heads != 1 or cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"arch {cfg.name!r} needs SSM/M-RoPE/frontend/multi-head support, "
            "which is not ported yet: ROADMAP Open items §1")


# --- pytree helpers ------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# --- initialization ------------------------------------------------------------

def _norm_params(cfg, gen):
    d = cfg.d_model
    p = {"gamma": torch.ones((d,), dtype=cfg.dtype, device=gen.device)}
    if cfg.norm_type == "layernorm":
        p["beta"] = torch.zeros((d,), dtype=cfg.dtype, device=gen.device)
    return p


def _dense(gen, din, dout, cfg, scale=0.02):
    w = torch.randn((din, dout), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(cfg.dtype)


def _stacked(gen, n, din, dout, cfg):
    """``n`` (din, dout) matrices drawn as one (n * din, dout) block, as the
    reference draws its stacked experts."""
    return _dense(gen, n * din, dout, cfg).reshape(n, din, dout)


def init_slot_params(cfg: ModelConfig, ffn: str, gen) -> Dict:
    """Float params of one attention slot with ``ffn`` in {dense, moe, none}."""
    d, hd = cfg.d_model, cfg.hd
    zeros = lambda n: torch.zeros((n,), dtype=cfg.dtype, device=gen.device)  # noqa: E731
    p: Dict = {"norm1": _norm_params(cfg, gen)}
    p["attn"] = {
        "wq": _dense(gen, d, cfg.n_heads * hd, cfg),
        "wk": _dense(gen, d, cfg.n_kv_heads * hd, cfg),
        "wv": _dense(gen, d, cfg.n_kv_heads * hd, cfg),
        "wo": _dense(gen, cfg.n_heads * hd, d, cfg),
    }
    if cfg.learned_pos:  # BERT uses biases everywhere
        p["attn"].update(bq=zeros(cfg.n_heads * hd), bk=zeros(cfg.n_kv_heads * hd),
                         bv=zeros(cfg.n_kv_heads * hd), bo=zeros(d))
    if cfg.qk_norm:
        p["attn"]["qn"] = torch.ones((hd,), dtype=cfg.dtype, device=gen.device)
        p["attn"]["kn"] = torch.ones((hd,), dtype=cfg.dtype, device=gen.device)
    if ffn != "none":
        p["norm2"] = _norm_params(cfg, gen)
    if ffn == "dense":
        if cfg.act == "swiglu":
            p["mlp"] = {"wg": _dense(gen, d, cfg.d_ff, cfg),
                        "wu": _dense(gen, d, cfg.d_ff, cfg),
                        "wd": _dense(gen, cfg.d_ff, d, cfg)}
        else:
            p["mlp"] = {"w1": _dense(gen, d, cfg.d_ff, cfg), "b1": zeros(cfg.d_ff),
                        "w2": _dense(gen, cfg.d_ff, d, cfg), "b2": zeros(d)}
    elif ffn == "moe":
        fe = cfg.moe_d_ff or cfg.d_ff
        groups = [("experts", cfg.n_experts)]
        if cfg.n_shared_experts:
            groups.append(("shared", cfg.n_shared_experts))
        p["moe"] = {"router": _dense(gen, d, cfg.n_experts, cfg)}
        for name, n in groups:
            p["moe"][name] = {"wg": _stacked(gen, n, d, fe, cfg),
                              "wu": _stacked(gen, n, d, fe, cfg),
                              "wd": _stacked(gen, n, fe, d, cfg)}
    return p


def slot_sites(cfg: ModelConfig, ffn: str):
    sites = list(ATTN_SITES)
    if ffn == "dense":
        sites += list(MLP_SITES_SWIGLU if cfg.act == "swiglu" else MLP_SITES_GELU)
    elif ffn == "moe":
        sites += list(Moe.MOE_SITES) + ["resid_m"]
        if cfg.n_shared_experts:
            sites += list(Moe.MOE_SHARED_SITES)
    return sites


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """Random float master weights from ``gen`` (on ``gen.device``)."""
    check_ported(cfg)
    blocks = {}
    for i, (_, ffn) in enumerate(slot_kinds(cfg)):
        blocks[f"slot{i}"] = tree_stack([init_slot_params(cfg, ffn, gen)
                                         for _ in range(cfg.n_reps)])
    p = {"embed": {"tokens": _dense(gen, cfg.vocab_size, cfg.d_model, cfg)},
         "blocks": blocks,
         "final_norm": _norm_params(cfg, gen)}
    if cfg.learned_pos:
        p["embed"]["pos"] = _dense(gen, cfg.max_position, cfg.d_model, cfg)
    if not cfg.tied_embeddings:
        p["lm_head"] = _dense(gen, cfg.d_model, cfg.vocab_size, cfg)
    return p


def init_amax(cfg: ModelConfig, device="cuda") -> Dict:
    z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    blocks = {f"slot{i}": {s: z((cfg.n_reps,)) for s in slot_sites(cfg, f)}
              for i, (_, f) in enumerate(slot_kinds(cfg))}
    return {"blocks": blocks, "embed_out": z(()), "head_in": z(())}


# --- forward -------------------------------------------------------------------

def _apply_slot(cfg, ffn, x, p, amax, pos, mask):
    """One slot -> (x, obs, aux loss of its MoE, 0 without one)."""
    policy = cfg.quant
    obs: Dict = {}
    h = L.qnorm(x, p["norm1"], policy, cfg.norm_type)
    out, o = L.attention_qat(h, p["attn"], amax, policy, cfg, pos, mask)
    obs.update(o)
    x, obs["resid_a"] = L.residual_add(x, out, amax["resid_a"], policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = L.qnorm(x, p["norm2"], policy, cfg.norm_type)
        if ffn == "dense":
            out, o = L.mlp_qat(h, p["mlp"], amax, policy, cfg.act)
        else:
            out, o, aux = Moe.moe_qat(h, p["moe"], amax, policy, cfg)
        obs.update(o)
        x, obs["resid_m"] = L.residual_add(x, out, amax["resid_m"], policy)
    return x, obs, aux


@torch.no_grad()
def forward(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor, *,
            mask: Optional[torch.Tensor] = None, pos: Optional[torch.Tensor] = None):
    """QAT (calibration) forward.  Returns (logits, obs tree matching
    ``init_amax``, aux_loss summed over the MoE slots)."""
    x, obs, aux = hidden(cfg, params, amax, tokens, mask=mask, pos=pos)
    w = params["embed"]["tokens"].T if cfg.tied_embeddings else params["lm_head"]
    logits = x @ w
    return logits.to(torch.float32), obs, aux


@torch.no_grad()
def hidden(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor, *,
           mask: Optional[torch.Tensor] = None, pos: Optional[torch.Tensor] = None):
    """The backbone of ``forward``: embeddings -> blocks -> final norm ->
    the fake-quantized head input.  Returns (hidden (B, S, d), obs, aux)."""
    check_ported(cfg)
    policy = cfg.quant
    x = params["embed"]["tokens"][tokens.long()]
    b, s = x.shape[0], x.shape[1]
    if cfg.learned_pos:
        x = x + params["embed"]["pos"][None, :s]
    if pos is None:
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, obs_embed = L.fake_quant_act(x, amax["embed_out"], policy.a_bits, policy.quantize_wa)
    if mask is None and not cfg.causal:
        mask = torch.ones((b, 1, s, s), dtype=torch.bool, device=x.device)
    kinds = slot_kinds(cfg)
    per_rep = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.n_reps):
        obs_rep = {}
        for i, (_, ffn) in enumerate(kinds):
            x, obs_rep[f"slot{i}"], aux = _apply_slot(
                cfg, ffn, x, tree_index(params["blocks"][f"slot{i}"], r),
                tree_index(amax["blocks"][f"slot{i}"], r), pos, mask)
            aux_total = aux_total + aux
        per_rep.append(obs_rep)
    x = L.qnorm(x, params["final_norm"], policy, cfg.norm_type)
    x, obs_head = L.fake_quant_act(x, amax["head_in"], policy.a_bits, policy.quantize_wa)
    return x, {"blocks": tree_stack(per_rep), "embed_out": obs_embed,
               "head_in": obs_head}, aux_total
