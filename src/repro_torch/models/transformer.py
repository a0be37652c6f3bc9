"""Config-driven QAT model stack (calibration and training): embeddings
(token, or the frontends: summed audio codebooks, precomputed vision-stub
embeddings prepended) -> super-blocks -> final norm -> LM head(s), for
architectures whose mixers are attention (qk-norm, M-RoPE and the sliding
window included), Mamba, mLSTM or sLSTM, with a dense, MoE or no
feed-forward.

Params and amax state keep the reference's stacked layout, (n_reps, ...)
on the leading axis, so the fold and the tests see the same trees; depth
is a Python loop over reps in place of ``lax.scan``.  ``forward`` and
``hidden`` record autograd when the caller does: calibration callers wrap
them in ``torch.no_grad()``.  With ``cfg.remat`` each super-block's
activations are recomputed in the backward (``layers.remat``), and with
``cfg.remat_groups`` > 1 also each group of super-blocks, as the
reference's two ``jax.checkpoint`` levels.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prng import log_f32
from repro_torch.models import layers as L
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as Moe
from repro_torch.models import xlstm as Xl
from repro_torch.sharding import collectives as C

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


# --- pytree helpers ------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in key order (anything but a dict is a leaf)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for v in tree.values() for leaf in tree_leaves(v)]


def tree_unflatten(like, leaves):
    """Nested dicts shaped as ``like`` holding ``leaves`` in key order."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return build(like)


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


def _mixer_params(cfg: ModelConfig, mixer: str, gen) -> Dict:
    """Float params of a slot's mixer, with the reference's shapes, scales,
    constant inits and dtypes."""
    d, hd = cfg.d_model, cfg.hd
    dev = gen.device
    zeros = lambda n, dt=cfg.dtype: torch.zeros((n,), dtype=dt, device=dev)  # noqa: E731
    full = lambda n, v, dt: torch.full((n,), v, dtype=dt, device=dev)  # noqa: E731
    if mixer == "attn":
        p = {"wq": _dense(gen, d, cfg.n_heads * hd, cfg),
             "wk": _dense(gen, d, cfg.n_kv_heads * hd, cfg),
             "wv": _dense(gen, d, cfg.n_kv_heads * hd, cfg),
             "wo": _dense(gen, cfg.n_heads * hd, d, cfg)}
        if cfg.learned_pos:  # BERT uses biases everywhere
            p.update(bq=zeros(cfg.n_heads * hd), bk=zeros(cfg.n_kv_heads * hd),
                     bv=zeros(cfg.n_kv_heads * hd), bo=zeros(d))
        if cfg.qk_norm:
            p["qn"] = torch.ones((hd,), dtype=cfg.dtype, device=dev)
            p["kn"] = torch.ones((hd,), dtype=cfg.dtype, device=dev)
        return p
    if mixer == "mamba":
        d_in, dt_rank = Mb.mamba_dims(cfg)
        n = cfg.mamba_d_state
        conv = torch.randn((cfg.mamba_d_conv, d_in), generator=gen, device=dev)
        # jnp.log's float32 values (XLA's CPU log, ``prng.log_f32``), as constants
        a_log = torch.as_tensor(log_f32(np.arange(1, n + 1, dtype=np.float32)), device=dev)
        return {"w_in": _dense(gen, d, 2 * d_in, cfg),
                "conv_w": (conv * 0.1).to(cfg.dtype),
                "conv_b": zeros(d_in),
                "w_x": _dense(gen, d_in, dt_rank + 2 * n, cfg),
                "w_dt": _dense(gen, dt_rank, d_in, cfg, scale=dt_rank**-0.5),
                "dt_bias": full(d_in, -4.6, torch.float32),      # softplus^-1(0.01)
                "A_log": a_log.expand(d_in, n).contiguous(),
                "D": full(d_in, 1.0, torch.float32),
                "w_out": _dense(gen, d_in, d, cfg)}
    if mixer == "mlstm":
        return {"wq": _dense(gen, d, d, cfg), "wk": _dense(gen, d, d, cfg),
                "wv": _dense(gen, d, d, cfg), "wo": _dense(gen, d, d, cfg),
                "w_ig": _dense(gen, d, cfg.n_heads, cfg),
                "b_ig": zeros(cfg.n_heads, torch.float32),
                "w_fg": _dense(gen, d, cfg.n_heads, cfg),
                "b_fg": full(cfg.n_heads, 3.0, torch.float32),
                "w_og": _dense(gen, d, d, cfg), "b_og": zeros(d),
                "ln_y": torch.ones((d,), dtype=cfg.dtype, device=dev)}
    dh = d // cfg.n_heads                                         # slstm
    r = torch.randn((cfg.n_heads, dh, 4 * dh), generator=gen, device=dev)
    return {"w_z": _dense(gen, d, d, cfg), "b_z": zeros(d),
            "w_i": _dense(gen, d, d, cfg), "b_i": zeros(d),
            "w_f": _dense(gen, d, d, cfg), "b_f": full(d, 3.0, cfg.dtype),
            "w_o": _dense(gen, d, d, cfg), "b_o": zeros(d),
            "r": (r * dh**-0.5).to(cfg.dtype),
            "w_out": _dense(gen, d, d, cfg)}


def init_slot_params(cfg: ModelConfig, mixer: str, ffn: str, gen) -> Dict:
    """Float params of one slot: ``mixer`` in {attn, mamba, mlstm, slstm}
    (under "attn" for attention, "mixer" otherwise, as in the reference),
    ``ffn`` in {dense, moe, none}."""
    d = cfg.d_model
    zeros = lambda n: torch.zeros((n,), dtype=cfg.dtype, device=gen.device)  # noqa: E731
    p: Dict = {"norm1": _norm_params(cfg, gen),
               "attn" if mixer == "attn" else "mixer": _mixer_params(cfg, mixer, gen)}
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


MIXER_SITES = {"attn": ATTN_SITES, "mamba": Mb.MAMBA_SITES + ("resid_a",),
               "mlstm": Xl.MLSTM_SITES + ("resid_a",), "slstm": Xl.SLSTM_SITES + ("resid_a",)}


def slot_sites(cfg: ModelConfig, mixer: str, ffn: str):
    sites = list(MIXER_SITES[mixer])
    if ffn == "dense":
        sites += list(MLP_SITES_SWIGLU if cfg.act == "swiglu" else MLP_SITES_GELU)
    elif ffn == "moe":
        sites += list(Moe.MOE_SITES) + ["resid_m"]
        if cfg.n_shared_experts:
            sites += list(Moe.MOE_SHARED_SITES)
    return sites


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """Random float master weights from ``gen`` (on ``gen.device``): an
    audio arch's ``embed.codebooks`` (K, V, d), and several untied LM heads
    stacked (K, d, V), as the reference's."""
    blocks = {}
    for i, (mixer, ffn) in enumerate(slot_kinds(cfg)):
        blocks[f"slot{i}"] = tree_stack([init_slot_params(cfg, mixer, ffn, gen)
                                         for _ in range(cfg.n_reps)])
    p = {"embed": {"tokens": _dense(gen, cfg.vocab_size, cfg.d_model, cfg)},
         "blocks": blocks,
         "final_norm": _norm_params(cfg, gen)}
    if cfg.frontend == "audio_codebooks":
        p["embed"]["codebooks"] = _stacked(gen, cfg.n_codebooks, cfg.vocab_size,
                                           cfg.d_model, cfg)
    if cfg.learned_pos:
        p["embed"]["pos"] = _dense(gen, cfg.max_position, cfg.d_model, cfg)
    if not cfg.tied_embeddings and cfg.n_lm_heads > 1:
        p["lm_head"] = torch.stack([_dense(gen, cfg.d_model, cfg.vocab_size, cfg)
                                    for _ in range(cfg.n_lm_heads)])
    elif not cfg.tied_embeddings:
        p["lm_head"] = _dense(gen, cfg.d_model, cfg.vocab_size, cfg)
    return p


def init_amax(cfg: ModelConfig, device="cuda") -> Dict:
    z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    blocks = {f"slot{i}": {s: z((cfg.n_reps,)) for s in slot_sites(cfg, m, f)}
              for i, (m, f) in enumerate(slot_kinds(cfg))}
    return {"blocks": blocks, "embed_out": z(()), "head_in": z(())}


# --- forward -------------------------------------------------------------------

CHUNK_TOKENS = 4096  # token-chunk size for the (token-parallel) dense MLP


def _chunked_mlp(x, p, amax, policy, act):
    """Token-chunked QAT MLP, as the reference's: rows are independent, so
    chunks of 512 positions (each with the whole batch) cap the live
    (tokens, d_ff) fake-quant chain, recomputed in the backward; each site's
    observation is the max over the chunks (each chunk falls back to its
    own batch statistic where the site's EMA is still 0, as in the
    reference)."""
    b, s, d = x.shape
    c = 512
    if b * s <= 2 * CHUNK_TOKENS or s % c != 0 or s <= c:
        return L.mlp_qat(x, p, amax, policy, act)
    ys, obs_c = [], []
    for i in range(0, s, c):
        y, o = L.remat(L.mlp_qat, x[:, i:i + c], p, amax, policy, act)
        ys.append(y)
        obs_c.append(o)
    obs = {k: torch.stack([o[k] for o in obs_c]).amax(0) for k in obs_c[0]}
    return torch.cat(ys, 1), obs


def _apply_slot(cfg, mixer, ffn, x, p, amax, pos, mask):
    """One slot -> (x, obs, aux loss of its MoE, 0 without one)."""
    policy = cfg.quant
    obs: Dict = {}
    h = L.qnorm(x, p["norm1"], policy, cfg.norm_type)
    if mixer == "attn":
        out, o = L.attention_qat(h, p["attn"], amax, policy, cfg, pos, mask)
    elif mixer == "mamba":
        out, o, _ = Mb.mamba_qat(h, p["mixer"], amax, policy, cfg)
    elif mixer == "mlstm":
        out, o, _ = Xl.mlstm_qat(h, p["mixer"], amax, policy, cfg)
    else:
        out, o, _ = Xl.slstm_qat(h, p["mixer"], amax, policy, cfg)
    obs.update(o)
    x, obs["resid_a"] = L.residual_add(x, out, amax["resid_a"], policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = L.qnorm(x, p["norm2"], policy, cfg.norm_type)
        if ffn == "dense":
            out, o = _chunked_mlp(h, p["mlp"], amax, policy, cfg.act)
        else:
            out, o, aux = Moe.moe_qat(h, p["moe"], amax, policy, cfg)
        obs.update(o)
        x, obs["resid_m"] = L.residual_add(x, out, amax["resid_m"], policy)
    return x, obs, aux


def forward(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor, *,
            mask: Optional[torch.Tensor] = None, pos: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None,
            pos3: Optional[torch.Tensor] = None):
    """QAT forward (arguments as ``hidden``).  Returns
    (logits (B, S, V), or (B, K, S, V) for K LM heads; the obs tree matching
    ``init_amax``; aux_loss summed over the MoE slots).  With a vocab-split
    head (``{"<model rank>": block}``) over more than one model rank the
    logits stay split too: a dict of this process's model ranks' float32
    (B, S, V / m) blocks, (B, K, S, V / m) for K heads, which
    ``train/steps.py``'s vocab-parallel cross-entropy takes as they are (one
    rank's block is the whole)."""
    x, obs, aux = hidden(cfg, params, amax, tokens, mask=mask, pos=pos,
                         extra_embeds=extra_embeds, pos3=pos3)
    head = params["embed"]["tokens"] if cfg.tied_embeddings else params.get("lm_head")

    def logits_of(x, w):
        if cfg.tied_embeddings:
            return x @ w.T
        if cfg.n_lm_heads > 1:          # (K, d, V) or a rank's (K, d, V / m)
            return torch.einsum("bsd,kdv->bksv", x, w)
        return x @ w

    if isinstance(head, dict):
        group = L._group(head)
        blocks = {k: logits_of(x_r, w).to(torch.float32)
                  for x_r, (k, w) in zip(C.copy_to_model(group, x), head.items(), strict=True)}
        return (blocks if group.size > 1 else blocks["0"]), obs, aux
    return logits_of(x, head).to(torch.float32), obs, aux


def embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S), or an audio arch's (B, K, S) codebook codes summed
    over the K codebooks in order -> float embeddings (B, S, d).  A lookup
    by ``F.embedding``, whose backward sums a repeated token's gradients in
    a fixed order (an indexing's backward on the CPU does not: the resumed
    run must equal the uninterrupted one bit for bit).  A vocab-split table
    takes ``_vocab_parallel_embed``: a split codebook table's lookups, one
    a codebook, are added in codebook order, as the whole table's are
    (each lookup is exact, so the sums are the same bits)."""
    if cfg.frontend != "audio_codebooks":
        w = params["embed"]["tokens"]
        if isinstance(w, dict):
            return _vocab_parallel_embed(tokens, w)
        return torch.nn.functional.embedding(tokens.long(), w)
    books = params["embed"]["codebooks"]
    like = next(iter(books.values())) if isinstance(books, dict) else books
    x = torch.zeros((tokens.shape[0], tokens.shape[2], cfg.d_model), dtype=like.dtype,
                    device=like.device)
    for ci in range(cfg.n_codebooks):
        if isinstance(books, dict):     # each codebook vocab-parallel, in codebook order
            e = _vocab_parallel_embed(tokens[:, ci], {k: w[ci] for k, w in books.items()})
        else:
            e = torch.nn.functional.embedding(tokens[:, ci].long(), books[ci])
        x = x + e
    return x


def _vocab_parallel_embed(tokens: torch.Tensor, blocks: Dict) -> torch.Tensor:
    """The lookup over a vocab-split table (``{"<model rank>": block}``):
    each rank looks up the tokens of its vocab block, zeros elsewhere, and
    the ranks' lookups are summed (``collectives.reduce_from_model``):
    exact, as one term of each sum is nonzero."""
    group = L._group(blocks)
    ids, parts = tokens.long(), []
    for key, w in blocks.items():
        t = ids - int(key) * w.shape[0]
        inside = (t >= 0) & (t < w.shape[0])
        e = torch.nn.functional.embedding(torch.where(inside, t, 0), w)
        parts.append(torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                   device=e.device)))
    return C.reduce_from_model(group, parts)


def hidden(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor, *,
           mask: Optional[torch.Tensor] = None, pos: Optional[torch.Tensor] = None,
           extra_embeds: Optional[torch.Tensor] = None,
           pos3: Optional[torch.Tensor] = None):
    """The backbone of ``forward``: embeddings -> blocks -> final norm ->
    the fake-quantized head input.  ``tokens`` (B, S), or (B, K, S) audio
    codes; ``extra_embeds`` (B, S_img, d), the vision stub's patch
    embeddings, go before the tokens' (S counts both); ``pos3`` (B, S, 3),
    the M-RoPE positions (default: ``pos`` on all three streams).  Returns
    (hidden (B, S, d), obs, aux)."""
    policy = cfg.quant
    x = embed(cfg, params, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s = x.shape[0], x.shape[1]
    if cfg.learned_pos:
        x = x + params["embed"]["pos"][None, :s]
    if pos is None:
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    if cfg.mrope_sections is not None:
        pos = pos3 if pos3 is not None else pos[..., None].expand(b, s, 3)
    x, obs_embed = L.fake_quant_act(x, amax["embed_out"], policy.a_bits, policy.quantize_wa)
    if mask is None and not cfg.causal:
        mask = torch.ones((b, 1, s, s), dtype=torch.bool, device=x.device)
    kinds = slot_kinds(cfg)

    def rep_body(x, aux_sum, r):
        """Super-block ``r``: every slot of the pattern once."""
        obs_rep = {}
        for i, (mixer, ffn) in enumerate(kinds):
            x, obs_rep[f"slot{i}"], aux = _apply_slot(
                cfg, mixer, ffn, x, tree_index(params["blocks"][f"slot{i}"], r),
                tree_index(amax["blocks"][f"slot{i}"], r), pos, mask)
            aux_sum = aux_sum + aux
        return x, aux_sum, obs_rep

    def body(x, aux_sum, r):
        return L.remat(rep_body, x, aux_sum, r) if cfg.remat else rep_body(x, aux_sum, r)

    def group_body(x, aux_sum, r0, n):
        obs_g = []
        for r in range(r0, r0 + n):
            x, aux_sum, o = body(x, aux_sum, r)
            obs_g.append(o)
        return x, aux_sum, obs_g

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    g = cfg.remat_groups
    if g > 1 and cfg.n_reps % g == 0:
        # two-level (sqrt-L) checkpointing: only the group boundaries keep
        # their input; the backward recomputes one group at a time
        per = cfg.n_reps // g
        per_rep = []
        for r0 in range(0, cfg.n_reps, per):
            x, aux_total, o = L.remat(group_body, x, aux_total, r0, per)
            per_rep += o
    else:
        x, aux_total, per_rep = group_body(x, aux_total, 0, cfg.n_reps)
    x = L.qnorm(x, params["final_norm"], policy, cfg.norm_type)
    x, obs_head = L.fake_quant_act(x, amax["head_in"], policy.a_bits, policy.quantize_wa)
    return x, {"blocks": tree_stack(per_rep), "embed_out": obs_embed,
               "head_in": obs_head}, aux_total
