"""Integer serving forward over the folded params: cache-less prefill,
chunk prefill into the paged int8 KV pool, and single-token paged decode.

The paper's deployment datapath: int8 activations end to end, packed-int4
weights, LUT softmax, integer LN, int8 KV pool, with one float island (the
RoPE rotation) and the fp32 ``lm_head`` scale.  Mirrors the reference
``models/serve_int.py`` for all-attention dense archs; every other branch
raises ``NotImplementedError``.

Backends (``kernels/ops.py``): on ``ref`` the cached forwards take the
row-exact q8 datapath (``_attn_rows_q8`` / ``_gqa_decode``), bit for bit the
reference's ``ref`` backend; on ``gpu`` they take the q7 paged kernels, as
the reference's ``pallas`` backend does.  The cache-less causal prefill
takes the blocked ``flash_qattention_torch`` on every backend.

Unlike the functional reference, the paged pool is updated IN PLACE (the
returned cache is the same dict of tensors): at full width a copy of the
pool per layer would cost more than the layer.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core.qlayernorm import QLNParams
from repro_torch.core.qlinear import FoldedLinear
from repro_torch.core.qsoftmax import MASK_OFFSET, make_exp_lut
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_qattention import divisor_tile, flash_qattention_torch
from repro_torch.models import layers as L
from repro_torch.models.transformer import check_ported, slot_kinds, tree_index

_LUTS: Dict = {}


def _lut(kind: str, device) -> torch.Tensor:
    key = (kind, str(device))
    if key not in _LUTS:
        vals = kref.make_exp_lut_q7() if kind == "q7" else make_exp_lut()
        _LUTS[key] = torch.as_tensor(vals, dtype=torch.int32, device=device)
    return _LUTS[key]


# --- primitive appliers -------------------------------------------------------

def _ln(x_i8, f, cfg):
    p = QLNParams(gamma_i=f["gamma_i"], beta_aligned=f["beta_al"], M_out=f["M"],
                  shift_out=f["sh"], subtract_mean=(cfg.norm_type == "layernorm"))
    return ops.layernorm_q(x_i8, p)


def _lin(x_i8, f, w_bits):
    fl = FoldedLinear(w_packed=f["w"], bias_i=f["b"], M=f["M"], shift=f["sh"],
                      w_bits=w_bits)
    return ops.linear_w4a8(x_i8, fl)


def _rescale_i8(x_i8, f):
    y = fxp.rescale(x_i8.to(torch.int32), f["M"], f["sh"])
    return torch.clamp(y, -127, 127).to(torch.int8)


def _resid_add(x_i8, f_rescale, delta_i8):
    xr = fxp.rescale(x_i8.to(torch.int32), f_rescale["M"], f_rescale["sh"])
    return torch.clamp(xr + delta_i8.to(torch.int32), -127, 127).to(torch.int8)


def _lut8(x_i8, lut_i8):
    """int8 -> int8 elementwise via a 256-entry LUT."""
    return lut_i8[(x_i8.to(torch.int64) + 128)]


def _rope_island(h_i8, inv_s_in, s_out, pos, cfg):
    """dequant -> rotate -> requant.  (B,S,H,D) int8."""
    hf = h_i8.to(torch.float32) * inv_s_in
    if not cfg.learned_pos:
        hf = L.apply_rope(hf, pos, cfg.rope_theta, cfg.partial_rotary)
    return torch.clamp(torch.round(hf * s_out), -127, 127).to(torch.int8)


# --- attention slot -----------------------------------------------------------

def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar-or-(B,) position argument as a (B,) int32 vector."""
    return torch.as_tensor(pos, dtype=torch.int32).to(device).reshape(-1).expand(b)


def _attn_rows_q8(qc, kc, vc, aq, cfg, mask):
    """Materialized row attention through the decode-identical integer
    datapath (q8 LUT softmax + M_pv requant) -> (B, H, S, hd) int8.
    ``mask`` is bool or None: (S, Skv) shared across the batch."""
    group = cfg.n_heads // cfg.n_kv_heads
    kg = kc.repeat_interleave(group, dim=2)
    vg = vc.repeat_interleave(group, dim=2)
    scores = kref.int_matmul(qc.permute(0, 2, 1, 3), kg.permute(0, 2, 3, 1))  # (B,H,S,Skv)
    if mask is not None:
        scores = torch.where(mask[None, None], scores, scores - MASK_OFFSET)
    probs = ops.softmax_q(scores, aq["M_idx"], aq["sh_idx"], _lut("q8", qc.device))
    pv = kref.int_matmul(probs, vg.permute(0, 2, 1, 3))
    return torch.clamp(fxp.rescale(pv, aq["M_pv"], aq["sh_pv"]), -127, 127).to(torch.int8)


def _qkv_rope(x_i8, f, cfg, pos):
    """LN -> q/k/v projections -> RoPE at ``pos`` (B, S).  Returns
    (qc (B,S,H,hd), kc/vc (B,S,Hkv,hd)) int8."""
    b, s, _ = x_i8.shape
    wb = cfg.quant.w_bits
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = _ln(x_i8, f["ln1"], cfg)
    qc = _lin(h, f["wq"], wb).reshape(b, s, nh, hd)
    kc = _lin(h, f["wk"], wb).reshape(b, s, nkv, hd)
    vc = _lin(h, f["wv"], wb).reshape(b, s, nkv, hd)
    aq = f["attn_q"]
    qc = _rope_island(qc, aq["inv_s_qp"], aq["s_q"], pos, cfg)
    kc = _rope_island(kc, aq["inv_s_kp"], aq["s_k"], pos, cfg)
    return qc, kc, vc


def _attn_prefill(x_i8, f, cfg, pos):
    """Cache-less prefill (evaluation path)."""
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos)
    aq = f["attn_q"]
    if cfg.causal:
        lut = _lut("q7", x_i8.device)
        ctx = torch.stack([flash_qattention_torch(
            qc[i].transpose(0, 1), kc[i].transpose(0, 1), vc[i].transpose(0, 1),
            aq["M_idx"], aq["sh_idx"], lut, aq["inv_s_logit"], aq["out_scale"],
            bkv=divisor_tile(512, s)) for i in range(b)])          # (B,H,S,D)
    else:
        # bidirectional (BERT): paper-style row LUT softmax, materialized
        ctx = _attn_rows_q8(qc, kc, vc, aq, cfg, None)
    ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
    return _lin(ctx, f["wo"], cfg.quant.w_bits)


def _gqa_decode(qg, k_cache, v_cache, lengths, aq):
    """Masked single-query GQA over a (B, S*, Hkv, hd) int8 KV view, q heads
    grouped per kv head; rows at >= lengths[b] are masked to LUT zero."""
    srows = k_cache.shape[1]
    scores = kref.int_matmul(qg, k_cache.permute(0, 2, 3, 1))    # (B,kv,g,S*)
    valid = torch.arange(srows, device=qg.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores, scores - MASK_OFFSET)
    probs = ops.softmax_q(scores, aq["M_idx"], aq["sh_idx"], _lut("q8", qg.device))
    pv = kref.int_matmul(probs, v_cache.permute(0, 2, 1, 3))     # (B,kv,g,hd)
    return torch.clamp(fxp.rescale(pv, aq["M_pv"], aq["sh_pv"]), -127, 127).to(torch.int8)


def _gather_view(pool, block_tables):
    """(B, max_blocks*P, Hkv, hd) slot-major view of the chain (ref path)."""
    b = block_tables.shape[0]
    return pool[block_tables.long()].reshape(b, -1, pool.shape[2], pool.shape[3])


def _attn_decode_paged(x_i8, f, cfg, cache, pos_vec, block_tables):
    """Paged decode step: x (B,1,d); cache {'k','v'}: (n_pages, P, Hkv, hd).
    The token's K/V row is written through the slot's block table (page =
    table[b, pos // P], row = pos % P; inactive slots, whose table rows are
    zero, write into the reserved trash page 0), then attention reads the
    pool through the table."""
    b, s, _ = x_i8.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    psize = cache["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos_vec[:, None])
    aq = f["attn_q"]
    pos_l = pos_vec.long()
    pg = torch.gather(block_tables.long(), 1, (pos_l // psize)[:, None])[:, 0]
    row = pos_l % psize
    cache["k"][pg, row] = kc[:, 0]
    cache["v"][pg, row] = vc[:, 0]
    lengths = pos_vec + 1
    qg = qc.reshape(b, nkv, nh // nkv, hd)
    if ops.backend(device=x_i8.device) == "gpu":
        ctx = ops.paged_decode_attention_q(
            qg, cache["k"], cache["v"], block_tables, lengths, aq["M_idx"],
            aq["sh_idx"], _lut("q7", x_i8.device), aq["inv_s_logit"], aq["out_scale"])
    else:
        ctx = _gqa_decode(qg, _gather_view(cache["k"], block_tables),
                          _gather_view(cache["v"], block_tables), lengths, aq)
    ctx = ctx.reshape(b, s, nh * hd)
    return _lin(ctx, f["wo"], cfg.quant.w_bits)


def _paged_prefill_write(cache, kc, vc, block_tables):
    """Scatter a chunk's K/V rows (B, S, Hkv, hd) into the pool through the
    block table (S a whole number of pages, every entry a page the request
    owns; pad rows land inside owned pages and are masked or overwritten)."""
    psize = cache["k"].shape[1]
    b, s = kc.shape[0], kc.shape[1]
    nb = s // psize
    assert nb * psize == s and block_tables.shape[1] == nb, (s, psize, block_tables.shape)
    idx = block_tables.long()
    cache["k"][idx] = kc.reshape(b, nb, psize, *kc.shape[2:])
    cache["v"][idx] = vc.reshape(b, nb, psize, *vc.shape[2:])


def _attn_prefill_paged(x_i8, f, cfg, cache, pos, block_tables, pos0: int, pos0_vec,
                        row_exact):
    """Chunk prefill through the block table: queries at [pos0, pos0+S)
    write their K/V rows into the slot's pages, then attend over the slot's
    whole mapped chain (shared prefix pages, earlier chunks, this chunk).
    ``pos0_vec`` is ``pos0`` as a (B,) device vector."""
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    psize = cache["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos)
    aq = f["attn_q"]
    p0 = pos0 // psize
    _paged_prefill_write(cache, kc, vc, block_tables[:, p0:p0 + s // psize])
    if row_exact:
        k_view = _gather_view(cache["k"], block_tables)
        v_view = _gather_view(cache["v"], block_tables)
        qpos = pos0 + torch.arange(s, device=x_i8.device)[:, None]
        kpos = torch.arange(k_view.shape[1], device=x_i8.device)[None, :]
        ctx = _attn_rows_q8(qc, k_view, v_view, aq, cfg, kpos <= qpos).permute(0, 2, 1, 3)
    else:
        ctx = ops.paged_prefill_attention_q(
            qc.permute(0, 2, 1, 3), cache["k"], cache["v"], block_tables,
            pos0_vec, aq["M_idx"], aq["sh_idx"],
            _lut("q7", x_i8.device), aq["inv_s_logit"], aq["out_scale"]
        ).permute(0, 2, 1, 3)
    return _lin(ctx.reshape(b, s, nh * hd), f["wo"], cfg.quant.w_bits)


# --- ffn slot -----------------------------------------------------------------

def _mlp_int(x_i8, f, cfg):
    wb = cfg.quant.w_bits
    h = _ln(x_i8, f["ln2"], cfg)
    if cfg.act == "swiglu":
        g = _lut8(_lin(h, f["wg"], wb), f["silu_lut"])
        u = _lin(h, f["wu"], wb)
        prod = g.to(torch.int32) * u.to(torch.int32)           # int16-range
        hh = torch.clamp(fxp.rescale(prod, f["prod"]["M"], f["prod"]["sh"]),
                         -127, 127).to(torch.int8)
        return _lin(hh, f["wd"], wb)
    g = _lut8(_lin(h, f["w1"], wb), f["gelu_lut"])
    return _lin(_rescale_i8(g, f["gelu_rescale"]), f["w2"], wb)


# --- whole-model serving forward -----------------------------------------------

def paged_page_nbytes(cfg: ModelConfig, page_size: int, kv_bits: int = 8) -> int:
    """Device bytes one pool page occupies across every layer (K + V)."""
    hd = cfg.hd // 2 if kv_bits == 4 else cfg.hd
    per = 2 * page_size * cfg.n_kv_heads * hd
    if kv_bits == 4:
        per += 2 * 4
    return cfg.n_reps * len(slot_kinds(cfg)) * per


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, kv_bits: int = 8,
                     device="cuda") -> Dict:
    """Global paged KV pool, (n_reps, n_pages, P, Hkv, hd) int8 per attn slot."""
    check_ported(cfg)
    if kv_bits != 8:
        raise NotImplementedError("the int4-packed KV pool (kv_bits=4) is not ported: "
                                  "ROADMAP Open items §1")
    shape = (cfg.n_reps, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {f"slot{i}": {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                         "v": torch.zeros(shape, dtype=torch.int8, device=device)}
            for i in range(len(slot_kinds(cfg)))}


def layer_views(folded: Dict, n_reps: int):
    """Per-rep views of the stacked block params (cached by the engine)."""
    return folded.get("layers") or [tree_index(folded["blocks"], r) for r in range(n_reps)]


def head_weights(folded: Dict) -> torch.Tensor:
    """The lm_head's int4 codes as float32 (K, V), unpacked once."""
    head = folded["lm_head"]
    if "w_f" in head:
        return head["w_f"]
    return packing.unpack_int4_planar(head["w"], axis=0).to(torch.float32)


def prepare_folded(cfg: ModelConfig, folded: Dict) -> Dict:
    """A shallow copy of ``folded`` with the per-layer views and the
    unpacked lm_head cached, for a serving loop that runs many forwards."""
    out = dict(folded)
    out["layers"] = layer_views(folded, cfg.n_reps)
    out["lm_head"] = dict(folded["lm_head"], w_f=head_weights(folded))
    return out


def _embed_int(folded: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> int8 embedding codes (B, S, d)."""
    return folded["embed"]["tokens_i8"][tokens.long()]


def serve_forward(cfg: ModelConfig, folded: Dict, tokens: torch.Tensor, *,
                  cache: Optional[Dict] = None, pos_offset=0, mode: str = "prefill",
                  block_tables: Optional[torch.Tensor] = None, verify_rows=None,
                  extra_embeds_i8=None, pos3=None, tp_axis=None):
    """Integer forward.

    prefill without cache: tokens (B,S) -> logits (B,S,V).  prefill with the
    paged cache (``block_tables`` (B, max_blocks)): also writes the K/V rows
    of positions [pos_offset, pos_offset+S) — ``pos_offset`` a host int,
    page-aligned — into the pool in place.  decode: tokens (B,1) + cache ->
    logits; ``pos_offset`` a scalar or per-slot (B,) vector.  Returns
    (logits, cache).
    """
    check_ported(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode={mode!r} (speculative verify) is not ported: "
                                  "ROADMAP Open items §1")
    if verify_rows is not None or extra_embeds_i8 is not None or pos3 is not None \
            or tp_axis is not None:
        raise NotImplementedError("verify rows, extra embeddings, M-RoPE positions and "
                                  "tensor parallelism are not ported: ROADMAP Open items §1")
    if cache is not None and block_tables is None:
        raise NotImplementedError("the contiguous KV cache layout is not ported: "
                                  "ROADMAP Open items §1")
    if mode == "decode" and cache is None:
        raise ValueError("decode needs the paged cache and block tables")
    dev = tokens.device
    x = _embed_int(folded, tokens)
    b, s = x.shape[0], x.shape[1]
    pos_vec = _pos_vector(pos_offset, b, dev)
    pos0 = int(pos_offset) if mode == "prefill" else None
    if cfg.learned_pos:
        pos_i8 = folded["embed"]["pos_i8"]
        posrow = pos_i8[pos_vec.long()][:, None] if mode == "decode" \
            else pos_i8[pos0:pos0 + s][None]
        x = torch.clamp(x.to(torch.int32) + posrow.to(torch.int32), -127, 127).to(torch.int8)
    pos = None if mode == "decode" else \
        (pos0 + torch.arange(s, dtype=torch.int32, device=dev)).expand(b, s)
    kinds = slot_kinds(cfg)
    row_exact = ops.backend(device=dev) != "gpu"
    for r, f_rep in enumerate(layer_views(folded, cfg.n_reps)):
        for i, (_, ffn) in enumerate(kinds):
            f = f_rep[f"slot{i}"]
            cslot = None if cache is None else \
                {k: v[r] for k, v in cache[f"slot{i}"].items()}
            if mode == "decode":
                out = _attn_decode_paged(x, f, cfg, cslot, pos_vec, block_tables)
            elif cslot is not None:
                out = _attn_prefill_paged(x, f, cfg, cslot, pos, block_tables, pos0,
                                          pos_vec, row_exact)
            else:
                out = _attn_prefill(x, f, cfg, pos)
            x = _resid_add(x, f["res_a"], out)
            if ffn == "dense":
                x = _resid_add(x, f["res_m"], _mlp_int(x, f, cfg))
        x = _rescale_i8(x, f_rep["block_out_rescale"])
    x = _ln(x, folded["final_norm"], cfg)
    # lm_head: the only product outside a kernel.  Every partial sum is an
    # integer below 2^24 (|x| <= 127, |w| <= 7, K <= 4096 * ...), so the
    # float32 product is exact (TF32 must stay off on the card).
    acc = torch.matmul(x.to(torch.float32), head_weights(folded))
    return acc * folded["lm_head"]["inv_acc"], cache
