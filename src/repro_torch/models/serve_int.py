"""Integer serving forward over the folded params: cache-less prefill,
chunk prefill into the paged KV pool (int8, or int4-packed at ``kv_bits=4``),
single-token paged decode and the speculative verify forward (``mode=
"verify"``, int8 pool), and the contiguous per-slot stripe (one-shot
prefill, single-token decode) that the lockstep engine and
``cache_layout="contiguous"`` use.

The paper's deployment datapath: int8 activations end to end, packed-int4
(or int8, ``w_bits=8``) weights, LUT softmax, integer LN, int8 KV pool, with
one float island (the RoPE rotation) and the fp32 ``lm_head`` scale.
Mirrors the reference ``models/serve_int.py`` for all-attention dense archs,
causal (yi-6b) and bidirectional (BERT, cache-less prefill only); every
other branch raises ``NotImplementedError``.

Backends (``kernels/ops.py``): on ``ref`` the cached forwards take the
row-exact q8 datapath (``_attn_rows_q8`` / ``_gqa_decode``), bit for bit the
reference's ``ref`` backend; on ``gpu`` they take the q7 kernels (paged
decode and prefill, their int4-packed twins, the contiguous decode; the
verify forward is the paged prefill kernel at a per-slot ``pos0``), as the
reference's ``pallas`` backend does.  The kv4 chunk prefill takes the q7
packed family on every backend, as in the reference.  The cache-less causal
prefill takes the blocked flash (``ops.flash_attention_q``: its plain
version on ``ref``, the ``flash_qattention`` kernel on ``gpu``), and so does
the contiguous one-shot prefill on ``gpu``; the bidirectional one the row
softmax (``ops.softmax_q``), the kernel on ``gpu``.

Unlike the functional reference, the caches are updated IN PLACE (the
returned cache is the same dict of tensors): at full width a copy of the
pool per layer would cost more than the layer.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixedpoint as fxp
from repro_torch.core import packing
from repro_torch.core import quant as q
from repro_torch.core.qlayernorm import QLNParams
from repro_torch.core.qlinear import FoldedLinear
from repro_torch.core.qsoftmax import MASK_OFFSET, make_exp_lut
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_qattention import divisor_tile
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
    ``mask`` is bool or None: (S, Skv) shared across the batch, or (B, S,
    Skv) per slot (the verify forward's per-slot causal frontiers)."""
    group = cfg.n_heads // cfg.n_kv_heads
    kg = kc.repeat_interleave(group, dim=2)
    vg = vc.repeat_interleave(group, dim=2)
    scores = kref.int_matmul(qc.permute(0, 2, 1, 3), kg.permute(0, 2, 3, 1))  # (B,H,S,Skv)
    if mask is not None:
        mask = mask[:, None] if mask.dim() == 3 else mask[None, None]
        scores = torch.where(mask, scores, scores - MASK_OFFSET)
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


def _attn_prefill(x_i8, f, cfg, pos, row_exact: bool = False):
    """Whole-sequence prefill from position 0: the cache-less evaluation
    path, and the one-shot prefill into the contiguous stripe, whose rows
    must continue bit-exactly into decode on ``ref`` (``row_exact``: the
    decode datapath's q8 rows under a causal mask).  Returns (out, kc, vc)."""
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos)
    aq = f["attn_q"]
    if cfg.causal and row_exact:
        idx = torch.arange(s, device=x_i8.device)
        ctx = _attn_rows_q8(qc, kc, vc, aq, cfg, idx[None, :] <= idx[:, None])
    elif cfg.causal:
        # the kernel reads the (B, S, H, D) projections in place and writes
        # ctx in q's layout, so the transposes below are views
        ctx = ops.flash_attention_q(
            qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), aq["M_idx"],
            aq["sh_idx"], _lut("q7", x_i8.device), aq["inv_s_logit"], aq["out_scale"],
            bkv=divisor_tile(512, s))                              # (B,H,S,D)
    else:
        # bidirectional (BERT): paper-style row LUT softmax, materialized
        ctx = _attn_rows_q8(qc, kc, vc, aq, cfg, None)
    ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
    return _lin(ctx, f["wo"], cfg.quant.w_bits), kc, vc


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


def _attn_decode(x_i8, f, cfg, cache, pos_vec):
    """Decode step over the contiguous stripe: x (B,1,d); cache {'k','v'}:
    (B, Smax, Hkv, hd) int8.  Each slot appends its row at its own position,
    then attends over its first ``pos + 1`` rows: on ``gpu`` through the
    contiguous decode kernel in blocks of ``divisor_tile(512, Smax)`` keys,
    on ``ref`` through the row-exact q8 rows."""
    b, s, _ = x_i8.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    smax = cache["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos_vec[:, None])
    aq = f["attn_q"]
    slot = torch.arange(b, device=x_i8.device)
    cache["k"][slot, pos_vec.long()] = kc[:, 0]
    cache["v"][slot, pos_vec.long()] = vc[:, 0]
    lengths = pos_vec + 1
    qg = qc.reshape(b, nkv, nh // nkv, hd)
    if ops.backend(device=x_i8.device) == "gpu":
        ctx = ops.decode_attention_q(
            qg, cache["k"], cache["v"], lengths, aq["M_idx"], aq["sh_idx"],
            _lut("q7", x_i8.device), aq["inv_s_logit"], aq["out_scale"],
            bkv=divisor_tile(512, smax))
    else:
        ctx = _gqa_decode(qg, cache["k"], cache["v"], lengths, aq)
    return _lin(ctx.reshape(b, s, nh * hd), f["wo"], cfg.quant.w_bits)


def _is_kv4(cslot) -> bool:
    """Packed int4 pool slots carry per-page scale leaves ('ks'/'vs')."""
    return "ks" in cslot


def _gather_view(pool, block_tables):
    """(B, max_blocks*P, Hkv, hd) slot-major view of the chain (ref path)."""
    b = block_tables.shape[0]
    return pool[block_tables.long()].reshape(b, -1, pool.shape[2], pool.shape[3])


def _dequant_paged_view(pool_u8, scales, block_tables):
    """The slot-major view of a PACKED chain, dequantized: (B, max_blocks*P,
    Hkv, hd) int8 (ref path; the kernels dequantize page by page)."""
    idx = block_tables.long().reshape(-1)
    pages = packing.dequantize_kv_pool(pool_u8[idx], scales[idx])    # (B*nb, P, Hkv, hd)
    return pages.reshape(block_tables.shape[0], -1, pages.shape[2], pages.shape[3])


def _attn_decode_paged(x_i8, f, cfg, cache, pos_vec, block_tables):
    """Paged decode step: x (B,1,d); cache {'k','v'}: (n_pages, P, Hkv, hd)
    int8, or (n_pages, P, Hkv, hd/2) uint8 with 'ks'/'vs' (n_pages,) fp32
    page scales at kv_bits=4.  The token's K/V row is written through the
    slot's block table (page = table[b, pos // P], row = pos % P; inactive
    slots, whose table rows are zero, write into the reserved trash page 0),
    then attention reads the pool through the table.

    kv4: the row that opens a page (row 0) sets the page's scale from its
    own codes; later rows quantize under the page's existing scale, so rows
    written earlier keep dequantizing to the same codes."""
    b, s, _ = x_i8.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    psize = cache["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos_vec[:, None])
    aq = f["attn_q"]
    pos_l = pos_vec.long()
    pg = torch.gather(block_tables.long(), 1, (pos_l // psize)[:, None])[:, 0]
    row = pos_l % psize
    kv4 = _is_kv4(cache)
    if kv4:
        for c, sc, rows in (("k", "ks", kc[:, 0]), ("v", "vs", vc[:, 0])):
            scale = torch.where(row == 0, packing.kv_page_scale(rows, dims=(1, 2)),
                                cache[sc][pg])
            cache[c][pg, row] = packing.quantize_kv_page(rows, scale[:, None, None])
            cache[sc][pg] = scale
    else:
        cache["k"][pg, row] = kc[:, 0]
        cache["v"][pg, row] = vc[:, 0]
    lengths = pos_vec + 1
    qg = qc.reshape(b, nkv, nh // nkv, hd)
    scal = (aq["M_idx"], aq["sh_idx"], _lut("q7", x_i8.device), aq["inv_s_logit"],
            aq["out_scale"])
    if ops.backend(device=x_i8.device) == "gpu":
        if kv4:
            ctx = ops.paged_decode_attention_q4(qg, cache["k"], cache["v"], cache["ks"],
                                                cache["vs"], block_tables, lengths, *scal)
        else:
            ctx = ops.paged_decode_attention_q(qg, cache["k"], cache["v"], block_tables,
                                               lengths, *scal)
    elif kv4:
        ctx = _gqa_decode(qg, _dequant_paged_view(cache["k"], cache["ks"], block_tables),
                          _dequant_paged_view(cache["v"], cache["vs"], block_tables),
                          lengths, aq)
    else:
        ctx = _gqa_decode(qg, _gather_view(cache["k"], block_tables),
                          _gather_view(cache["v"], block_tables), lengths, aq)
    ctx = ctx.reshape(b, s, nh * hd)
    return _lin(ctx, f["wo"], cfg.quant.w_bits)


def _paged_prefill_write(cache, kc, vc, block_tables):
    """Scatter a chunk's K/V rows (B, S, Hkv, hd) into the pool through the
    block table (S a whole number of pages, every entry a page the request
    owns; pad rows land inside owned pages and are masked or overwritten).
    kv4: each written page is quantized under ONE scale from its whole
    (P, Hkv, hd) codes, and the scale leaves update with the payload."""
    psize = cache["k"].shape[1]
    b, s = kc.shape[0], kc.shape[1]
    nb = s // psize
    assert nb * psize == s and block_tables.shape[1] == nb, (s, psize, block_tables.shape)
    idx = block_tables.long()
    for c, rows in (("k", kc), ("v", vc)):
        pages = rows.reshape(b, nb, psize, *rows.shape[2:])
        if _is_kv4(cache):
            scale = packing.kv_page_scale(pages, dims=(2, 3, 4))           # (B, nb)
            cache[c][idx] = packing.quantize_kv_page(pages, scale[:, :, None, None, None])
            cache[c + "s"][idx] = scale
        else:
            cache[c][idx] = pages


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
    scal = (aq["M_idx"], aq["sh_idx"], _lut("q7", x_i8.device), aq["inv_s_logit"],
            aq["out_scale"])
    # the paged kernels read the (B, S, H, D) projections in place and write
    # ctx in q's layout, so on the card the permutes below are views
    if _is_kv4(cache):
        # kv4 takes the q7 packed family on every backend, as the reference
        # does: a decode-written page's scale comes from its first row, a
        # prefill-written page's from the whole page, so no row-exact
        # identity between the two holds anyway
        ctx = ops.paged_prefill_attention_q4(
            qc.permute(0, 2, 1, 3), cache["k"], cache["v"], cache["ks"], cache["vs"],
            block_tables, pos0_vec, *scal).permute(0, 2, 1, 3)
    elif row_exact:
        k_view = _gather_view(cache["k"], block_tables)
        v_view = _gather_view(cache["v"], block_tables)
        qpos = pos0 + torch.arange(s, device=x_i8.device)[:, None]
        kpos = torch.arange(k_view.shape[1], device=x_i8.device)[None, :]
        ctx = _attn_rows_q8(qc, k_view, v_view, aq, cfg, kpos <= qpos).permute(0, 2, 1, 3)
    else:
        ctx = ops.paged_prefill_attention_q(
            qc.permute(0, 2, 1, 3), cache["k"], cache["v"], block_tables, pos0_vec, *scal
        ).permute(0, 2, 1, 3)
    return _lin(ctx.reshape(b, s, nh * hd), f["wo"], cfg.quant.w_bits)


def _verify_index(pos_vec, n_rows, block_tables, psize: int, s: int):
    """Where the verify forward's columns sit: per slot ``b`` and column
    ``j``, the position ``pos_vec[b] + j`` and the (page, row) its K/V row
    is written to, (B, S) each.  Columns at or past ``n_rows[b]`` are
    padding and go to row 0 of the trash page 0.  A padding column's
    position may lie past the block table: the reference's gather fills such
    entries and its ``where`` then discards them, torch's gather would
    raise, so the table index is clamped first."""
    cols = torch.arange(s, dtype=torch.int32, device=pos_vec.device)
    positions = pos_vec[:, None] + cols[None, :]
    valid = cols[None, :] < n_rows[:, None]
    blk = torch.clamp(positions.long() // psize, max=block_tables.shape[1] - 1)
    pg = torch.where(valid, torch.gather(block_tables.long(), 1, blk), 0)
    row = torch.where(valid, positions.long() % psize, 0)
    return positions, pg, row


def _attn_verify_paged(x_i8, f, cfg, cache, pos_vec, positions, pg, row, block_tables,
                       row_exact):
    """Speculative verify: S = k+1 candidate rows per slot in one forward,
    row 0 the slot's last committed token at its decode cursor
    ``pos_vec[b]``, rows 1..k its draft proposals (``_verify_index`` gives
    ``positions`` and the (``pg``, ``row``) write targets).  The K/V rows
    scatter per (page, row) like the decode step's (the positions are not
    page-aligned); real columns past the slot's accepted prefix leave rows
    above its cursor that the causal masks hide until the cursor reaches
    them and the owner rewrites them.  Attention reads the slot's whole
    chain, row i of slot b up to position ``pos_vec[b] + i``: on ``ref``
    the row-exact q8 rows under a per-slot causal mask (row i equals the
    decode step at that position bit for bit), on ``gpu`` the paged prefill
    kernel with ``pos_vec`` as its per-slot ``pos0``.  The int8 pool only,
    as in the reference (M-RoPE archs are refused by ``check_ported``)."""
    if _is_kv4(cache):
        raise NotImplementedError("speculative verify serves the int8 pool only (spec x kv4: "
                                  "not in the reference either)")
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, positions)
    aq = f["attn_q"]
    cache["k"][pg, row] = kc
    cache["v"][pg, row] = vc
    if row_exact:
        k_view = _gather_view(cache["k"], block_tables)
        v_view = _gather_view(cache["v"], block_tables)
        kpos = torch.arange(k_view.shape[1], device=x_i8.device)
        ctx = _attn_rows_q8(qc, k_view, v_view, aq, cfg,
                            kpos[None, None, :] <= positions[:, :, None]).permute(0, 2, 1, 3)
    else:
        ctx = ops.paged_prefill_attention_q(
            qc.permute(0, 2, 1, 3), cache["k"], cache["v"], block_tables, pos_vec,
            aq["M_idx"], aq["sh_idx"], _lut("q7", x_i8.device), aq["inv_s_logit"],
            aq["out_scale"]).permute(0, 2, 1, 3)
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
    """Global paged KV pool, (n_reps, n_pages, P, Hkv, hd) int8 per attn slot.

    ``kv_bits=4``: (n_reps, n_pages, P, Hkv, hd/2) uint8, nibble-planar along
    hd (half the bytes), plus per-page fp32 scale leaves 'ks'/'vs' of shape
    (n_reps, n_pages), all at the all-zero page's scale float32(1/7) (so the
    trash page dequantizes to exact zeros)."""
    check_ported(cfg)
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4 (got {kv_bits})")
    hd = cfg.hd // 2 if kv_bits == 4 else cfg.hd
    dtype = torch.uint8 if kv_bits == 4 else torch.int8
    shape = (cfg.n_reps, n_pages, page_size, cfg.n_kv_heads, hd)
    cache = {}
    for i in range(len(slot_kinds(cfg))):
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
        if kv_bits == 4:
            for sc in ("ks", "vs"):
                c[sc] = torch.full((cfg.n_reps, n_pages), q.recip_f32(packing.KV4_QMAX),
                                   dtype=torch.float32, device=device)
        cache[f"slot{i}"] = c
    return cache


def cache_rows(cfg: ModelConfig, max_len: int) -> int:
    """KV rows per slot of the contiguous stripe (a sliding-window arch
    would ring-buffer to its window)."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Dict:
    """The contiguous stripe: (n_reps, batch, Smax, Hkv, hd) int8 K and V per
    attention slot."""
    check_ported(cfg)
    shape = (cfg.n_reps, batch, cache_rows(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {f"slot{i}": {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                         "v": torch.zeros(shape, dtype=torch.int8, device=device)}
            for i in range(len(slot_kinds(cfg)))}


def layer_views(folded: Dict, n_reps: int):
    """Per-rep views of the stacked block params (cached by the engine)."""
    return folded.get("layers") or [tree_index(folded["blocks"], r) for r in range(n_reps)]


def head_dtype(cfg: ModelConfig) -> torch.dtype:
    """The float type in which the lm_head's integer product is exact.

    Every partial sum of ``x_i8 @ w`` is an integer of magnitude at most
    d_model * 127 * qmax(w_bits); float32 holds every such integer while
    that stays below 2^24 (BERT-base at w8: 768 * 127 * 127 = 12.4 M; yi-6b
    at w4: 4096 * 127 * 7 = 3.6 M) and float64 far beyond (yi-6b at w8:
    66 M)."""
    bound = cfg.d_model * 127 * q.qmax(cfg.quant.w_bits)
    return torch.float32 if bound < 2**24 else torch.float64


def head_weights(cfg: ModelConfig, folded: Dict) -> torch.Tensor:
    """The lm_head's codes (int8 at w8, unpacked int4 otherwise) as a
    (K, V) tensor of ``head_dtype``, converted once."""
    head = folded["lm_head"]
    if "w_f" in head:
        return head["w_f"]
    w = head["w"] if cfg.quant.w_bits == 8 else packing.unpack_int4_planar(head["w"], axis=0)
    return w.to(head_dtype(cfg))


def prepare_folded(cfg: ModelConfig, folded: Dict) -> Dict:
    """A shallow copy of ``folded`` with the per-layer views and the
    converted lm_head cached, for a serving loop that runs many forwards."""
    out = dict(folded)
    out["layers"] = layer_views(folded, cfg.n_reps)
    out["lm_head"] = dict(folded["lm_head"], w_f=head_weights(cfg, folded))
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
    page-aligned — into the pool in place.  prefill with the contiguous
    stripe (no ``block_tables``): writes rows [0, S) of every slot, from
    position 0.  decode: tokens (B,1) + either cache -> logits;
    ``pos_offset`` a scalar or per-slot (B,) vector.  verify (the paged
    int8 pool only): tokens (B, k+1), each slot's last committed token and
    its draft proposals; ``pos_offset`` the per-slot (B,) decode cursor and
    ``verify_rows`` (B,) each slot's real row count (the rest is padding);
    logits for every row, (B, k+1, V), row i what the decode step at
    position ``pos_offset[b] + i`` gives (``_attn_verify_paged``).  Returns
    (logits, cache).
    """
    check_ported(cfg)
    if mode not in ("prefill", "decode", "verify"):
        raise ValueError(f"mode must be prefill|decode|verify (got {mode!r})")
    if extra_embeds_i8 is not None or pos3 is not None or tp_axis is not None:
        raise NotImplementedError("extra embeddings, M-RoPE positions and tensor parallelism "
                                  "are not ported: ROADMAP Open items §1")
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a KV cache")
    if mode == "verify" and (cache is None or block_tables is None or verify_rows is None):
        raise ValueError("verify mode needs a paged cache, block tables and verify_rows")
    if mode == "prefill" and cache is not None and block_tables is None \
            and int(pos_offset) != 0:
        raise ValueError("a prefill into the contiguous stripe starts at position 0")
    dev = tokens.device
    x = _embed_int(folded, tokens)
    b, s = x.shape[0], x.shape[1]
    pos_vec = _pos_vector(pos_offset, b, dev)
    pos0 = int(pos_offset) if mode == "prefill" else None
    if mode == "verify":
        vidx = _verify_index(pos_vec, _pos_vector(verify_rows, b, dev), block_tables,
                             cache["slot0"]["k"].shape[2], s)
    if cfg.learned_pos:
        pos_i8 = folded["embed"]["pos_i8"]
        if mode == "prefill":
            posrow = pos_i8[pos0:pos0 + s][None]
        else:   # a padding verify column may sit past the table: clamped, then unused
            grid = pos_vec[:, None] + torch.arange(s, dtype=torch.int32, device=dev)
            posrow = pos_i8[torch.clamp(grid.long(), max=pos_i8.shape[0] - 1)]
        x = torch.clamp(x.to(torch.int32) + posrow.to(torch.int32), -127, 127).to(torch.int8)
    pos = None if mode != "prefill" else \
        (pos0 + torch.arange(s, dtype=torch.int32, device=dev)).expand(b, s)
    kinds = slot_kinds(cfg)
    row_exact = ops.backend(device=dev) != "gpu"
    for r, f_rep in enumerate(layer_views(folded, cfg.n_reps)):
        for i, (_, ffn) in enumerate(kinds):
            f = f_rep[f"slot{i}"]
            cslot = None if cache is None else \
                {k: v[r] for k, v in cache[f"slot{i}"].items()}
            if mode == "verify":
                out = _attn_verify_paged(x, f, cfg, cslot, pos_vec, *vidx, block_tables,
                                         row_exact)
            elif mode == "decode" and block_tables is not None:
                out = _attn_decode_paged(x, f, cfg, cslot, pos_vec, block_tables)
            elif mode == "decode":
                out = _attn_decode(x, f, cfg, cslot, pos_vec)
            elif cslot is not None and block_tables is not None:
                out = _attn_prefill_paged(x, f, cfg, cslot, pos, block_tables, pos0,
                                          pos_vec, row_exact)
            else:
                # cache-less, or the one-shot prefill into the contiguous
                # stripe (row-exact on ref, so decode continues bit-exactly)
                out, kc, vc = _attn_prefill(x, f, cfg, pos,
                                            row_exact=cslot is not None and row_exact)
                if cslot is not None:
                    cslot["k"][:, :s] = kc
                    cslot["v"][:, :s] = vc
            x = _resid_add(x, f["res_a"], out)
            if ffn == "dense":
                x = _resid_add(x, f["res_m"], _mlp_int(x, f, cfg))
        x = _rescale_i8(x, f_rep["block_out_rescale"])
    x = _ln(x, folded["final_norm"], cfg)
    # lm_head: the only product outside a kernel, exact in head_dtype (TF32
    # must stay off on the card); then the reference's int32 -> float32
    # accumulator times the float32 scale.
    w = head_weights(cfg, folded)
    acc = torch.matmul(x.to(w.dtype), w).to(torch.float32)
    return acc * folded["lm_head"]["inv_acc"], cache
