"""Integer serving forward over the folded params: cache-less prefill,
chunk prefill into the paged KV pool (int8, or int4-packed at ``kv_bits=4``),
single-token paged decode and the speculative verify forward (``mode=
"verify"``, int8 pool), and the contiguous per-slot stripe (one-shot
prefill, single-token decode) that the lockstep engine and
``cache_layout="contiguous"`` use.

The paper's deployment datapath: int8 activations end to end, packed-int4
(or int8, ``w_bits=8``) weights, LUT softmax, integer LN, int8 KV pool, with
float islands: the RoPE rotation (with qk-norm's RMSNorm before it), the
MoE router and combine, the fp32 ``lm_head`` scale, and the recurrent
mixers' cores.  Mirrors the reference ``models/serve_int.py`` for every
arch of ``configs/``: attention with a dense or MoE feed-forward, causal
(yi-6b, qwen3-4b, qwen2-moe-a2.7b, ...; with a sliding window,
mixtral-8x22b, on the contiguous stripe as a window-sized ring; with
M-RoPE and the vision stub's embeddings prepended, qwen2-vl-2b; with four
summed codebooks in and four LM heads out, musicgen-medium) and
bidirectional (BERT, cache-less prefill only); and the recurrent slots of
jamba's Mamba hybrid and of xLSTM (``mamba_float`` / ``xlstm_float``:
weight-only int4 projections on float activations, a float32 core, the
output requantized onto the residual grid), whose state lives in the
contiguous cache and advances one decode step at a time.  With a
tensor-parallel mesh (``mesh=``, the paged pool only) the pool is one shard
per rank over its KV heads and each rank attends its heads on its device.
A MoE slot makes one ``int4_matmul`` launch per expert and linear (the
reference ``vmap``s them).

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
pool per layer would cost more than the layer.  So are recurrent states,
through the views the engine hands over (one slot of one rep).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

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
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as Moe
from repro_torch.models import xlstm as Xl
from repro_torch.models.transformer import slot_kinds, tree_index

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


@contextlib.contextmanager
def ieee_fp32(device):
    """Full float32 matmuls (TF32 off) on the card for the body, whatever the
    process-wide precision; the caller's setting is restored afterwards.
    PyTorch's ``fp32_precision`` API where it exists (mixing it with the
    legacy flags raises)."""
    if torch.device(device).type != "cuda":
        yield
        return
    mm = torch.backends.cuda.matmul
    new_api = hasattr(mm, "fp32_precision")
    prev = mm.fp32_precision if new_api else torch.get_float32_matmul_precision()
    if new_api:
        mm.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if new_api:
            mm.fp32_precision = prev
        else:
            torch.set_float32_matmul_precision(prev)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 (or float64) whatever the process-wide
    matmul precision (``ieee_fp32``).  The lm_head's product is exact only
    so (every partial sum an integer below 2^24)."""
    with ieee_fp32(a.device):
        return torch.matmul(a, b)


def wonly_weight(f: Dict) -> torch.Tensor:
    """A weight-only linear's float32 weight, ``codes * inv_s_w`` (cached
    under ``w_f`` by ``prepare_folded``)."""
    if "w_f" in f:
        return f["w_f"]
    return packing.unpack_int4_planar(f["w"], axis=0).to(torch.float32) * f["inv_s_w"]


def _lin_wonly(x_f, f):
    """Weight-only int4 linear on float activations (the SSM islands):
    ``x_f @ (codes * inv_s_w)`` (+ b), in that order, with TF32 off."""
    y = exact_matmul(x_f, wonly_weight(f))
    return y + f["b"] if "b" in f else y


def _rope_island(h_i8, inv_s_in, s_out, pos, cfg, qn=None):
    """dequant -> (qk-norm: RMSNorm with gamma ``qn``) -> rotate -> requant.
    (B,S,H,D) int8.  ``pos`` (B, S), or (B, S, 3) on an M-RoPE arch, where
    (B, S) positions rotate all three streams alike (a decode step's, as
    the reference's ``_decode_qkv`` broadcasts them)."""
    hf = h_i8.to(torch.float32) * inv_s_in
    if qn is not None:
        hf = L.rmsnorm_xla(hf, qn)
    if cfg.mrope_sections is not None:
        pos3 = pos if pos.dim() == 3 else pos[..., None].expand(*pos.shape, 3)
        hf = L.apply_mrope(hf, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif not cfg.learned_pos:
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
    qc = _rope_island(qc, aq["inv_s_qp"], aq["s_q"], pos, cfg, aq.get("qn"))
    kc = _rope_island(kc, aq["inv_s_kp"], aq["s_k"], pos, cfg, aq.get("kn"))
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
        live = idx[None, :] <= idx[:, None]
        if cfg.sliding_window:
            live &= idx[None, :] > idx[:, None] - cfg.sliding_window
        ctx = _attn_rows_q8(qc, kc, vc, aq, cfg, live)
    elif cfg.causal:
        # the kernel reads the (B, S, H, D) projections in place and writes
        # ctx in q's layout, so the transposes below are views
        ctx = ops.flash_attention_q(
            qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), aq["M_idx"],
            aq["sh_idx"], _lut("q7", x_i8.device), aq["inv_s_logit"], aq["out_scale"],
            bkv=divisor_tile(512, s), window=cfg.sliding_window)   # (B,H,S,D)
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
    (B, Smax, Hkv, hd) int8.  Each slot writes its row at its own position
    (at ``pos % Smax`` for a sliding-window arch, whose stripe is a ring of
    the window's rows), then attends over its first ``pos + 1`` rows (the
    whole ring once it has wrapped; it then holds exactly the keys inside
    the window, in ring order, as the reference walks them): on ``gpu``
    through the contiguous decode kernel in blocks of ``divisor_tile(512,
    Smax)`` keys, on ``ref`` through the row-exact q8 rows."""
    b, s, _ = x_i8.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    smax = cache["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos_vec[:, None])
    aq = f["attn_q"]
    slot = torch.arange(b, device=x_i8.device)
    row = (pos_vec % smax if cfg.sliding_window else pos_vec).long()
    cache["k"][slot, row] = kc[:, 0]
    cache["v"][slot, row] = vc[:, 0]
    lengths = torch.clamp(pos_vec + 1, max=smax) if cfg.sliding_window else pos_vec + 1
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


def _on(aq: Dict, dev) -> Dict:
    """The attention scalars ``aq`` on ``dev``."""
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in aq.items()}


def _q7_scalars(aq: Dict, dev):
    return (aq["M_idx"], aq["sh_idx"], _lut("q7", dev), aq["inv_s_logit"], aq["out_scale"])


def _over_ranks(cfg, mesh, cache, qc, kc, vc, aq, attend):
    """``attend(pool, q, k, v, aq, dev) -> ctx`` (B, S, heads, hd) int8, once
    over the unsharded pool with every head (``mesh`` None), or once per rank
    of a tensor-parallel ``mesh`` on the rank's shard of the pool with the
    rank's contiguous block of heads: q (B, S, H, hd) in blocks of
    G * Hkv/tp heads and k/v (B, S, Hkv, hd) in blocks of Hkv/tp, so each
    rank's GQA groups stay whole, moved with ``aq`` to the rank's device
    (no copy where it is the caller's).  Each pool is checked to hold the
    heads its rank owns, on its device, so a shard is never written through
    the unsharded path.  The contexts are concatenated in rank order, which
    is head order, on the caller's device: int8 codes move, nothing is
    recomputed or re-rounded.  Returns (B, S, H, hd)."""
    if mesh is None:
        _check_pool(cache, cfg.n_kv_heads, qc.device)
        return attend(cache, qc, kc, vc, aq, qc.device)
    nkv, nh = cfg.n_kv_heads // mesh.size, cfg.n_heads // mesh.size
    parts = []
    for r, (dev, pool) in enumerate(zip(mesh.devices, cache, strict=True)):
        _check_pool(pool, nkv, dev)
        q, k, v = (t[:, :, r * n:(r + 1) * n].to(dev)
                   for t, n in ((qc, nh), (kc, nkv), (vc, nkv)))
        ctx = attend(pool, q, k, v, aq if dev == qc.device else _on(aq, dev), dev)
        parts.append(ctx.to(qc.device))
    return torch.cat(parts, dim=2)


def _first(cache, mesh):
    """The unsharded pool, or rank 0's shard: what the pool's layout is read
    from."""
    return cache if mesh is None else cache[0]


def _check_pool(pool: Dict, hkv: int, dev):
    k = pool["k"]
    if k.shape[-2] != hkv or k.device != dev:
        raise ValueError(f"a pool of {k.shape[-2]} KV heads on {k.device} where the rank owns "
                         f"{hkv} on {dev}")


def _attn_decode_paged(x_i8, f, cfg, cache, pos_vec, block_tables, mesh=None):
    """Paged decode step: x (B,1,d); cache {'k','v'}: (n_pages, P, Hkv, hd)
    int8, or (n_pages, P, Hkv, hd/2) uint8 with 'ks'/'vs' (n_pages,) fp32
    page scales at kv_bits=4.  The token's K/V row is written through the
    slot's block table (page = table[b, pos // P], row = pos % P; inactive
    slots, whose table rows are zero, write into the reserved trash page 0),
    then attention reads the pool through the table.  Under a tensor-parallel
    ``mesh`` ``cache`` is the per-rank list of shards, each written and read
    by its rank's heads (``_over_ranks``).

    kv4: the row that opens a page (row 0) sets the page's scale from its
    own codes, all heads of them (computed before the heads are split, so
    every rank's replica of the scale agrees); later rows quantize under the
    page's existing scale, so rows written earlier keep dequantizing to the
    same codes."""
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    kv4, psize = _is_kv4(_first(cache, mesh)), _first(cache, mesh)["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos_vec[:, None])
    pos_l = pos_vec.long()
    pg = torch.gather(block_tables.long(), 1, (pos_l // psize)[:, None])[:, 0]
    row = pos_l % psize
    lengths = pos_vec + 1
    fresh = {"k": packing.kv_page_scale(kc[:, 0], dims=(1, 2)),
             "v": packing.kv_page_scale(vc[:, 0], dims=(1, 2))} if kv4 else None

    def attend(c, q, k, v, aq, dev):
        pg_, row_, btab, lens = (t.to(dev) for t in (pg, row, block_tables, lengths))
        for name, rows in (("k", k[:, 0]), ("v", v[:, 0])):
            if kv4:
                sc = name + "s"
                scale = torch.where(row_ == 0, fresh[name].to(dev), c[sc][pg_])
                c[name][pg_, row_] = packing.quantize_kv_page(rows, scale[:, None, None])
                c[sc][pg_] = scale
            else:
                c[name][pg_, row_] = rows
        qg = q.reshape(b, c["k"].shape[2], -1, hd)
        if ops.backend(device=dev) == "gpu":
            if kv4:
                ctx = ops.paged_decode_attention_q4(qg, c["k"], c["v"], c["ks"], c["vs"], btab,
                                                    lens, *_q7_scalars(aq, dev))
            else:
                ctx = ops.paged_decode_attention_q(qg, c["k"], c["v"], btab, lens,
                                                   *_q7_scalars(aq, dev))
        elif kv4:
            ctx = _gqa_decode(qg, _dequant_paged_view(c["k"], c["ks"], btab),
                              _dequant_paged_view(c["v"], c["vs"], btab), lens, aq)
        else:
            ctx = _gqa_decode(qg, _gather_view(c["k"], btab), _gather_view(c["v"], btab),
                              lens, aq)
        return ctx.reshape(b, s, -1, hd)

    ctx = _over_ranks(cfg, mesh, cache, qc, kc, vc, f["attn_q"], attend)
    return _lin(ctx.reshape(b, s, nh * hd), f["wo"], cfg.quant.w_bits)


def _page_scales(kc, vc, psize: int) -> Dict:
    """kv4: the scale of each page a chunk writes, from its whole (P, Hkv,
    hd) codes, (B, S/P) for K and V; computed on every head before any
    split, so the ranks' replicas agree."""
    b, s = kc.shape[0], kc.shape[1]
    return {c: packing.kv_page_scale(t.reshape(b, s // psize, psize, *t.shape[2:]),
                                     dims=(2, 3, 4)) for c, t in (("k", kc), ("v", vc))}


def _paged_prefill_write(cache, kc, vc, block_tables, scales=None):
    """Scatter a chunk's K/V rows (B, S, Hkv, hd) into the pool through the
    block table (S a whole number of pages, every entry a page the request
    owns; pad rows land inside owned pages and are masked or overwritten).
    kv4: each written page is quantized under its scale from ``scales``
    (``_page_scales``), and the scale leaves update with the payload."""
    psize = cache["k"].shape[1]
    b, s = kc.shape[0], kc.shape[1]
    nb = s // psize
    assert nb * psize == s and block_tables.shape[1] == nb, (s, psize, block_tables.shape)
    idx = block_tables.long()
    for c, rows in (("k", kc), ("v", vc)):
        pages = rows.reshape(b, nb, psize, *rows.shape[2:])
        if _is_kv4(cache):
            scale = scales[c]
            cache[c][idx] = packing.quantize_kv_page(pages, scale[:, :, None, None, None])
            cache[c + "s"][idx] = scale
        else:
            cache[c][idx] = pages


def _attn_prefill_paged(x_i8, f, cfg, cache, pos, block_tables, pos0: int, pos0_vec,
                        row_exact, mesh=None):
    """Chunk prefill through the block table: queries at [pos0, pos0+S)
    write their K/V rows into the slot's pages, then attend over the slot's
    whole mapped chain (shared prefix pages, earlier chunks, this chunk).
    ``pos0_vec`` is ``pos0`` as a (B,) device vector.  Under a
    tensor-parallel ``mesh`` every rank runs the same chunk on its heads."""
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    kv4, psize = _is_kv4(_first(cache, mesh)), _first(cache, mesh)["k"].shape[1]
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, pos)
    p0 = pos0 // psize
    wtab = block_tables[:, p0:p0 + s // psize]
    scales = _page_scales(kc, vc, psize) if kv4 else None

    def attend(c, q, k, v, aq, dev):
        btab, p0_vec = block_tables.to(dev), pos0_vec.to(dev)
        _paged_prefill_write(c, k, v, wtab.to(dev),
                             scales and {n: t.to(dev) for n, t in scales.items()})
        # the paged kernels read the (B, S, H, D) projections in place and
        # write ctx in q's layout, so on the card the permutes are views
        if kv4:
            # kv4 takes the q7 packed family on every backend, as the
            # reference does: a decode-written page's scale comes from its
            # first row, a prefill-written page's from the whole page, so no
            # row-exact identity between the two holds anyway
            ctx = ops.paged_prefill_attention_q4(q.permute(0, 2, 1, 3), c["k"], c["v"], c["ks"],
                                                 c["vs"], btab, p0_vec, *_q7_scalars(aq, dev))
        elif row_exact:
            k_view, v_view = _gather_view(c["k"], btab), _gather_view(c["v"], btab)
            qpos = pos0 + torch.arange(s, device=dev)[:, None]
            kpos = torch.arange(k_view.shape[1], device=dev)[None, :]
            ctx = _attn_rows_q8(q, k_view, v_view, aq, cfg, kpos <= qpos)
        else:
            ctx = ops.paged_prefill_attention_q(q.permute(0, 2, 1, 3), c["k"], c["v"], btab,
                                                p0_vec, *_q7_scalars(aq, dev))
        return ctx.permute(0, 2, 1, 3)

    ctx = _over_ranks(cfg, mesh, cache, qc, kc, vc, f["attn_q"], attend)
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
                       row_exact, mesh=None):
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
    kernel with ``pos_vec`` as its per-slot ``pos0``.  Under a
    tensor-parallel ``mesh`` each rank verifies on its heads.  The int8 pool
    only, as in the reference (``serve_forward`` refuses M-RoPE archs, as
    the reference asserts)."""
    if _is_kv4(_first(cache, mesh)):
        raise NotImplementedError("speculative verify serves the int8 pool only (spec x kv4: "
                                  "not in the reference either)")
    b, s, _ = x_i8.shape
    nh, hd = cfg.n_heads, cfg.hd
    qc, kc, vc = _qkv_rope(x_i8, f, cfg, positions)

    def attend(c, q, k, v, aq, dev):
        pg_, row_, btab = pg.to(dev), row.to(dev), block_tables.to(dev)
        c["k"][pg_, row_] = k
        c["v"][pg_, row_] = v
        if row_exact:
            k_view, v_view = _gather_view(c["k"], btab), _gather_view(c["v"], btab)
            kpos = torch.arange(k_view.shape[1], device=dev)
            ctx = _attn_rows_q8(q, k_view, v_view, aq, cfg,
                                kpos[None, None, :] <= positions.to(dev)[:, :, None])
        else:
            ctx = ops.paged_prefill_attention_q(q.permute(0, 2, 1, 3), c["k"], c["v"], btab,
                                                pos_vec.to(dev), *_q7_scalars(aq, dev))
        return ctx.permute(0, 2, 1, 3)

    ctx = _over_ranks(cfg, mesh, cache, qc, kc, vc, f["attn_q"], attend)
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


def _expert_linears(grp: Dict) -> List[Dict]:
    """Per-expert views of a stacked expert group's linears: [{wg, wu, wd}]."""
    return [{k: tree_index(grp[k], e) for k in ("wg", "wu", "wd")}
            for e in range(grp["wg"]["w"].shape[0])]


def _experts_int(xe_i8, grp, cfg):
    """SwiGLU experts, expert e on rows xe_i8[e]: (E, C, d) int8 -> (E, C, d)
    int8 on the group's output grid (``grp`` as ``layer_views`` gives it).
    One GEMM launch per expert and linear; the SiLU LUT and the product
    rescale are the group's, so they run once over every expert's rows."""
    wb = cfg.quant.w_bits
    lins = grp["linears"]
    g = torch.stack([_lin(x, lin["wg"], wb) for x, lin in zip(xe_i8, lins)])
    u = torch.stack([_lin(x, lin["wu"], wb) for x, lin in zip(xe_i8, lins)])
    prod = _lut8(g, grp["silu_lut"]).to(torch.int32) * u.to(torch.int32)
    hh = torch.clamp(fxp.rescale(prod, grp["prod"]["M"], grp["prod"]["sh"]),
                     -127, 127).to(torch.int8)
    return torch.stack([_lin(x, lin["wd"], wb) for x, lin in zip(hh, lins)])


def router_logits(hf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """The MoE router's float32 logits ``hf @ router``.  On the CPU a
    float32 product (XLA's order at the served widths); on the card a
    float64 product rounded to float32, which TF32 cannot touch and whose
    rows do not depend on the forward's other rows (cuBLAS picks its
    float32 summation order by shape, so a token's gates would otherwise
    move with its batch)."""
    if hf.device.type != "cuda":
        return torch.matmul(hf, router)
    return torch.matmul(hf.to(torch.float64), router.to(torch.float64)).to(torch.float32)


def _moe_route(h_i8, f, cfg):
    """The router island of a MoE slot over ``h_i8`` (T, d), the slot's
    ln2 output: float32 logits (``router_logits``), softmax, top-k under
    the capacity of T rows.  Returns (dest, gates, cap)."""
    t = h_i8.shape[0]
    gate_logits = router_logits(h_i8.to(torch.float32) * f["inv_s_mi"], f["router"])
    cap = Moe.capacity(t, cfg.n_experts, cfg.top_k)
    dest, gates, _ = Moe.topk_routing(gate_logits, cfg.top_k, cap)
    return dest, gates, cap


def _moe_experts(h_i8, f, cfg, dest, gates, cap):
    """A MoE slot after routing: dispatch ``h_i8`` (T, d) by ``dest``, the
    integer experts, the float32 combine by ``gates`` (then the shared
    experts, in order), requantized onto the slot's residual grid ->
    (T, d) int8."""
    t, d = h_i8.shape
    fe = f["experts"]
    xe = Moe.scatter_dispatch(h_i8, dest, cfg.n_experts, cap).reshape(cfg.n_experts, cap, d)
    yf = _experts_int(xe, fe, cfg).to(torch.float32) * fe["inv_s_out"]
    yt = Moe.gather_combine(yf.reshape(cfg.n_experts * cap, d), dest, gates, torch.float32)
    if "shared" in f:
        sh = f["shared"]
        ys = _experts_int(h_i8[None].expand(cfg.n_shared_experts, t, d), sh, cfg)
        yt = yt + torch.sum(ys.to(torch.float32) * sh["inv_s_out"], 0)
    return torch.clamp(torch.round(yt * f["s_rm"]), -127, 127).to(torch.int8)


def _moe_int(x_i8, f, cfg):
    """Integer experts behind a float32 router and combine (the islands)."""
    b, s, d = x_i8.shape
    h = _ln(x_i8, f["ln2"], cfg).reshape(b * s, d)
    return _moe_experts(h, f, cfg, *_moe_route(h, f, cfg)).reshape(b, s, d)


# --- recurrent slots (weight-only int4, float core) -----------------------------

def _requant_out(out, f):
    """A recurrent mixer's float output onto the residual grid of its slot."""
    return torch.clamp(torch.round(out * f["s_ra"]), -127, 127).to(torch.int8)


def _write_state(state: Dict, new: Dict):
    """A decode step's new recurrent state, written in place into the cache
    leaves it was given (views of the engine's cache)."""
    for k, v in new.items():
        state[k].copy_(v)


def mamba_float(x_i8, f, cfg, state=None):
    """A Mamba slot up to its float output: integer LN -> float island
    (weight-only in/x/out projections, causal conv, selective scan).
    ``state`` {h, conv} (decode, S == 1) is updated in place; without it the
    whole sequence runs through the chunked scan from a zero state."""
    h = _ln(x_i8, f["ln1"], cfg)
    with ieee_fp32(x_i8.device):
        hf = h.to(torch.float32) * f["inv_s_in"]
        m = f["mx"]
        _, dt_rank = Mb.mamba_dims(cfg)
        n = cfg.mamba_d_state
        xi, z = torch.chunk(_lin_wonly(hf, m["w_in"]), 2, dim=-1)
        xc, conv_state = Mb.causal_conv(xi, m["conv_w"], None if state is None else state["conv"])
        xc = Mb.silu(xc + m["conv_b"])
        dt_r, B_, C_ = torch.split(_lin_wonly(xc, m["w_x"]), [dt_rank, n, n], dim=-1)
        dt = Mb.softplus(dt_r @ m["w_dt"] + m["dt_bias"])
        A = -torch.exp(m["A_log"])
        if state is None:
            y = Mb.ssm_chunked(xc, dt, B_, C_, A, m["D"])
        else:
            y, hstate = Mb.ssm_step(xc, dt, B_, C_, A, m["D"], state["h"])
            _write_state(state, {"h": hstate, "conv": conv_state})
        return _lin_wonly(y * Mb.silu(z), m["w_out"])


def xlstm_float(x_i8, f, cfg, kind: str, state=None):
    """An mLSTM or sLSTM slot up to its float output: integer LN -> float
    island (weight-only projections, float gates, the recurrence).
    ``state`` (decode, S == 1: mLSTM {C, n, m}, sLSTM {c, n, h, m}) is
    updated in place; without it the mLSTM runs its parallel form and the
    sLSTM its scan from a zero state."""
    b, s, d = x_i8.shape
    nh = cfg.n_heads
    h = _ln(x_i8, f["ln1"], cfg)
    with ieee_fp32(x_i8.device):
        hf = h.to(torch.float32) * f["inv_s_in"]
        m = f["mx"]
        if kind == "slstm":
            gates = [_lin_wonly(hf, m[w]) + m[bias]
                     for w, bias in (("w_z", "b_z"), ("w_i", "b_i"), ("w_f", "b_f"),
                                     ("w_o", "b_o"))]
            hs, new = Xl.slstm_scan(*gates, m["r"], nh, state)
            if state is not None:
                _write_state(state, new)
            return _lin_wonly(hs, m["w_out"])
        qh = Xl.heads(_lin_wonly(hf, m["wq"]), nh)
        kh = Xl.heads(_lin_wonly(hf, m["wk"]), nh) * Xl.key_scale(d // nh)
        vh = Xl.heads(_lin_wonly(hf, m["wv"]), nh)
        gi = hf @ m["w_ig"] + m["b_ig"]
        logf = Xl.log_sigmoid(hf @ m["w_fg"] + m["b_fg"])
        if state is None:
            y = Xl.mlstm_parallel(qh, kh, vh, gi, logf)
        else:
            y, new = Xl.mlstm_step(qh, kh, vh, gi, logf, state)
            _write_state(state, new)
        og = torch.sigmoid(hf @ m["w_og"] + m["b_og"])
        return _lin_wonly(L.rmsnorm_xla(y.reshape(b, s, d), m["ln_y"]) * og, m["wo"])


def _mamba_int(x_i8, f, cfg, state=None):
    """A Mamba slot: ``mamba_float``, then int8 on the slot's residual grid."""
    return _requant_out(mamba_float(x_i8, f, cfg, state), f)


def _xlstm_int(x_i8, f, cfg, kind: str, state=None):
    """An mLSTM or sLSTM slot: ``xlstm_float``, then int8 on the slot's
    residual grid."""
    return _requant_out(xlstm_float(x_i8, f, cfg, kind, state), f)


# --- whole-model serving forward -----------------------------------------------

def _check_pageable(cfg: ModelConfig):
    """The paged pool serves all-attention non-SWA archs only (a sliding
    window's stripe is already a window-sized ring, a recurrent state does
    not grow with the sequence), as in the reference."""
    if cfg.sliding_window or recurrent(cfg):
        raise ValueError(f"arch {cfg.name!r} has a sliding window or a recurrent mixer: the "
                         "paged cache requires an all-attention, non-SWA arch (use the "
                         "contiguous layout)")


def paged_page_nbytes(cfg: ModelConfig, page_size: int, kv_bits: int = 8) -> int:
    """Device bytes one pool page occupies across every layer (K + V)."""
    _check_pageable(cfg)
    hd = cfg.hd // 2 if kv_bits == 4 else cfg.hd
    per = 2 * page_size * cfg.n_kv_heads * hd
    if kv_bits == 4:
        per += 2 * 4
    return cfg.n_reps * len(slot_kinds(cfg)) * per


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, kv_bits: int = 8,
                     device="cuda", mesh=None):
    """Global paged KV pool, (n_reps, n_pages, P, Hkv, hd) int8 per attn slot.

    ``kv_bits=4``: (n_reps, n_pages, P, Hkv, hd/2) uint8, nibble-planar along
    hd (half the bytes), plus per-page fp32 scale leaves 'ks'/'vs' of shape
    (n_reps, n_pages), all at the all-zero page's scale float32(1/7) (so the
    trash page dequantizes to exact zeros).

    With a tensor-parallel ``mesh`` (``launch/mesh.py``): a list of pools,
    rank r's on ``mesh.devices[r]`` with Hkv/tp heads of every page (and its
    own copy of the scale leaves), as ``sharding.partition.split_pool``
    lays them out; ``device`` is then unused."""
    _check_pageable(cfg)
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4 (got {kv_bits})")
    if mesh is None:
        return _paged_pool(cfg, n_pages, page_size, kv_bits, cfg.n_kv_heads, device)
    if cfg.n_kv_heads % mesh.size:
        raise ValueError(f"TP={mesh.size} must divide n_kv_heads={cfg.n_kv_heads}")
    return [_paged_pool(cfg, n_pages, page_size, kv_bits, cfg.n_kv_heads // mesh.size, dev)
            for dev in mesh.devices]


def _paged_pool(cfg: ModelConfig, n_pages: int, page_size: int, kv_bits: int, hkv: int,
                device) -> Dict:
    hd = cfg.hd // 2 if kv_bits == 4 else cfg.hd
    dtype = torch.uint8 if kv_bits == 4 else torch.int8
    shape = (cfg.n_reps, n_pages, page_size, hkv, hd)
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
    """KV rows per slot of the contiguous stripe (a sliding-window arch's is
    a ring of at most its window's rows)."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Dict:
    """Per-slot decode state, stacked (n_reps, batch, ...): the contiguous
    stripe, (Smax, Hkv, hd) int8 K and V, per attention slot; float32
    zeros per recurrent slot: Mamba h (d_in, N) and conv (K-1, d_in),
    mLSTM C (H, dh, dh), n (H, dh) and m (H,), sLSTM c, n, h, m (H, dh)."""
    lead = (cfg.n_reps, batch)
    dh = cfg.d_model // cfg.n_heads
    shapes = {"attn": {k: (cache_rows(cfg, max_len), cfg.n_kv_heads, cfg.hd)
                       for k in ("k", "v")},
              "mlstm": {"C": (cfg.n_heads, dh, dh), "n": (cfg.n_heads, dh),
                        "m": (cfg.n_heads,)},
              "slstm": {k: (cfg.n_heads, dh) for k in ("c", "n", "h", "m")}}
    if any(m == "mamba" for m, _ in slot_kinds(cfg)):
        d_in, _ = Mb.mamba_dims(cfg)
        shapes["mamba"] = {"h": (d_in, cfg.mamba_d_state), "conv": (cfg.mamba_d_conv - 1, d_in)}
    return {f"slot{i}": {k: torch.zeros(lead + shp, device=device,
                                        dtype=torch.int8 if m == "attn" else torch.float32)
                         for k, shp in shapes[m].items()}
            for i, (m, _) in enumerate(slot_kinds(cfg))}


def recurrent(cfg: ModelConfig) -> bool:
    """Whether any slot of ``cfg`` carries a recurrent state (Mamba, mLSTM,
    sLSTM)."""
    return any(m != "attn" for m, _ in slot_kinds(cfg))


def _attn_leaf(cache: Dict) -> torch.Tensor:
    """The K leaf of the cache's first attention slot."""
    return next(c["k"] for c in cache.values() if "k" in c)


def _rep_view(f_rep: Dict) -> Dict:
    """One rep's params with each expert group's per-expert linears listed
    under ``"linears"``."""
    out = dict(f_rep)
    for name, f in f_rep.items():
        if isinstance(f, dict) and "experts" in f:
            out[name] = dict(f, **{g: dict(f[g], linears=_expert_linears(f[g]))
                                   for g in ("experts", "shared") if g in f})
    return out


def layer_views(folded: Dict, n_reps: int):
    """Per-rep views of the stacked block params, the expert linears
    indexed per expert (cached by the engine)."""
    return folded.get("layers") or [_rep_view(tree_index(folded["blocks"], r))
                                    for r in range(n_reps)]


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
    (d, V) tensor of ``head_dtype``, or (K, d, V) for K stacked heads,
    converted once."""
    head = folded["lm_head"]
    if "w_f" in head:
        return head["w_f"]
    w = head["w"] if cfg.quant.w_bits == 8 else packing.unpack_int4_planar(head["w"], axis=-2)
    return w.to(head_dtype(cfg))


def _with_float_weights(f_slot: Dict) -> Dict:
    """A recurrent slot's view with each weight-only linear's float32
    weight cached under ``w_f``."""
    mx = {k: dict(v, w_f=wonly_weight(v)) if isinstance(v, dict) else v
          for k, v in f_slot["mx"].items()}
    return dict(f_slot, mx=mx)


def prepare_folded(cfg: ModelConfig, folded: Dict) -> Dict:
    """A shallow copy of ``folded`` with the per-layer views, the converted
    lm_head and the recurrent slots' float32 weights (``wonly_weight``)
    cached, for a serving loop that runs many forwards."""
    out = dict(folded)
    out["layers"] = [{k: _with_float_weights(v) if isinstance(v, dict) and "mx" in v else v
                      for k, v in rep.items()} for rep in layer_views(folded, cfg.n_reps)]
    out["lm_head"] = dict(folded["lm_head"], w_f=head_weights(cfg, folded))
    return out


def float_weight_bytes(prepared: Dict) -> int:
    """Bytes of the float32 weights ``prepare_folded`` cached for the
    recurrent slots' weight-only linears."""
    return sum(v["w_f"].numel() * 4 for rep in prepared["layers"] for f in rep.values()
               if isinstance(f, dict) and "mx" in f
               for v in f["mx"].values() if isinstance(v, dict))


def _embed_int(cfg: ModelConfig, folded: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> int8 embedding codes (B, S, d); an audio arch's
    (B, K, S) codebook codes -> the K codebooks' rows summed in int32, then
    clipped to int8."""
    if cfg.frontend != "audio_codebooks":
        return folded["embed"]["tokens_i8"][tokens.long()]
    books = folded["embed"]["codebooks_i8"]
    acc = sum(books[ci][tokens[:, ci].long()].to(torch.int32) for ci in range(cfg.n_codebooks))
    return torch.clamp(acc, -127, 127).to(torch.int8)


def serve_forward(cfg: ModelConfig, folded: Dict, tokens: torch.Tensor, *,
                  cache: Optional[Dict] = None, pos_offset=0, mode: str = "prefill",
                  block_tables: Optional[torch.Tensor] = None, verify_rows=None,
                  extra_embeds_i8=None, pos3=None, mesh=None):
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
    position ``pos_offset[b] + i`` gives (``_attn_verify_paged``).

    The frontends, as in the reference: an audio arch takes (B, K, S)
    codebook codes (K = ``n_codebooks``; (B, K, 1) at decode), and with K LM
    heads the logits are (B, K, S, V); ``extra_embeds_i8`` (B, S_img, d),
    int8 codes on the embedding's grid, go before the tokens' rows (S then
    counts both), and ``pos3`` (B, S, 3) gives a prefill's M-RoPE (t, h, w)
    positions (default: the row positions on all three streams; a decode
    step rotates its position on all three).

    Tensor parallelism, the paged pool only: with a ``mesh``
    (``launch/mesh.py``'s ``TPMesh``) ``cache`` is the list of the ranks'
    shards (``init_paged_cache(..., mesh=)``), rank r's on
    ``mesh.devices[r]`` with Hkv/tp heads of every page.  The projections,
    RoPE, LN, ``wo``, the MLP and the lm_head run once, on the tokens'
    device; each rank writes and attends its own heads on its device, and
    the contexts are concatenated in head order before ``wo``
    (``_over_ranks``), so the logits equal the unsharded forward's.
    Returns (logits, cache).
    """
    if mode not in ("prefill", "decode", "verify"):
        raise ValueError(f"mode must be prefill|decode|verify (got {mode!r})")
    if mesh is not None and (cache is None or block_tables is None or len(cache) != mesh.size):
        raise ValueError("a tensor-parallel mesh shards the paged KV pool: it needs block tables "
                         f"and one pool shard per rank ({mesh.size})")
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a KV cache")
    if mode == "verify" and (cache is None or block_tables is None or verify_rows is None):
        raise ValueError("verify mode needs a paged cache, block tables and verify_rows")
    if mode == "verify" and cfg.mrope_sections is not None:
        raise ValueError(f"arch {cfg.name!r} rotates by M-RoPE: the speculative verify "
                         "forward does not serve it (the reference asserts the same)")
    if mode == "prefill" and cache is not None and recurrent(cfg):
        raise ValueError(f"arch {cfg.name!r} has a recurrent state: a prefill with a cache "
                         "runs as the batch-1 decode loop (Engine._prefill_slot), one decode "
                         "step per prompt token")
    dev = tokens.device
    x = _embed_int(cfg, folded, tokens)
    if extra_embeds_i8 is not None:
        x = torch.cat([extra_embeds_i8.to(torch.int8), x], dim=1)
    b, s = x.shape[0], x.shape[1]
    if mode == "prefill" and cache is not None and block_tables is None:
        if int(pos_offset) != 0:
            raise ValueError("a prefill into the contiguous stripe starts at position 0")
        rows = _attn_leaf(cache).shape[2]
        if s > rows:
            raise ValueError(f"a one-shot prefill of {s} rows does not fit the stripe's "
                             f"{rows} (a longer prompt of a sliding-window arch takes the "
                             "decode loop)")
    pos_vec = _pos_vector(pos_offset, b, dev)
    pos0 = int(pos_offset) if mode == "prefill" else None
    if mode == "verify":
        vidx = _verify_index(pos_vec, _pos_vector(verify_rows, b, dev), block_tables,
                             _attn_leaf(_first(cache, mesh)).shape[2], s)
    if cfg.learned_pos:
        pos_i8 = folded["embed"]["pos_i8"]
        if mode == "prefill":
            posrow = pos_i8[pos0:pos0 + s][None]
        else:   # a padding verify column may sit past the table: clamped, then unused
            grid = pos_vec[:, None] + torch.arange(s, dtype=torch.int32, device=dev)
            posrow = pos_i8[torch.clamp(grid.long(), max=pos_i8.shape[0] - 1)]
        x = torch.clamp(x.to(torch.int32) + posrow.to(torch.int32), -127, 127).to(torch.int8)
    pos = None
    if mode == "prefill":
        pos = (pos0 + torch.arange(s, dtype=torch.int32, device=dev)).expand(b, s)
        if cfg.mrope_sections is not None and pos3 is not None:
            pos = pos3.to(device=dev, dtype=torch.int32)
    kinds = slot_kinds(cfg)
    row_exact = ops.backend(device=dev) != "gpu"
    for r, f_rep in enumerate(layer_views(folded, cfg.n_reps)):
        for i, (mixer, ffn) in enumerate(kinds):
            f = f_rep[f"slot{i}"]
            if cache is None:
                cslot = None
            elif mesh is None:
                cslot = {k: v[r] for k, v in cache[f"slot{i}"].items()}
            else:
                cslot = [{k: v[r] for k, v in shard[f"slot{i}"].items()} for shard in cache]
            if mixer == "mamba":
                out = _mamba_int(x, f, cfg, cslot)
            elif mixer != "attn":
                out = _xlstm_int(x, f, cfg, mixer, cslot)
            elif mode == "verify":
                out = _attn_verify_paged(x, f, cfg, cslot, pos_vec, *vidx, block_tables,
                                         row_exact, mesh)
            elif mode == "decode" and block_tables is not None:
                out = _attn_decode_paged(x, f, cfg, cslot, pos_vec, block_tables, mesh)
            elif mode == "decode":
                out = _attn_decode(x, f, cfg, cslot, pos_vec)
            elif cslot is not None and block_tables is not None:
                out = _attn_prefill_paged(x, f, cfg, cslot, pos, block_tables, pos0,
                                          pos_vec, row_exact, mesh)
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
            elif ffn == "moe":
                x = _resid_add(x, f["res_m"], _moe_int(x, f, cfg))
        x = _rescale_i8(x, f_rep["block_out_rescale"])
    x = _ln(x, folded["final_norm"], cfg)
    # lm_head: the only product outside a kernel, exact in head_dtype with
    # TF32 off (exact_matmul); then the reference's int32 -> float32
    # accumulator times the float32 scale.  K stacked heads: one product of
    # x against each head's codes, (B, K, S, V), each head times its scale.
    w = head_weights(cfg, folded)
    inv_acc = folded["lm_head"]["inv_acc"]
    if w.dim() == 3:
        x, inv_acc = x[:, None], inv_acc[:, None, None]
    acc = exact_matmul(x.to(w.dtype), w).to(torch.float32)
    return acc * inv_acc, cache
