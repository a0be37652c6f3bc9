"""Causal integer flash attention and the single-sequence decode: the CUDA
kernels ``csrc/flash_qattention.cu`` and ``csrc/flash_qdecode.cu``, their
wrappers and the plain version of the first.

Replace the TPU kernels ``flash_qattention`` and ``flash_qdecode`` of
``repro/kernels/flash_qattention.py``.  ``flash_qattention_torch`` mirrors
the reference's ``flash_qattention_jax``: the per-block integer datapath
(int8 QK^T -> int32 scores -> q7 LUT numerators -> int8 P@V) with the fp32
online carry, as a loop over KV blocks.  On a CUDA tensor a wrapper
launches its kernel (or raises); on a CPU tensor it computes the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.core import qsoftmax as qs
from repro_torch.analysis.boundary import kernel_launch
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.decode_attention import (
    _check_device,
    _i32,
    _same_strides,
    _strided,
    _stripe_call,
)
from repro_torch.kernels.prefill_attention import MAX_HEADS_PER_BLOCK, ROWS_PER_BLOCK
from repro_torch.kernels.ref import (
    NEG_INIT,
    SKIP_EXP_ARG,
    _epilogue,
    _online_update,
    flash_qdecode_ref,
    int_matmul,
)

SOURCE = "src/repro_torch/csrc/flash_qattention.cu"
REPLACES = "src/repro/kernels/flash_qattention.py:240"
DECODE_SOURCE = "src/repro_torch/csrc/flash_qdecode.cu"
DECODE_REPLACES = "src/repro/kernels/flash_qattention.py:129"


def divisor_tile(cap: int, n: int) -> int:
    """Largest tile <= ``cap`` that divides ``n`` exactly."""
    cap = min(cap, n)
    while n % cap:
        cap -= 1
    return cap


def flash_qattention_torch(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7,
                           inv_s_logit, out_scale, *, q_offset: int = 0, bkv: int = 512,
                           window: int | None = None):
    """q (..., H, Sq, D) x k/v (..., Hkv, Skv, D) int8 -> (..., H, Sq, D)
    int8, query row i at position ``qpos = q_offset + i`` attending to the
    keys at ``kpos <= qpos`` (and ``kpos > qpos - window`` with a sliding
    ``window``), one carry update per block of ``bkv`` keys (``bkv``
    divides Skv).  KV blocks wholly past the last row's frontier are
    skipped, as the kernels do: such a block would add num = 0 with f = 1
    (a masked key's index clips to 255, whose table entry is 0; every row
    has a live key, its own, at or before the frontier), so the result
    equals the reference's, which computes them.  Blocks below the window
    are computed from block 0, as the reference does: their masked scores
    leave nonzero numerators in the carry until the first live block scales
    them by exp((m_old - m_new) * inv_s_logit)."""
    h, sq, d = q_i8.shape[-3:]
    hkv, skv = k_i8.shape[-3], k_i8.shape[-2]
    group = h // hkv
    dev = q_i8.device
    bkv = min(bkv, skv)
    if skv % bkv:
        raise ValueError(f"bkv {bkv} does not divide Skv {skv}")
    lead = q_i8.shape[:-3]
    qpos = q_offset + torch.arange(sq, dtype=torch.int32, device=dev)[:, None]
    m = torch.full((*lead, h, sq, 1), NEG_INIT, dtype=torch.int32, device=dev)
    den = torch.zeros((*lead, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((*lead, h, sq, d), dtype=torch.float32, device=dev)
    lut32 = lut_q7.to(torch.int32)
    inv = torch.as_tensor(inv_s_logit, dtype=torch.float32, device=dev)
    for k_i in range(min(skv // bkv, (q_offset + sq - 1) // bkv + 1)):
        blk = slice(k_i * bkv, (k_i + 1) * bkv)
        kg = k_i8[..., blk, :].repeat_interleave(group, dim=-3)
        vg = v_i8[..., blk, :].repeat_interleave(group, dim=-3)
        s = int_matmul(q_i8, kg.transpose(-1, -2))           # (..., H, Sq, bkv)
        kpos = k_i * bkv + torch.arange(bkv, dtype=torch.int32, device=dev)[None, :]
        live = kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        s = torch.where(live, s, s - qs.MASK_OFFSET)
        m, den, acc = _online_update(m, den, acc, s, vg, M_idx, shift_idx, lut32, inv)
    return _epilogue(acc, den, out_scale)


def _launch_flash(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale, *,
                  q_offset: int, bkv: int, window, gh=None):
    """The flash kernel on CUDA int8 (B, H, Sq, D) / (B, Hkv, Skv, D)
    operands, ``gh`` q heads a block (None: the tuner's pick); counts
    nothing."""
    b, h, sq, d = q_i8.shape
    b_k, hkv, skv, d_k = k_i8.shape
    bkv = min(bkv, skv)
    if (b_k, d_k) != (b, d) or v_i8.shape != k_i8.shape or hkv == 0 \
            or h % hkv or d > 128 or d % 16 or not 0 < bkv <= 512 or skv % bkv \
            or q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"flash_qattention: unsupported shapes q {tuple(q_i8.shape)}, k/v "
                         f"{tuple(k_i8.shape)}, bkv {bkv}, q_offset {q_offset}, window "
                         f"{window} (needs H a multiple of Hkv, D <= 128, D % 16 == 0, "
                         f"bkv <= 512 dividing Skv, q_offset >= 0, window >= 1)")
    dev = q_i8.device
    q = _strided(q_i8)
    k, v = _same_strides(k_i8, v_i8)
    lut = _i32(lut_q7, dev)
    if lut.data_ptr() % 16:                 # the kernel copies it in 16-byte pieces
        lut = lut.clone()
    scal = _build.attn_scalars(dev, M_idx, shift_idx, inv_s_logit, out_scale)
    out = torch.empty_like(q)
    if gh is None:
        gh = autotune.attn_heads_per_block(
            h // hkv, -(-sq // ROWS_PER_BLOCK) * b * hkv, _build.sm_count(dev),
            shape=("flash_qattention", b, h, sq, d, hkv, skv, bkv, q_offset, window),
            device=dev)
    if (h // hkv) % gh or gh > MAX_HEADS_PER_BLOCK:
        raise ValueError(f"flash_qattention: heads_per_block {gh} must divide H / Hkv = "
                         f"{h // hkv} and be at most {MAX_HEADS_PER_BLOCK}")
    rc = _build.bind("flash_qattention", "flash_qattention", 9, 20)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lut.data_ptr(),
        *(t.data_ptr() for t in scal), out.data_ptr(), b, h, hkv, d, sq, skv, bkv, q_offset,
        window or 0, SKIP_EXP_ARG, gh, *q.stride()[:3], *k.stride()[:3], *out.stride()[:3],
        _build.stream_of(dev))
    _build.check_launch(rc, "flash_qattention")
    return out


@kernel_launch
def flash_qattention(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale,
                     *, q_offset: int = 0, bkv: int = 512, window: int | None = None):
    """Causal flash attention, q (B, H, Sq, D) x k/v (B, Hkv, Skv, D) int8
    -> (B, H, Sq, D) int8: the reference's single-sequence kernel with a
    leading batch dimension.  Query row i sits at position ``q_offset +
    i``; with a sliding ``window`` it sees only the keys less than
    ``window`` positions back.  The carry updates once per block of ``bkv``
    keys (clipped to Skv; it must divide Skv).  A windowed row tile starts
    at the first block live for its first row where ``window_skip_margin``
    exceeds 1 (decided by the kernel from the ``inv_s_logit`` it reads, so
    the host never waits for the card), else at block 0.  The inputs may be
    strided views (the serving forward passes its (B, S, H, D) projections
    transposed); the output takes q's layout.  The reference's q-block size
    ``bq`` does not change the result, so the kernel takes its own: a CTA
    serves 16 query rows of the q heads of one kv head that
    ``autotune.attn_heads_per_block`` picks, one staging of K and V for all
    of them."""
    if q_i8.device.type == "cpu":
        return flash_qattention_torch(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7,
                                      inv_s_logit, out_scale, q_offset=q_offset, bkv=bkv,
                                      window=window)
    _check_device("flash_qattention", q_i8)
    if q_i8.dtype != torch.int8 or k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise TypeError("flash_qattention wants int8 q, k and v")
    if q_i8.dim() != 4 or k_i8.dim() != 4:
        raise ValueError(f"flash_qattention: q {tuple(q_i8.shape)} and k {tuple(k_i8.shape)} "
                         f"must be (B, H, Sq, D) and (B, Hkv, Skv, D)")
    out = _launch_flash(q_i8, k_i8, v_i8, M_idx, shift_idx, lut_q7, inv_s_logit, out_scale,
                        q_offset=q_offset, bkv=bkv, window=window)
    flash_qattention.launches += 1
    return out


flash_qattention.launches = 0


@kernel_launch
def flash_qdecode(q_i8, k_i8, v_i8, cache_len, M_idx, shift_idx, lut_q7, inv_s_logit,
                  out_scale, *, bkv: int = 512):
    """One token's GQA decode: q (Hkv, G, D) int8 x the cache (Hkv, Smax, D)
    int8, keys at or past ``cache_len`` (a scalar) masked, one carry update
    per block of ``bkv`` keys (clipped to Smax; it must divide Smax) ->
    (Hkv, G, D) int8.  On the card the cache is read in place through its
    strides (a (Smax, Hkv, D) stripe seen transposed needs no copy); it is
    the contiguous decode's split at B = 1, three CUDA launches per call."""
    if q_i8.device.type == "cpu":
        return flash_qdecode_ref(q_i8, k_i8, v_i8, cache_len, M_idx, shift_idx, lut_q7,
                                 inv_s_logit, out_scale, bkv=bkv)
    _check_device("flash_qdecode", q_i8)
    if q_i8.dtype != torch.int8 or k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise TypeError("flash_qdecode wants int8 q and caches")
    hkv, g, d = q_i8.shape
    hkv_c, smax, d_c = k_i8.shape
    bkv = min(bkv, smax)
    if (hkv_c, d_c) != (hkv, d) or v_i8.shape != k_i8.shape or g > 16 or d > 128 \
            or d % 16 or not 0 < bkv <= 512 or smax % bkv:
        raise ValueError(f"flash_qdecode: unsupported shapes q {tuple(q_i8.shape)}, cache "
                         f"{tuple(k_i8.shape)}, bkv {bkv} (needs G <= 16, D <= 128, "
                         f"D % 16 == 0, bkv <= 512 dividing Smax)")
    k, v = _same_strides(k_i8, v_i8)
    out = _stripe_call("flash_qdecode", q_i8, k, v,
                       _build.device_scalar(cache_len, torch.int32, q_i8.device), lut_q7,
                       (M_idx, shift_idx, inv_s_logit, out_scale), 1, hkv, g, d, smax, bkv,
                       (k.stride(0), k.stride(1)))
    flash_qdecode.launches += 1
    return out


flash_qdecode.launches = 0
