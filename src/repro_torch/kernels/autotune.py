"""Per-shape launch tuning for the port's kernels: the counterpart of the
reference's ``kernels/autotune.py``, with the port's knobs.

* ``gemm_plan(m, k, n, w_bits, sms)`` — the integer GEMMs' tile and K split
  (``int4_matmul``, ``int8_bitsplit_matmul``).  The path stays fixed by M:
  the decode path at M <= 8, the tensor cores above.
* ``attn_heads_per_block(group, units, sms)`` — the q heads one block of the
  paged prefill (int8 and int4 pools) or the flash prefill serves.  Every
  K/V page streams once per block, so this is the counterpart of the
  reference's ``prefill_bq``; the port's 16-row q tile is a warp's mma tile
  and no knob.
* ``decode_bkv(smax, ...)`` — the contiguous decode's block of keys, asked
  by ``ops.decode_attention_q(bkv=None)``.

The GEMMs' partials are exact int32 sums and a block's heads never meet, so
the first two knobs move no bits.  ``bkv`` does move codes, although the
reference's docstring calls it neutral: the stripe decode's q7 carry takes
each block's max, and the LUT numerators follow it
(``tests/test_torch_autotune.py::test_bkv_moves_codes``).  So no mode picks
it: ``decode_bkv`` gives the pin or 512, fitted to Smax, and the served
decode keeps ``divisor_tile(512, Smax)``, as the reference's keeps 512.

Modes, from ``REPRO_TORCH_AUTOTUNE``:

* ``roofline`` (the default): the GEMMs' plan from a cost model priced on
  ``hw_constants``.  A launch costs the launch floor plus its waves over
  the SMs (the blocks an SM holds set by the shared memory the library
  says the plan asks, ``_build.smem_query``, and by the register file); a
  wave of b blocks runs on min(b, SMS) SMs at their share of the card,
  takes the larger of its blocks' bytes and tensor-core operations plus
  their weights' unpacking on the CUDA cores, and the launch floor.  A K
  split adds the reduce pass: one more launch over its int32 partials.
  Ties keep the ``off`` rule's pick; without a card (no library to ask)
  the pick is the ``off`` rule's.  The heads per block keep the ``off``
  rule: it already streams each page the fewest times that fill the card.
* ``measure``: race every candidate of the GEMMs' plan and the heads per
  block through the live kernel on synthetic inputs at the exact shape
  (``measure_best``: one warm-up, then the median of ``MEASURE_REPS``
  calls timed by CUDA events, each after the L2 is overwritten) and cache
  the winner.  Racing launches through the wrappers' uncounted launchers,
  so no ``launches`` or ``path_launches`` counter moves.  On a CPU device,
  over ``MEASURE_BYTES_CAP``, or for a shape with no kernel to race, the
  model's pick.
* ``off``: the fixed rules: ``int4_matmul.plan`` and
  ``prefill_attention.heads_per_block``.

Pins win over every mode, each fitted to what is legal at the shape:
``REPRO_TORCH_GEMM_PLAN`` (``BMxBN/SPLIT``; the decode path takes only the
split), ``REPRO_TORCH_HEADS_PER_BLOCK`` and ``REPRO_TORCH_DECODE_BKV``.
Every modeled or measured pick is cached under a key that holds every input
of it, the SM count included (``("measure",) + key`` for a measured one);
``clear_cache()`` forgets them.
"""
from __future__ import annotations

import os
import re
import statistics
import time
from typing import Callable, Sequence

from repro_torch.kernels import _build
from repro_torch.kernels.hw_constants import (
    HBM_BW,
    L2_BYTES,
    LAUNCH_FLOOR_S,
    MAX_REGISTERS,
    PEAK_INT8_OPS,
    PEAK_INT32_OPS,
    REGISTERS_PER_SM,
    SMEM_PER_SM,
    SMEM_RESERVED,
    SMS,
)

MODES = ("roofline", "measure", "off")
DEFAULT_DECODE_BKV = 512      # the reference's, and the most the stripe kernel takes

_cache: dict = {}


def clear_cache() -> None:
    _cache.clear()


def _mode() -> str:
    m = os.environ.get("REPRO_TORCH_AUTOTUNE", "roofline")
    if m not in MODES:
        raise ValueError(f"REPRO_TORCH_AUTOTUNE={m!r}; one of {MODES}")
    return m


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None


def _fit(c: int, n: int) -> int:
    """Largest divisor of ``n`` that is <= c (mirrors divisor_tile)."""
    c = min(c, n)
    while n % c:
        c -= 1
    return c


def _cuda(device) -> bool:
    import torch

    return device is not None and torch.device(device).type == "cuda"


# --- the cost model ------------------------------------------------------------

def _per_sm(threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` dynamic shared memory one
    SM holds: by its shared memory, and by its register file at the most
    registers a thread may take (the kernels' launch bounds promise no
    fewer)."""
    return max(1, min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                      REGISTERS_PER_SM // (threads * MAX_REGISTERS)))


def _waves_seconds(blocks: int, blk_s: float, per_sm: int, sms: int) -> float:
    """Modeled seconds of ``blocks`` equal blocks of ``blk_s`` seconds of
    the whole card's work each, ``per_sm`` resident on an SM: waves of
    ``sms * per_sm`` blocks; a wave of b blocks runs on min(b, sms) SMs at
    their share of the card, plus the launch floor (its blocks' start and
    drain)."""
    def wave(b):
        return b * blk_s * sms / min(b, sms) + LAUNCH_FLOOR_S

    full, rest = divmod(blocks, sms * per_sm)
    return full * wave(sms * per_sm) + (wave(rest) if rest else 0.0)


def _roofline_pick(candidates: Sequence, seconds: Callable) -> object:
    """The candidate of least modeled seconds; the first on a tie (every
    knob lists the off rule's pick first)."""
    best, best_t = None, None
    for c in candidates:
        t = seconds(c)
        if best_t is None or t < best_t:
            best, best_t = c, t
    return best


def gemm_seconds(p, m: int, k: int, n: int, w_bits: int, sms: int, smem: int) -> float:
    """Modeled seconds of GEMM plan ``p`` at (M, K, N), whose launch asks
    ``smem`` bytes of dynamic shared memory.  Each block reads its x tile
    and weight slice and writes its output tile (int32 partials when K is
    split), the larger of those bytes and its tile's padded products on the
    tensor cores, and then unpacks each weight byte on the CUDA cores
    (``UNPACK_OPS_PER_BYTE``), at their int32 rate with 8 warps a block and
    in proportion with fewer.  A split adds the reduce pass: a launch
    reading split x M x N int32 partials."""
    from repro_torch.kernels import int4_matmul as MM

    w4 = w_bits == 4
    if p.path == "decode":
        steps = (k // 2 if w4 else k) // MM.DECODE_ROWS
        rows = -(-steps // p.split) * MM.DECODE_ROWS      # weight rows of the longest slice
        kv = rows * (2 if w4 else 1)                        # the k values they hold
        threads, out_rows = 32 * MM.DECODE_WARPS, m
    else:
        kv = -(-(-(-k // MM.TC_STAGE_K)) // p.split) * MM.TC_STAGE_K
        rows = kv // 2 if w4 else kv
        threads, out_rows = 2 * p.bm, p.bm
    w_bytes = rows * p.bn
    blk_bytes = out_rows * kv + w_bytes + out_rows * p.bn * (4 if p.split > 1 else 1)
    blk_ops = 2 * p.bm * p.bn * kv
    unpack_s = MM.UNPACK_OPS_PER_BYTE[w_bits] * w_bytes / (PEAK_INT32_OPS * min(1.0, threads / 256))
    blk_s = max(blk_bytes / HBM_BW, blk_ops / PEAK_INT8_OPS) + unpack_s
    t = LAUNCH_FLOOR_S + _waves_seconds(p.blocks, blk_s, _per_sm(threads, smem), sms)
    if p.split > 1:
        t += LAUNCH_FLOOR_S + (4 * p.split * m * n + m * n + 4 * n) / HBM_BW
    return t


# --- the knobs -----------------------------------------------------------------

def gemm_candidates(m: int, k: int, n: int, w_bits: int = 4, sms: int = SMS) -> list:
    """Every plan the tuner may pick for (M, K, N), ``plan``'s first.  The
    decode path: each K split whose staged x slice fits and whose slices
    hold at least one 32-row step.  The tensor cores: each tile of
    ``TC_TILES`` with the splits 1 .. stages // TC_MIN_STAGES."""
    from repro_torch.kernels import int4_matmul as MM

    off = MM.plan(m, k, n, w_bits, sms)
    out = [off]
    if off.path == "decode":
        cols = -(-n // MM.DECODE_COLS)
        for split in range(1, (k // 2 if w_bits == 4 else k) // MM.DECODE_ROWS + 1):
            if MM.decode_fits(k, split, w_bits):
                out.append(MM.GemmPlan("decode", 8, MM.DECODE_COLS, split, off.vec,
                                       cols * split))
    else:
        stages = -(-k // MM.TC_STAGE_K)
        for bm, bn in MM.TC_TILES:
            tiles = -(-m // bm) * -(-n // bn)
            for split in range(1, max(1, stages // MM.TC_MIN_STAGES) + 1):
                out.append(MM.GemmPlan("tensor_core", bm, bn, split, off.vec, tiles * split))
    return list(dict.fromkeys(out))


def _pinned_plan(pin: str, m: int, k: int, n: int, w_bits: int, sms: int):
    """``REPRO_TORCH_GEMM_PLAN`` = ``BMxBN/SPLIT`` fitted to (M, K, N): the
    split clipped to the slices K has (the decode path: raised until the x
    slice fits), the tile one of ``TC_TILES`` (the decode path keeps its
    own)."""
    from repro_torch.kernels import int4_matmul as MM

    got = re.fullmatch(r"(\d+)x(\d+)/(\d+)", pin.strip())
    if got is None or (int(got[1]), int(got[2])) not in MM.TC_TILES:
        raise ValueError(f"REPRO_TORCH_GEMM_PLAN={pin!r}: want BMxBN/SPLIT with BMxBN one of "
                         f"{['%dx%d' % t for t in MM.TC_TILES]}")
    off = MM.plan(m, k, n, w_bits, sms)
    split = max(1, int(got[3]))
    if off.path == "decode":
        split = min(split, (k // 2 if w_bits == 4 else k) // MM.DECODE_ROWS)
        while not MM.decode_fits(k, split, w_bits):
            split += 1
        return off._replace(split=split, blocks=off.blocks // off.split * split)
    bm, bn = int(got[1]), int(got[2])
    split = min(split, -(-k // MM.TC_STAGE_K))
    return off._replace(bm=bm, bn=bn, split=split, blocks=-(-m // bm) * -(-n // bn) * split)


def gemm_plan(m: int, k: int, n: int, w_bits: int = 4, sms: int = SMS, *, device=None):
    """The ``GemmPlan`` a (M, K, N) GEMM launches on ``device``, where the
    model asks the library for each plan's shared memory and measured mode
    races (without a CUDA device: a cached pick, else the off rule)."""
    from repro_torch.kernels import int4_matmul as MM

    pin = os.environ.get("REPRO_TORCH_GEMM_PLAN")
    if pin:
        return _pinned_plan(pin, m, k, n, w_bits, sms)
    mode = _mode()
    if mode == "off":
        return MM.plan(m, k, n, w_bits, sms)
    key = ("gemm_plan", m, k, n, w_bits, sms)
    if mode == "measure":
        got = _measured_gemm_plan(("measure",) + key, m, k, n, w_bits, sms, device)
        if got is not None:
            return got                    # else: fall back to the model
    got = _cache.get(key)
    if got is None:
        if not _cuda(device):
            return MM.plan(m, k, n, w_bits, sms)
        lib = "int4_matmul" if w_bits == 4 else "int8_bitsplit_matmul"
        got = _roofline_pick(gemm_candidates(m, k, n, w_bits, sms), lambda p: gemm_seconds(
            p, m, k, n, w_bits, sms,
            _build.smem_query(lib, MM.PATHS.index(p.path), p.bm, p.bn, k, p.split)))
        _cache[key] = got
    return got


def heads_candidates(group: int, units: int, sms: int = SMS) -> list:
    """The divisors of the group up to ``MAX_HEADS_PER_BLOCK``,
    ``heads_per_block``'s first, then the rest largest first."""
    from repro_torch.kernels import prefill_attention as PA

    divs = [d for d in range(PA.MAX_HEADS_PER_BLOCK, 0, -1) if group % d == 0]
    return list(dict.fromkeys([PA.heads_per_block(group, units, sms)] + divs))


def attn_heads_per_block(group: int, units: int, sms: int = SMS, *, shape=None,
                         device=None) -> int:
    """q heads a block for ``units`` (row tile, slot, kv head) triples of a
    GQA group of ``group`` heads: the pin, the measured winner, else the off
    rule.  ``shape`` names the kernel and its exact geometry, for measured
    mode (``_measured_heads``)."""
    from repro_torch.kernels import prefill_attention as PA

    pin = _env_int("REPRO_TORCH_HEADS_PER_BLOCK")
    if pin:
        return _fit(min(pin, PA.MAX_HEADS_PER_BLOCK), group)
    if _mode() == "measure":
        got = _measured_heads(("measure", "attn_heads_per_block", group, units, sms, shape),
                              heads_candidates(group, units, sms), shape, device)
        if got is not None:
            return got
    return PA.heads_per_block(group, units, sms)


def decode_bkv(smax: int, *, batch_slots: int, hkv: int, hd: int, kv_bits: int = 8) -> int:
    """Block of keys for the contiguous decode at this shape (the
    reference's signature): ``REPRO_TORCH_DECODE_BKV`` or 512, fitted to
    ``smax``, in every mode.  It moves codes (the module's docstring), so
    neither the model nor a race picks it: a pick that followed timing
    would make the output codes follow it too."""
    pin = _env_int("REPRO_TORCH_DECODE_BKV")
    return _fit(min(pin or DEFAULT_DECODE_BKV, DEFAULT_DECODE_BKV), smax)


# --- REPRO_TORCH_AUTOTUNE=measure: race candidates through the live kernels -----

MEASURE_REPS = 3                 # timed reps per candidate (after 1 warm-up)
MEASURE_BYTES_CAP = 2 << 30      # skip measuring shapes needing > 2 GiB


def measure_best(candidates, timer, *, key=None):
    """Measured mode core: time ``timer(candidate)`` (seconds) over the
    candidate set and cache the argmin under ``key``; returns the winner."""
    if key is not None and key in _cache:
        return _cache[key]
    best, best_t = None, None
    for c in candidates:
        t = timer(c)
        if best_t is None or t < best_t:
            best, best_t = c, t
    if key is not None:
        _cache[key] = best
    return best


def _timed_call(fn, device, reps: int = MEASURE_REPS) -> float:
    """Median device seconds of one ``fn()`` over ``reps`` calls, each
    after a write of twice the L2 (a served layer reads its operands cold),
    timed by CUDA events while the stream is held busy for as long as the
    host takes to enqueue them; one untimed call first."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        torch.cuda._sleep(int((2 * host_s * reps + 1e-4) * 2e9))    # ~2 GHz clock
        for start, end in events:
            flush.fill_(1)
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def _measured_gemm_plan(key, m, k, n, w_bits, sms, device):
    """Race ``gemm_candidates`` through the GEMM's kernel on seeded random
    operands at (M, K, N); None (-> the model) off the card or over the
    cap."""
    if key in _cache:
        return _cache[key]
    cands = gemm_candidates(m, k, n, w_bits, sms)
    w_bytes = k * n // 2 if w_bits == 4 else k * n
    partials = 4 * max(p.split for p in cands) * m * n
    if not _cuda(device) or m * k + w_bytes + partials > MEASURE_BYTES_CAP:
        return None
    import torch

    from repro_torch.kernels import int4_matmul as MM

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8, device=device)
    w = (torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=device)
         if w_bits == 4 else
         torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8, device=device))
    bias = torch.zeros(n, dtype=torch.int32, device=device)
    Mq = torch.tensor(1 << 14, dtype=torch.int32, device=device)
    shq = torch.tensor(20, dtype=torch.int32, device=device)
    name = "int4_matmul" if w_bits == 4 else "int8_bitsplit_matmul"
    return measure_best(cands, lambda p: _timed_call(
        lambda: MM._launch(name, x, w, bias, Mq, shq, n, p), device), key=key)


def _attn_quant_meta(device):
    """Softmax requant scalars for synthetic attention inputs (the
    reference's ``_attn_quant_meta``; they move bits, never runtime)."""
    import math

    import torch

    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qsoftmax import LUT_DELTA
    from repro_torch.kernels import ref

    s_logit = 1.0 / (0.05 * math.sqrt(64))
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32, device=device),
            torch.tensor(sh, dtype=torch.int32, device=device),
            torch.as_tensor(ref.make_exp_lut_q7(), device=device),
            torch.tensor(1.0 / s_logit, dtype=torch.float32, device=device),
            torch.tensor(1.0, dtype=torch.float32, device=device))


def _measured_heads(key, cands, shape, device):
    """Race the heads-per-block candidates through the kernel ``shape``
    names, on synthetic inputs at its geometry:
    ``("paged_prefill_qattention" or "..._q4", B, H, Sq, D, Hkv, P, nb)``
    (every slot's table maps nb distinct pages and the chunk ends the chain,
    so each candidate pays the whole chain) or ``("flash_qattention", B, H,
    Sq, D, Hkv, Skv, bkv, q_offset, window)``.  None off the card, without
    a shape or over the cap."""
    if key in _cache:
        return _cache[key]
    if shape is None or not _cuda(device) or len(cands) == 1:
        return None
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def codes(*s, dtype=torch.int8):
        lo, hi = (-64, 65) if dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, s, generator=gen, dtype=dtype, device=device)

    name, b, h, sq, d, hkv = shape[:6]
    scal = _attn_quant_meta(device)
    if name == "flash_qattention":
        from repro_torch.kernels import flash_qattention as FA

        skv, bkv, q_offset, window = shape[6:]
        if (b * h * sq + 2 * b * hkv * skv) * d > MEASURE_BYTES_CAP:
            return None
        q, k, v = codes(b, h, sq, d), codes(b, hkv, skv, d), codes(b, hkv, skv, d)
        run = lambda gh: FA._launch_flash(q, k, v, *scal, q_offset=q_offset, bkv=bkv,
                                          window=window, gh=gh)
    else:
        from repro_torch.kernels import prefill_attention as PA

        psize, nb = shape[6:]
        n_pages = b * nb + 1
        q4 = name.endswith("_q4")
        if 2 * n_pages * psize * hkv * d // (2 if q4 else 1) > MEASURE_BYTES_CAP:
            return None
        q = codes(b, h, sq, d)
        btab = 1 + torch.arange(b * nb, dtype=torch.int32, device=device).reshape(b, nb)
        pos0 = torch.full((b,), max(0, nb * psize - sq), dtype=torch.int32, device=device)
        if q4:
            kp = codes(n_pages, psize, hkv, d // 2, dtype=torch.uint8)
            vp = codes(n_pages, psize, hkv, d // 2, dtype=torch.uint8)
            sc = torch.full((n_pages,), 0.05, dtype=torch.float32, device=device)
            run = lambda gh: PA._launch_q4(q, kp, vp, sc, sc, btab, pos0, *scal, gh=gh)
        else:
            kp, vp = codes(n_pages, psize, hkv, d), codes(n_pages, psize, hkv, d)
            run = lambda gh: PA._launch_int8(q, kp, vp, btab, pos0, *scal, gh=gh)
    return measure_best(cands, lambda gh: _timed_call(lambda: run(gh), device), key=key)
