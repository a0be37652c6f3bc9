#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA card (an H100),
``nvcc`` and PyTorch built for CUDA.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the eleven CUDA kernels of the port (``_build.KERNELS``) from
   ``src/repro_torch/csrc``, one ``nvcc`` each, all at once, and prints the
   build time, each kernel's registers and shared memory and the integer
   tensor-core instructions in its SASS (the paged prefill kernels, the
   stripe decode kernels and the flash prefill must have IMMA and no IDP);
3. holds every kernel against its plain PyTorch version on the card at the
   shapes of the serving paths (yi-6b for the four of the engine, the three
   of its other KV layouts and the two flash kernels, BERT-base for
   ``quant_softmax`` and ``int8_bitsplit_matmul``; equal arrays required;
   the two paged decode kernels and the contiguous decode also on one
   4,096-row chain or stripe, the two paged prefill kernels also on a
   704-row prompt and on the last 16-row chunk of a 1,024-row chain, the
   int8 one also at the speculative verify forward's shape: 8 slots of
   4 rows at ragged, unaligned cursors 33-1000 on 1,024-row chains)
   and times the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (the two GEMMs at every served
   shape beside ``torch._int_mm``, with the path and tile each took, the
   kernel / ``_int_mm`` factor and the share of the bound, yi-6b's at
   M = 32 too, the verify forward's rows; ``quant_layernorm`` at every
   (R, N) a served path runs, yi-6b's 8, 32, 512 and 704 rows and
   BERT-base's 128 and 4,096; ``quant_layernorm`` and ``quant_softmax``
   beside the launch floor, a one-element ``torch.neg`` in the same
   timing loop);
4. serves yi-6b at full width (32 layers, d=4096, random weights from a
   seed, calibrated on (2, 32) seeded tokens and folded to integers) through
   the port's ``Engine``: 8 requests once with whole-prompt prefill and once
   with chunked prefill, which must give the same tokens, reuse a shared
   prefix and launch every kernel of that path, then profiles a decode
   tick and a 512-row and a 128-row paged prefill chunk; in every served run,
   ``[eval]`` and ``[bert]`` the GEMMs of a prefill or cache-less forward
   must take the tensor-core path and those of a decode tick the decode
   path (launches counted by path);
   ``[spec]``: the same requests with speculative decoding (``spec_k=3``)
   on the paged int8 pool, once with ``PromptLookupDraft`` and once with a
   ``SequenceDraft`` of the one-shot run's tokens (the oracle): both must
   give the one-shot tokens with ``drafted == accepted + rejected``, every
   verify forward must launch ``paged_prefill_qattention`` 32 times (its
   GEMMs on the tensor cores, M = 32), and the oracle must reject nothing
   with fewer decode forwards than the plain run's; decode forwards,
   acceptance and tok/s printed, then a profile of one verify forward;
   ``[router]``: two ``Engine`` replicas over the one folded model behind a
   ``ReplicaRouter`` with prefix affinity and the shared prefix tier: the
   same requests must give the one-shot tokens and publish pages to the
   tier (prefix hits and adopted pages per replica printed, not gated),
   then an ``AsyncServer`` over the router streams 4 of them, its streams
   equal to the returned tokens;
5. ``[kv4]``: the same requests on the int4-packed pool (``kv_bits=4``),
   one-shot and chunked: the packed kernels run 32 times per decode tick
   and per prefill chunk, a page takes 262,400 bytes against 524,288, and
   the first token where kv4 leaves the int8 run is printed (not gated);
   ``[contiguous]``: the same requests on the contiguous stripe (each
   one-shot prefill through ``flash_qattention``, 32 launches), then the
   ``LockstepEngine`` (8 prompts of 32 tokens, 16 new), through
   ``decode_qattention`` (32 launches per tick); the TTFT p50 of the three
   layouts side by side;
   ``[eval]``: the cache-less causal forward at full width at (1, 512) and
   (2, 1024) (finite logits, 32 ``flash_qattention`` launches per forward,
   median latency), profiles of a (1, 512) forward and a 704-token stripe
   prefill, and ``flash_qdecode`` per layer over that stripe's cache, equal
   to ``decode_qattention`` on it; no served path may run the plain flash
   on the card (counted);
   then checks a small model against the same forward on the CPU on the
   paged int8 pool, the packed pool, the stripe, the verify forward and
   without a cache;
6. ``[bert]``: BERT-base at full width (12 layers, d=768, 12 heads, d_ff
   3072, vocab 30522), under the paper's W4A8 policy and under W8A8:
   calibrates on (2, 128) seeded tokens, folds, runs the cache-less integer
   forward at (1, 128), the paper's point, and at (8, 512), checks the
   logits (finite, right shape) and each kernel's launches per forward
   (``quant_softmax`` 12, the policy's GEMM 72, ``quant_layernorm`` 25),
   prints the median latency and sequences/s at (1, 128), and holds the
   small BERT on the card against the CPU (equal logits).

The line before the last is ``{"kernels": [...]}`` (per kernel: launches
on the served path, mismatches, times, bound); the last is
``{"ok": true, "device": {...}}``.  Any fault exits non-zero before that
line; without a card, or without the rest of the repository, it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 67e12          # H100 SXM CUDA-core float32 rate (32-bit ops)
L2_BYTES = 50 << 20            # H100 L2 cache
SEED = 0
LINEARS_PER_LAYER = 7          # yi-6b: wq, wk, wv, wo, wg, wu, wd, each an int4_matmul


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def sass_ops(path: str) -> dict:
    """Counts of the integer tensor-core instructions (IMMA: mma.sync,
    IGMMA: wgmma) and of IDP (__dp4a) in a built library's SASS
    (``cuobjdump`` beside ``nvcc``)."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("IMMA", "IGMMA", "IDP")}


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, args, cold: bool = True, batches: int = 3) -> float:
    """Device time per call of ``fn(*args)``, median over ``batches``.

    ``cold``: copies of the inputs that together exceed the 50 MB L2 run
    back to back, at least 8 calls between two events, so every call reads
    cold inputs, as each layer does on the served path; the stream is
    first held busy (``torch.cuda._sleep``) for longer than the host takes
    to enqueue the calls, so the events time the device and not the Python
    that launches them.  Otherwise 3 calls on the same inputs (the plain
    versions, whose eager launches the host paces)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n_sets = min(64, -(-2 * L2_BYTES // max(nbytes, 1))) if cold else 1
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(n_sets - 1)]
    calls = [sets[i % n_sets] for i in range(max(n_sets, 8) if cold else 3)]
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        torch.cuda._sleep(int((1.5 * host_s * len(calls) + 1e-3) * 2e9))  # ~2 GHz clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in calls:
            fn(*c)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / len(calls))
    return float(np.median(per_call))


def compare(got, want):
    """(mismatching codes, largest absolute difference) of two int arrays."""
    d = (got.long() - want.long()).abs()
    return int((d > 0).sum()), float(d.max())


def reset_gemm_paths():
    from repro_torch.kernels import int4_matmul as mm

    for f in (mm.int4_matmul, mm.int8_bitsplit_matmul):
        f.path_launches = dict.fromkeys(mm.PATHS, 0)


def gemm_paths(name: str = "int4_matmul") -> dict:
    """A GEMM wrapper's launches by path since the last reset_gemm_paths()."""
    from repro_torch.kernels import int4_matmul as mm

    return dict(getattr(mm, name).path_launches)


def check_paths(what, got, tc_forwards, decode_forwards, per_forward):
    """Every GEMM of a prefill (or cache-less) forward took the tensor-core
    path, every GEMM of a decode forward the decode path."""
    want = {"tensor_core": per_forward * tc_forwards, "decode": per_forward * decode_forwards}
    check(got == want, f"{what}: GEMM launches by path {got} != {want} (every prefill GEMM "
          "on the tensor cores, every decode GEMM on the decode path)")


# --- kernel phases -------------------------------------------------------------

def _rand_i8(torch, gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


# (K, N) of yi-6b's linears (wq and wo, wk and wv, wg and wu, wd) and of
# BERT-base's (the four attention projections, w1, w2)
YI6B_GEMMS = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096))
BERT_GEMMS = ((768, 768), (768, 3072), (3072, 768))


def gemm_phase(torch, gen, w4: bool, shapes, main_shape, shape_text):
    """One integer GEMM (``int4_matmul`` if ``w4``, else
    ``int8_bitsplit_matmul``) at each (M, K, N) of ``shapes``: equal to its
    plain version, then timed beside the plain version and
    ``torch._int_mm`` on the same product (int32 accumulator only; it needs
    more than 16 rows, so a decode batch is padded to 32).  Prints a row per
    shape with the path and tile ``plan`` chose, the kernel / _int_mm factor
    and the kernel's share of its bound; returns the ``main_shape`` row."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core import packing
    from repro_torch.kernels import int4_matmul as mod
    from repro_torch.kernels.ref import int4_matmul_ref, int8_bitsplit_matmul_ref

    fn, plain = ((mod.int4_matmul, int4_matmul_ref) if w4 else
                 (mod.int8_bitsplit_matmul, int8_bitsplit_matmul_ref))
    mism, err, rows = 0, 0.0, []
    for m, k, n in shapes:
        x = _rand_i8(torch, gen, (m, k))
        if w4:
            w = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.uint8)
            w8 = packing.unpack_int4_planar(w, axis=0)
        else:
            w = w8 = _rand_i8(torch, gen, (k, n))
        bias = torch.randint(-(1 << 16), 1 << 16, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        M, sh = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in
                 fxp.quantize_multiplier(40.0 / (np.sqrt(k) * 73.0 * (4.6 if w4 else 73.0))))
        args = (x, w, bias, M, sh)
        c, e = compare(fn(*args), plain(*args))
        mism, err = mism + c, max(err, e)
        xl = torch.cat([x, x.new_zeros((32 - m, k))]) if m < 32 else x
        p = mod.plan(m, k, n, 4 if w4 else 8)
        row = dict(m=m, k=k, n=n, plan=p, mismatches=c, ms=device_ms(torch, fn, args),
                   plain_ms=device_ms(torch, plain, args, cold=False),
                   library_ms=device_ms(torch, torch._int_mm, (xl, w8)))
        w_bytes = k * n // 2 if w4 else k * n
        row["bound_ms"], row["bound_by"] = bound_ms(m * k + w_bytes + 4 * n + m * n,
                                                    2.0 * m * k * n)
        rows.append(row)
        print(f"  {fn.__name__} M={m:4d} K={k:5d} N={n:5d} [{p.path} {p.bm}x{p.bn} split "
              f"{p.split}]: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, _int_mm "
              f"{row['library_ms']:.4f} ms, kernel/_int_mm {row['ms'] / row['library_ms']:.2f}x, "
              f"{100 * row['bound_ms'] / row['ms']:.1f} % of the {row['bound_by']} bound "
              f"({row['bound_ms']:.5f} ms)", flush=True)
    big = [r for r in rows if r["m"] >= 128]
    print(f"  {fn.__name__} faster than torch._int_mm at every shape with M >= 128: "
          f"{all(r['ms'] < r['library_ms'] for r in big)} "
          f"({sum(r['ms'] < r['library_ms'] for r in big)} of {len(big)})")
    main = next(r for r in rows if (r["m"], r["k"], r["n"]) == main_shape)
    return dict(main, mismatches=mism, max_abs_err=err, shape=shape_text,
                rows={(r["m"], r["k"], r["n"]): r for r in rows})


def phase_int4_matmul(torch, gen):
    # M = 32: a verify forward's rows (8 slots x spec_k + 1 = 4)
    shapes = ([(m, k, n) for m in (8, 32, 128, 256, 512, 2048) for k, n in YI6B_GEMMS]
              + [(m, k, n) for m in (128, 4096) for k, n in BERT_GEMMS])
    row = gemm_phase(torch, gen, True, shapes, (8, 4096, 11008),
                     "M=8 (decode batch) K=4096 N=11008 (wg/wu)")
    row["verify"] = dict(row["rows"][(32, 4096, 11008)],
                         shape="M=32 (verify: 8 slots x 4 rows) K=4096 N=11008 (wg/wu)")
    return row


def launch_floor_ms(torch) -> float:
    """Device time per call of a one-element PyTorch op (``torch.neg``),
    timed by the same loop as the kernels: the least time a launch takes."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    return device_ms(torch, torch.neg, (one,))


# (subtract_mean, R, N) of the served LN/RMSNorm calls: yi-6b's RMSNorm at a
# decode tick, a verify forward (8 slots x 4 rows), a 512-row chunk and the
# longest one-shot prefill chunk; LN at yi-6b's width; BERT-base's LN at
# (1, 128) and (8, 512)
LN_SHAPES = ((False, 8, 4096), (False, 32, 4096), (False, 512, 4096), (False, 704, 4096),
             (True, 8, 4096), (True, 512, 4096), (True, 128, 768), (True, 4096, 768))


def ln_cases(torch, gen):
    """(label, x, params) at every LN_SHAPES entry, each batch with a
    zero-variance row."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qlayernorm import QLNParams

    params = {}
    for sub_mean, r, n in LN_SHAPES:
        if (sub_mean, n) not in params:
            gamma = _rand_i8(torch, gen, (n,))
            beta = torch.randint(-(1 << 20), 1 << 20, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32) if sub_mean else \
                torch.zeros(n, dtype=torch.int32, device="cuda")
            M, sh = fxp.quantize_multiplier(3.3e-5)
            params[sub_mean, n] = QLNParams(
                gamma, beta, torch.tensor(M, dtype=torch.int32, device="cuda"),
                torch.tensor(sh, dtype=torch.int32, device="cuda"), sub_mean)
        x = _rand_i8(torch, gen, (r, n))
        x[0] = 3                                  # a zero-variance row
        yield f"R={r} N={n} {'LN' if sub_mean else 'RMS'}", x, params[sub_mean, n]


def phase_quant_layernorm(torch, gen):
    from repro_torch.kernels import quant_layernorm as mod
    from repro_torch.kernels.ref import quant_layernorm_ref

    floor = launch_floor_ms(torch)
    print(f"  launch floor (torch.neg on one element, the same timing loop): {floor:.4f} ms")
    mism, err, main, verify = 0, 0.0, None, None
    for label, x, p in ln_cases(torch, gen):
        r, n = x.shape
        c, e = compare(mod.quant_layernorm(x, p), quant_layernorm_ref(x, p))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, mod.quant_layernorm, (x, p)),
                   plain_ms=device_ms(torch, quant_layernorm_ref, (x, p), cold=False),
                   library_ms=None, launch_floor_ms=floor)
        # x in, codes out, gamma and beta once; ~15 32-bit integer operations per code
        # on the merged path (counted in csrc/quant_layernorm.cu's header)
        row["bound_ms"], row["bound_by"] = bound_ms(2 * r * n + 5 * n, 15.0 * r * n,
                                                    F32_OPS_PER_S)
        print(f"  quant_layernorm {label}: kernel {row['ms']:.4f} ms ({row['ms'] - floor:+.4f} "
              f"over the floor), plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), {c} mismatches")
        if label == "R=512 N=4096 RMS":
            main = row
        if label == "R=32 N=4096 RMS":
            verify = dict(row, mismatches=c, shape="R=32 (verify rows) N=4096 RMSNorm")
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="R=512 (prefill rows) N=4096 RMSNorm", verify=verify)


def _attn_scalars(torch, d):
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qsoftmax import LUT_DELTA
    from repro_torch.kernels.ref import make_exp_lut_q7

    s_logit = 1.0 / (2.0 / (np.sqrt(d) * 73.0 * 73.0))  # random codes: logits ~ +-2
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * LUT_DELTA))
    dev = "cuda"
    return (torch.tensor(M, dtype=torch.int32, device=dev),
            torch.tensor(sh, dtype=torch.int32, device=dev),
            torch.as_tensor(make_exp_lut_q7(), device=dev),
            torch.tensor(np.float32(1.0 / s_logit), device=dev),
            torch.tensor(np.float32(1.1), device=dev))


def _chains(torch, rows, nb, n_pages, psize):
    btab = torch.zeros((len(rows), nb), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    used = 0
    for b, ln in enumerate(rows):
        k = -(-int(ln) // psize)
        btab[b, :k] = perm[used:used + k]
        used += k
    return btab.to("cuda")


def _pack_pool(torch, gen, n_pages, psize, hkv, d):
    """A random int4-packed pool (every nibble code) and fp32 page scales as
    the write path makes them (max(amax, 1) / 7 for amax in 1..127); page 0,
    the trash page, at the all-zero page's 1/7."""
    packed = torch.randint(0, 256, (n_pages, psize, hkv, d // 2), generator=gen,
                           device="cuda", dtype=torch.uint8)
    amax = torch.randint(1, 128, (n_pages,), generator=gen, device="cuda")
    scales = amax.to(torch.float32) * float(np.float32(1.0 / 7.0))
    scales[0] = float(np.float32(1.0 / 7.0))
    return packed, scales


def _pool(torch, gen, n_pages, psize, hkv, d, packed):
    """(pool arguments, KV bytes per pool row of one kv head, bytes per page
    beyond the rows): int8 K and V, or packed K and V with their scales."""
    if not packed:
        return ((_rand_i8(torch, gen, (n_pages, psize, hkv, d)),
                 _rand_i8(torch, gen, (n_pages, psize, hkv, d))), 2 * d, 0)
    (kp, ks), (vp, vs) = (_pack_pool(torch, gen, n_pages, psize, hkv, d) for _ in range(2))
    return (kp, vp, ks, vs), d, 8


def _decode_shape(torch, gen, lengths, nb, packed):
    """Inputs of the paged decode kernels at yi-6b's heads (Hkv=4, G=8,
    D=128, 16-row pages) for slots of ``lengths`` rows, ``nb`` table
    entries each, and the bound of one call."""
    hkv, g, d, psize = 4, 8, 128, 16
    b = len(lengths)
    n_pages = b * nb + 1
    pool, row_bytes, page_bytes = _pool(torch, gen, n_pages, psize, hkv, d, packed)
    args = (_rand_i8(torch, gen, (b, hkv, g, d)), *pool,
            _chains(torch, lengths, nb, n_pages, psize),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), *_attn_scalars(torch, d))
    pages = [-(-n // psize) for n in lengths]
    bound = bound_ms(2 * b * hkv * g * d + sum(lengths) * hkv * row_bytes
                     + page_bytes * sum(pages) + 4 * b * (nb + 1) + 1024,
                     4.0 * hkv * g * d * sum(lengths))
    return args, pages, bound


def phase_paged_decode(torch, gen, packed=False):
    """The split paged decode at the decode tick's shape (B=8, lengths
    33-1000) and on one 4,096-row chain: equal to the plain version, the
    kernel, plain and bound times, and the blocks of each launch."""
    from repro_torch.kernels import decode_attention as mod
    from repro_torch.kernels import ref

    fn, plain = (mod.paged_decode_qattention_q4, ref.paged_decode_qattention_q4_ref) \
        if packed else (mod.paged_decode_qattention, ref.paged_decode_qattention_ref)
    shapes = {"B=8": ([33, 100, 250, 400, 520, 640, 700, 1000], 64),   # yi-6b, max_len 1024
              "B=1 len=4096": ([4096], 256)}                           # yi-6b's full context
    rows = {}
    for label, (lengths, nb) in shapes.items():
        args, pages, (bnd, bnd_by) = _decode_shape(torch, gen, lengths, nb, packed)
        mism, err = compare(fn(*args), plain(*args))
        blocks = -(-nb // mod.SPAN) * 4 * len(lengths)
        live = sum(4 * -(-n // mod.SPAN) for n in pages)
        rows[label] = dict(ms=device_ms(torch, fn, args),
                           plain_ms=device_ms(torch, plain, args, cold=False), library_ms=None,
                           mismatches=mism, max_abs_err=err, bound_ms=bnd, bound_by=bnd_by,
                           launches_per_call=3, blocks=blocks, live_blocks=live,
                           shape=f"{label} Hkv=4 G=8 D=128 P=16{' packed' if packed else ''} "
                                 f"lengths={lengths}")
        print(f"  {fn.__name__} {label}: kernel {rows[label]['ms']:.4f} ms, "
              f"plain {rows[label]['plain_ms']:.4f} ms, "
              f"bound {bnd:.5f} ms ({bnd_by}); passes A and B {blocks} blocks each, "
              f"{live} with pages to run, the carry {len(lengths) * 4 * 8} blocks; "
              f"{mism} mismatching codes")
    long_row = rows["B=1 len=4096"]
    check(long_row["mismatches"] == 0,
          f"{fn.__name__}: kernel != plain version on the 4,096-row chain")
    return dict(rows["B=8"], long=long_row)


def phase_paged_prefill(torch, gen, packed=False):
    """The paged prefill at yi-6b's heads: a 512-row one-shot prompt, a
    128-row chunk at position 256, two unaligned slots, the longest one-shot
    prompt (704 rows) and the last 16-row chunk of a 1,024-row chain; equal
    to the plain version, the kernel, plain and bound times of each."""
    from repro_torch.kernels import prefill_attention as mod
    from repro_torch.kernels import ref

    fn, plain = (mod.paged_prefill_qattention_q4, ref.paged_prefill_qattention_q4_ref) \
        if packed else (mod.paged_prefill_qattention, ref.paged_prefill_qattention_ref)
    h, hkv, d, psize = 32, 4, 128, 16
    cases = {"main": (512, [0]), "chunk": (128, [256]), "unaligned": (64, [37, 0]),
             "long": (704, [0]), "last_chunk": (16, [1008])}
    if not packed:      # the speculative verify forward (int8 pool only): S = spec_k + 1
        cases["verify"] = (4, VERIFY_POS0)
    mism, err, rows_of = 0, 0.0, {}
    for label, (sq, pos0) in cases.items():
        nb = 64 if label == "verify" else -(-(max(pos0) + sq) // psize) + 1  # 1,024-row chains
        n_pages = len(pos0) * nb + 1
        pool, row_bytes, page_bytes = _pool(torch, gen, n_pages, psize, hkv, d, packed)
        args = (_rand_i8(torch, gen, (len(pos0), h, sq, d)), *pool,
                _chains(torch, [p + sq for p in pos0], nb, n_pages, psize),
                torch.tensor(pos0, dtype=torch.int32, device="cuda"), *_attn_scalars(torch, d))
        c, e = compare(fn(*args), plain(*args))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, fn, args),
                   plain_ms=device_ms(torch, plain, args, cold=False), library_ms=None,
                   mismatches=c, shape=f"B={len(pos0)} H=32 Hkv=4 D=128 P=16"
                                       f"{' packed' if packed else ''} S={sq} pos0={pos0}")
        keys = sum(sum(p + i + 1 for i in range(sq)) for p in pos0)
        rows = sum(p + sq for p in pos0)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * len(pos0) * h * sq * d + rows * hkv * row_bytes
            + page_bytes * -(-rows // psize) + 4 * len(pos0) * nb + 1024, 4.0 * h * d * keys)
        print(f"  {fn.__name__} S={sq} pos0={pos0}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}); "
              f"{c} mismatching codes")
        rows_of[label] = row
    return dict(rows_of["main"], mismatches=mism, max_abs_err=err,
                **{k: rows_of[k] for k in ("chunk", "long", "last_chunk", "verify")
                   if k in rows_of})


# the verify case of row 3: 8 slots' decode cursors (the decode tick's
# lengths 33-1000, most not on a page boundary), 4 rows each
VERIFY_POS0 = [33, 100, 250, 400, 520, 640, 700, 1000]


def _stripe_blocks(mod, lengths, smax, bkv, hkv=4):
    """CTAs of passes A and B of the stripe decode at ``lengths``: every
    span, and those whose first row lies below the slot's length."""
    subtiles = -(-bkv // mod.STRIPE_ROWS)
    spb = -(-subtiles // mod.STRIPE_WARPS)
    starts = [j * bkv + si * mod.STRIPE_WARPS * mod.STRIPE_ROWS
              for j in range(smax // bkv) for si in range(spb)]
    live = sum(hkv * sum(r < n for r in starts) for n in lengths)
    return len(lengths) * hkv * len(starts), live


def phase_decode_contiguous(torch, gen):
    """Row 6 at yi-6b's group (Hkv 4, G 8, D 128), bkv 512: the decode
    tick's batch (B=8, lengths 33-1000 on 1,024-row stripes) and one slot
    over yi-6b's full context (B=1, 4,096 rows); equal to the plain
    version, the kernel, plain and bound times, and the CTAs of each pass."""
    from repro_torch.kernels import decode_attention as mod
    from repro_torch.kernels.ref import decode_qattention_ref

    hkv, g, d, bkv = 4, 8, 128, 512
    shapes = {"B=8": ([33, 100, 250, 400, 520, 640, 700, 1000], 1024),   # yi-6b, max_len 1024
              "B=1 len=4096": ([4096], 4096)}                            # yi-6b's full context
    rows_of = {}
    for label, (lengths, smax) in shapes.items():
        b = len(lengths)
        args = (_rand_i8(torch, gen, (b, hkv, g, d)), _rand_i8(torch, gen, (b, smax, hkv, d)),
                _rand_i8(torch, gen, (b, smax, hkv, d)),
                torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                *_attn_scalars(torch, d))

        def kernel(*a):
            return mod.decode_qattention(*a, bkv=bkv)

        def plain(*a):
            return decode_qattention_ref(*a, bkv)

        mism, err = compare(kernel(*args), plain(*args))
        row = dict(ms=device_ms(torch, kernel, args),
                   plain_ms=device_ms(torch, plain, args, cold=False),
                   library_ms=None, mismatches=mism, max_abs_err=err, launches_per_call=3,
                   shape=f"{label} Hkv=4 G=8 D=128 Smax={smax} bkv=512 lengths={lengths}")
        # the function needs the live rows only: a masked key's numerator is 0
        rows = sum(lengths)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * b * hkv * g * d + 2 * rows * hkv * d + 4 * b + 1024, 4.0 * hkv * g * d * rows)
        blocks, live = _stripe_blocks(mod, lengths, smax, bkv, hkv)
        print(f"  decode (contiguous) {label} Smax={smax} bkv={bkv} lengths={lengths}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}); passes A and B {blocks} CTAs "
              f"each, {live} with rows to run, the carry "
              f"{b * hkv * g * d // 4 // 32} CTAs; {mism} mismatching codes")
        rows_of[label] = row
    long_row = rows_of["B=1 len=4096"]
    check(long_row["mismatches"] == 0,
          "decode_qattention: kernel != plain version on the 4,096-row stripe")
    return dict(rows_of["B=8"], long=long_row)


def phase_flash_qattention(torch, gen):
    """Row 9 at yi-6b's heads (H 32, Hkv 4, D 128): the (1, 512) cache-less
    prefill at its serving block, the 700-token prompt's stripe bucket (S
    704, bkv 352), ``ops.attention_q``'s default block (S 1024, bkv 128)
    and a q_offset (Sq 128 at 896 over Skv 1024).  q, k and v are (B, S,
    H, D) tensors seen transposed, as the serving forward hands them over."""
    from repro_torch.kernels import flash_qattention as mod

    h, hkv, d = 32, 4, 128
    cases = [(512, 512, 0, 512), (704, 704, 0, 352), (1024, 1024, 0, 128),
             (128, 1024, 896, 512)]
    mism, err, main = 0, 0.0, None
    for sq, skv, q_offset, bkv in cases:
        q = _rand_i8(torch, gen, (1, sq, h, d)).transpose(1, 2)
        k, v = (_rand_i8(torch, gen, (1, skv, hkv, d)).transpose(1, 2) for _ in range(2))
        args = (q, k, v, *_attn_scalars(torch, d))

        def kernel(*a):
            return mod.flash_qattention(*a, q_offset=q_offset, bkv=bkv)

        def plain(*a):
            return mod.flash_qattention_torch(*a, q_offset=q_offset, bkv=bkv)

        c, e = compare(kernel(*args), plain(*args))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, kernel, args),
                   plain_ms=device_ms(torch, plain, args, cold=False), library_ms=None)
        # the keys up to the last row's frontier, each read once; every live
        # causal pair costs 2 * D operations in QK^T and 2 * D in P.V
        keys = min(skv, q_offset + sq)
        pairs = h * sum(min(skv, q_offset + i + 1) for i in range(sq))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * h * sq * d + 2 * hkv * keys * d + 1024 + 16, 4.0 * d * pairs)
        print(f"  flash_qattention Sq={sq} Skv={skv} q_offset={q_offset} bkv={bkv}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), {c} mismatches")
        if main is None:
            main = row
    print("  library: none (no single PyTorch call computes the q7 LUT flash; "
          "scaled_dot_product_attention is a float softmax)")
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="B=1 H=32 Hkv=4 D=128 S=512 bkv=512 (the (1, 512) prefill)")


def phase_flash_qdecode(torch, gen):
    """Row 10 at yi-6b's group (Hkv 4, G 8, D 128), bkv 512: a 1024-row
    cache holding 1000 keys and a 4096-row one holding 3000."""
    from repro_torch.kernels import flash_qattention as mod
    from repro_torch.kernels.ref import flash_qdecode_ref

    hkv, g, d, bkv = 4, 8, 128, 512
    mism, err, main = 0, 0.0, None
    for smax, cache_len in ((1024, 1000), (4096, 3000)):
        args = (_rand_i8(torch, gen, (hkv, g, d)), _rand_i8(torch, gen, (hkv, smax, d)),
                _rand_i8(torch, gen, (hkv, smax, d)),
                torch.tensor(cache_len, dtype=torch.int32, device="cuda"),
                *_attn_scalars(torch, d))

        def kernel(*a):
            return mod.flash_qdecode(*a, bkv=bkv)

        def plain(*a):
            return flash_qdecode_ref(*a, bkv=bkv)

        c, e = compare(kernel(*args), plain(*args))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, kernel, args),
                   plain_ms=device_ms(torch, plain, args, cold=False), library_ms=None)
        # the live rows only: a masked key's numerator is 0
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * hkv * g * d + 2 * cache_len * hkv * d + 4 + 1024 + 16,
            4.0 * hkv * g * d * cache_len)
        print(f"  flash_qdecode Smax={smax} cache_len={cache_len} bkv={bkv}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), {c} mismatches")
        if main is None:
            main = row
    print("  library: none (no single PyTorch call computes the q7 LUT decode)")
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="Hkv=4 G=8 D=128 Smax=1024 bkv=512 cache_len=1000")


def softmax_cases(torch, gen):
    """(label, args) of BERT's softmax rows: B * 12 heads * S queries of S
    keys at (1, 128) and (8, 512), and a ragged S = 77 with the tail of every
    third row masked."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core import qsoftmax as qs

    lut = torch.as_tensor(qs.make_exp_lut(), dtype=torch.int32, device="cuda")
    M, sh = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in
             fxp.quantize_multiplier(1.0 / (40.0 * qs.LUT_DELTA)))
    for r, s in ((1536, 128), (49152, 512), (7392, 77)):
        x = torch.randint(-400_000, 400_000, (r, s), generator=gen, device="cuda",
                          dtype=torch.int32)
        if s == 77:
            x[::3, 50:] -= qs.MASK_OFFSET
        yield f"R={r} S={s}", (x, M, sh, lut)


def phase_quant_softmax(torch, gen):
    from repro_torch.kernels import quant_softmax as mod
    from repro_torch.kernels.ref import quant_softmax_ref

    floor = launch_floor_ms(torch)
    print(f"  launch floor (torch.neg on one element, the same timing loop): {floor:.4f} ms")
    mism, err, main = 0, 0.0, None
    for label, args in softmax_cases(torch, gen):
        r, s = args[0].shape
        c, e = compare(mod.quant_softmax(*args), quant_softmax_ref(*args))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, mod.quant_softmax, args),
                   plain_ms=device_ms(torch, quant_softmax_ref, args, cold=False),
                   library_ms=None, launch_floor_ms=floor)
        # 4 bytes in and 1 out per code; ~16 32-bit integer operations per code
        row["bound_ms"], row["bound_by"] = bound_ms(5 * r * s + 4 * 256 + 8, 16.0 * r * s,
                                                    F32_OPS_PER_S)
        print(f"  quant_softmax {label}: kernel {row['ms']:.4f} ms ({row['ms'] - floor:+.4f} "
              f"over the floor), plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), "
              f"{100 * row['bound_ms'] / row['ms']:.1f} % of it, {c} mismatches")
        if main is None:
            main = row
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="R=1536 S=128 (BERT-base at (1, 128): 12 heads x 128 queries)")


def phase_int8_bitsplit(torch, gen):
    shapes = [(m, k, n) for m in (128, 4096) for k, n in BERT_GEMMS]   # (1, 128), (8, 512)
    return gemm_phase(torch, gen, False, shapes, (128, 768, 3072),
                      "M=128 (BERT-base at (1, 128)) K=768 N=3072 (w1)")


# --- the served path ---------------------------------------------------------------

def _prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, vocab, 128)
    lengths = [32, 700, 160, 450, 96, 600, 250, 380]
    out = []
    for i, n in enumerate(lengths):
        p = rng.integers(0, vocab, n)
        if i in (2, 6):                     # these two share a 128-token prefix
            p[:128] = prefix
        out.append(p.astype(np.int32))
    return out


def profile_steps(torch, step, what: str, n: int = 3):
    """Where the time of ``step()`` goes: ``n`` calls on the host clock
    (each ending in a synchronise) and ``n`` under torch.profiler (device
    activity only); prints the device's busy share of an unprofiled call
    and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    wall_ms = float(np.median(walls)) * 1e3
    busy_ms = sum(r[0] for r in rows) / n / 1e3
    if not rows:
        print(f"  {what}: {wall_ms:.2f} ms wall; device time not measured "
              "(the profiler recorded none)")
        return
    launches = sum(r[1] for r in rows) // n
    print(f"  {what}: {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), {launches} device kernels per call")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / n / 1e3:8.3f} ms/call {count // n:5d}x  {key[:80]}")
    for label, picked in (
            ("integer GEMMs, every path and the split-K reduce",
             [r for r in rows if "fq::igemm::" in r[2]]),
            ("paged decode attention, its three passes",
             [r for r in rows if "fq::split_" in r[2]]),
            ("paged prefill attention",
             [r for r in rows if "paged_prefill_kernel" in r[2]]),
            ("contiguous decode attention, its three passes",
             [r for r in rows if "fq::stripe_" in r[2]]),
            ("flash prefill attention", [r for r in rows if "flash_kernel" in r[2]]),
            ("integer LayerNorm", [r for r in rows if "quant_layernorm_kernel" in r[2]]),
            ("LUT softmax", [r for r in rows if "quant_softmax_kernel" in r[2]])):
        if picked:
            ms = sum(r[0] for r in picked) / n / 1e3
            print(f"    {label}: {ms:.3f} ms/call ({100 * ms / busy_ms:.1f} % of device "
                  f"time), {sum(r[1] for r in picked) // n} kernels per call")


def profile_decode(torch, cfg, folded, what="decode tick (batch 8)", **extra):
    """A steady decode tick of the served requests, once every prompt is
    cached (``Engine.poll`` ends in a device-to-host copy)."""
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=1024, **extra))
    for p in _prompts(cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new_tokens=32))
    while eng.sched.waiting or eng.sched.prefilling:
        eng.poll()
    profile_steps(torch, eng.poll, what)


def profile_prefill_chunks(torch, cfg, folded):
    """One paged int8 prefill chunk of 512 rows at position 0 (a one-shot
    prompt) and one of 128 rows at position 256 (a chunked run's chunk),
    each a whole-model forward through the paged pool (16-row pages, a
    64-entry block table): wall and device time, kernels, and the paged
    prefill attention's share."""
    from repro_torch.models import serve_int as S

    pf = S.prepare_folded(cfg, folded)
    nb = 64
    cache = S.init_paged_cache(cfg, nb + 1, 16, device="cuda")
    btab = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
    prompt = torch.as_tensor(_prompts(cfg.vocab_size)[1][None, :512], device="cuda")
    for rows, pos0 in ((512, 0), (128, 256)):
        toks = prompt[:, pos0:pos0 + rows]
        profile_steps(torch, lambda t=toks, p=pos0: S.serve_forward(
            cfg, pf, t, cache=cache, pos_offset=p, mode="prefill", block_tables=btab),
            f"paged int8 prefill chunk, {rows} rows at position {pos0}")


def serve(torch, cfg, folded, kernels, on_engine=None, **extra):
    """The 8 requests through one ``Engine`` (``extra``: EngineConfig fields;
    ``on_engine(eng)`` runs on the engine before the first submit), with
    the counts of ``kernels`` set to 0 just before."""
    from repro_torch.serve.engine import Engine, EngineConfig, Request, RequestStatus

    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=1024, **extra))
    if on_engine is not None:
        on_engine(eng)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in _prompts(cfg.vocab_size)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    reset_gemm_paths()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    first, tick_launches = {}, None
    while eng.has_work:
        before = [k.launches for k in kernels]
        chunks, steps = eng.counters["prefill_chunks"], eng.counters["decode_steps"]
        events = eng.poll()
        now = time.perf_counter() - t0
        for e in events:
            if e.token is not None:
                first.setdefault(e.rid, now)
        if tick_launches is None and eng.counters["prefill_chunks"] == chunks \
                and eng.counters["decode_steps"] == steps + 1:
            tick_launches = [k.launches - b for k, b in zip(kernels, before)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    check(all(r.status is RequestStatus.FINISHED for r in reqs),
          f"not every request finished: {[r.status for r in reqs]}")
    toks = [r.result().tolist() for r in reqs]
    check(all(len(t) == 32 and all(0 <= x < cfg.vocab_size for x in t) for t in toks),
          "a request returned the wrong number of tokens or an out-of-vocab token")
    n_tok = sum(len(t) for t in toks)
    return dict(tokens=toks, counters=dict(eng.counters), launches=launches,
                paths=gemm_paths(), tick_launches=tick_launches, wall_s=wall,
                tok_per_s=n_tok / wall,
                ttft_p50_s=float(np.median(list(first.values()))),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                bytes_per_page=eng.alloc.bytes_per_page if eng.alloc is not None else None)


def print_run(name, r, kernels):
    names = [k.__name__ for k in kernels]
    c = r["counters"]
    print(f"  {name}: {r['tok_per_s']:.1f} tok/s ({r['wall_s']:.2f} s wall), TTFT p50 "
          f"{r['ttft_p50_s'] * 1e3:.1f} ms, peak {r['peak_gib']:.2f} GiB")
    print(f"    counters: { {k: v for k, v in c.items() if v} }")
    print(f"    launches: {dict(zip(names, r['launches']))}")
    print(f"    launches in one decode-only tick: {dict(zip(names, r['tick_launches']))}")
    print(f"    int4_matmul launches by path: {r['paths']}")


def load_yi6b(torch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import calibrated_folded

    cfg = get_config("yi-6b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size) == (32, 4096, 32, 4, 128, 11008, 64000), "yi-6b is not full width")
    t0 = time.perf_counter()
    folded = calibrated_folded(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  yi-6b: init + calibrate (2, 32) + fold {time.perf_counter() - t0:.1f} s, "
          f"folded {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, folded


def phase_serve(torch, cfg, folded, kernels):
    from repro_torch.models import serve_int as S

    runs = {"one-shot": serve(torch, cfg, folded, kernels),
            "chunked": serve(torch, cfg, folded, kernels, max_prefill_chunk=128,
                             max_batched_tokens=256)}
    for name, r in runs.items():
        print_run(name, r, kernels)
        check(all(n > 0 for n in r["launches"]),
              f"{name}: a kernel of the path was never launched: {r['launches']}")
        check_paths(name, r["paths"], r["counters"]["prefill_chunks"],
                    r["counters"]["decode_steps"], LINEARS_PER_LAYER * cfg.n_layers)
    one, chunked = runs["one-shot"], runs["chunked"]
    check(one["tokens"] == chunked["tokens"], "chunked prefill changed the tokens")
    check(one["counters"]["prefix_hits"] >= 1, "the shared prefix was not reused")
    check(chunked["counters"]["chunked_prefills"] >= 1, "no prompt was chunked")
    profile_decode(torch, cfg, folded)
    profile_prefill_chunks(torch, cfg, folded)

    # the integer forward's logits at full width: finite, right shape
    toks = torch.as_tensor(_prompts(cfg.vocab_size)[0][None, :32], device="cuda")
    logits, _ = S.serve_forward(cfg, S.prepare_folded(cfg, folded), toks)
    check(tuple(logits.shape) == (1, 32, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"full-width logits: shape {tuple(logits.shape)} or non-finite values")
    return one


SPEC_K = 3


def count_verify(eng, per_forward: list):
    """Wrap ``eng._verify`` (the speculative verify forward) so each call
    appends the ``paged_prefill_qattention`` launches it made to
    ``per_forward``; the engine's own counters stay the reference's (a
    verify forward counts as one ``decode_steps``)."""
    from repro_torch.kernels import prefill_attention as pa

    inner = eng._verify

    def verify(toks, nrows):
        before = pa.paged_prefill_qattention.launches
        out = inner(toks, nrows)
        per_forward.append(pa.paged_prefill_qattention.launches - before)
        return out

    eng._verify = verify


def profile_verify(torch, cfg, folded):
    """One verify forward of 8 slots x (spec_k + 1) rows, once every prompt
    of the served requests is cached: wall and device time, kernels, the
    paged prefill attention's share."""
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=1024, spec_k=SPEC_K))
    for p in _prompts(cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new_tokens=32))
    while eng.sched.waiting or eng.sched.prefilling:
        eng.poll()
    rng = np.random.default_rng(SEED + 4)
    toks = rng.integers(0, cfg.vocab_size, (8, SPEC_K + 1)).astype(np.int32)
    for b in eng.sched.decoding:
        toks[b, 0] = eng.sched.slots[b].last_token
    nrows = np.full(8, SPEC_K + 1, np.int32)
    print(f"  cursors {eng.pos.tolist()}")
    profile_steps(torch, lambda: eng._verify(toks, nrows),
                  f"verify forward (8 slots x {SPEC_K + 1} rows)")


def phase_spec(torch, cfg, folded, kernels, plain):
    """yi-6b at full width on the paged int8 pool with speculative decoding
    (spec_k = 3), the [serve] requests twice: with ``PromptLookupDraft`` and
    with a ``SequenceDraft`` of the one-shot run's tokens (the oracle).
    Both must give the one-shot run's tokens; every verify forward launches
    ``paged_prefill_qattention`` once per layer (its GEMMs take the tensor
    cores: M = 32); the oracle rejects nothing and needs fewer decode
    forwards than the plain run.  Returns the oracle run."""
    from repro_torch.serve.draft import PromptLookupDraft, SequenceDraft

    seqs = [list(p) + t for p, t in zip(_prompts(cfg.vocab_size), plain["tokens"])]
    plain_steps = plain["counters"]["decode_steps"]
    runs, total = {}, [0] * len(kernels)
    for name, draft in (("prompt lookup", PromptLookupDraft()), ("oracle", SequenceDraft(seqs))):
        per_fwd = []
        r = serve(torch, cfg, folded, kernels, on_engine=lambda e, f=per_fwd: count_verify(e, f),
                  spec_k=SPEC_K, draft=draft)
        c = r["counters"]
        nv = len(per_fwd)
        print_run(f"spec {name}", r, kernels)
        print(f"    decode forwards {c['decode_steps']} ({nv} verify, {c['decode_steps'] - nv} "
              f"plain) against {plain_steps} in the plain run; accepted {c['accepted']} of "
              f"{c['drafted']} drafted ({c['rejected']} rejected), accept_len_hist "
              f"{dict(sorted(c['accept_len_hist'].items()))}; paged_prefill_qattention "
              f"launches per verify forward {sorted(set(per_fwd))}")
        check(r["tokens"] == plain["tokens"], f"spec {name}: tokens differ from plain decode "
              f"(first divergence {first_divergence(plain['tokens'], r['tokens'])})")
        check(c["drafted"] == c["accepted"] + c["rejected"],
              f"spec {name}: drafted {c['drafted']} != accepted + rejected")
        check(all(n == cfg.n_layers for n in per_fwd),
              f"spec {name}: paged_prefill_qattention launches per verify forward {per_fwd}")
        check(r["launches"][2] == cfg.n_layers * (c["prefill_chunks"] + nv),
              f"spec {name}: paged_prefill_qattention launches {r['launches'][2]}")
        check_paths(f"spec {name}", r["paths"], c["prefill_chunks"] + nv, c["decode_steps"] - nv,
                    LINEARS_PER_LAYER * cfg.n_layers)
        total = [a + b for a, b in zip(total, r["launches"])]
        runs[name] = dict(r, verify_forwards=nv)
    oracle = runs["oracle"]
    c = oracle["counters"]
    check(oracle["verify_forwards"] > 0 and c["rejected"] == 0 and c["decode_steps"] < plain_steps,
          f"spec oracle: rejected {c['rejected']}, decode forwards {c['decode_steps']} (plain "
          f"{plain_steps})")
    check(all(n > 0 for n in total), f"spec: a kernel of the path was never launched: {total}")
    profile_verify(torch, cfg, folded)
    return oracle


def phase_router(torch, cfg, folded, kernels, plain):
    """Two ``Engine`` replicas over the one folded yi-6b behind a
    ``ReplicaRouter`` with prefix affinity and the shared prefix tier: the
    [serve] requests must give the one-shot run's tokens and publish pages
    to the tier (every paged handoff publishes); where the requests landed,
    prefix hits and adopted pages are printed, not gated (they follow the
    dispatch order).  Then an ``AsyncServer`` over the router streams the
    first 4 requests again: the streamed tokens must equal the returned
    ones and the one-shot run's."""
    import asyncio

    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.serve.router import ReplicaRouter, RouterConfig
    from repro_torch.serve.server import AsyncServer

    reps = [Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=1024)) for _ in range(2)]
    router = ReplicaRouter(reps, RouterConfig(affinity=True, shared_tier=True))
    prompts = _prompts(cfg.vocab_size)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        router.submit(r)
    ticks = 0
    while router.has_work:
        router.poll()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [r.result().tolist() for r in reqs]
    launches = [k.launches for k in kernels]
    print(f"  router (2 replicas, affinity, shared tier): {sum(map(len, toks)) / wall:.1f} tok/s "
          f"({wall:.2f} s wall, {ticks} router ticks), launches "
          f"{dict(zip([k.__name__ for k in kernels], launches))}")
    for i, rep in enumerate(reps):
        c = rep.counters
        print(f"    replica {i}: completed {c['completed']}, prefix_hits {c['prefix_hits']}, "
              f"published_pages {c['published_pages']}, adopted_pages {c['adopted_pages']}, "
              f"decode_steps {c['decode_steps']}")
    print(f"    router counters {router.counters}, tier pages {router.prefix_tier.n_pages}")
    check(toks == plain["tokens"], "router: tokens differ from the single-engine one-shot run "
          f"(first divergence {first_divergence(plain['tokens'], toks)})")
    check(sum(rep.counters["published_pages"] for rep in reps) > 0,
          "router: no page was published to the shared tier")
    check(all(n > 0 for n in launches), f"router: a kernel was never launched: {launches}")

    async def stream():
        server = AsyncServer(router)
        task = asyncio.ensure_future(server.serve_forever())
        try:
            handles = [await server.submit(Request(prompt=p, max_new_tokens=32))
                       for p in prompts[:4]]
            return [await h.tokens() for h in handles], [h.result().tolist() for h in handles]
        finally:
            server.stop()
            await task

    t0 = time.perf_counter()
    streams, results = asyncio.run(asyncio.wait_for(stream(), 600))
    print(f"  AsyncServer over the router: 4 requests streamed in {time.perf_counter() - t0:.2f} s"
          f", {sum(map(len, streams))} tokens, streams equal the returned tokens: "
          f"{streams == results}")
    check(streams == results == plain["tokens"][:4],
          "AsyncServer: streamed tokens differ from the returned or the one-shot tokens")


def first_divergence(a, b):
    """(request, token index) of the first token where two runs differ, or
    None; requests in order, then tokens."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return i, j
    return None


def phase_kv4(torch, cfg, folded, int8_run):
    """yi-6b at full width on the int4-packed pool: the [serve] requests
    one-shot and chunked.  The paged int8 attention kernels must stay idle
    and the packed ones run 32 times (one per layer) per decode tick and
    per prefill chunk; where kv4's tokens leave the int8 run's is reported,
    not gated (kv4 is a quality contract in the reference too)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa

    q4 = [pa.paged_prefill_qattention_q4, da.paged_decode_qattention_q4]
    int8 = [pa.paged_prefill_qattention, da.paged_decode_qattention]
    kernels = q4 + int8
    runs = {"kv4 one-shot": serve(torch, cfg, folded, kernels, kv_bits=4),
            "kv4 chunked": serve(torch, cfg, folded, kernels, kv_bits=4,
                                 max_prefill_chunk=128, max_batched_tokens=256)}
    for name, r in runs.items():
        print_run(name, r, kernels)
        c = r["counters"]
        want = [cfg.n_layers * c["prefill_chunks"], cfg.n_layers * c["decode_steps"], 0, 0]
        check(r["launches"] == want, f"{name}: launches {r['launches']} != {want} "
              "(32 per prefill chunk and per decode tick, no int8 attention kernel)")
        check(r["tick_launches"][1] == cfg.n_layers, f"{name}: q4 decode launches per tick "
              f"{r['tick_launches'][1]} != {cfg.n_layers}")
        check(r["bytes_per_page"] == 262_400, f"{name}: bytes per page {r['bytes_per_page']}")
        check_paths(name, r["paths"], c["prefill_chunks"], c["decode_steps"],
                    LINEARS_PER_LAYER * cfg.n_layers)
    one, chunked = runs["kv4 one-shot"], runs["kv4 chunked"]
    check(chunked["counters"]["chunked_prefills"] >= 1, "kv4: no prompt was chunked")
    print(f"  bytes per page (16 rows, all layers): kv4 {one['bytes_per_page']:,} vs int8 "
          f"{int8_run['bytes_per_page']:,} ({int8_run['bytes_per_page'] / one['bytes_per_page']:.3f}x)")
    for name, r in runs.items():
        div = first_divergence(int8_run["tokens"], r["tokens"])
        same = sum(x == y for x, y in zip(int8_run["tokens"], r["tokens"]))
        print(f"  {name} vs int8 one-shot: first divergence (request, token) {div}, "
              f"{same} of 8 requests identical (reported, not gated)")
    print(f"  kv4 chunked vs kv4 one-shot: first divergence "
          f"{first_divergence(one['tokens'], chunked['tokens'])} (reported, not gated)")
    profile_decode(torch, cfg, folded, "kv4 decode tick (batch 8)", kv_bits=4)
    return one


def serve_lockstep(torch, cfg, folded, kernels, n=8, prompt_len=32, new=16, temperature=0.0):
    from repro_torch.serve.engine import EngineConfig, LockstepEngine, Request

    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
                    max_new_tokens=new, temperature=temperature) for _ in range(n)]
    eng = LockstepEngine(cfg, folded, EngineConfig(batch_slots=n, max_len=1024))
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    reset_gemm_paths()
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [r.out.tolist() for r in reqs]
    check(all(len(t) == new and all(0 <= x < cfg.vocab_size for x in t) for t in toks),
          "lockstep: a request returned the wrong number of tokens or an out-of-vocab token")
    return dict(tokens=toks, launches=[k.launches for k in kernels], paths=gemm_paths(),
                wall_s=wall, tok_per_s=n * new / wall, steps=prompt_len + new - 1,
                sampled_steps=new - 1 if temperature > 0 else 0)


def sample_draw_ms(torch, cfg, batch, reps=7):
    """Host time of one sampled step's draw over (batch, vocab) float32
    logits, median of ``reps``: ``prng.categorical`` (jax.random's threefry
    Gumbel draw) beside the torch.Generator Gumbel draw the lockstep engine
    used before it followed jax.random."""
    from repro_torch.core import prng

    logits = (np.random.default_rng(SEED + 3).standard_normal((batch, cfg.vocab_size))
              * 4).astype(np.float32)
    key, gen = prng.key(SEED), torch.Generator().manual_seed(SEED)

    def threefry():
        nonlocal key
        key, sub = prng.split(key)
        return prng.categorical(sub, logits / np.float32(0.7), -1)

    def generator():
        z = torch.from_numpy(logits) / 0.7
        u = torch.rand(z.shape, generator=gen).clamp_(min=1e-20)
        return torch.argmax(z - torch.log(-torch.log(u)), -1).numpy()

    ms = {}
    for name, fn in (("threefry", threefry), ("torch.Generator", generator)):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(times))
    print(f"  sampled draw on the host, ({batch}, {cfg.vocab_size}) logits: threefry "
          f"categorical {ms['threefry']:.3f} ms, torch.Generator Gumbel {ms['torch.Generator']:.3f}"
          f" ms (median of {reps}; torch threads {torch.get_num_threads()})")
    return ms


def phase_contiguous(torch, cfg, folded):
    """yi-6b at full width on the contiguous stripe (8 slots x 1024 rows):
    the [serve] requests through the continuous engine (one-shot prefill per
    request through flash_qattention, 32 launches each, then
    decode_qattention at bkv=512, 32 launches per tick), then the
    LockstepEngine on 8 prompts of 32 tokens, 16 new tokens each (it
    prefills through decode steps), greedy and sampled at T=0.7, and the
    host time of one sampled step's draw."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels import prefill_attention as pa

    kernels = [da.decode_qattention, fa.flash_qattention, pa.paged_prefill_qattention,
               da.paged_decode_qattention]
    r = serve(torch, cfg, folded, kernels, cache_layout="contiguous")
    print_run("contiguous", r, kernels)
    c = r["counters"]
    check(c["oneshot_prefills"] == 8, f"contiguous: one-shot prefills {c['oneshot_prefills']}")
    want = [cfg.n_layers * c["decode_steps"], cfg.n_layers * c["oneshot_prefills"], 0, 0]
    check(r["launches"] == want, f"contiguous: launches {r['launches']} != {want} (32 "
          "decode_qattention per tick, 32 flash_qattention per one-shot prefill, no paged "
          "kernel)")
    check_paths("contiguous", r["paths"], c["oneshot_prefills"], c["decode_steps"],
                LINEARS_PER_LAYER * cfg.n_layers)
    stripe = 2 * cfg.n_layers * 8 * 1024 * cfg.n_kv_heads * cfg.hd
    print(f"  stripe: 8 x 1024 rows, {stripe / 1e6:.0f} MB for {cfg.n_layers} layers (K + V)")
    lock = serve_lockstep(torch, cfg, folded, kernels)
    print(f"  lockstep: {lock['tok_per_s']:.1f} tok/s ({lock['wall_s']:.2f} s wall, "
          f"{lock['steps']} decode steps at batch 8), launches "
          f"{dict(zip([k.__name__ for k in kernels], lock['launches']))}")
    check(lock["launches"] == [cfg.n_layers * lock["steps"], 0, 0, 0],
          f"lockstep: launches {lock['launches']} (32 per decode step; it prefills through "
          "decode steps)")
    print(f"  lockstep: int4_matmul launches by path {lock['paths']}")
    check_paths("lockstep", lock["paths"], 0, lock["steps"], LINEARS_PER_LAYER * cfg.n_layers)
    hot = serve_lockstep(torch, cfg, folded, kernels, temperature=0.7)
    print(f"  lockstep sampled (T=0.7): {hot['tok_per_s']:.1f} tok/s ({hot['wall_s']:.2f} s "
          f"wall, {hot['steps']} decode steps, {hot['sampled_steps']} of them sampled); greedy "
          f"{lock['wall_s'] / lock['steps'] * 1e3:.2f} ms per step, sampled "
          f"{hot['wall_s'] / hot['steps'] * 1e3:.2f}")
    check(hot["launches"] == lock["launches"], f"lockstep sampled: launches {hot['launches']}")
    sample_draw_ms(torch, cfg, 8)
    profile_decode(torch, cfg, folded, "contiguous decode tick (batch 8)",
                   cache_layout="contiguous")
    return r


def phase_eval(torch, cfg, folded):
    """yi-6b at full width, the cache-less causal ``serve_forward`` (the
    evaluation path, and the quickstart's) at (1, 512) and (2, 1024):
    finite logits of the right shape, 32 ``flash_qattention`` launches per
    forward (one per layer, the whole batch at once), the median latency;
    a profile of one (1, 512) forward and of one 704-token one-shot
    prefill into a contiguous stripe.  Then ``flash_qdecode``, the
    reference's single-sequence decode (its own public function: no model
    calls it in either package), once per layer over that stripe's K/V
    turned to (Hkv, Smax, D), each equal to ``decode_qattention`` on the
    stripe itself.  Returns the launches of the two flash kernels."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels.ref import make_exp_lut_q7
    from repro_torch.models import serve_int as S

    prep = S.prepare_folded(cfg, folded)
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for b, s, n in ((1, 512, 5), (2, 1024, 3)):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                               device="cuda")
        torch.cuda.synchronize()
        fa.flash_qattention.launches = 0
        reset_gemm_paths()
        logits, _ = S.serve_forward(cfg, prep, toks)
        torch.cuda.synchronize()
        n_flash = fa.flash_qattention.launches
        paths = gemm_paths()
        check_paths(f"eval ({b}, {s})", paths, 1, 0, LINEARS_PER_LAYER * cfg.n_layers)
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"eval ({b}, {s}): logits shape {tuple(logits.shape)} or non-finite values")
        check(n_flash == cfg.n_layers, f"eval ({b}, {s}): flash_qattention launches {n_flash}"
              f" != {cfg.n_layers}")
        out.setdefault("flash_qattention", n_flash)
        del logits
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            S.serve_forward(cfg, prep, toks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        lat = float(np.median(walls))
        print(f"  ({b}, {s}): logits finite, flash_qattention {n_flash} launches per forward,"
              f" int4_matmul by path {paths}; median {lat * 1e3:.2f} ms over {n} forwards ({b * s / lat:.0f} tokens/s; "
              "host clock)")
        if (b, s) == (1, 512):
            profile_steps(torch, lambda: S.serve_forward(cfg, prep, toks), "(1, 512) forward")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 704)).astype(np.int32),
                           device="cuda")
    cache = S.init_cache(cfg, 1, 1024, device="cuda")
    profile_steps(torch, lambda: S.serve_forward(cfg, prep, toks, cache=cache),
                  "stripe one-shot prefill of 704 tokens")
    q = torch.randint(-127, 128, (cfg.n_layers, cfg.n_kv_heads,
                                  cfg.n_heads // cfg.n_kv_heads, cfg.hd),
                      generator=torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda", dtype=torch.int8)
    lut = torch.as_tensor(make_exp_lut_q7(), device="cuda")
    torch.cuda.synchronize()
    fa.flash_qdecode.launches = 0
    got = []
    for layer, f in enumerate(S.layer_views(prep, cfg.n_reps)):
        aq = f["slot0"]["attn_q"]
        kc, vc = (cache["slot0"][c][layer, 0].transpose(0, 1) for c in ("k", "v"))
        got.append(fa.flash_qdecode(q[layer], kc, vc, 704, aq["M_idx"], aq["sh_idx"], lut,
                                    aq["inv_s_logit"], aq["out_scale"], bkv=512))
    torch.cuda.synchronize()
    out["flash_qdecode"] = fa.flash_qdecode.launches
    check(out["flash_qdecode"] == cfg.n_layers,
          f"flash_qdecode launches {out['flash_qdecode']} != {cfg.n_layers}")
    differ = 0
    for layer, f in enumerate(S.layer_views(prep, cfg.n_reps)):
        aq = f["slot0"]["attn_q"]
        want = da.decode_qattention(
            q[layer][None], cache["slot0"]["k"][layer], cache["slot0"]["v"][layer],
            torch.tensor([704], dtype=torch.int32, device="cuda"), aq["M_idx"], aq["sh_idx"],
            lut, aq["inv_s_logit"], aq["out_scale"], bkv=512)
        differ += int((got[layer] != want[0]).sum())
    print(f"  flash_qdecode over the 704-token stripe, {out['flash_qdecode']} launches (one per"
          f" layer): {differ} codes differ from decode_qattention on the same cache")
    check(differ == 0, "flash_qdecode != decode_qattention on the same cache")
    return out


def phase_small_reference(torch):
    """The same prefill + decode of a small yi-6b on the card and on the CPU,
    both through the gpu backend's wrappers (the CPU computes the plain
    versions), on the paged int8 pool, the int4-packed pool and the
    contiguous stripe, then its cache-less prefill.  The card replays the
    CPU's tokens.  The kernels' fp32 carry is the plain versions' own (no
    fast math, no contraction), so the packed pool, the stripe and the
    cache-less prefill must give equal logits; the int8 pool is compared by
    argmax as in earlier runs, with the count printed."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map

    cfg = smoke_config("yi-6b")
    folded_cpu = calibrated_folded(cfg, SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    btab = torch.tensor([[3, 5, 1, 0], [2, 7, 4, 0]], dtype=torch.int32)

    def cache_for(layout, dev):
        if layout == "contiguous":
            return S.init_cache(cfg, 2, 64, device=dev), None
        return (S.init_paged_cache(cfg, 9, 16, 4 if layout == "kv4" else 8, device=dev),
                btab.to(dev))

    prev = os.environ.get("REPRO_TORCH_KERNELS")
    os.environ["REPRO_TORCH_KERNELS"] = "gpu"
    try:
        for layout in ("int8", "kv4", "contiguous"):
            out, fed = {}, []
            for dev in ("cpu", "cuda"):
                folded = tree_map(lambda t, d=dev: t.to(d), folded_cpu)
                cache, bt = cache_for(layout, dev)
                logits, cache = S.serve_forward(cfg, folded, prompt.to(dev), cache=cache,
                                                pos_offset=0, block_tables=bt)
                rows = [logits.reshape(-1, cfg.vocab_size).cpu()]
                for step in range(4):
                    if dev == "cpu":
                        fed.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
                    logits, cache = S.serve_forward(
                        cfg, folded, fed[step].to(dev), cache=cache,
                        pos_offset=torch.full((2,), 32 + step, dtype=torch.int32, device=dev),
                        mode="decode", block_tables=bt)
                    rows.append(logits.reshape(-1, cfg.vocab_size).cpu())
                out[dev] = torch.cat(rows)
            a, b = out["cpu"], out["cuda"]
            check(bool(torch.isfinite(b).all()), f"small model {layout}: non-finite logits")
            differ = int((a != b).sum())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            print(f"  small yi-6b {layout}, card vs CPU: {differ} of {a.numel()} logits "
                  f"differ, argmax agrees on {agree:.4f} of {a.shape[0]} rows")
            if layout == "int8":
                check(agree >= 0.99, f"small model: card and CPU disagree on {1 - agree:.3f}")
            else:
                check(differ == 0, f"small model {layout}: card and CPU logits differ")
        # the verify forward on the int8 pool (the paged prefill kernel at the
        # per-slot cursors 32 and 27), after the same prompt's prefill; the
        # real rows (4 and 2) compared
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32))
        out = {}
        for dev in ("cpu", "cuda"):
            folded = tree_map(lambda t, d=dev: t.to(d), folded_cpu)
            cache, bt = cache_for("int8", dev)
            S.serve_forward(cfg, folded, prompt.to(dev), cache=cache, pos_offset=0,
                            block_tables=bt)
            logits, _ = S.serve_forward(
                cfg, folded, toks.to(dev), cache=cache, mode="verify", block_tables=bt,
                pos_offset=torch.tensor([32, 27], dtype=torch.int32, device=dev),
                verify_rows=torch.tensor([4, 2], dtype=torch.int32, device=dev))
            out[dev] = torch.cat([logits[0, :4], logits[1, :2]]).cpu()
        differ = int((out["cpu"] != out["cuda"]).sum())
        print(f"  small yi-6b verify forward (2 slots, 4 and 2 rows), card vs CPU: {differ} of "
              f"{out['cpu'].numel()} logits differ")
        check(bool(torch.isfinite(out["cuda"]).all()) and differ == 0,
              "small model verify forward: card and CPU logits differ")
        # the cache-less causal prefill (flash_qattention on the card) at an
        # odd length, so its KV block is the whole 37-token row
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32))
        out = {dev: S.serve_forward(cfg, tree_map(lambda t, d=dev: t.to(d), folded_cpu),
                                    toks.to(dev))[0].cpu() for dev in ("cpu", "cuda")}
        differ = int((out["cpu"] != out["cuda"]).sum())
        print(f"  small yi-6b cache-less prefill (2, 37), card vs CPU: {differ} of "
              f"{out['cpu'].numel()} logits differ")
        check(bool(torch.isfinite(out["cuda"]).all()) and differ == 0,
              "small model cache-less prefill: card and CPU logits differ")
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_KERNELS"]
        else:
            os.environ["REPRO_TORCH_KERNELS"] = prev


BERT_LAUNCHES = {"quant_softmax": 12, "gemm": 72, "quant_layernorm": 25}   # per forward


def bert_forward_once(torch, S, cfg, folded, toks, kernels):
    """One cache-less integer forward with the counts of ``kernels`` set to
    0 just before it; returns (logits, launches by kernel name)."""
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    reset_gemm_paths()
    logits, _ = S.serve_forward(cfg, folded, toks)
    torch.cuda.synchronize()
    return logits, {k.__name__: k.launches for k in kernels}


def phase_bert(torch):
    """BERT-base at full width under W4A8 (the paper's FQ-BERT) and W8A8
    (Q8BERT): calibrate, fold, and the cache-less integer forward at the
    paper's (1, 128) and at (8, 512), each through quant_softmax, the
    policy's GEMM and quant_layernorm.  Returns the launches of the
    (1, 128) forward under each policy."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import policy
    from repro_torch.kernels.int4_matmul import int4_matmul, int8_bitsplit_matmul
    from repro_torch.kernels.quant_layernorm import quant_layernorm
    from repro_torch.kernels.quant_softmax import quant_softmax
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S

    base = get_config("bert-base")
    check((base.n_layers, base.d_model, base.n_heads, base.hd, base.d_ff, base.vocab_size,
           base.causal) == (12, 768, 12, 64, 3072, 30522, False), "bert-base is not full width")
    rng = np.random.default_rng(SEED)
    out = {}
    for name in ("POLICY_FQ", "POLICY_W8A8"):
        cfg = dataclasses.replace(base, quant=getattr(policy, name))
        gemm = int8_bitsplit_matmul if cfg.quant.w_bits == 8 else int4_matmul
        kernels = (quant_softmax, gemm, quant_layernorm)
        want = {"quant_softmax": BERT_LAUNCHES["quant_softmax"],
                gemm.__name__: BERT_LAUNCHES["gemm"],
                "quant_layernorm": BERT_LAUNCHES["quant_layernorm"]}
        t0 = time.perf_counter()
        folded = S.prepare_folded(cfg, calibrated_folded(cfg, SEED, device="cuda"))
        torch.cuda.synchronize()
        print(f"  {name}: init + calibrate (2, 128) + fold {time.perf_counter() - t0:.1f} s")
        for b, s in ((1, 128), (8, 512)):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                                   device="cuda")
            logits, launches = bert_forward_once(torch, S, cfg, folded, toks, kernels)
            check(tuple(logits.shape) == (b, s, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"bert {name} ({b}, {s}): logits shape {tuple(logits.shape)} or non-finite")
            check(launches == want, f"bert {name} ({b}, {s}): launches {launches} != {want}")
            paths = gemm_paths(gemm.__name__)
            check_paths(f"bert {name} ({b}, {s})", paths, 1, 0, BERT_LAUNCHES["gemm"])
            print(f"    ({b}, {s}): logits finite, launches per forward {launches}, "
                  f"{gemm.__name__} by path {paths}")
            if (b, s) == (1, 128):
                out[name] = launches
                walls = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    S.serve_forward(cfg, folded, toks)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                lat = float(np.median(walls))
                print(f"    (1, 128) latency median {lat * 1e3:.2f} ms over 10 forwards "
                      f"({1.0 / lat:.1f} sequences/s; host clock, smoke observation)")
                profile_steps(torch, lambda: S.serve_forward(cfg, folded, toks),
                              "(1, 128) forward")
            else:
                t0 = time.perf_counter()
                S.serve_forward(cfg, folded, toks)
                torch.cuda.synchronize()
                print(f"    (8, 512) one forward {(time.perf_counter() - t0) * 1e3:.1f} ms")
        del folded
        torch.cuda.empty_cache()
    return out


def phase_small_bert_reference(torch):
    """The smoke bert-base under both policies: the cache-less integer
    forward on the card (the kernels) against the CPU (the plain versions);
    every stage is integer but the lm_head's exact product and scale, so
    the logits must be equal."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core import policy
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map

    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, 512, (2, 77)).astype(np.int32))
    for name in ("POLICY_FQ", "POLICY_W8A8"):
        cfg = dataclasses.replace(smoke_config("bert-base"), quant=getattr(policy, name))
        folded = calibrated_folded(cfg, SEED, device="cpu")
        want, _ = S.serve_forward(cfg, folded, toks)
        got, _ = S.serve_forward(cfg, tree_map(lambda t: t.to("cuda"), folded), toks.to("cuda"))
        differ = int((got.cpu() != want).sum())
        print(f"  small bert-base {name}, card vs CPU: {differ} of {want.numel()} logits differ")
        check(differ == 0, f"small bert {name}: card and CPU logits differ")


def guard_plain_flash(torch):
    """Wrap the plain flash (``flash_qattention_torch``, where the wrapper
    and ``ops`` call it) so that every call counts by the device of its
    query; returns the live counts."""
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels import ops

    plain = fa.flash_qattention_torch
    calls = {"cuda": 0, "cpu": 0}

    def counted(q, *a, **kw):
        calls[q.device.type] += 1
        return plain(q, *a, **kw)

    fa.flash_qattention_torch = counted
    ops.flash_qattention_torch = counted
    return calls


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch

        from repro_torch.kernels import _build
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_qattention as fa
        from repro_torch.kernels import int4_matmul as mm
        from repro_torch.kernels import prefill_attention as pa
        from repro_torch.kernels import quant_layernorm as ln
        from repro_torch.kernels import quant_softmax as sm
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a CUDA "
              "card only", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on; the lm_head product must stay exact float32")

    start = time.perf_counter()

    def stamp(what):
        print(f"  [{what} done at {time.perf_counter() - start:.0f} s]")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} kernels (nvcc "
          f"{' '.join(_build.FLAGS)})")
    for name, info in _build.build_info.items():
        usage = [line.split(":", 1)[1].strip() for line in info["ptxas"].splitlines()
                 if "Used" in line]
        serial = info["ptxas"].count("C7515")
        ops = sass_ops(info["path"])
        print(f"  {name}: {'; '.join(usage)}"
              + (f"; {serial} ptxas notes that wgmma is serialized" if serial else "")
              + f"; SASS {ops}")
        if name.startswith("paged_prefill_attention") or name in (
                "decode_attention", "flash_qdecode", "flash_qattention"):
            check(ops["IMMA"] > 0 and ops["IDP"] == 0,
                  f"{name}: QK^T and P.V must run on the tensor cores (SASS {ops})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    table = [  # (wrapper, its kernel phase, source, the TPU kernel it replaces)
        (mm.int4_matmul, phase_int4_matmul, mm.SOURCE, mm.REPLACES),
        (ln.quant_layernorm, phase_quant_layernorm, ln.SOURCE, ln.REPLACES),
        (pa.paged_prefill_qattention, phase_paged_prefill, pa.SOURCE, pa.REPLACES),
        (da.paged_decode_qattention, phase_paged_decode, da.SOURCE, da.REPLACES),
        (sm.quant_softmax, phase_quant_softmax, sm.SOURCE, sm.REPLACES),
        (mm.int8_bitsplit_matmul, phase_int8_bitsplit, mm.BITSPLIT_SOURCE, mm.BITSPLIT_REPLACES),
        (da.paged_decode_qattention_q4, lambda t, g: phase_paged_decode(t, g, packed=True),
         da.Q4_SOURCE, da.Q4_REPLACES),
        (pa.paged_prefill_qattention_q4, lambda t, g: phase_paged_prefill(t, g, packed=True),
         pa.Q4_SOURCE, pa.Q4_REPLACES),
        (da.decode_qattention, phase_decode_contiguous, da.STRIPE_SOURCE, da.STRIPE_REPLACES),
        (fa.flash_qattention, phase_flash_qattention, fa.SOURCE, fa.REPLACES),
        (fa.flash_qdecode, phase_flash_qdecode, fa.DECODE_SOURCE, fa.DECODE_REPLACES),
    ]
    check(len(table) == len(_build.KERNELS), "the kernel table and _build.KERNELS disagree")
    engine_wrappers = [fn for fn, *_ in table[:4]]      # the yi-6b engine's kernels
    rows = []
    for fn, phase, *_ in table:
        print(f"[kernel] {fn.__name__}")
        row = phase(torch, gen)
        print(f"  mismatches vs plain: {row['mismatches']} (max abs err {row['max_abs_err']})")
        check(row["mismatches"] == 0, f"{fn.__name__}: kernel != plain version")
        rows.append(row)
    torch.cuda.empty_cache()
    stamp("kernel phases")

    # the served paths must reach the plain flash on no CUDA tensor: every
    # call of it from here on is counted by the device of its query
    plain_calls = guard_plain_flash(torch)
    print("[serve] yi-6b, full width, 8 requests x 32 new tokens")
    cfg, folded = load_yi6b(torch)
    served = phase_serve(torch, cfg, folded, engine_wrappers)
    stamp("serve")
    print(f"[spec] yi-6b, full width, speculative decoding (spec_k={SPEC_K}) on the paged int8 "
          "pool, the same requests")
    spec = phase_spec(torch, cfg, folded, engine_wrappers, served)
    stamp("spec")
    print("[router] yi-6b, full width, two replicas, prefix affinity and the shared tier, the "
          "same requests; then an AsyncServer")
    phase_router(torch, cfg, folded, engine_wrappers, served)
    stamp("router")
    print("[kv4] yi-6b, full width, the int4-packed pool (kv_bits=4), the same requests")
    kv4 = phase_kv4(torch, cfg, folded, served)
    stamp("kv4")
    print("[contiguous] yi-6b, full width, the contiguous stripe and the LockstepEngine")
    contiguous = phase_contiguous(torch, cfg, folded)
    print(f"  TTFT p50: paged int8 one-shot {served['ttft_p50_s']:.3f} s, kv4 one-shot "
          f"{kv4['ttft_p50_s']:.3f} s, contiguous {contiguous['ttft_p50_s']:.3f} s")
    stamp("contiguous")
    print("[eval] yi-6b, full width, the cache-less causal forward at (1, 512) and (2, 1024)")
    evals = phase_eval(torch, cfg, folded)
    stamp("eval")
    check(plain_calls["cuda"] == 0, f"the plain flash ran on the card {plain_calls['cuda']} "
          "times on the served paths")
    print(f"  flash_qattention_torch on a CUDA tensor: {plain_calls['cuda']} calls on the "
          "served paths")
    del folded
    torch.cuda.empty_cache()
    print("[check] small model against the CPU")
    phase_small_reference(torch)
    print("[bert] bert-base, full width, W4A8 and W8A8, cache-less integer forward")
    bert = phase_bert(torch)
    print("[check] small bert-base against the CPU")
    phase_small_bert_reference(torch)
    stamp("all phases")

    # launches: each kernel's count on its own main path (yi-6b one-shot
    # serving for the engine's four, the kv4 one-shot run for the packed
    # pool's two, the contiguous engine's run for decode_qattention and
    # flash_qattention; the [eval] phase's per-layer calls of the public
    # flash_qdecode; BERT at (1, 128) for the other two)
    launches = dict(zip([fn.__name__ for fn in engine_wrappers], served["launches"]))
    rows[2]["verify"].update(launches_per_forward=cfg.n_layers, forwards=spec["verify_forwards"])
    launches["paged_prefill_qattention_q4"], launches["paged_decode_qattention_q4"] = \
        kv4["launches"][:2]
    launches["decode_qattention"], launches["flash_qattention"] = contiguous["launches"][:2]
    launches["flash_qdecode"] = evals["flash_qdecode"]
    launches["quant_softmax"] = bert["POLICY_FQ"]["quant_softmax"]
    launches["int8_bitsplit_matmul"] = bert["POLICY_W8A8"]["int8_bitsplit_matmul"]
    check(all(n > 0 for n in launches.values()), f"a kernel was never launched: {launches}")
    kernels = []
    for (fn, _, source, replaces), row in zip(table, rows):
        kernels.append({
            "name": fn.__name__, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[fn.__name__], "max_abs_err": row["max_abs_err"],
            "mismatches": row["mismatches"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            **({"launch_floor_ms": row["launch_floor_ms"]} if "launch_floor_ms" in row else {}),
            **{case: {k: row[case][k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "mismatches",
                                                "launches_per_forward", "forwards")
                      if k in row[case]}
               for case in ("chunk", "long", "last_chunk", "verify") if case in row}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
