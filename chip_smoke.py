#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA card (an H100),
``nvcc`` and PyTorch built for CUDA.  It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the four CUDA kernels of the serving path from
   ``src/repro_torch/csrc`` and prints the build time and each kernel's
   registers and shared memory;
3. holds every kernel against its plain PyTorch version on the card at the
   yi-6b shapes of the serving path (equal arrays required) and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call;
4. serves yi-6b at full width (32 layers, d=4096, random weights from a
   seed, calibrated on (2, 32) seeded tokens and folded to integers) through
   the port's ``Engine``: 8 requests once with whole-prompt prefill and once
   with chunked prefill, which must give the same tokens, reuse a shared
   prefix and launch every kernel;
5. checks the integer forward's logits (finite, right shape) at full width,
   and on a small model against the same forward on the CPU.

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
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
L2_BYTES = 50 << 20            # H100 L2 cache
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
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


# --- kernel phases -------------------------------------------------------------

def _rand_i8(torch, gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def phase_int4_matmul(torch, gen):
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core import packing
    from repro_torch.kernels import int4_matmul as mod
    from repro_torch.kernels.ref import int4_matmul_ref

    shapes = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096)]
    mism, err, rows, main = 0, 0.0, [], None
    for m in (8, 512):
        for k, n in shapes:
            x = _rand_i8(torch, gen, (m, k))
            w = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                              dtype=torch.uint8)
            bias = torch.randint(-(1 << 16), 1 << 16, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            M, sh = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in
                     fxp.quantize_multiplier(40.0 / (np.sqrt(k) * 73.0 * 4.6)))
            got = mod.int4_matmul(x, w, bias, M, sh)
            c, e = compare(got, int4_matmul_ref(x, w, bias, M, sh))
            mism, err = mism + c, max(err, e)
            # yardstick: torch._int_mm on pre-unpacked int8 weights (int32
            # accumulator only; it needs more than 16 rows, so decode pads)
            w8 = packing.unpack_int4_planar(w, axis=0)
            xl = torch.cat([x, x.new_zeros((32 - m, k))]) if m < 32 else x
            args = (x, w, bias, M, sh)
            row = dict(m=m, k=k, n=n, ms=device_ms(torch, mod.int4_matmul, args),
                       plain_ms=device_ms(torch, int4_matmul_ref, args, cold=False),
                       library_ms=device_ms(torch, torch._int_mm, (xl, w8)))
            row["bound_ms"], row["bound_by"] = bound_ms(m * k + k * n // 2 + 4 * n + m * n,
                                                        2.0 * m * k * n)
            rows.append(row)
            if (m, k, n) == (8, 4096, 11008):
                main = row
    for r in rows:
        print(f"  int4_matmul M={r['m']:4d} K={r['k']:5d} N={r['n']:5d}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, _int_mm "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="M=8 (decode batch) K=4096 N=11008 (wg/wu)")


def phase_quant_layernorm(torch, gen):
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qlayernorm import QLNParams
    from repro_torch.kernels import quant_layernorm as mod
    from repro_torch.kernels.ref import quant_layernorm_ref

    n = 4096
    mism, err, main = 0, 0.0, None
    for sub_mean in (False, True):               # RMSNorm (yi-6b), LayerNorm
        gamma = _rand_i8(torch, gen, (n,))
        beta = torch.randint(-(1 << 20), 1 << 20, (n,), generator=gen, device="cuda",
                             dtype=torch.int32) if sub_mean else \
            torch.zeros(n, dtype=torch.int32, device="cuda")
        M, sh = fxp.quantize_multiplier(3.3e-5)
        p = QLNParams(gamma, beta, torch.tensor(M, dtype=torch.int32, device="cuda"),
                      torch.tensor(sh, dtype=torch.int32, device="cuda"), sub_mean)
        for r in (8, 512):
            x = _rand_i8(torch, gen, (r, n))
            x[0] = 3                              # a zero-variance row
            c, e = compare(mod.quant_layernorm(x, p), quant_layernorm_ref(x, p))
            mism, err = mism + c, max(err, e)
            row = dict(ms=device_ms(torch, mod.quant_layernorm, (x, p)),
                       plain_ms=device_ms(torch, quant_layernorm_ref, (x, p), cold=False),
                       library_ms=None)
            row["bound_ms"], row["bound_by"] = bound_ms(2 * r * n + 5 * n, 2.0 * r * n)
            print(f"  quant_layernorm R={r:4d} N={n} {'LN ' if sub_mean else 'RMS'}: kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
            if r == 512 and not sub_mean:
                main = row
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="R=512 (prefill rows) N=4096 RMSNorm")


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


def phase_paged_decode(torch, gen):
    from repro_torch.kernels import decode_attention as mod
    from repro_torch.kernels.ref import paged_decode_qattention_ref

    hkv, g, d, psize, nb = 4, 8, 128, 16, 64           # yi-6b, max_len 1024
    lengths = [33, 100, 250, 400, 520, 640, 700, 1000]
    b = len(lengths)
    n_pages = b * nb + 1
    kp = _rand_i8(torch, gen, (n_pages, psize, hkv, d))
    vp = _rand_i8(torch, gen, (n_pages, psize, hkv, d))
    args = (_rand_i8(torch, gen, (b, hkv, g, d)), kp, vp,
            _chains(torch, lengths, nb, n_pages, psize),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), *_attn_scalars(torch, d))
    mism, err = compare(mod.paged_decode_qattention(*args), paged_decode_qattention_ref(*args))
    row = dict(ms=device_ms(torch, mod.paged_decode_qattention, args),
               plain_ms=device_ms(torch, paged_decode_qattention_ref, args, cold=False),
               library_ms=None, mismatches=mism, max_abs_err=err,
               shape=f"B=8 Hkv=4 G=8 D=128 P=16 lengths={lengths}")
    live = sum(lengths)
    row["bound_ms"], row["bound_by"] = bound_ms(
        2 * b * hkv * g * d + 2 * live * hkv * d + 4 * b * (nb + 1) + 1024,
        4.0 * hkv * g * d * live)
    print(f"  paged_decode B={b} lengths={lengths}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def phase_paged_prefill(torch, gen):
    from repro_torch.kernels import prefill_attention as mod
    from repro_torch.kernels.ref import paged_prefill_qattention_ref

    h, hkv, d, psize = 32, 4, 128, 16
    cases = [(512, [0]), (128, [256]), (64, [37, 0])]   # one-shot, chunk, unaligned
    mism, err, main = 0, 0.0, None
    for sq, pos0 in cases:
        nb = -(-(max(pos0) + sq) // psize) + 1
        n_pages = len(pos0) * nb + 1
        kp = _rand_i8(torch, gen, (n_pages, psize, hkv, d))
        vp = _rand_i8(torch, gen, (n_pages, psize, hkv, d))
        args = (_rand_i8(torch, gen, (len(pos0), h, sq, d)), kp, vp,
                _chains(torch, [p + sq for p in pos0], nb, n_pages, psize),
                torch.tensor(pos0, dtype=torch.int32, device="cuda"), *_attn_scalars(torch, d))
        c, e = compare(mod.paged_prefill_qattention(*args), paged_prefill_qattention_ref(*args))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, mod.paged_prefill_qattention, args),
                   plain_ms=device_ms(torch, paged_prefill_qattention_ref, args, cold=False),
                   library_ms=None)
        keys = sum(sum(p + i + 1 for i in range(sq)) for p in pos0)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * len(pos0) * h * sq * d + 2 * sum(p + sq for p in pos0) * hkv * d
            + 4 * len(pos0) * nb + 1024, 4.0 * h * d * keys)
        print(f"  paged_prefill S={sq} pos0={pos0}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
        if main is None:
            main = row
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="B=1 H=32 Hkv=4 D=128 P=16 S=512 pos0=0")


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


def profile_decode(torch, cfg, folded, n: int = 3):
    """Where a steady decode tick's time goes: the served requests, once
    every prompt is cached, run ``n`` decode ticks on the host clock and
    ``n`` under torch.profiler (device activity only); prints device time
    by kernel and the device's busy share of an unprofiled tick."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=1024))
    for p in _prompts(cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new_tokens=32))
    while eng.sched.waiting or eng.sched.prefilling:
        eng.poll()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.poll()                      # ends in a device-to-host copy
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.poll()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    wall_ms = float(np.median(walls)) * 1e3
    busy_ms = sum(r[0] for r in rows) / n / 1e3
    if not rows:
        print(f"  decode tick: {wall_ms:.2f} ms wall; device time not measured "
              "(the profiler recorded none)")
        return
    print(f"  decode tick (batch 8): {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %)")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / n / 1e3:8.3f} ms/tick {count // n:5d}x  {key[:80]}")


def serve(torch, cfg, folded, kernels, **extra):
    from repro_torch.serve.engine import Engine, EngineConfig, Request, RequestStatus

    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=1024, **extra))
    reqs = [Request(prompt=p, max_new_tokens=32) for p in _prompts(cfg.vocab_size)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
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
                tick_launches=tick_launches, wall_s=wall, tok_per_s=n_tok / wall,
                ttft_p50_s=float(np.median(list(first.values()))),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_serve(torch, kernels):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S

    cfg = get_config("yi-6b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size) == (32, 4096, 32, 4, 128, 11008, 64000), "yi-6b is not full width")
    t0 = time.perf_counter()
    folded = calibrated_folded(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  yi-6b: init + calibrate (2, 32) + fold {time.perf_counter() - t0:.1f} s, "
          f"folded {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    runs = {"one-shot": serve(torch, cfg, folded, kernels),
            "chunked": serve(torch, cfg, folded, kernels, max_prefill_chunk=128,
                             max_batched_tokens=256)}
    names = [k.__name__ for k in kernels]
    for name, r in runs.items():
        c = r["counters"]
        print(f"  {name}: {r['tok_per_s']:.1f} tok/s ({r['wall_s']:.2f} s wall), TTFT p50 "
              f"{r['ttft_p50_s'] * 1e3:.1f} ms, peak {r['peak_gib']:.2f} GiB")
        print(f"    counters: { {k: v for k, v in c.items() if v} }")
        print(f"    launches: {dict(zip(names, r['launches']))}")
        print(f"    launches in one decode-only tick: {dict(zip(names, r['tick_launches']))}")
        check(all(n > 0 for n in r["launches"]),
              f"{name}: a kernel of the path was never launched: {r['launches']}")
    one, chunked = runs["one-shot"], runs["chunked"]
    check(one["tokens"] == chunked["tokens"], "chunked prefill changed the tokens")
    check(one["counters"]["prefix_hits"] >= 1, "the shared prefix was not reused")
    check(chunked["counters"]["chunked_prefills"] >= 1, "no prompt was chunked")
    profile_decode(torch, cfg, folded)

    # the integer forward's logits at full width: finite, right shape
    toks = torch.as_tensor(_prompts(cfg.vocab_size)[0][None, :32], device="cuda")
    logits, _ = S.serve_forward(cfg, S.prepare_folded(cfg, folded), toks)
    check(tuple(logits.shape) == (1, 32, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"full-width logits: shape {tuple(logits.shape)} or non-finite values")
    del folded
    torch.cuda.empty_cache()
    return one


def phase_small_reference(torch):
    """The same paged prefill + decode of a small yi-6b on the card and on
    the CPU, both through the gpu backend's wrappers (the CPU computes the
    plain versions).  Integer stages agree exactly; the fp32 exp of the
    attention carry may move a code by one, so logits are compared by
    argmax and the differing count is printed."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map

    cfg = smoke_config("yi-6b")
    folded_cpu = calibrated_folded(cfg, SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    btab = torch.tensor([[3, 5, 1, 0], [2, 7, 4, 0]], dtype=torch.int32)
    out, fed = {}, []                  # the card replays the CPU's tokens
    prev = os.environ.get("REPRO_TORCH_KERNELS")
    os.environ["REPRO_TORCH_KERNELS"] = "gpu"
    try:
        for dev in ("cpu", "cuda"):
            folded = tree_map(lambda t, d=dev: t.to(d), folded_cpu)
            cache = S.init_paged_cache(cfg, 9, 16, device=dev)
            logits, cache = S.serve_forward(cfg, folded, prompt.to(dev), cache=cache,
                                            pos_offset=0, block_tables=btab.to(dev))
            rows = [logits.reshape(-1, cfg.vocab_size).cpu()]
            for step in range(4):
                if dev == "cpu":
                    fed.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
                logits, cache = S.serve_forward(
                    cfg, folded, fed[step].to(dev), cache=cache,
                    pos_offset=torch.full((2,), 32 + step, dtype=torch.int32, device=dev),
                    mode="decode", block_tables=btab.to(dev))
                rows.append(logits.reshape(-1, cfg.vocab_size).cpu())
            out[dev] = torch.cat(rows)
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_KERNELS"]
        else:
            os.environ["REPRO_TORCH_KERNELS"] = prev
    a, b = out["cpu"], out["cuda"]
    check(bool(torch.isfinite(b).all()), "small model: non-finite logits on the card")
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"  small yi-6b, card vs CPU: {int((a != b).sum())} of {a.numel()} logits differ, "
          f"argmax agrees on {agree:.4f} of {a.shape[0]} rows")
    check(agree >= 0.99, f"small model: card and CPU disagree on {1 - agree:.3f} of rows")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch

        from repro_torch.kernels import _build
        from repro_torch.kernels.decode_attention import paged_decode_qattention
        from repro_torch.kernels.int4_matmul import int4_matmul
        from repro_torch.kernels.prefill_attention import paged_prefill_qattention
        from repro_torch.kernels.quant_layernorm import quant_layernorm
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

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} kernels (nvcc "
          f"{' '.join(_build.FLAGS)})")
    for name, info in _build.build_info.items():
        usage = [ln.split(":", 1)[1].strip() for ln in info["ptxas"].splitlines()
                 if "Used" in ln]
        print(f"  {name}: {'; '.join(usage)}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    wrappers = [int4_matmul, quant_layernorm, paged_prefill_qattention,
                paged_decode_qattention]
    phases = [phase_int4_matmul, phase_quant_layernorm, phase_paged_prefill,
              phase_paged_decode]
    rows = []
    for fn, phase in zip(wrappers, phases):
        print(f"[kernel] {fn.__name__}")
        row = phase(torch, gen)
        print(f"  mismatches vs plain: {row['mismatches']} (max abs err {row['max_abs_err']})")
        check(row["mismatches"] == 0, f"{fn.__name__}: kernel != plain version")
        rows.append(row)
    torch.cuda.empty_cache()

    print("[serve] yi-6b, full width, 8 requests x 32 new tokens")
    served = phase_serve(torch, wrappers)
    print("[check] small model against the CPU")
    phase_small_reference(torch)

    kernels = []
    for fn, row, n in zip(wrappers, rows, served["launches"]):
        mod = sys.modules[fn.__module__]
        kernels.append({
            "name": fn.__name__, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": n, "max_abs_err": row["max_abs_err"],
            "mismatches": row["mismatches"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"]})
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
