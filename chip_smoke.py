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
   4 rows at ragged, unaligned cursors 33-1000 on 1,024-row chains; the
   paged decode and prefill kernels, int8 and packed, also at the shape of
   one rank of [tp]: Hkv = 1 with its G = 8 q heads)
   and times the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (the two GEMMs at every served
   shape beside ``torch._int_mm``, with the path and tile each took, the
   kernel / ``_int_mm`` factor and the share of the bound, yi-6b's at
   M = 32 too, the verify forward's rows, qwen3-4b's linears at M = 8 and
   512 and qwen2-moe-a2.7b's experts at M = 4, 8 and 43; ``quant_layernorm``
   at every (R, N) a served path runs, yi-6b's 8, 32, 512 and 704 rows,
   BERT-base's 128 and 4,096, qwen3-4b's and qwen2-moe's widths 2560 and
   2048 and stablelm's LN at 2048; ``quant_layernorm`` and
   ``quant_softmax`` beside the launch floor, a one-element ``torch.neg``
   in the same timing loop; the paged decode and prefill kernels, int8 and
   packed, also at G = 1: qwen2-moe's 16 heads of 128 and stablelm's 32
   heads of 64; with mixtral-8x22b's shapes: ``flash_qattention`` with its
   4,096-token window at S = 8,192, 8,064, 4,160, 4,032 and 4,000 and at
   q_offset 8,064 (the skip branch and its margin printed, the time beside
   the unwindowed call; S = 8,192 also in the branch that walks from block
   0), ``decode_qattention`` at G = 6 over 4,096-row rings, the GEMMs at
   K = 6144 / 16384 for M = 4 and 1,250, the attention's at M = 8 and
   4,000, the experts' at 1,300 and 2,560, and the LN at N = 6144 for R =
   8, 4,000, 4,032, 4,160 and 8,192; the [mixtral] phase then holds every
   shape its forwards gave rows 1, 2, 6 and 9 again; with jamba-1.5-large's
   shapes: the GEMMs at K = 8192 / 24576 for M = 1, 8 and 512, the RMSNorm
   at N = 8192 for R = 1, 8 and 512, ``decode_qattention`` at Hkv 8, G 8
   over 256-row stripes (B = 8 and 1), ``flash_qattention`` at H 64, Hkv 8,
   S 512; xlstm-1.3b's LN at N = 2048 for R = 1 and 1,024; with
   qwen2-vl-2b's and musicgen-medium's: the GEMMs at K = 1536 / 8960 / 6144
   for M = 8 and 512, the RMSNorm and the LN at N = 1536 for R = 8 and 512,
   ``decode_qattention`` at (Hkv 2, G 6, D 128) and (Hkv 24, G 1, D 64)
   over 1,024-row stripes (B = 8 and 1), ``flash_qattention`` at (H 12, Hkv
   2, D 128) at (1, 512) and (H = Hkv = 24, D 64) at (8, 64) and (2, 512);
   the [xlstm], [jamba], [qwen2vl] and [musicgen] phases hold every shape
   their forwards gave again);
4. serves yi-6b at full width (32 layers, d=4096, random weights from a
   seed, calibrated on (2, 32) seeded tokens and folded to integers) through
   the port's ``Engine``: 8 requests once with whole-prompt prefill and once
   with chunked prefill, which must give the same tokens, reuse a shared
   prefix and launch every kernel of that path, then profiles a decode
   tick and a 512-row and a 128-row paged prefill chunk; in every served run,
   ``[eval]`` and ``[bert]`` every GEMM must take the path its M implies,
   the decode path at M <= 8 and the tensor cores above (launches counted
   by path against the shapes of the recorded forwards);
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
   ``[tp]`` (``phase_tp``): yi-6b over a 4-rank tensor-parallel mesh on the
   one card (``TPMesh((cuda:0,) * 4)``, one KV head a rank): the [serve]
   requests on the int8 pool, on kv4 and at spec_k=3 (prompt lookup), each
   equal to its tp=1 run in tokens and counters, the paged attention
   kernels 4 x 32 times a decode tick and a prefill chunk (the GEMMs once),
   each rank's shard printed, a decode tick profiled;
   ``[contiguous]``: the same requests on the contiguous stripe (each
   one-shot prefill through ``flash_qattention``, 32 launches), then the
   ``LockstepEngine`` (8 prompts of 32 tokens, 16 new), through
   ``decode_qattention`` (32 launches per tick); the TTFT p50 of the three
   layouts side by side;
   ``[eval]``: the cache-less causal forward at full width at (1, 512) and
   (2, 1024) (finite logits, 32 ``flash_qattention`` launches per forward,
   median latency), profiles of a (1, 512) forward and a 704-token stripe
   prefill, and ``flash_qdecode`` per layer over that stripe's cache, equal
   to ``decode_qattention`` on it;
   ``[qwen3]`` and ``[moe]``: qwen3-4b at full size (36 layers, qk-norm)
   and qwen2-moe-a2.7b at its published widths at ``MOE_DEPTH`` of 24
   layers (60 routed experts top-4 and 4 shared, one ``int4_matmul``
   launch per expert and linear), each
   calibrated and folded on the card (time and GiB printed), the 8
   requests one-shot and chunked through the Engine on the paged int8 pool
   (equal tokens unless the MoE router dropped a choice at capacity, which
   couples a forward's rows: then the drops and the first divergence are
   printed), every GEMM on the path its M implies (a MoE's experts at M =
   capacity), the launches of a decode forward and of a chunk, profiles of
   a decode tick and a 512-row chunk with the experts' share of the GEMM
   time;
   ``[mixtral]``: mixtral-8x22b at its published widths at 4 of 56 layers
   (``phase_mixtral``): 9 requests on the 4,096-row contiguous ring, one of
   4,000 prompt tokens and 160 new that wraps it, gated on the launches (4
   ``flash_qattention`` per one-shot prefill, 4 ``decode_qattention`` per
   tick, no paged kernel), the GEMM paths and the ring; at the first
   layer, before any router, the ring decode equal bit for bit to the
   plain decode over a ring rebuilt from the cache-less forward's K and V
   over the same 4,160 tokens (and the served q, K and V to that
   forward's), the windowed flash equal to its plain version on that
   forward's inputs, and the ring's and the prefill's codes against the
   flash's counted beside the flash against itself at half the block
   (printed); the logits against the cache-less forward (KL and argmax,
   printed, not gated); the (1, 8,192) forward timed and profiled, a tick
   profiled; every shape the phase's forwards gave rows 1, 2, 6 and 9 held
   against the plain versions;
   ``[xlstm]`` and ``[jamba]`` (``phase_recurrent``): xlstm-1.3b at its
   published widths at ``XLSTM_DEPTH`` of 48 layers (21 mLSTM and 3
   sLSTM, d 2048) and jamba-1.5-large at
   its published widths (d 8192, 64 heads, 8 KV heads, d_ff 24,576, vocab
   65,536, Mamba d_state 16) at 8 of 72 layers with ``n_experts=0``, each
   calibrated and folded on the card (time, GiB and the float32 weight
   cache of the weight-only linears printed), 8 requests of 8-64 prompt
   tokens and 32 new through ``make_engine`` (``auto``: the contiguous
   layout, every prompt through the batch-1 decode loop), gated on the
   counters, the launches per forward (``quant_layernorm`` 49 / 17,
   jamba's ``int4_matmul`` 28 on the path its M implies and
   ``decode_qattention`` 1, no flash and no paged kernel) and the dual
   form (the decode recurrence against the cache-less form at xlstm's
   slots 1 and 0 over 128 rows and jamba's slot 0 over 200, within the
   reference's bound); the ``LockstepEngine``'s first divergence printed;
   a tick, a loop step and the (1, 512) cache-less forward profiled (the
   float products' share), (1, 1024) timed for xlstm; the state's bytes a
   slot;
   ``[qwen2vl]`` (``phase_qwen2vl``): qwen2-vl-2b at full size (28 layers,
   M-RoPE, the tied head), which ``make_engine`` must hand to the
   ``LockstepEngine``: the [contiguous] lockstep workload greedy and
   sampled, then the vision stub: 256 image codes on a 16 x 16 ``pos3``
   grid before 256 text tokens, the cache-less (1, 512) forward, the same
   one-shot into a 1,024-row stripe (logits equal to the cache-less
   forward's) and 32 greedy decode steps; ``[musicgen]``
   (``phase_musicgen``): musicgen-medium at full size (48 layers, 4
   codebooks, 4 LM heads), served as the reference serves it, through
   ``serve_forward`` (its ``LockstepEngine.generate`` raises): 8 streams of
   64 frames one-shot into an 8 x 1,024-row stripe (logits equal to the
   cache-less forward's), 64 greedy decode steps of (8, 4, 1) codes, the
   cache-less (2, 4, 512) forward; both gated on the launches per forward
   and the GEMM paths, with a decode step and a prefill profiled;
   no served phase may run a plain version or the ``ref`` datapath's
   attention on the card (``PlainGuard``, counted from ``[serve]`` to
   ``[musicgen]``);
   then checks a small model against the same forward on the CPU on the
   paged int8 pool, the packed pool, the stripe, the verify forward and
   without a cache, and small stablelm-1.6b, qwen3-4b and qwen2-moe-a2.7b
   through the Engine (equal greedy tokens, the differing logits of a
   prefill and 4 decode steps counted), and the small mixtral (window 16):
   one-shot and decode-loop prefills, the LockstepEngine, decode past the
   window, equal greedy tokens; the small xlstm-1.3b and jamba-1.5-large
   (its 4 experts top-2): the Engine's greedy tokens equal, the logits of a
   cache-less prefill and 4 decode steps that differ counted; the small
   qwen2-vl-2b (sections (4, 6, 6)) and musicgen-medium: the vision stub's
   or the codebooks' forward, one-shot prefill and decode steps (and
   qwen2-vl's LockstepEngine), equal greedy tokens;
6. ``[bert]``: BERT-base at full width (12 layers, d=768, 12 heads, d_ff
   3072, vocab 30522), under the paper's W4A8 policy and under W8A8:
   calibrates on (2, 128) seeded tokens, folds, runs the cache-less integer
   forward at (1, 128), the paper's point, and at (8, 512), checks the
   logits (finite, right shape) and each kernel's launches per forward
   (``quant_softmax`` 12, the policy's GEMM 72, ``quant_layernorm`` 25),
   prints the median latency and sequences/s at (1, 128), and holds the
   small BERT on the card against the CPU (equal logits);
7. ``[train]`` (``phase_train``): BERT-base at full size under W4A8 takes
   60 steps of ``make_bert_train_step`` at (32, 128) on the synthetic SST-2
   task of ``launch/train_bert_sst2.py`` (its ``make_batch``; loss and
   accuracy every 10
   steps, ms per step, peak memory; the loss must be finite and its mean
   over the last 10 steps below that over the first 10), its
   ``TrainState`` saved and restored with ``train/checkpoint.py`` (every
   leaf equal bit for bit), the held-out accuracy of the QAT forward beside
   the fp32 policy's (printed, not gated), then the trained backbone folded
   with the trained EMA amax and served as integers at (1, 128) and (8,
   512) through ``int4_matmul``, ``quant_layernorm`` and ``quant_softmax``
   (the launches per forward counted, the logits equal bit for bit to the
   plain versions' on the card); yi-6b at its published widths and 8 of
   its 32 layers (bf16 params, float32 moments, remat) takes 5 steps of
   ``make_train_step`` on one ``SyntheticLM`` batch at (4, 1,024) (loss and
   grad norm each step, all finite, the last loss below the first; ms per
   step, tokens/s, peak memory, the memory reckoned before the run), a step
   and the AdamW update profiled; xlstm-1.3b at full size (48 layers: 6
   sLSTM + 42 mLSTM, d 2,048, bf16 params, float32 moments, remat) takes 2
   steps at (2, 1,024) on one ``SyntheticLM`` batch (S crosses the
   mLSTM's 512-row chunks, each sLSTM layer loops 1,024 times; loss and
   grad norm each step, finite, the last loss below the first; ms per step,
   tokens/s, peak memory, the state reckoned before the run), a step
   profiled and one sLSTM layer's loop (forward, recompute, backward)
   timed alone for its share of the step;
8. ``[sst2]`` (``phase_sst2``): the paper's Table I experiment as
   ``launch/train_bert_sst2.py`` runs it at its defaults (a BERT of
   d_model 128 and 2 layers, 150 QAT steps at (16, 32), lr 1e-3): every 25th
   step's loss and accuracy, the held-out accuracy under FQ and fp32
   execution (printed, not gated) and the wall time; every loss finite;
9. ``[mesh]`` (``phase_mesh``): training over a (data, model) mesh
   (``train/steps.py::jit_train_step``), its ranks named on the one card.
   BERT-base at full size under W4A8 on ``[train]``'s (32, 128) batches:
   3 steps on a (1, 1) mesh equal 3 steps of ``make_bert_train_step``,
   every leaf bit for bit; 3 steps on (4, 1) over ``(cuda:0,) * 4`` with
   FSDP against ``blocked_step``, the same steps on the same 8-row blocks
   with no sharding (each loss and grad norm within ``MESH_RTOL``, step 1's
   gradient and the final moments within ``MESH_RTOL`` of each leaf's
   largest element, the final params within ``MESH_PARAM_LRS`` x lr), the
   32-row unsharded step's losses and params printed beside them; where an
   8-row forward parts from the 32-row one (``rows_island``: the first
   fake-quant site whose input differs, and one product at the two row
   counts); each rank's shard bytes against the bytes its specs give; the
   elastic resize (2 steps on (1, 1), a checkpoint, a restore onto (4, 1)
   whose shards equal the saved leaves, 1 step) equal bit for bit to the
   same run re-split in memory.  yi-6b at ``[train]``'s 8 of 32 layers
   (bf16, remat, (4, 1,024)) on (4, 1) with FSDP: each rank's params and
   moments bytes, the peak reckoned before the run, 2 steps against
   ``blocked_step`` (losses and grad norms within ``MESH_RTOL``) and
   against ``[train]``'s (the first loss within ``MESH_LOSS_RTOL``, the
   second and the first grad norm within ``MESH_TRAIN_RTOL``), ms per step
   beside ``[train]``'s, the collectives' device time, the peak
   memory and a profiled step.  qwen2-moe-a2.7b at its published widths
   (60 experts top-4, 4 shared, bf16, remat) and 2 of 24 layers on (4, 1)
   with FSDP, its ranks routing each MoE layer over the whole batch
   through the counts exchange: 2 steps at (4, 1,024) against
   ``blocked_step`` (whose four blocks route together; each loss, grad
   norm and aux within ``MESH_RTOL``) and against the unsharded step on
   the same batch (the first loss within ``MESH_LOSS_RTOL``, the second
   and the first grad norm within ``MESH_TRAIN_RTOL``), aux > 0; per MoE
   layer the routing choices that differ from the unsharded forward's and
   the choices dropped; ms a step against the unsharded step, the
   exchange's host ms, the peak and each rank's bytes against the specs'.
   Then (``mesh_processes``) BERT-base's and qwen2-moe's (4, 1) runs again
   on MESH_PROCS processes, one a rank, sharing the card over gloo
   (``launch/ranks.py``; the parent frees the card first): every rank's
   params, moments, amax and steps (``ranks.digest``) and every metric
   equal to the one-process runs' bit for bit, the routing counts
   exchanged between the processes; each rank's tally of collectives
   equal to the reckoning from the specs; rank 0's BERT-base checkpoint
   restored equal to the one-process final state, folded and served at
   (1, 128) through rows 1, 2 and 5, each equal to its plain version;
   printed: each rank's own peak against the one-process peak, ms a step
   against the one-process step's, each collective kind's host ms and
   bytes a rank, the op routes (``collectives.ROUTES``).
   Each line carries the card's name and power limit.
10. ``[analysis]`` (``phase_analysis``): the static analysis of the integer
   datapath (``repro_torch.analysis``) on ``[serve]``'s yi-6b weights at
   full width.  Each of ``analyze.PRESETS`` (kv 8/4 x tp 1/4 x spec 0/3,
   tp 4 over ``(cuda:0,) * 4``) as a paged engine of 4 slots x 128 rows
   on 16-row pages: every hot step (decode, prefill chunk, verify)
   recorded op by op and audited; 0 violations over every graph, and
   every graph launched a kernel.  Per graph: ops, float ops (against the
   committed CPU baseline, not gated), the launches each wrapper's own
   counter took, bytes by dtype, the worst exactness ratio of its exact
   integer products over the operands' static ranges (and over this run's
   values).  The kernel lint on the card (the battery of edge-case
   lengths, origins and tables over sentinel, trash and guard pages, with
   every input buffer unchanged by each call; compute-sanitizer's memcheck
   where the tool runs; the shared-memory budget from ptxas and the
   libraries' dynamic requests; argument order; shared bodies): 0
   violations, and every check ok but a memcheck whose tool refuses the
   card, which is printed; each kernel's registers and shared memory
   printed.  The fixtures' self-test must pass.
11. ``[autotune]`` (``phase_autotune``, after the kernel phases, and
   ``phase_autotune_served``, after ``[analysis]``): the launch tuner of
   ``kernels/autotune.py``.  At every GEMM shape of the kernel phases and
   every attention case of the paged prefill, flash prefill and
   contiguous decode phases, every candidate of the knob (the GEMM plans,
   the heads per block, the bkv) must equal the plain version (at that
   bkv), and each GEMM plan's shared memory the library's; one row a shape
   times the off rule's, the model's and the measured pick on cold inputs
   beside the bound.  Racing must move no wrapper counter, and one wrapper
   call each in measured mode must count one launch.  Then the W4A8 GEMMs'
   launches x ms for each mode over yi-6b's one-shot run and a qwen2-moe
   decode tick, and a yi-6b prefill chunk and decode tick under each mode:
   equal logits, bit for bit.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches
on the served path and in ``[tp]``, ``[mixtral]``, ``[xlstm]``, ``[jamba]``,
``[qwen2vl]``, ``[musicgen]`` and ``[train]``,
mismatches, times, bound); the last is
``{"ok": true, "device": {...}}``.  Any fault exits non-zero before that
line; without a card, or without the rest of the repository, it exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:    # the card's ceilings, one source with the port
    from repro_torch.kernels.hw_constants import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.kernels.hw_constants import L2_BYTES
    from repro_torch.kernels.hw_constants import PEAK_F32_OPS as F32_OPS_PER_S
    from repro_torch.kernels.hw_constants import PEAK_INT8_OPS as INT8_OPS_PER_S
except ImportError:     # no port beside this script: main() says so and fails
    pass
SEED = 0


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


def bound_ms(nbytes: float, ops: float, ops_per_s: float | None = None):
    ops_per_s = ops_per_s or INT8_OPS_PER_S
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


# (B, S, mode, launches by counter) of every serve_forward call since the
# last reset_gemm_paths(), S the rows (an image's and the text's; an audio
# arch's frames); filled by record_forwards()
FORWARDS: list = []


def record_forwards(kernels):
    """Wrap ``serve_int.serve_forward`` (the engines and this script call it
    through the module) so that each call appends its token shape, its mode
    and the launches it made: each wrapper of ``kernels`` by name and the
    W4A8 GEMM by path."""
    from repro_torch.kernels import int4_matmul as mm
    from repro_torch.models import serve_int as S

    inner = S.serve_forward

    def counts():
        return dict({k.__name__: k.launches for k in kernels},
                    **{f"gemm {p}": n for p, n in mm.int4_matmul.path_launches.items()})

    def recorded(cfg, folded, tokens, **kw):
        before = counts()
        out = inner(cfg, folded, tokens, **kw)
        after = counts()
        extra = kw.get("extra_embeds_i8")
        rows = int(tokens.shape[-1]) + (0 if extra is None else int(extra.shape[1]))
        FORWARDS.append((int(tokens.shape[0]), rows, kw.get("mode", "prefill"),
                         {k: after[k] - before[k] for k in after}))
        return out

    S.serve_forward = recorded


def reset_gemm_paths():
    from repro_torch.kernels import int4_matmul as mm

    for f in (mm.int4_matmul, mm.int8_bitsplit_matmul):
        f.path_launches = dict.fromkeys(mm.PATHS, 0)
    FORWARDS.clear()


def gemm_paths(name: str = "int4_matmul") -> dict:
    """A GEMM wrapper's launches by path since the last reset_gemm_paths()."""
    from repro_torch.kernels import int4_matmul as mm

    return dict(getattr(mm, name).path_launches)


def forward_gemms(cfg, t: int) -> list:
    """(M, K, N) of every integer GEMM of one super-block of a forward over
    t = B * S rows: an attention slot's four projections and a dense FFN's
    linears at M = t; a MoE slot's shared experts (three linears each) at M
    = t and its routed experts (three each) at M = capacity(t).  A
    recurrent mixer (Mamba, mLSTM, sLSTM) has none: its projections are
    weight-only float products."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import slot_kinds

    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    fe = cfg.moe_d_ff or cfg.d_ff
    out = []
    for mixer, ffn in slot_kinds(cfg):
        if mixer == "attn":
            out += [(t, d, q), (t, d, kv), (t, d, kv), (t, q, d)]
        if ffn == "moe":
            lin = [(d, fe), (d, fe), (fe, d)]
            out += [(t, k, n) for k, n in lin] * cfg.n_shared_experts
            out += [(capacity(t, cfg.n_experts, cfg.top_k), k, n) for k, n in lin] * \
                cfg.n_experts
        elif ffn == "dense":
            lin = [(d, cfg.d_ff)] * (2 if cfg.act == "swiglu" else 1) + [(cfg.d_ff, d)]
            out += [(t, k, n) for k, n in lin]
    return out


def check_paths(what, cfg, got, forwards):
    """Every GEMM of the recorded ``forwards`` took the path its M implies:
    the decode path at M <= 8 (a decode tick, or experts at their capacity
    of 4-8 rows), the tensor cores above."""
    from repro_torch.kernels.int4_matmul import DECODE_MAX_M

    want = {"tensor_core": 0, "decode": 0}
    for b, s, _, _ in forwards:
        for m, _, _ in forward_gemms(cfg, b * s):
            want["decode" if m <= DECODE_MAX_M else "tensor_core"] += cfg.n_reps
    check(got == want, f"{what}: GEMM launches by path {got} != {want} (each GEMM on the "
          "path its M implies)")


# --- kernel phases -------------------------------------------------------------

def _rand_i8(torch, gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


# (K, N) of yi-6b's linears (wq and wo, wk and wv, wg and wu, wd) and of
# BERT-base's (the four attention projections, w1, w2)
YI6B_GEMMS = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096))
BERT_GEMMS = ((768, 768), (768, 3072), (3072, 768))
# qwen3-4b's (wq, wk and wv, wg and wu, wo, wd) and qwen2-moe-a2.7b's
# experts' (wg and wu, wd); the experts run at M = capacity: 4 at a decode
# tick or a chunk of up to 48 rows, 8 at 96 rows, 43 at a 512-row chunk
QWEN3_GEMMS = ((2560, 4096), (2560, 1024), (2560, 9728), (4096, 2560), (9728, 2560))
EXPERT_GEMMS = ((2048, 1408), (1408, 2048))
# mixtral-8x22b's: the attention's (wq and wo, wk and wv) and the experts'
# (wg and wu, wd); each at M = 4 and 1,250, the attention's at a decode tick
# (M = 8) and the long request's 4,000-row one-shot prefill, the experts' at
# their capacity in the 4,160- and 8,192-row cache-less forwards (1,300 and
# 2,560; 4 at a tick, 1,250 at the 4,000-row prefill)
MIXTRAL_ATTN_GEMMS = ((6144, 6144), (6144, 1024))
MIXTRAL_EXPERT_GEMMS = ((6144, 16384), (16384, 6144))
# jamba-1.5-large's (wq and wo, wk and wv, wg and wu, wd), each at M = 1 (a
# decode-loop prefill step), 8 (a tick) and 512 (the cache-less forward)
JAMBA_GEMMS = ((8192, 8192), (8192, 1024), (8192, 24576), (24576, 8192))
# qwen2-vl-2b's (wq and wo, wk and wv, wg and wu, wd) and musicgen-medium's
# (the attention's four, w1, w2), each at a lockstep step or a decode step
# of 8 streams (M = 8) and a 512-row forward or prefill
QWEN2VL_GEMMS = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
MUSICGEN_GEMMS = ((1536, 1536), (1536, 6144), (6144, 1536))


def _gemm_args(torch, gen, m, k, n, w4: bool):
    """Random inputs of one (M, K, N) GEMM, ``int4_matmul``'s (packed int4
    weights) if ``w4``, else ``int8_bitsplit_matmul``'s: (args, the int8
    weights)."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core import packing

    x = _rand_i8(torch, gen, (m, k))
    if w4:
        w = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda", dtype=torch.uint8)
        w8 = packing.unpack_int4_planar(w, axis=0)
    else:
        w = w8 = _rand_i8(torch, gen, (k, n))
    bias = torch.randint(-(1 << 16), 1 << 16, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    M, sh = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in
             fxp.quantize_multiplier(40.0 / (np.sqrt(k) * 73.0 * (4.6 if w4 else 73.0))))
    return (x, w, bias, M, sh), w8


def gemm_phase(torch, gen, w4: bool, shapes, main_shape, shape_text):
    """One integer GEMM (``int4_matmul`` if ``w4``, else
    ``int8_bitsplit_matmul``) at each (M, K, N) of ``shapes``: equal to its
    plain version, then timed beside the plain version and
    ``torch._int_mm`` on the same product (int32 accumulator only; it needs
    more than 16 rows, so a decode batch is padded to 32).  Prints a row per
    shape with the path and tile the tuner chose, the kernel / _int_mm factor
    and the kernel's share of its bound; returns the ``main_shape`` row."""
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels import int4_matmul as mod
    from repro_torch.kernels.ref import int4_matmul_ref, int8_bitsplit_matmul_ref

    sms = _build.sm_count(torch.device("cuda"))
    fn, plain = ((mod.int4_matmul, int4_matmul_ref) if w4 else
                 (mod.int8_bitsplit_matmul, int8_bitsplit_matmul_ref))
    mism, err, rows = 0, 0.0, []
    for m, k, n in dict.fromkeys(shapes):
        args, w8 = _gemm_args(torch, gen, m, k, n, w4)
        x = args[0]
        c, e = compare(fn(*args), plain(*args))
        mism, err = mism + c, max(err, e)
        xl = torch.cat([x, x.new_zeros((32 - m, k))]) if m < 32 else x
        p = autotune.gemm_plan(m, k, n, 4 if w4 else 8, sms)
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


def served_gemm_shapes() -> list:
    """(M, K, N) of the W4A8 GEMMs the kernel phase holds: every served
    arch's linears at the M its paths give (M = 32: a verify forward's rows,
    8 slots x spec_k + 1 = 4)."""
    return list(dict.fromkeys(
        [(m, k, n) for m in (8, 32, 128, 256, 512, 2048) for k, n in YI6B_GEMMS]
        + [(m, k, n) for m in (128, 4096) for k, n in BERT_GEMMS]
        + [(m, k, n) for m in (8, 512) for k, n in QWEN3_GEMMS]
        + [(m, k, n) for m in (4, 8, 43) for k, n in EXPERT_GEMMS]
        + [(m, k, n) for m in (4, 1250)
           for k, n in MIXTRAL_ATTN_GEMMS + MIXTRAL_EXPERT_GEMMS]
        + [(m, k, n) for m in (8, 4000) for k, n in MIXTRAL_ATTN_GEMMS]
        + [(m, k, n) for m in (1300, 2560) for k, n in MIXTRAL_EXPERT_GEMMS]
        + [(m, k, n) for m in (1, 8, 512) for k, n in JAMBA_GEMMS]
        + [(m, k, n) for m in (8, 512) for k, n in QWEN2VL_GEMMS + MUSICGEN_GEMMS]))


def phase_int4_matmul(torch, gen):
    row = gemm_phase(torch, gen, True, served_gemm_shapes(), (8, 4096, 11008),
                     "M=8 (decode batch) K=4096 N=11008 (wg/wu)")
    row["verify"] = dict(row["rows"][(32, 4096, 11008)],
                         shape="M=32 (verify: 8 slots x 4 rows) K=4096 N=11008 (wg/wu)")
    row["qwen3"] = dict(row["rows"][(8, 2560, 9728)],
                        shape="M=8 (qwen3-4b decode batch) K=2560 N=9728 (wg/wu)")
    row["expert"] = dict(row["rows"][(4, 2048, 1408)],
                         shape="M=4 (qwen2-moe expert at a decode tick) K=2048 N=1408 (wg/wu)")
    row["expert_chunk"] = dict(row["rows"][(43, 2048, 1408)],
                               shape="M=43 (qwen2-moe expert, 512-row chunk) K=2048 N=1408")
    row["mixtral"] = dict(row["rows"][(4, 6144, 16384)],
                          shape="M=4 (mixtral expert at a decode tick) K=6144 N=16384 (wg/wu)")
    row["mixtral_prefill"] = dict(row["rows"][(1250, 6144, 16384)],
                                  shape="M=1250 (mixtral expert, 4,000-row prefill) K=6144 "
                                        "N=16384 (wg/wu)")
    row["mixtral_attn"] = dict(row["rows"][(8, 6144, 6144)],
                               shape="M=8 (mixtral decode tick) K=6144 N=6144 (wq/wo)")
    row["mixtral_attn_prefill"] = dict(row["rows"][(4000, 6144, 6144)],
                                       shape="M=4000 (mixtral 4,000-row prefill) K=6144 "
                                             "N=6144 (wq/wo)")
    row["jamba"] = dict(row["rows"][(8, 8192, 24576)],
                        shape="M=8 (jamba decode tick) K=8192 N=24576 (wg/wu)")
    row["jamba_loop"] = dict(row["rows"][(1, 8192, 24576)],
                             shape="M=1 (jamba decode-loop prefill step) K=8192 N=24576 (wg/wu)")
    row["jamba_prefill"] = dict(row["rows"][(512, 24576, 8192)],
                                shape="M=512 (jamba (1, 512) cache-less forward) K=24576 "
                                      "N=8192 (wd)")
    row["qwen2vl"] = dict(row["rows"][(8, 1536, 8960)],
                          shape="M=8 (qwen2-vl lockstep step) K=1536 N=8960 (wg/wu)")
    row["qwen2vl_prefill"] = dict(row["rows"][(512, 8960, 1536)],
                                  shape="M=512 (qwen2-vl vision-stub forward) K=8960 N=1536 "
                                        "(wd)")
    row["musicgen"] = dict(row["rows"][(8, 1536, 6144)],
                           shape="M=8 (musicgen decode step, 8 streams) K=1536 N=6144 (w1)")
    row["musicgen_prefill"] = dict(row["rows"][(512, 6144, 1536)],
                                   shape="M=512 (musicgen one-shot prefill, 8 x 64 frames) "
                                         "K=6144 N=1536 (w2)")
    return row


def launch_floor_ms(torch) -> float:
    """Device time per call of a one-element PyTorch op (``torch.neg``),
    timed by the same loop as the kernels: the least time a launch takes."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    return device_ms(torch, torch.neg, (one,))


# (subtract_mean, R, N) of the served LN/RMSNorm calls: yi-6b's RMSNorm at a
# decode tick, a verify forward (8 slots x 4 rows), a 512-row chunk and the
# longest one-shot prefill chunk; LN at yi-6b's width; BERT-base's LN at
# (1, 128) and (8, 512); qwen3-4b's (2560) and qwen2-moe's (2048) RMSNorm
# and stablelm's LN (2048) at a decode tick and a 512-row chunk; mixtral's
# RMSNorm (6144) at a decode tick, the long request's 4,000-row one-shot
# prefill, the 4,160- and 8,192-row cache-less forwards, and a 4,032-row
# stripe bucket; xlstm-1.3b's LN (2048) at a decode-loop step, a tick and
# the (1, 512) and (1, 1024) cache-less forwards; jamba-1.5-large's RMSNorm
# (8192) at a loop step, a tick and the (1, 512) forward; qwen2-vl-2b's
# RMSNorm and musicgen-medium's LN (1536) at a lockstep or decode step of 8
# and a 512-row forward or prefill
LN_SHAPES = ((False, 8, 4096), (False, 32, 4096), (False, 512, 4096), (False, 704, 4096),
             (True, 8, 4096), (True, 512, 4096), (True, 128, 768), (True, 4096, 768),
             (False, 8, 2560), (False, 512, 2560), (False, 8, 2048), (False, 512, 2048),
             (True, 8, 2048), (True, 512, 2048), (False, 8, 6144), (False, 4000, 6144),
             (False, 4032, 6144), (False, 4160, 6144), (False, 8192, 6144),
             (True, 1, 2048), (True, 1024, 2048), (False, 1, 8192), (False, 8, 8192),
             (False, 512, 8192), (False, 8, 1536), (False, 512, 1536), (True, 8, 1536),
             (True, 512, 1536))


def _ln_params(torch, gen, sub_mean: bool, n: int):
    """Random LN (``sub_mean``) or RMSNorm parameters of width ``n``."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qlayernorm import QLNParams

    gamma = _rand_i8(torch, gen, (n,))
    beta = torch.randint(-(1 << 20), 1 << 20, (n,), generator=gen, device="cuda",
                         dtype=torch.int32) if sub_mean else \
        torch.zeros(n, dtype=torch.int32, device="cuda")
    M, sh = fxp.quantize_multiplier(3.3e-5)
    return QLNParams(gamma, beta, torch.tensor(M, dtype=torch.int32, device="cuda"),
                     torch.tensor(sh, dtype=torch.int32, device="cuda"), sub_mean)


def _ln_input(torch, gen, r: int, n: int):
    """Random (r, n) codes, the first row of zero variance."""
    x = _rand_i8(torch, gen, (r, n))
    x[0] = 3
    return x


def ln_cases(torch, gen):
    """(label, x, params) at every LN_SHAPES entry, each batch with a
    zero-variance row."""
    params = {}
    for sub_mean, r, n in LN_SHAPES:
        if (sub_mean, n) not in params:
            params[sub_mean, n] = _ln_params(torch, gen, sub_mean, n)
        yield (f"R={r} N={n} {'LN' if sub_mean else 'RMS'}", _ln_input(torch, gen, r, n),
               params[sub_mean, n])


def phase_quant_layernorm(torch, gen):
    from repro_torch.kernels import quant_layernorm as mod
    from repro_torch.kernels.ref import quant_layernorm_ref

    floor = launch_floor_ms(torch)
    print(f"  launch floor (torch.neg on one element, the same timing loop): {floor:.4f} ms")
    mism, err, picked = 0, 0.0, {}
    wanted = {"R=512 N=4096 RMS": ("main", "R=512 (prefill rows) N=4096 RMSNorm"),
              "R=32 N=4096 RMS": ("verify", "R=32 (verify rows) N=4096 RMSNorm"),
              "R=8 N=6144 RMS": ("mixtral", "R=8 (mixtral decode tick) N=6144 RMSNorm"),
              "R=4000 N=6144 RMS": ("mixtral_prefill",
                                    "R=4000 (mixtral 4,000-row one-shot prefill) N=6144 "
                                    "RMSNorm"),
              "R=8192 N=6144 RMS": ("mixtral_forward",
                                    "R=8192 (mixtral (1, 8192) forward) N=6144 RMSNorm"),
              "R=8 N=2048 LN": ("xlstm", "R=8 (xlstm decode tick) N=2048 LN"),
              "R=1 N=2048 LN": ("xlstm_loop", "R=1 (xlstm decode-loop step) N=2048 LN"),
              "R=8 N=8192 RMS": ("jamba", "R=8 (jamba decode tick) N=8192 RMSNorm"),
              "R=512 N=8192 RMS": ("jamba_prefill",
                                   "R=512 (jamba (1, 512) forward) N=8192 RMSNorm"),
              "R=8 N=1536 RMS": ("qwen2vl", "R=8 (qwen2-vl lockstep step) N=1536 RMSNorm"),
              "R=512 N=1536 RMS": ("qwen2vl_prefill",
                                   "R=512 (qwen2-vl vision-stub forward) N=1536 RMSNorm"),
              "R=8 N=1536 LN": ("musicgen", "R=8 (musicgen decode step) N=1536 LN"),
              "R=512 N=1536 LN": ("musicgen_prefill",
                                  "R=512 (musicgen one-shot prefill) N=1536 LN")}
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
        if label in wanted:
            key, shape = wanted[label]
            picked[key] = dict(row, mismatches=c, shape=shape)
    return dict(picked.pop("main"), mismatches=mism, max_abs_err=err, **picked)


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


# (label, wrapper name, args, keywords, (bound ms, bound by)) of every case the
# paged prefill, flash prefill and contiguous decode phases held: [autotune]
# tunes the attention knobs at these shapes
ATTN_CASES: list = []


# (Hkv, G, D) of the served archs' attention: yi-6b's GQA, and G = 1 at
# qwen2-moe-a2.7b's 16 heads of 128 and stablelm-1.6b's 32 heads of 64
YI6B_HEADS = (4, 8, 128)
G1_HEADS = {"qwen2-moe G=1": (16, 1, 128), "stablelm G=1": (32, 1, 64)}
# [tp]: yi-6b over TP ranks, each with Hkv / TP = 1 KV head and its G = 8 q heads
TP = 4
TP_HEADS = (YI6B_HEADS[0] // TP, YI6B_HEADS[1], YI6B_HEADS[2])


def _decode_shape(torch, gen, lengths, nb, packed, heads=YI6B_HEADS):
    """Inputs of the paged decode kernels at ``heads`` (Hkv, G, D; 16-row
    pages) for slots of ``lengths`` rows, ``nb`` table entries each, and
    the bound of one call."""
    (hkv, g, d), psize = heads, 16
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
    tick = [33, 100, 250, 400, 520, 640, 700, 1000]                   # max_len 1024
    shapes = {"B=8": (tick, 64, YI6B_HEADS),
              "B=1 len=4096": ([4096], 256, YI6B_HEADS),                # yi-6b's full context
              "tp rank": (tick, 64, TP_HEADS),                          # [tp]'s shard
              **{label: (tick, 64, heads) for label, heads in G1_HEADS.items()}}
    rows = {}
    for label, (lengths, nb, heads) in shapes.items():
        hkv, g, d = heads
        args, pages, (bnd, bnd_by) = _decode_shape(torch, gen, lengths, nb, packed, heads)
        mism, err = compare(fn(*args), plain(*args))
        blocks = -(-nb // mod.SPAN) * hkv * len(lengths)
        live = sum(hkv * -(-n // mod.SPAN) for n in pages)
        rows[label] = dict(ms=device_ms(torch, fn, args),
                           plain_ms=device_ms(torch, plain, args, cold=False), library_ms=None,
                           mismatches=mism, max_abs_err=err, bound_ms=bnd, bound_by=bnd_by,
                           launches_per_call=3, blocks=blocks, live_blocks=live,
                           shape=f"{label} Hkv={hkv} G={g} D={d} P=16"
                                 f"{' packed' if packed else ''} lengths={lengths}")
        print(f"  {fn.__name__} {label} (Hkv={hkv} G={g} D={d}): kernel "
              f"{rows[label]['ms']:.4f} ms, plain {rows[label]['plain_ms']:.4f} ms, "
              f"bound {bnd:.5f} ms ({bnd_by}); passes A and B {blocks} blocks each, "
              f"{live} with pages to run, the carry {len(lengths) * hkv * g * d // 128} "
              f"blocks; {mism} mismatching codes")
    for label, row in rows.items():
        check(row["mismatches"] == 0, f"{fn.__name__}: kernel != plain version at {label}")
    return dict(rows["B=8"], long=rows["B=1 len=4096"], tp_rank=rows["tp rank"],
                g1_moe=rows["qwen2-moe G=1"], g1_stablelm=rows["stablelm G=1"])


def phase_paged_prefill(torch, gen, packed=False):
    """The paged prefill at yi-6b's heads: a 512-row one-shot prompt, a
    128-row chunk at position 256, two unaligned slots, the longest one-shot
    prompt (704 rows) and the last 16-row chunk of a 1,024-row chain; equal
    to the plain version, the kernel, plain and bound times of each."""
    from repro_torch.kernels import prefill_attention as mod
    from repro_torch.kernels import ref

    fn, plain = (mod.paged_prefill_qattention_q4, ref.paged_prefill_qattention_q4_ref) \
        if packed else (mod.paged_prefill_qattention, ref.paged_prefill_qattention_ref)
    yi = (32, 4, 128)                   # (H, Hkv, D)
    psize = 16
    cases = {"main": (512, [0], yi), "chunk": (128, [256], yi), "unaligned": (64, [37, 0], yi),
             "long": (704, [0], yi), "last_chunk": (16, [1008], yi)}
    if not packed:      # the speculative verify forward (int8 pool only): S = spec_k + 1
        cases["verify"] = (4, VERIFY_POS0, yi)
    # [tp]'s shard: a rank's G * Hkv / TP q heads over its Hkv / TP KV heads
    hkv, g, d = TP_HEADS
    cases["tp_rank"] = (512, [0], (hkv * g, hkv, d))
    for label, (hkv, _, d) in G1_HEADS.items():          # G = 1: a one-shot 512-row prompt
        cases[label] = (512, [0], (hkv, hkv, d))
    mism, err, rows_of = 0, 0.0, {}
    for label, (sq, pos0, (h, hkv, d)) in cases.items():
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
                   mismatches=c, shape=f"B={len(pos0)} H={h} Hkv={hkv} D={d} P=16"
                                       f"{' packed' if packed else ''} S={sq} pos0={pos0}")
        keys = sum(sum(p + i + 1 for i in range(sq)) for p in pos0)
        rows = sum(p + sq for p in pos0)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * len(pos0) * h * sq * d + rows * hkv * row_bytes
            + page_bytes * -(-rows // psize) + 4 * len(pos0) * nb + 1024, 4.0 * h * d * keys)
        ATTN_CASES.append((f"{fn.__name__} {label} H={h} Hkv={hkv} D={d} S={sq} pos0={pos0}",
                           fn.__name__, args, {}, (row["bound_ms"], row["bound_by"])))
        print(f"  {fn.__name__} H={h} Hkv={hkv} D={d} S={sq} pos0={pos0}: kernel "
              f"{row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}); "
              f"{c} mismatching codes")
        rows_of[label] = row
    return dict(rows_of["main"], mismatches=mism, max_abs_err=err,
                g1_moe=rows_of["qwen2-moe G=1"], g1_stablelm=rows_of["stablelm G=1"],
                **{k: rows_of[k] for k in ("chunk", "long", "last_chunk", "verify", "tp_rank")
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
    """Row 6 at bkv 512: yi-6b's group (Hkv 4, G 8, D 128) at the decode
    tick's batch (B=8, lengths 33-1000 on 1,024-row stripes) and one slot
    over yi-6b's full context (B=1, 4,096 rows); mixtral's (Hkv 8, G 6) at
    a tick of 8 slots over its 4,096-row rings, lengths 33 to 4,096 (full
    rings among them: a wrapped ring holds positions out of order, which
    the kernel does not see); jamba-1.5-large's (Hkv 8, G 8) over its
    256-row stripes at bkv 256, a tick of 8 slots and a loop step of one;
    qwen2-vl-2b's (Hkv 2, G 6, D 128) and musicgen-medium's (Hkv 24, G 1,
    D 64) over 1,024-row stripes, 8 slots and one (the vision stub's 512
    rows and its decode steps); equal to the plain version, the kernel,
    plain and bound times, and the CTAs of each pass."""
    from repro_torch.kernels import decode_attention as mod
    from repro_torch.kernels.ref import decode_qattention_ref

    tick = [33, 100, 250, 400, 520, 640, 700, 1000]
    shapes = {"B=8": (tick, 1024, 4, 8, 128),                        # yi-6b, 1024
              "B=1 len=4096": ([4096], 4096, 4, 8, 128),             # yi-6b's context
              "mixtral B=8": ([33, 600, 1024, 2047, 2048, 3000, 4095, 4096], 4096, 8, 6, 128),
              # jamba's attention slot on its 256-row stripes (bkv 256): a tick
              # and a decode-loop prefill step
              "jamba B=8": ([17, 40, 80, 128, 150, 200, 230, 256], 256, 8, 8, 128),
              "jamba B=1": ([128], 256, 8, 8, 128),
              "qwen2vl B=8": (tick, 1024, 2, 6, 128),
              "qwen2vl B=1": ([545], 1024, 2, 6, 128),
              "musicgen B=8": (tick, 1024, 24, 1, 64),
              "musicgen B=1": ([545], 1024, 24, 1, 64)}
    rows_of = {}
    for label, (lengths, smax, hkv, g, d) in shapes.items():
        bkv = min(512, smax)
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
                   shape=f"{label} Hkv={hkv} G={g} D={d} Smax={smax} bkv={bkv} "
                         f"lengths={lengths}")
        # the function needs the live rows only: a masked key's numerator is 0
        rows = sum(lengths)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * b * hkv * g * d + 2 * rows * hkv * d + 4 * b + 1024, 4.0 * hkv * g * d * rows)
        ATTN_CASES.append((f"decode_qattention {label} Hkv={hkv} G={g} D={d} Smax={smax}",
                           "decode_qattention", args, {}, (row["bound_ms"], row["bound_by"])))
        blocks, live = _stripe_blocks(mod, lengths, smax, bkv, hkv)
        print(f"  decode (contiguous) {label} Hkv={hkv} G={g} D={d} Smax={smax} bkv={bkv} "
              f"lengths={lengths}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); passes A and B {blocks} "
              f"CTAs each, {live} with rows to run, the carry "
              f"{b * hkv * g * d // 4 // 32} CTAs; {mism} mismatching codes")
        rows_of[label] = row
    for label, row in rows_of.items():
        check(row["mismatches"] == 0, f"decode_qattention: kernel != plain version at {label}")
    return dict(rows_of["B=8"], long=rows_of["B=1 len=4096"], g6_ring=rows_of["mixtral B=8"],
                jamba=rows_of["jamba B=8"], jamba_loop=rows_of["jamba B=1"],
                qwen2vl=rows_of["qwen2vl B=8"], qwen2vl_b1=rows_of["qwen2vl B=1"],
                musicgen=rows_of["musicgen B=8"], musicgen_b1=rows_of["musicgen B=1"],
                mismatches=sum(r["mismatches"] for r in rows_of.values()),
                max_abs_err=max(r["max_abs_err"] for r in rows_of.values()))


def _flash_bound(h, hkv, d, sq, skv, q_offset, window, b=1):
    """Bytes (q and the output once, the K and V rows some row sees) and
    operations (2 * D in QK^T and 2 * D in P.V per live pair) of a causal,
    maybe windowed, flash call over ``b`` sequences, as (ms, "bytes" |
    "operations")."""
    lo = [0 if window is None else max(0, q_offset + i - window + 1) for i in range(sq)]
    hi = [min(skv, q_offset + i + 1) for i in range(sq)]
    pairs = h * sum(e - a for a, e in zip(lo, hi))
    keys = max(hi) - min(lo)
    return bound_ms(b * (2 * h * sq * d + 2 * hkv * keys * d) + 1024 + 16, 4.0 * d * pairs * b)


def _small_inv_scalars(torch, d):
    """``_attn_scalars`` at a logit scale 600 times larger: masked keys still
    clip to the table's zero entry, but ``window_skip_margin`` is below 1,
    so a windowed tile walks from block 0."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.core.qsoftmax import LUT_DELTA

    M, sh, lut, _, osc = _attn_scalars(torch, d)
    s_logit = 600.0 / (2.0 / (np.sqrt(d) * 73.0 * 73.0))
    M, sh = fxp.quantize_multiplier(1.0 / (s_logit * LUT_DELTA))
    return (torch.tensor(M, dtype=torch.int32, device="cuda"),
            torch.tensor(sh, dtype=torch.int32, device="cuda"), lut,
            torch.tensor(np.float32(1.0 / s_logit), device="cuda"), osc)


# mixtral-8x22b's attention (H 48, Hkv 8, D 128) and window (4,096), and the
# windowed cases of row 9: (label, Sq, Skv, q_offset, bkv); the (1, 8,192)
# forward, the long request's 4,000-row one-shot prefill and the 4,160-row
# cache-less forward over it are the [mixtral] phase's
MIXTRAL_HEADS = (48, 8, 128)
MIXTRAL_WINDOW = 4096
JAMBA_HEADS = (64, 8, 128)
QWEN2VL_HEADS = (12, 2, 128)
MUSICGEN_HEADS = (24, 24, 64)
WINDOW_CASES = (("window_s8192", 8192, 8192, 0, 512),
                ("window_q_offset", 128, 8192, 8064, 512),
                ("window_bkv504", 8064, 8064, 0, 504),
                ("window_never_bites", 4032, 4032, 0, 504),
                ("window_s4000", 4000, 4000, 0, 500),
                ("window_s4160", 4160, 4160, 0, 416))


def phase_flash_qattention(torch, gen):
    """Row 9 at yi-6b's heads (H 32, Hkv 4, D 128): the (1, 512) cache-less
    prefill at its serving block, the 700-token prompt's stripe bucket (S
    704, bkv 352), ``ops.attention_q``'s default block (S 1024, bkv 128)
    and a q_offset (Sq 128 at 896 over Skv 1024).  Then with mixtral's
    heads and window (4,096): S 8,192 at bkv 512 (the window bites), Sq 128
    at q_offset 8,064 over 8,192, S 8,064 at bkv 504 (no divisor of the
    window), S 4,032 at bkv 504 (the window never bites), S 4,000 at bkv
    500 and S 4,160 at bkv 416 (the [mixtral] phase's long request: its
    one-shot prefill and the cache-less forward over it), each beside the
    same call without a window, the skip branch and its margin
    printed; S 8,192 also in the branch that walks from block 0.  Then
    jamba-1.5-large's heads (H 64, Hkv 8) at its (1, 512) cache-less
    forward; qwen2-vl-2b's (H 12, Hkv 2) at the vision stub's (1, 512)
    forward; musicgen-medium's (H = Hkv = 24, D 64) at its one-shot
    prefill of 8 streams of 64 frames and its (2, 512) cache-less forward.
    q, k and v are (B, S, H, D) tensors seen transposed, as the serving
    forward hands them over."""
    from repro_torch.kernels import flash_qattention as mod
    from repro_torch.kernels.ref import window_skip_margin

    cases = [(None, (32, 4, 128), 512, 512, 0, 512, None, 1),
             (None, (32, 4, 128), 704, 704, 0, 352, None, 1),
             (None, (32, 4, 128), 1024, 1024, 0, 128, None, 1),
             (None, (32, 4, 128), 128, 1024, 896, 512, None, 1)]
    cases += [(label, MIXTRAL_HEADS, sq, skv, q_offset, bkv, MIXTRAL_WINDOW, 1)
              for label, sq, skv, q_offset, bkv in WINDOW_CASES]
    cases += [("jamba", JAMBA_HEADS, 512, 512, 0, 512, None, 1),   # its (1, 512) forward
              ("qwen2vl", QWEN2VL_HEADS, 512, 512, 0, 512, None, 1),
              ("musicgen", MUSICGEN_HEADS, 64, 64, 0, 64, None, 8),
              ("musicgen_forward", MUSICGEN_HEADS, 512, 512, 0, 512, None, 2)]
    mism, err, main, windowed = 0, 0.0, None, {}
    for label, (h, hkv, d), sq, skv, q_offset, bkv, window, b in cases:
        q = _rand_i8(torch, gen, (b, sq, h, d)).transpose(1, 2)
        k, v = (_rand_i8(torch, gen, (b, skv, hkv, d)).transpose(1, 2) for _ in range(2))
        args = (q, k, v, *_attn_scalars(torch, d))

        def kernel(*a, w=window):
            return mod.flash_qattention(*a, q_offset=q_offset, bkv=bkv, window=w)

        def plain(*a):
            return mod.flash_qattention_torch(*a, q_offset=q_offset, bkv=bkv, window=window)

        c, e = compare(kernel(*args), plain(*args))
        mism, err = mism + c, max(err, e)
        row = dict(ms=device_ms(torch, kernel, args),
                   plain_ms=device_ms(torch, plain, args, cold=False,
                                      batches=1 if window else 3),
                   library_ms=None, mismatches=c)
        row["bound_ms"], row["bound_by"] = _flash_bound(h, hkv, d, sq, skv, q_offset, window, b)
        text = (f"B={b} H={h} Hkv={hkv} D={d} Sq={sq} Skv={skv} q_offset={q_offset} bkv={bkv}"
                + (f" window={window}" if window else ""))
        ATTN_CASES.append((f"flash_qattention {text}", "flash_qattention", args,
                           dict(q_offset=q_offset, bkv=bkv, window=window),
                           (row["bound_ms"], row["bound_by"])))
        extra = ""
        if window:
            margin = window_skip_margin(float(args[6]), d)
            row.update(shape=text, skip_margin=margin, ms_no_window=device_ms(
                torch, lambda *a: kernel(*a, w=None), args))
            branch = "starts each tile at its first live block" if margin > 1 else \
                "walks from block 0"
            extra = (f"; skip branch {branch} (window_skip_margin {margin:.1f}); without the "
                     f"window {row['ms_no_window']:.4f} ms")
            if label == "window_s8192":
                small = (q, k, v, *_small_inv_scalars(torch, d))
                cs, es = compare(kernel(*small), plain(*small))
                mism, err = mism + cs, max(err, es)
                row["ms_from_block_0"] = device_ms(torch, kernel, small)
                extra += (f"; at a logit scale 600x larger (margin "
                          f"{window_skip_margin(float(small[6]), d):.2f}) the tiles walk from "
                          f"block 0: {row['ms_from_block_0']:.4f} ms, {cs} mismatches")
            windowed[label] = row
        elif label:
            windowed[label] = dict(row, shape=text)
        print(f"  flash_qattention {text}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}, "
              f"the live pairs), {c} mismatches{extra}", flush=True)
        if main is None:
            main = row
    print("  library: none (no single PyTorch call computes the q7 LUT flash; "
          "scaled_dot_product_attention is a float softmax)")
    return dict(main, mismatches=mism, max_abs_err=err,
                shape="B=1 H=32 Hkv=4 D=128 S=512 bkv=512 (the (1, 512) prefill)", **windowed)


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


BITSPLIT_SHAPES = [(m, k, n) for m in (128, 4096) for k, n in BERT_GEMMS]   # (1, 128), (8, 512)


def phase_int8_bitsplit(torch, gen):
    return gemm_phase(torch, gen, False, BITSPLIT_SHAPES, (128, 768, 3072),
                      "M=128 (BERT-base at (1, 128)) K=768 N=3072 (w1)")


# --- [autotune]: the launch tuner's picks -------------------------------------------

AUTOTUNE_MODES = ("off", "roofline", "measure")


def _under(mode: str, ask):
    """``ask()`` with ``REPRO_TORCH_AUTOTUNE=mode`` (the default again after)."""
    os.environ["REPRO_TORCH_AUTOTUNE"] = mode
    try:
        return ask()
    finally:
        del os.environ["REPRO_TORCH_AUTOTUNE"]


def tune_row(torch, label, cands, launch, plain, args, ask, bound, rows):
    """One shape of [autotune]: every candidate ``c`` of a knob,
    ``launch(c, *args)`` (a launch no wrapper counts), against
    ``plain(c)``; then the off rule's, the model's and the measured pick
    (``ask()`` under each mode), each timed by ``device_ms`` on cold inputs
    beside ``bound``; appends the row to ``rows``."""
    bad = sum(compare(launch(c, *args), plain(c))[0] for c in cands)
    picks = {mode: _under(mode, ask) for mode in AUTOTUNE_MODES}
    ms = {c: device_ms(torch, lambda *a, c=c: launch(c, *a), args)
          for c in dict.fromkeys(picks.values())}

    def text(c):
        return f"{c.bm}x{c.bn}/{c.split}" if hasattr(c, "split") else str(c)

    row = dict(shape=label, candidates=len(cands), mismatches=bad, bound_ms=bound[0],
               bound_by=bound[1], **{f"{m}_pick": text(c) for m, c in picks.items()},
               **{f"{m}_ms": ms[c] for m, c in picks.items()})
    rows.append(row)
    print(f"  {label}: off {row['off_pick']} {row['off_ms']:.4f} ms, model "
          f"{row['roofline_pick']} {row['roofline_ms']:.4f} ms, measured "
          f"{row['measure_pick']} {row['measure_ms']:.4f} ms, bound {bound[0]:.5f} ms "
          f"({bound[1]}); {len(cands)} candidates, {bad} mismatching codes", flush=True)
    return row


def tune_gemm(torch, gen, m, k, n, w_bits, rows):
    """[autotune] at one GEMM shape: every ``gemm_candidates`` plan equal to
    the plain version."""
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels import int4_matmul as mm
    from repro_torch.kernels.ref import int4_matmul_ref, int8_bitsplit_matmul_ref

    sms = _build.sm_count(torch.device("cuda"))
    name = "int4_matmul" if w_bits == 4 else "int8_bitsplit_matmul"
    args, _ = _gemm_args(torch, gen, m, k, n, w_bits == 4)
    want = (int4_matmul_ref if w_bits == 4 else int8_bitsplit_matmul_ref)(*args)
    cands = autotune.gemm_candidates(m, k, n, w_bits, sms)
    w_bytes = k * n // 2 if w_bits == 4 else k * n
    return tune_row(
        torch, f"{name} M={m} K={k} N={n} [{cands[0].path}]", cands,
        lambda p, *a: mm._launch(name, *a, n, p), lambda p: want, args,
        lambda: autotune.gemm_plan(m, k, n, w_bits, sms, device="cuda"),
        bound_ms(m * k + w_bytes + 4 * n + m * n, 2.0 * m * k * n), rows)


def tune_attention(torch, label, name, args, kw, bound, rows):
    """[autotune] at one attention case of the kernel phases: every heads
    per block of the paged or flash prefill, or every bkv a pin can ask of
    the contiguous decode, equal to the plain version (at that bkv)."""
    from repro_torch.kernels import _build, autotune, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels import prefill_attention as pa

    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    q = args[0]
    if name == "decode_qattention":
        b, smax, hkv, d = args[1].shape
        cands = tuple(dict.fromkeys(autotune._fit(c, smax) for c in (512, 256, 128)))
        return tune_row(torch, label, cands,
                        lambda c, *a: da._launch_stripe(*a, bkv=c),
                        lambda c: ref.decode_qattention_ref(*args, c), args,
                        lambda: autotune.decode_bkv(smax, batch_slots=b, hkv=hkv, hd=d),
                        bound, rows)
    b, h, sq, d = q.shape
    if name == "flash_qattention":
        hkv, skv = args[1].shape[1], args[1].shape[2]
        bkv = min(kw["bkv"], skv)
        shape = (name, b, h, sq, d, hkv, skv, bkv, kw["q_offset"], kw["window"])
        want = fa.flash_qattention_torch(*args, **kw)

        def launch(gh, *a):
            return fa._launch_flash(*a, **kw, gh=gh)
    else:
        hkv, psize, nb = args[1].shape[2], args[1].shape[1], args[-7].shape[1]
        shape = (name, b, h, sq, d, hkv, psize, nb)
        q4 = name.endswith("_q4")
        want = (ref.paged_prefill_qattention_q4_ref if q4 else
                ref.paged_prefill_qattention_ref)(*args)

        def launch(gh, *a):
            return (pa._launch_q4 if q4 else pa._launch_int8)(*a, gh=gh)
    group, units = h // hkv, -(-sq // pa.ROWS_PER_BLOCK) * b * hkv
    return tune_row(torch, label, autotune.heads_candidates(group, units, sms), launch,
                    lambda gh: want, args,
                    lambda: autotune.attn_heads_per_block(group, units, sms, shape=shape,
                                                          device=dev), bound, rows)


def check_not_slower(rows, where: str):
    """Gate: at no shape of ``rows`` is the default (the model's) pick
    slower than the off rule's by more than max(10 %, 0.002 ms)."""
    slow = [r["shape"] for r in rows
            if r["roofline_ms"] > max(1.1 * r["off_ms"], r["off_ms"] + 0.002)]
    print(f"  {where}: the model's pick slower than the off rule by more than "
          f"max(10 %, 0.002 ms) at {len(slow)} of {len(rows)} shapes {slow}")
    check(not slow, f"[autotune] {where}: the model's pick is slower than the off rule "
                    f"at {slow}")


def wrapper_counts():
    """Every wrapper's launches, and the GEMMs' by path."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels import int4_matmul as mm
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.kernels import quant_layernorm as ln
    from repro_torch.kernels import quant_softmax as sm

    fns = (mm.int4_matmul, mm.int8_bitsplit_matmul, ln.quant_layernorm, sm.quant_softmax,
           pa.paged_prefill_qattention, pa.paged_prefill_qattention_q4,
           da.paged_decode_qattention, da.paged_decode_qattention_q4, da.decode_qattention,
           fa.flash_qattention, fa.flash_qdecode)
    return dict({f.__name__: f.launches for f in fns},
                **{f"{f.__name__} {p}": v for f in fns[:2] for p, v in f.path_launches.items()})


def phase_autotune(torch, gen):
    """[autotune], the kernels: every candidate of every knob equal to its
    plain version at the served GEMM shapes (``served_gemm_shapes``, BERT's
    bit-split ones) and at every attention case of the kernel phases; the
    off rule's, the model's and the measured pick timed beside the bound;
    racing moves no wrapper counter, and a wrapper call in measured mode
    counts one launch however many candidates it raced."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import int4_matmul as mm
    from repro_torch.kernels import prefill_attention as pa

    t0 = time.perf_counter()
    before, rows = wrapper_counts(), []
    for m, k, n in served_gemm_shapes():
        tune_gemm(torch, gen, m, k, n, 4, rows)
    for m, k, n in BITSPLIT_SHAPES:
        tune_gemm(torch, gen, m, k, n, 8, rows)
    for case in ATTN_CASES:
        tune_attention(torch, *case, rows)
    check(wrapper_counts() == before, "[autotune]: racing moved a wrapper's launch counter")
    # one call of each kind through its wrapper in measured mode, its
    # candidates raced afresh: one launch counted
    autotune.clear_cache()
    gemm_args, _ = _gemm_args(torch, gen, 8, 4096, 11008, True)
    _, name, attn_args, _, _ = next(c for c in ATTN_CASES if c[1] == "paged_prefill_qattention")
    _, _, stripe_args, _, _ = next(c for c in ATTN_CASES if c[1] == "decode_qattention")
    _under("measure", lambda: (mm.int4_matmul(*gemm_args), pa.paged_prefill_qattention(
        *attn_args), ops.decode_attention_q(*stripe_args)))
    after = wrapper_counts()
    moved = {k: after[k] - v for k, v in before.items() if after[k] != v}
    check(moved == {"int4_matmul": 1, "int4_matmul decode": 1, "paged_prefill_qattention": 1,
                    "decode_qattention": 1},
          f"[autotune]: one wrapper call each in measured mode moved the counters by {moved}")
    gain = [r["shape"] for r in rows if r["measure_ms"] < r["off_ms"] / 1.1]
    print(f"  measured winner faster than the off rule by more than 10 %: {len(gain)} of "
          f"{len(rows)} shapes {gain}")
    bad = [r["shape"] for r in rows if r["mismatches"]]
    check(not bad, f"[autotune]: a candidate differs from the plain version at {bad}")
    check_not_slower(rows, "kernels")
    ATTN_CASES.clear()
    print(f"  [autotune] kernels {time.perf_counter() - t0:.1f} s; racing moved no counter")
    return rows


def phase_autotune_served(torch, gen, cfg, folded, served, guard):
    """[autotune], the served path: launches x ms of the W4A8 GEMMs for each
    mode over yi-6b's one-shot run (``served``'s recorded forwards) and one
    qwen2-moe-a2.7b decode tick at its published 24 layers
    (``forward_gemms``); then one paged prefill chunk (8 slots x 32 rows)
    and one decode tick of yi-6b under each mode: equal logits, bit for
    bit.  The shapes' comparisons with the plain versions run paused
    under ``guard``."""
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.models import serve_int as S

    t0 = time.perf_counter()
    moe = get_config("qwen2-moe-a2.7b")
    runs = {"yi-6b one-shot run": (cfg, [b * s for b, s, _, _ in served["forwards"]]),
            "qwen2-moe-a2.7b decode tick (8 rows, 24 layers)": (moe, [8])}
    rows = {}
    for what, (c, ts) in runs.items():
        counts = Counter()
        for t in ts:
            for mkn in forward_gemms(c, t):
                counts[mkn] += c.n_reps
        total = dict.fromkeys(AUTOTUNE_MODES, 0.0)
        for (m, k, n), cnt in counts.items():
            if (m, k, n) not in rows:
                with guard.paused():
                    rows[(m, k, n)] = tune_gemm(torch, gen, m, k, n, 4, [])
            for mode in AUTOTUNE_MODES:
                total[mode] += cnt * rows[(m, k, n)][f"{mode}_ms"]
        print(f"  {what}: {sum(counts.values())} W4A8 GEMM launches, launches x ms: off "
              f"{total['off']:.2f} ms, model {total['roofline']:.2f} ms, measured "
              f"{total['measure']:.2f} ms")
    check_not_slower(list(rows.values()), "served GEMMs")
    pf = S.prepare_folded(cfg, folded)
    toks = torch.as_tensor(np.stack([p[:32] for p in _prompts(cfg.vocab_size)]), device="cuda")
    btab = 1 + torch.arange(8 * 8, dtype=torch.int32, device="cuda").reshape(8, 8)
    logits = {}
    for mode in AUTOTUNE_MODES:
        def step():
            cache = S.init_paged_cache(cfg, 8 * 8 + 1, 16, device="cuda")
            pre, _ = S.serve_forward(cfg, pf, toks, cache=cache, mode="prefill",
                                     block_tables=btab)
            dec, _ = S.serve_forward(cfg, pf, pre[:, -1:].argmax(-1), cache=cache,
                                     pos_offset=torch.full((8,), 32, device="cuda"),
                                     mode="decode", block_tables=btab)
            return pre, dec

        logits[mode] = _under(mode, step)
    same = {mode: all(torch.equal(a, b) for a, b in zip(logits["off"], got))
            for mode, got in logits.items()}
    print(f"  yi-6b prefill chunk (8 x 32 rows) and decode tick, logits equal to the off "
          f"rule's: {same}; {time.perf_counter() - t0:.1f} s")
    check(all(same.values()), f"[autotune]: the modes' logits differ: {same}")
    return rows


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


def device_rows(torch, prof) -> list:
    """(device us, count, name) for each kernel name of a finished
    torch.profiler run, summed over its raw device events:
    ``key_averages()`` parses every event into Python objects first, which
    takes minutes for a training step's 10^6 kernels."""
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            us, count = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    return [(us, count, name) for name, (us, count) in sums.items()]


def profile_steps(torch, step, what: str, n: int = 3, experts: bool = False,
                  wall_ms: float | None = None):
    """Where the time of ``step()`` goes: ``n`` calls on the host clock
    (each ending in a synchronise; or ``wall_ms``, an unprofiled call's
    time the caller measured) and ``n`` under torch.profiler (device
    activity only); prints the device's busy share of an unprofiled call
    and device time by kernel.  ``experts``: then the routed and shared
    experts' share of the integer GEMMs' device time
    (``expert_gemm_share``)."""
    from torch.profiler import ProfilerActivity, profile

    walls = [] if wall_ms is None else [wall_ms / 1e3]
    for _ in range(n if wall_ms is None else 0):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = device_rows(torch, prof)
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
            ("LUT softmax", [r for r in rows if "quant_softmax_kernel" in r[2]]),
            ("float products (cuBLAS GEMM / GEMV: the recurrent slots' weight-only "
             "linears and gates, the lm_head, the QAT forward's and backward's products)",
             [r for r in rows if any(w in r[2].lower() for w in ("gemm", "gemv", "nvjet"))
              and "fq::igemm::" not in r[2]]),
            ("elementwise and reduction kernels (the QAT fake-quant chains, the LUT softmax "
             "simulator, norms, the AdamW update)",
             [r for r in rows if "elementwise" in r[2] or "reduce_kernel" in r[2]])):
        if picked:
            ms = sum(r[0] for r in picked) / n / 1e3
            print(f"    {label}: {ms:.3f} ms/call ({100 * ms / busy_ms:.1f} % of device "
                  f"time), {sum(r[1] for r in picked) // n} kernels per call")
    if experts:
        expert_gemm_share(torch, step)


def expert_gemm_share(torch, step):
    """The experts' share of the W4A8 GEMMs' device time in ``step()``:
    one call records every ``ops.linear_w4a8`` call's operands and whether
    it came from inside ``serve_int._experts_int``; then the recorded GEMMs
    are replayed under torch.profiler, all of them and the experts' alone,
    and each replay's GEMM kernels (the split-K reduces included) summed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models import serve_int as S

    saved = ops.linear_w4a8, S._experts_int
    calls, depth = [], [0]

    def gemm(x, fl):
        calls.append((x, fl, depth[0] > 0))
        return saved[0](x, fl)

    def experts(*a, **kw):
        depth[0] += 1
        try:
            return saved[1](*a, **kw)
        finally:
            depth[0] -= 1

    ops.linear_w4a8, S._experts_int = gemm, experts
    try:
        step()
    finally:
        ops.linear_w4a8, S._experts_int = saved

    def replay_ms(picked):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for x, fl, _ in picked:
                ops.linear_w4a8(x, fl)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if "fq::igemm::" in e.key) / 1e3

    mine = [c for c in calls if c[2]]
    total, ms = replay_ms(calls), replay_ms(mine)
    print(f"    experts' GEMMs (routed and shared), replayed under the profiler: {len(mine)} "
          f"launches {ms:.3f} ms of all {len(calls)} W4A8 GEMMs' {total:.3f} ms "
          f"({100 * ms / total:.1f} %)")


def profile_decode(torch, cfg, folded, what="decode tick (batch 8)", max_len=1024, **extra):
    """A steady decode tick of the served requests, once every prompt is
    cached (``Engine.poll`` ends in a device-to-host copy); a MoE arch's
    experts' share of the GEMM time too."""
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=max_len, **extra))
    for p in _prompts(cfg.vocab_size):
        eng.submit(Request(prompt=p, max_new_tokens=32))
    while eng.sched.waiting or eng.sched.prefilling:
        eng.poll()
    profile_steps(torch, eng.poll, what, experts=bool(cfg.n_experts))


def profile_prefill_chunks(torch, cfg, folded, chunks=((512, 0), (128, 256))):
    """Paged int8 prefill chunks of (rows, position): by default one of 512
    rows at 0 (a one-shot prompt) and one of 128 rows at 256 (a chunked
    run's chunk), each a whole-model forward through the paged pool
    (16-row pages, a 64-entry block table): wall and device time, kernels,
    the paged prefill attention's share (and a MoE arch's experts')."""
    from repro_torch.models import serve_int as S

    pf = S.prepare_folded(cfg, folded)
    nb = 64
    cache = S.init_paged_cache(cfg, nb + 1, 16, device="cuda")
    btab = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
    prompt = torch.as_tensor(_prompts(cfg.vocab_size)[1][None, :512], device="cuda")
    for rows, pos0 in chunks:
        toks = prompt[:, pos0:pos0 + rows]
        profile_steps(torch, lambda t=toks, p=pos0: S.serve_forward(
            cfg, pf, t, cache=cache, pos_offset=p, mode="prefill", block_tables=btab),
            f"paged int8 prefill chunk, {rows} rows at position {pos0}",
            experts=bool(cfg.n_experts))


def serve(torch, cfg, folded, kernels, on_engine=None, prompts=None, max_len=1024, **extra):
    """The 8 requests (``prompts``, by default ``_prompts``) through one
    engine of ``make_engine`` (``extra``: EngineConfig fields;
    ``on_engine(eng)`` runs on the engine before the first submit), with
    the counts of ``kernels`` set to 0 just before."""
    from repro_torch.serve.engine import EngineConfig, Request, RequestStatus, make_engine

    eng = make_engine(cfg, folded, EngineConfig(batch_slots=8, max_len=max_len, **extra))
    if on_engine is not None:
        on_engine(eng)
    reqs = [Request(prompt=p, max_new_tokens=32)
            for p in (prompts if prompts is not None else _prompts(cfg.vocab_size))]
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
    return dict(tokens=toks, counters=dict(eng.counters), launches=launches, layout=eng.layout,
                paths=gemm_paths(), forwards=list(FORWARDS), tick_launches=tick_launches,
                wall_s=wall,
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
        check_paths(name, cfg, r["paths"], r["forwards"])
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
    forwards than the plain run.  Returns both runs, by draft."""
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
        check_paths(f"spec {name}", cfg, r["paths"], r["forwards"])
        total = [a + b for a, b in zip(total, r["launches"])]
        runs[name] = dict(r, verify_forwards=nv)
    oracle = runs["oracle"]
    c = oracle["counters"]
    check(oracle["verify_forwards"] > 0 and c["rejected"] == 0 and c["decode_steps"] < plain_steps,
          f"spec oracle: rejected {c['rejected']}, decode forwards {c['decode_steps']} (plain "
          f"{plain_steps})")
    check(all(n > 0 for n in total), f"spec: a kernel of the path was never launched: {total}")
    profile_verify(torch, cfg, folded)
    return runs


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
        check_paths(name, cfg, r["paths"], r["forwards"])
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


def phase_tp(torch, cfg, folded, plain, kv4, spec, kernel_rows):
    """yi-6b at full width over a TP-rank tensor-parallel mesh on the one
    card (``TPMesh((cuda:0,) * TP)``): the paged pool split over its KV
    heads, one shard of Hkv / TP = 1 head a rank, under one host scheduler.
    The [serve] requests on the int8 pool, on the kv4 pool and with
    speculative decoding (spec_k = 3, prompt lookup) must give their tp = 1
    runs' tokens and counters bit for bit (``plain``, ``kv4``, ``spec``);
    every attention kernel of the path runs TP times a layer (rows 3, 4, 7
    and 8 at the rank's shape), the GEMMs once.  Prints each rank's shard
    and the rank-shape kernel times of the kernel phases (``kernel_rows``,
    by wrapper name) beside yi-6b's Hkv = 4, and profiles a decode tick.
    Returns the runs."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import prefill_attention as pa
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.serve.draft import PromptLookupDraft

    mesh = TPMesh((torch.device("cuda", 0),) * TP)
    attn = [pa.paged_prefill_qattention, da.paged_decode_qattention,
            pa.paged_prefill_qattention_q4, da.paged_decode_qattention_q4]
    names = [k.__name__ for k in attn]
    hkv = cfg.n_kv_heads // TP
    runs = {}
    for name, want, kw in (("int8", plain, {}), ("kv4", kv4, {"kv_bits": 4}),
                           ("spec", spec, {"spec_k": SPEC_K, "draft": PromptLookupDraft()})):
        shards, per_fwd = [], []

        def on_engine(eng, shards=shards, per_fwd=per_fwd):
            shards.extend(eng.cache)
            count_verify(eng, per_fwd)

        r = serve(torch, cfg, folded, attn, on_engine=on_engine, mesh=mesh, **kw)
        print_run(f"tp={TP} {name}", r, attn)
        for rank, shard in enumerate(shards):
            k = shard["slot0"]["k"]
            nbytes = sum(t.numel() * t.element_size() for c in shard.values() for t in c.values())
            print(f"    rank {rank}: K/V {tuple(k.shape)} {k.dtype} on {k.device}, "
                  f"contiguous {k.is_contiguous()}, {nbytes:,} bytes")
        check(len(shards) == TP and all(
            sh["slot0"]["k"].shape[3] == hkv and sh["slot0"]["k"].is_contiguous()
            and sh["slot0"]["k"].device == mesh.devices[rank] for rank, sh in enumerate(shards)),
            f"tp {name}: the shards are not {TP} contiguous pools of {hkv} KV heads")
        c = r["counters"]
        nv = len(per_fwd)
        check(r["tokens"] == want["tokens"], f"tp {name}: tokens differ from tp=1 (first "
              f"divergence {first_divergence(want['tokens'], r['tokens'])})")
        check(c == want["counters"], f"tp {name}: counters {c} != tp=1 {want['counters']}")
        per_layer = TP * cfg.n_layers
        prefill, decode = (2, 3) if name == "kv4" else (0, 1)
        expect = [0] * 4
        expect[prefill] = per_layer * (c["prefill_chunks"] + nv)
        expect[decode] = per_layer * (c["decode_steps"] - nv)
        check(r["launches"] == expect, f"tp {name}: launches {dict(zip(names, r['launches']))} "
              f"!= {dict(zip(names, expect))} ({TP} per layer and forward)")
        tick = r["tick_launches"][prefill] + r["tick_launches"][decode]   # a verify tick's too
        check(tick == per_layer, f"tp {name}: {tick} attention launches in a decode tick, not "
              f"{per_layer}")
        check(all(n == per_layer for n in per_fwd),
              f"tp {name}: paged_prefill_qattention launches per verify forward {per_fwd}")
        check_paths(f"tp {name}", cfg, r["paths"], r["forwards"])
        print(f"    equal to tp=1 in tokens and counters; {per_layer} attention launches a "
              "decode tick" + (f", {nv} verify forwards" if nv else ""))
        runs[name] = r
    profile_decode(torch, cfg, folded, f"tp={TP} decode tick (batch 8)", mesh=mesh)
    for name in names:
        row = kernel_rows[name]
        rank = row["tp_rank"]
        print(f"  {name}: rank shape {rank['shape']}: {rank['ms']:.4f} ms (bound "
              f"{rank['bound_ms']:.5f} ms, {rank['bound_by']}) x {TP} ranks, against "
              f"{row['ms']:.4f} ms at {row['shape']}")
    return runs


def serve_lockstep(torch, cfg, folded, kernels, n=8, prompt_len=32, new=16, temperature=0.0,
                   make=None):
    """``n`` prompts of ``prompt_len`` seeded tokens, ``new`` tokens each,
    through a ``LockstepEngine`` of 8 slots x 1,024 rows (``make``, by
    default the class itself, builds it), with the counts of ``kernels`` set
    to 0 just before."""
    from repro_torch.serve.engine import EngineConfig, LockstepEngine, Request

    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
                    max_new_tokens=new, temperature=temperature) for _ in range(n)]
    eng = (make or LockstepEngine)(cfg, folded, EngineConfig(batch_slots=n, max_len=1024))
    check(isinstance(eng, LockstepEngine), f"{cfg.name}: make_engine built {type(eng)}")
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
                forwards=list(FORWARDS),
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
    check_paths("contiguous", cfg, r["paths"], r["forwards"])
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
    check_paths("lockstep", cfg, lock["paths"], lock["forwards"])
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
        check_paths(f"eval ({b}, {s})", cfg, paths, FORWARDS)
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


def phase_analysis(torch, cfg, folded, guard):
    """``repro_torch.analysis`` on the card: the six presets' hot steps
    audited through the kernels at yi-6b's full width (0 violations), the
    kernel lint (0 violations; the battery's plain versions run paused
    under the guard), the self-test.  Prints what each graph ran and
    each kernel's ptxas budget."""
    from repro_torch.analysis import analyze, cost, fixtures, kernel_lint, report

    t0 = time.perf_counter()
    presets, skipped = analyze.run_audits(device="cuda", with_bytes=True, cfg=cfg,
                                          folded=folded, engine_kw=dict(max_len=128,
                                                                        page_size=16))
    t_audit = time.perf_counter() - t0
    with guard.paused():
        lint = kernel_lint.run_all("cuda")
    t_lint = time.perf_counter() - t0 - t_audit
    doc = report.build_report(presets=presets, skipped=skipped, kernel_lint=lint,
                              torch_version=torch.__version__)
    base = json.loads(analyze.BASELINE.read_text())
    for pname, (_, results, hbm) in presets.items():
        for g, r in results.items():
            new = sorted(r.float_prims - set(base["presets"][pname]["graphs"][g]["float_prims"]))
            print(f"  {pname}/{g}: {r.n_eqns} ops {cost.op_counts(r.ops)}, wrapper launches "
                  f"{r.launched}, exact-product ratio {r.exact_ratio:.4g} of the carrier "
                  f"over the operands' ranges ({r.exact_ratio_seen:.4g} over this run's), bytes "
                  f"{ {k: int(v) for k, v in sorted(hbm[g].items())} } (most: "
                  f"{[(k, int(v)) for k, v in cost.top_ops(r.ops)]}), float ops "
                  f"{len(r.float_prims)} ({len(new)} beyond the CPU baseline: {new})")
            for v in r.violations:
                print(f"    [{v.rule}] {v.scope}: {v.detail}")
    for c in lint["checks"]:
        print(f"  lint {c['check']} {c['kernel']}: {'ok' if c['ok'] else 'NOT OK'} ({c['detail']})")
    failed = kernel_lint.failed_checks(lint)
    for v in lint["violations"]:
        print(f"    [{v['rule']}] {v['graph']}: {v['detail']}")
    st = fixtures.run_self_test()
    bad = [n for n, f in st["fixtures"].items() if not f["ok"]]
    print(f"  self-test: {len(st['fixtures']) - len(bad)} of {len(st['fixtures'])} fixtures "
          f"behaved; audit {t_audit:.1f} s, lint {t_lint:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s")
    check(doc["violations_total"] == 0, f"[analysis]: {doc['violations_total']} violation(s)")
    check(not failed, f"[analysis]: lint checks not ok: {failed}")
    unlaunched = [f"{p}/{g}" for p, (_, results, _) in presets.items()
                  for g, r in results.items() if not r.launched]
    check(not unlaunched, f"[analysis]: graphs that launched no kernel: {unlaunched}")
    check(st["ok"], f"[analysis]: fixtures not flagged with their rule: {bad}")
    return doc


# name -> (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab), at
# full size; a MoE's d_ff is its experts' (moe_d_ff)
ARCHS = {"qwen3-4b": (36, 2560, 32, 8, 128, 9728, 151936),
         "qwen2-moe-a2.7b": (24, 2048, 16, 16, 128, 1408, 151936),
         "mixtral-8x22b": (56, 6144, 48, 8, 128, 16384, 32768),
         "xlstm-1.3b": (48, 2048, 4, 4, 512, 0, 50304),
         "jamba-1.5-large-398b": (72, 8192, 64, 8, 128, 24576, 65536),
         "qwen2-vl-2b": (28, 1536, 12, 2, 128, 8960, 151936),
         "musicgen-medium": (48, 1536, 24, 24, 64, 6144, 2048)}


def load_arch(torch, name, n_layers=None, **overrides):
    """One of ``ARCHS`` at full size, at its full depth or ``n_layers`` (and
    other config ``overrides``): random weights from SEED, calibrated on
    (2, 32) and folded on the card (the float weights freed by
    ``calibrated_folded``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import calibrated_folded

    cfg = get_config(name)
    dims = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.moe_d_ff or cfg.d_ff, cfg.vocab_size)
    check(dims == ARCHS[name], f"{name} is not full size: {dims}")
    if n_layers is not None:
        overrides["n_layers"] = n_layers
    cfg = dataclasses.replace(cfg, **overrides)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    folded = calibrated_folded(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  {name} ({cfg.n_layers} layers): init + calibrate (2, 32) + fold "
          f"{time.perf_counter() - t0:.1f} s, "
          f"folded {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)"
          + (f"; {cfg.n_experts} routed experts top-{cfg.top_k} and {cfg.n_shared_experts} "
             f"shared a layer" if cfg.n_experts else "; qk-norm" if cfg.qk_norm else "")
          + (f"; block pattern {''.join(cfg.pattern)}" if len(cfg.pattern) > 1 else ""))
    return cfg, folded


def print_forward_launches(r):
    """The launches of the first decode forward and of the shortest and the
    longest prefill chunk of a served run (``record_forwards``)."""
    chunks = sorted((s, i) for i, (_, s, mode, _) in enumerate(r["forwards"])
                    if mode == "prefill")
    picks = [i for i, f in enumerate(r["forwards"]) if f[2] == "decode"][:1]
    picks += sorted({chunks[0][1], chunks[-1][1]}) if chunks else []
    for i in picks:
        b, s, mode, launches = r["forwards"][i]
        what = f"decode forward ({b} slots)" if mode == "decode" else f"{s}-row chunk"
        print(f"    {what}: { {k: v for k, v in launches.items() if v} }")


class DroppedChoices:
    """While open, counts the routing choices ``models.moe.topk_routing``
    drops (its expert's capacity full) on the device; ``n`` after close, of
    ``choices`` made."""

    def __init__(self):
        self.n = self.choices = 0

    def __enter__(self):
        from repro_torch.models import moe

        self.inner = moe.topk_routing
        self.total = 0          # a device tensor after the first call: no sync per call
        self.choices = 0

        def counted(gate_logits, top_k, cap):
            dest, gates, aux = self.inner(gate_logits, top_k, cap)
            self.total = self.total + (dest == gate_logits.shape[1] * cap).sum()
            self.choices += dest.numel()
            return dest, gates, aux

        moe.topk_routing = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.topk_routing = self.inner
        self.n = int(self.total)


def phase_arch(torch, name, kernels, n_layers=None):
    """An arch of ``ARCHS`` at full size through the Engine on the paged int8
    pool: the 8 requests one-shot and chunked (128-row chunks), every
    kernel of the path launched, every GEMM on the path its M implies (a
    MoE's experts at M = capacity); the launches of a decode forward and of
    each chunk length; profiles of a decode tick and a 512-row chunk.  The
    two runs must give equal tokens unless a MoE router dropped a routing
    choice (capacity couples the rows of a forward, so a dropped choice
    depends on the forward's other rows and legitimately moves tokens:
    then the first divergence is printed, not gated).  The weights are
    freed before it returns."""
    cfg, folded = load_arch(torch, name, n_layers=n_layers)
    runs, drops = {}, {}
    for label, extra in (("one-shot", {}),
                         ("chunked", dict(max_prefill_chunk=128, max_batched_tokens=256))):
        with DroppedChoices() as dropped:
            runs[label] = serve(torch, cfg, folded, kernels, **extra)
        drops[label] = dropped.n
        if cfg.n_experts:
            print(f"  {name} {label}: {dropped.n} of {dropped.choices} routing choices dropped "
                  f"at capacity ({100 * dropped.n / dropped.choices:.1f} %)")
        r = runs[label]
        print_run(f"{name} {label}", r, kernels)
        print_forward_launches(r)
        check(all(n > 0 for n in r["launches"]),
              f"{name} {label}: a kernel of the path was never launched: {r['launches']}")
        check_paths(f"{name} {label}", cfg, r["paths"], r["forwards"])
    one, chunked = runs["one-shot"], runs["chunked"]
    div = first_divergence(one["tokens"], chunked["tokens"])
    if cfg.n_experts:
        print(f"  one-shot vs chunked first divergence (request, token): {div}")
    if drops["one-shot"] == drops["chunked"] == 0:
        check(div is None, f"{name}: chunked prefill changed the tokens (first divergence {div})")
    else:
        print(f"  {name}: one-shot vs chunked tokens not gated (dropped choices depend on each "
              f"forward's rows); {sum(a == b for a, b in zip(one['tokens'], chunked['tokens']))} "
              "of 8 requests identical")
    check(chunked["counters"]["chunked_prefills"] >= 1, f"{name}: no prompt was chunked")
    profile_decode(torch, cfg, folded, f"{name} decode tick (batch 8)")
    profile_prefill_chunks(torch, cfg, folded, chunks=((512, 0),))
    del folded
    torch.cuda.empty_cache()
    return one


def phase_small_archs(torch):
    """Small stablelm-1.6b, qwen3-4b and qwen2-moe-a2.7b: the same Engine
    requests on the card (the kernels) and on the CPU (their plain versions,
    REPRO_TORCH_KERNELS=gpu), one-shot and chunked, must give equal greedy
    tokens; then a paged prefill and 4 decode steps fed the CPU's tokens,
    with the logits that differ counted (the router's and the qk-norm
    RoPE island's float steps may move a code between the devices)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    prev = os.environ.get("REPRO_TORCH_KERNELS")
    os.environ["REPRO_TORCH_KERNELS"] = "gpu"
    try:
        for name in ("stablelm-1.6b", "qwen3-4b", "qwen2-moe-a2.7b"):
            cfg = smoke_config(name)
            folded_cpu = calibrated_folded(cfg, SEED, device="cpu")
            folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to("cuda"), folded_cpu)}
            rng = np.random.default_rng(SEED)
            prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in (9, 30, 17, 12)]
            toks = {}
            for dev in ("cpu", "cuda"):
                for chunk in (None, 8):
                    kw = dict(max_prefill_chunk=8, max_batched_tokens=16) if chunk else {}
                    eng = Engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64,
                                                                 page_size=4, **kw))
                    toks[dev, chunk] = [r.out.tolist() for r in eng.generate(
                        [Request(prompt=p, max_new_tokens=8) for p in prompts])]
            btab = torch.tensor([[3, 5, 1, 0], [2, 7, 4, 0]], dtype=torch.int32)
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
            out, fed = {}, []
            for dev in ("cpu", "cuda"):
                cache = S.init_paged_cache(cfg, 9, 16, device=dev)
                bt = btab.to(dev)
                logits, cache = S.serve_forward(cfg, folded[dev], prompt.to(dev), cache=cache,
                                                pos_offset=0, block_tables=bt)
                rows = [logits.reshape(-1, cfg.vocab_size).cpu()]
                for step in range(4):
                    if dev == "cpu":
                        fed.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
                    logits, cache = S.serve_forward(
                        cfg, folded[dev], fed[step].to(dev), cache=cache,
                        pos_offset=torch.full((2,), 32 + step, dtype=torch.int32, device=dev),
                        mode="decode", block_tables=bt)
                    rows.append(logits.reshape(-1, cfg.vocab_size).cpu())
                out[dev] = torch.cat(rows)
            a, b = out["cpu"], out["cuda"]
            differ = int((a != b).sum())
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            print(f"  small {name}, card vs CPU: Engine tokens equal one-shot "
                  f"{toks['cuda', None] == toks['cpu', None]}, chunked "
                  f"{toks['cuda', 8] == toks['cpu', 8]}; paged prefill + 4 decode steps: "
                  f"{differ} of {a.numel()} logits differ, argmax agrees on {agree:.4f} of "
                  f"{a.shape[0]} rows")
            check(bool(torch.isfinite(b).all()), f"small {name}: non-finite logits on the card")
            check(toks["cuda", None] == toks["cpu", None] and toks["cuda", 8] == toks["cpu", 8],
                  f"small {name}: the card's greedy tokens differ from the CPU's")
            if not cfg.n_experts:       # a MoE's dropped choices follow its chunking
                check(toks["cuda", None] == toks["cuda", 8],
                      f"small {name}: chunked prefill changed the card's tokens")
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_KERNELS"]
        else:
            os.environ["REPRO_TORCH_KERNELS"] = prev


MIXTRAL_DEPTH = 4      # of 56 layers: see phase_mixtral
MIXTRAL_LONG = (4000, 160)   # the long request: prompt tokens, new tokens


class PlainGuard:
    """Counts, by name, the calls on CUDA tensors of every plain version a
    kernel wrapper or ``ops`` could fall into instead of its kernel, and of
    the ``ref`` datapath's attention (``serve_int._gqa_decode`` and
    ``_attn_rows_q8``), wherever the wrappers, ``ops`` and ``serve_int``
    reach them.  Installed once; ``paused()`` lets a phase hold a kernel
    against its plain version on the card without counting."""

    PLAIN = ("int4_matmul_ref", "int8_bitsplit_matmul_ref", "quant_layernorm_ref",
             "quant_softmax_ref", "decode_qattention_ref", "paged_decode_qattention_ref",
             "paged_decode_qattention_q4_ref", "paged_prefill_qattention_ref",
             "paged_prefill_qattention_q4_ref", "flash_qdecode_ref", "flash_qattention_torch",
             "_gqa_decode", "_attn_rows_q8")
    MODULES = ("ref", "int4_matmul", "quant_layernorm", "quant_softmax", "decode_attention",
               "prefill_attention", "flash_qattention", "ops")

    def __init__(self):
        import importlib

        self.n = dict.fromkeys(self.PLAIN, 0)
        self.on = True
        mods = [importlib.import_module(f"repro_torch.kernels.{m}") for m in self.MODULES]
        for mod in mods + [importlib.import_module("repro_torch.models.serve_int")]:
            for attr in self.PLAIN:
                if hasattr(mod, attr):
                    setattr(mod, attr, self._counted(attr, getattr(mod, attr)))

    def _counted(self, attr, inner):
        def counted(x, *a, **kw):
            if self.on and getattr(x, "is_cuda", False):
                self.n[attr] += 1
            return inner(x, *a, **kw)

        return counted

    @contextlib.contextmanager
    def paused(self):
        self.on = False
        try:
            yield
        finally:
            self.on = True

    def ran(self) -> dict:
        return {k: v for k, v in self.n.items() if v}


class Captured:
    """While open, the served path's contiguous decode and flash
    (``ops.decode_qattention``, ``ops.flash_qattention``) append (args,
    output) of each call to ``calls[name]``, in call order: a forward's
    first call of either is its first layer's."""

    NAMES = ("decode_qattention", "flash_qattention")

    def __enter__(self):
        from repro_torch.kernels import ops

        self.calls = {name: [] for name in self.NAMES}
        self.saved = {name: getattr(ops, name) for name in self.NAMES}
        for name, inner in self.saved.items():
            def kept(*a, _inner=inner, _name=name, **kw):
                out = _inner(*a, **kw)
                self.calls[_name].append((a, out))
                return out

            setattr(ops, name, kept)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name, inner in self.saved.items():
            setattr(ops, name, inner)


def _kl_argmax(want, got):
    """Mean KL(softmax(want) || softmax(got)) over rows, in float64, and the
    share of rows whose argmax agrees."""
    def log_softmax(x):
        x = np.asarray(x, np.float64)
        x = x - x.max(-1, keepdims=True)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    lw, lg = log_softmax(want), log_softmax(got)
    kl = float(np.mean(np.sum(np.exp(lw) * (lw - lg), axis=-1)))
    return kl, float(np.mean(want.argmax(-1) == got.argmax(-1)))


def _codes_differ(a, b) -> str:
    d = (a.long() - b.long()).abs()
    n = int((d > 0).sum())
    return f"{n} of {d.numel()} codes differ ({100 * n / d.numel():.3f} %), max {int(d.max())}"


def check_layer0(torch, guard, window, n_prompt, steps, dscal, prefill, full):
    """The first layer of the long request, where a row's q, K and V depend
    on its token and position only, so every path sees the same codes.
    ``steps``: (position, q, K ring, V ring, length, output) of each ring
    decode step, ``dscal`` the decode's scalars; ``prefill`` and ``full``:
    (args, output) of the first flash call of its one-shot prefill (its
    ``n_prompt`` rows, then the bucket's padding) and of the cache-less
    forward over all its tokens.  Gated, bit for bit: the
    prefill's and the decode's q, K and V are the forward's rows; each
    step's ring holds the forward's K and V of exactly the positions inside
    the window, at ``position % Smax``, with length ``min(position + 1,
    Smax)``; the ring decode's output equals the plain decode over rings
    rebuilt from the forward's K and V; the forward's windowed flash equals
    its plain version on its own inputs.  Printed: the ring's and the
    prefill's codes against the forward's flash (a q7 carry's integer
    numerators follow its running max, so two block partitions differ in
    codes), beside the forward's flash at half its block."""
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels.ref import decode_qattention_ref

    (q, k, v, *fscal), fout = full                   # (1, H | Hkv, S, D) views
    (pq, pk, pv, *_), pout = prefill
    smax = steps[0][2].shape[0]
    hkv, s, d = k.shape[1:]
    g = q.shape[1] // hkv
    kf, vf = k[0].transpose(0, 1), v[0].transpose(0, 1)             # (S, Hkv, D)
    check(bool((pq[:, :, :n_prompt] == q[:, :, :n_prompt]).all()
               and (pk[:, :, :n_prompt] == k[:, :, :n_prompt]).all()
               and (pv[:, :, :n_prompt] == v[:, :, :n_prompt]).all()),
          "mixtral layer 0: the one-shot prefill's q, K, V differ from the cache-less "
          "forward's")
    pos = torch.tensor([p for p, *_ in steps], device="cuda")
    qd = torch.stack([st[1] for st in steps])                        # (T, Hkv, G, D)
    check(bool((qd == q[0, :, pos].transpose(0, 1).reshape(-1, hkv, g, d)).all()),
          "mixtral layer 0: the decode's q differs from the cache-less forward's")
    lengths = torch.tensor([st[4] for st in steps], dtype=torch.int32, device="cuda")
    check(bool((lengths == torch.clamp(pos + 1, max=smax)).all()),
          f"mixtral layer 0: ring lengths {lengths.tolist()[:4]}... (want min(pos + 1, "
          f"{smax}))")
    # the position ring row r holds at step p: the one of p - smax < x <= p
    # with x % smax == r (none yet where x < 0)
    rows = torch.arange(smax, device="cuda")
    src = pos[:, None] - (pos[:, None] - rows[None, :]) % smax
    live = (src >= 0)[..., None, None]
    kr = torch.where(live, kf[src.clamp(min=0)], 0)
    vr = torch.where(live, vf[src.clamp(min=0)], 0)
    ks, vs = torch.stack([st[2] for st in steps]), torch.stack([st[3] for st in steps])
    bad = int((((ks != kr) | (vs != vr)) & live).sum())
    check(bad == 0, f"mixtral layer 0: {bad} live ring codes differ from the cache-less "
          "forward's K and V at their positions")
    out = torch.stack([st[5] for st in steps])
    with guard.paused():
        want = decode_qattention_ref(qd, kr, vr, lengths, *dscal, fa.divisor_tile(512, smax))
        flash_plain = fa.flash_qattention_torch(q, k, v, *fscal, bkv=fa.divisor_tile(512, s),
                                                window=window)
    ring_bad, _ = compare(out, want)
    flash_bad, _ = compare(fout, flash_plain)
    print(f"  layer 0, positions {int(pos[0])}-{int(pos[-1])}: the ring's q, K and V are the "
          f"cache-less forward's; the ring decode against the plain decode over the rebuilt "
          f"rings: {ring_bad} mismatching codes; the forward's windowed flash (S {s}, bkv "
          f"{fa.divisor_tile(512, s)}) against its plain version: {flash_bad}")
    check(ring_bad == 0 and flash_bad == 0,
          f"mixtral layer 0: ring decode {ring_bad}, windowed flash {flash_bad} codes differ "
          "from the plain versions on the served inputs")
    half = fa.flash_qattention(q, k, v, *fscal, bkv=fa.divisor_tile(512, s) // 2,
                               window=window)
    flash_rows = fout[0, :, pos].transpose(0, 1).reshape(-1, hkv, g, d)
    print(f"  layer 0 against the cache-less flash (not gated: a q7 carry's numerators "
          f"follow its running max): the ring decode {_codes_differ(out, flash_rows)}; the "
          f"one-shot prefill (S {pq.shape[2]}, bkv {fa.divisor_tile(512, pq.shape[2])}) "
          f"{_codes_differ(pout[:, :, :n_prompt], fout[:, :, :n_prompt])}; the same flash "
          f"at bkv "
          f"{fa.divisor_tile(512, s) // 2} {_codes_differ(half, fout)}")


def hold_forward_shapes(torch, cfg, forwards, smax, guard, what="mixtral"):
    """Every shape that the recorded ``forwards`` ((B, S, mode, launches))
    gave the kernels, held against the plain versions on random codes:
    each layer's GEMMs (``forward_gemms``), the norms at R = B * S, and for
    an arch with attention a prefill's (maybe windowed) flash at (B, S)
    with its serving block and a decode forward's stripe decode at (B,
    ``smax``) over lengths up to a full stripe.  Prints the shapes; fails
    on any mismatching code."""
    from repro_torch.models.transformer import slot_kinds

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels import int4_matmul as mm
    from repro_torch.kernels import quant_layernorm as ln
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    forms = {(b, s, mode) for b, s, mode, _ in forwards}
    gemms = sorted({g for b, s, _ in forms for g in forward_gemms(cfg, b * s)})
    norms = sorted({b * s for b, s, _ in forms})
    attn = any(m == "attn" for m, _ in slot_kinds(cfg))
    flashes = sorted({(b, s) for b, s, mode in forms if mode == "prefill" and attn})
    decodes = sorted({b for b, _, mode in forms if mode == "decode" and attn})
    params = _ln_params(torch, gen, cfg.norm_type == "layernorm", cfg.d_model)
    scal = _attn_scalars(torch, d)
    bad = {}
    with guard.paused():
        for m, k, n in gemms:
            args, _ = _gemm_args(torch, gen, m, k, n, True)
            bad[f"int4_matmul {m}x{k}x{n}"] = compare(mm.int4_matmul(*args),
                                                     ref.int4_matmul_ref(*args))[0]
        for r in norms:
            x = _ln_input(torch, gen, r, cfg.d_model)
            bad[f"quant_layernorm R={r}"] = compare(ln.quant_layernorm(x, params),
                                                    ref.quant_layernorm_ref(x, params))[0]
        for b, s in flashes:
            q = _rand_i8(torch, gen, (b, s, h, d)).transpose(1, 2)
            k, v = (_rand_i8(torch, gen, (b, s, hkv, d)).transpose(1, 2) for _ in range(2))
            kw = dict(bkv=fa.divisor_tile(512, s), window=cfg.sliding_window)
            bad[f"flash_qattention B={b} S={s} bkv={kw['bkv']}"] = compare(
                fa.flash_qattention(q, k, v, *scal, **kw),
                fa.flash_qattention_torch(q, k, v, *scal, **kw))[0]
        for b in decodes:
            lengths = torch.randint(1, smax + 1, (b,), generator=gen, device="cuda",
                                    dtype=torch.int32)
            lengths[0] = smax
            args = (_rand_i8(torch, gen, (b, hkv, h // hkv, d)),
                    _rand_i8(torch, gen, (b, smax, hkv, d)),
                    _rand_i8(torch, gen, (b, smax, hkv, d)), lengths, *scal)
            bkv = fa.divisor_tile(512, smax)
            bad[f"decode_qattention B={b} Smax={smax} bkv={bkv}"] = compare(
                da.decode_qattention(*args, bkv=bkv), ref.decode_qattention_ref(*args, bkv))[0]
    print(f"  held against the plain versions at every shape of the phase's forwards: "
          f"{len(gemms)} GEMMs (M {sorted({m for m, _, _ in gemms})}), the norm at R "
          f"{norms}, the flash at (B, S) {flashes}, the stripe decode at B {decodes}: "
          f"{sum(bad.values())} mismatching codes")
    check(not any(bad.values()),
          f"{what}: kernels differ from their plain versions at served shapes: "
          f"{ {k: v for k, v in bad.items() if v} }")


def phase_mixtral(torch, kernels, guard):
    """mixtral-8x22b at its published widths (d 6144, 48 heads, 8 KV heads,
    8 experts of d_ff 16,384 top-2, vocab 32,768, a 4,096-row sliding
    window) at MIXTRAL_DEPTH layers of 56: its int4 codes alone take ~70 GB
    at full depth, and the calibration holds float weights.  An Engine of 8
    slots and max_len 4,352 resolves to the contiguous stripe, a ring of
    4,096 rows; it serves the 8 requests and one of 4,000 prompt tokens and
    160 new ones, whose decode runs past position 4,096 and wraps the ring.
    Gates: the ring; finite logits; 4 ``flash_qattention`` launches per
    one-shot prefill and 4 ``decode_qattention`` per tick, no paged kernel;
    every GEMM on the path its M implies; the first layer of the long
    request against a cache-less forward over its 4,160 tokens
    (``check_layer0``).  Printed, not gated: the KL and argmax agreement
    between its decode logits and that forward's (after 4 random MoE
    layers, two q7 carries that partition their blocks differently part
    far).  Then the cache-less forward at (1, 8,192), where the window
    bites (median latency, a profile), and a decode tick profiled; last,
    every shape the phase's forwards ran is held against the plain
    versions (``hold_forward_shapes``).  The weights are freed before it
    returns."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_qattention as fa
    from repro_torch.kernels.ref import window_skip_margin
    from repro_torch.models import serve_int as S
    from repro_torch.serve.engine import Engine, EngineConfig, Request, RequestStatus

    cfg, folded = load_arch(torch, "mixtral-8x22b", n_layers=MIXTRAL_DEPTH)
    prep = S.prepare_folded(cfg, folded)
    margins = [window_skip_margin(float(f["slot0"]["attn_q"]["inv_s_logit"]), cfg.hd)
               for f in prep["layers"]]
    branch = "starts each tile at its first live block" if min(margins) > 1 else \
        "walks from block 0 in some layer"
    print(f"  window_skip_margin per layer {[round(m, 1) for m in margins]}: the windowed "
          f"flash {branch}")
    eng = Engine(cfg, folded, EngineConfig(batch_slots=8, max_len=4352))
    check(eng.layout == "contiguous" and eng.smax == MIXTRAL_WINDOW,
          f"mixtral: layout {eng.layout}, {eng.smax} rows a slot (want the contiguous "
          f"4,096-row ring)")
    n_prompt, n_new = MIXTRAL_LONG
    long_prompt = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size,
                                                           n_prompt).astype(np.int32)
    reqs = [Request(prompt=long_prompt, max_new_tokens=n_new)]
    reqs += [Request(prompt=p, max_new_tokens=32) for p in _prompts(cfg.vocab_size)]
    rows, steps, finite = [], [], [True]
    inner = eng._decode

    def decode(toks):
        cap.calls["decode_qattention"].clear()
        out = inner(toks)
        finite[0] = finite[0] and bool(np.isfinite(out).all())
        for b, st in enumerate(eng.sched.slots):
            if st is not None and st.rid == reqs[0].rid:
                rows.append((int(eng.pos[b]), out[b].copy()))
                (q, kc, vc, lengths, *scal), ctx = cap.calls["decode_qattention"][0]
                steps.append((rows[-1][0], q[b].clone(), kc[b].clone(), vc[b].clone(),
                              int(lengths[b]), ctx[b].clone()))
                dscal[:] = scal
        return out

    eng._decode = decode
    dscal = []
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    reset_gemm_paths()
    t0 = time.perf_counter()
    with Captured() as cap, DroppedChoices() as dropped:
        for r in reqs:
            eng.submit(r)
        while eng.has_work:
            eng.poll()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = eng.counters
    launches = {k.__name__: k.launches for k in kernels}
    forwards = list(FORWARDS)
    prefill = next(call for call in cap.calls["flash_qattention"]     # the first is reqs[0]'s
                   if call[0][0].shape[2] == eng._bucket_len(n_prompt))
    del cap
    n_tok = sum(len(r.out) for r in reqs)
    print(f"  mixtral: {n_tok / wall:.1f} tok/s ({wall:.2f} s wall), 9 requests (one of "
          f"{n_prompt} prompt tokens and {n_new} new), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"    counters: { {k: v for k, v in c.items() if v} }")
    print(f"    launches: {launches}; int4_matmul by path {gemm_paths()}")
    print(f"    {dropped.n} of {dropped.choices} routing choices dropped at capacity")
    check(all(r.status is RequestStatus.FINISHED for r in reqs), "mixtral: a request failed")
    check(finite[0], "mixtral: non-finite decode logits")
    check(c["oneshot_prefills"] == 9 and c["loop_prefill_steps"] == 0,
          f"mixtral: one-shot prefills {c['oneshot_prefills']}, loop steps "
          f"{c['loop_prefill_steps']}")
    want = {"flash_qattention": cfg.n_layers * c["oneshot_prefills"],
            "decode_qattention": cfg.n_layers * c["decode_steps"],
            "paged_prefill_qattention": 0, "paged_decode_qattention": 0}
    check(all(launches[k] == v for k, v in want.items()),
          f"mixtral: launches {launches}, want {want} (4 flash_qattention per one-shot prefill, "
          "4 decode_qattention per tick, no paged kernel)")
    check(launches["int4_matmul"] > 0 and launches["quant_layernorm"] > 0,
          f"mixtral: a kernel of the path never ran: {launches}")
    check_paths("mixtral", cfg, gemm_paths(), FORWARDS)
    last_pos = rows[-1][0]
    check(len(rows) == n_new - 1 and last_pos == n_prompt + n_new - 2 > MIXTRAL_WINDOW,
          f"mixtral: the long request's decode ended at position {last_pos} after "
          f"{len(rows)} steps (want past {MIXTRAL_WINDOW})")
    # the cache-less forward over the same tokens: the first layer gated,
    # the logits printed (the reference's own check)
    seq = np.concatenate([long_prompt, reqs[0].out]).astype(np.int32)
    toks = torch.as_tensor(seq[None], device="cuda")
    with Captured() as cap, DroppedChoices() as dropped_full:
        logits, _ = S.serve_forward(cfg, prep, toks)
        full = logits[0].cpu().numpy()
    del logits
    check_layer0(torch, guard, cfg.sliding_window, n_prompt, steps, dscal, prefill,
                 cap.calls["flash_qattention"][0])
    forwards += FORWARDS[-1:]
    del cap, steps, prefill
    pos = [p for p, _ in rows]
    kl, agree = _kl_argmax(full[pos], np.stack([r for _, r in rows]))
    kl_last, agree_last = _kl_argmax(full[pos[-1:]], rows[-1][1][None])
    print(f"  ring decode vs the cache-less forward over {len(seq)} tokens: last position "
          f"{pos[-1]}: KL {kl_last:.3e}, argmax {'agrees' if agree_last else 'differs'}; "
          f"over the {len(pos)} decode positions {pos[0]}-{pos[-1]}: mean KL {kl:.3e}, "
          f"argmax agrees on {agree:.4f} (not gated; the forward dropped {dropped_full.n} of "
          f"{dropped_full.choices} routing choices, the served run {dropped.n} of "
          f"{dropped.choices})")
    # the cache-less forward where the window bites
    toks = torch.as_tensor(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (1, 8192)).astype(np.int32), device="cuda")
    fa.flash_qattention.launches = 0
    reset_gemm_paths()
    logits, _ = S.serve_forward(cfg, prep, toks)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (1, 8192, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "mixtral (1, 8192): logits")
    check(fa.flash_qattention.launches == cfg.n_layers,
          f"mixtral (1, 8192): flash_qattention launches {fa.flash_qattention.launches}")
    check_paths("mixtral (1, 8192)", cfg, gemm_paths(), FORWARDS)
    del logits
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        S.serve_forward(cfg, prep, toks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    lat = float(np.median(walls))
    print(f"  cache-less (1, 8192): median {lat * 1e3:.2f} ms over 3 forwards "
          f"({8192 / lat:.0f} tokens/s; host clock), {cfg.n_layers} flash_qattention a forward")
    profile_steps(torch, lambda: S.serve_forward(cfg, prep, toks), "mixtral (1, 8192) forward",
                  n=2, experts=True)
    profile_decode(torch, cfg, folded, "mixtral decode tick (batch 8, 4,096-row rings)",
                   max_len=4352)
    hold_forward_shapes(torch, cfg, forwards + FORWARDS, eng.smax, guard)
    del folded, prep
    torch.cuda.empty_cache()
    return dict(launches=launches)


def phase_small_mixtral(torch):
    """The small mixtral (window 16) on the card (the kernels) and on the
    CPU (their plain versions, REPRO_TORCH_KERNELS=gpu): the Engine on
    ``cache_layout="auto"`` (the 16-row ring) with one-shot prompts (9, 12)
    and prompts longer than the window (30, 20: the batch-1 decode loop),
    and the LockstepEngine, every request decoding past the window: equal
    greedy tokens.  Then a one-shot stripe prefill and 12 decode steps past
    the window fed the CPU's tokens, the differing logits counted."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import Engine, EngineConfig, LockstepEngine, Request

    prev = os.environ.get("REPRO_TORCH_KERNELS")
    os.environ["REPRO_TORCH_KERNELS"] = "gpu"
    try:
        cfg = smoke_config("mixtral-8x22b")
        folded_cpu = calibrated_folded(cfg, SEED, device="cpu")
        folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to("cuda"), folded_cpu)}
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 30, 12, 20)]
        toks, loops = {}, {}
        for dev in ("cpu", "cuda"):
            eng = Engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64))
            toks[dev, "engine"] = [r.out.tolist() for r in eng.generate(
                [Request(prompt=p, max_new_tokens=12) for p in prompts])]
            loops[dev] = (eng.layout, eng.counters["loop_prefill_steps"],
                          eng.counters["oneshot_prefills"])
            toks[dev, "lockstep"] = [r.out.tolist() for r in LockstepEngine(
                cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64)).generate(
                [Request(prompt=p, max_new_tokens=10) for p in prompts[:3]])]
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
        out, fed = {}, []
        for dev in ("cpu", "cuda"):
            cache = S.init_cache(cfg, 2, 64, device=dev)
            logits, cache = S.serve_forward(cfg, folded[dev], prompt.to(dev), cache=cache)
            got = [logits.reshape(-1, cfg.vocab_size).cpu()]
            for step in range(12):
                if dev == "cpu":
                    fed.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
                logits, cache = S.serve_forward(
                    cfg, folded[dev], fed[step].to(dev), cache=cache,
                    pos_offset=torch.full((2,), 12 + step, dtype=torch.int32, device=dev),
                    mode="decode")
                got.append(logits.reshape(-1, cfg.vocab_size).cpu())
            out[dev] = torch.cat(got)
        a, b = out["cpu"], out["cuda"]
        differ = int((a != b).sum())
        print(f"  small mixtral, card vs CPU: (layout, loop prefill steps, one-shot prefills) "
              f"{loops['cuda']}; Engine tokens equal "
              f"{toks['cuda', 'engine'] == toks['cpu', 'engine']}, LockstepEngine tokens equal "
              f"{toks['cuda', 'lockstep'] == toks['cpu', 'lockstep']}; stripe prefill + 12 "
              f"decode steps to position 23: {differ} of {a.numel()} logits differ")
        check(loops["cuda"] == loops["cpu"] == ("contiguous", 50, 2),
              f"small mixtral: (layout, loop steps, one-shot prefills) {loops}")
        check(bool(torch.isfinite(b).all()), "small mixtral: non-finite logits on the card")
        check(toks["cuda", "engine"] == toks["cpu", "engine"]
              and toks["cuda", "lockstep"] == toks["cpu", "lockstep"],
              "small mixtral: the card's greedy tokens differ from the CPU's")
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_KERNELS"]
        else:
            os.environ["REPRO_TORCH_KERNELS"] = prev


# the recurrent archs' requests: 8 prompts of 8-64 tokens (every prompt
# token is one batch-1 forward of the decode-loop prefill), 32 new tokens
# each, on 8 slots of max_len 256
RECURRENT_LENS = (8, 64, 12, 20, 8, 16, 32, 10)
RECURRENT_MAX_LEN = 256
JAMBA_DEPTH = 8        # of 72 layers: one super-block, see phase_recurrent
# of 48 and 24 layers: the script passed 1,000 s with [analysis] on a slow
# host, so [xlstm] and [moe] serve at half depth (their widths published)
XLSTM_DEPTH = 24
MOE_DEPTH = 6          # of 24 layers: 12 before [mesh]'s qwen2-moe took its time
DUAL_FORM_TOL = dict(atol=2e-3, rtol=2e-2)   # the reference's dual-form bound


def _recurrent_prompts(vocab: int):
    rng = np.random.default_rng(SEED + 7)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in RECURRENT_LENS]


def slot_input(torch, cfg, prep, toks, fn_name: str, index: int):
    """(int8 input, folded slot) of the ``index``-th call of
    ``serve_int.<fn_name>`` (``_mamba_int`` or ``_xlstm_int``) in a
    cache-less forward over ``toks``: a recurrent slot's input as the model
    gives it."""
    from repro_torch.models import serve_int as S

    calls, inner = [], getattr(S, fn_name)

    def recorded(x_i8, f, *a, **kw):
        calls.append((x_i8, f))
        return inner(x_i8, f, *a, **kw)

    setattr(S, fn_name, recorded)
    try:
        S.serve_forward(cfg, prep, toks)
    finally:
        setattr(S, fn_name, inner)
    return calls[index]


def dual_form(torch, cfg, prep, slot: int, mixer: str, n: int):
    """The dual-form gate at ``slot`` (rep 0): on the int8 input the model
    gives that slot over ``n`` seeded tokens, the recurrent decode from a
    zero state (one row at a time, the state written in place) against the
    cache-less form (the mLSTM's parallel form, the sLSTM's scan, the
    Mamba's chunked scan) on the same rows: float outputs within the
    reference's bound (``DUAL_FORM_TOL``), the requantized codes that differ
    counted."""
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import slot_kinds

    toks = torch.as_tensor(np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32), device="cuda")
    if mixer == "mamba":
        fn_name, island = "_mamba_int", lambda x, f, st=None: S.mamba_float(x, f, cfg, st)
    else:
        fn_name, island = "_xlstm_int", lambda x, f, st=None: S.xlstm_float(x, f, cfg, mixer,
                                                                             st)
    # the slot's place among the slots that call the same function (rep 0)
    index = [i for i, (m, _) in enumerate(slot_kinds(cfg))
             if m != "attn" and (m == "mamba") == (mixer == "mamba")].index(slot)
    x, f = slot_input(torch, cfg, prep, toks, fn_name, index)
    whole = island(x, f)
    state = {k: v[0] for k, v in S.init_cache(cfg, 1, n, device="cuda")[f"slot{slot}"].items()}
    steps = torch.cat([island(x[:, t:t + 1], f, state) for t in range(n)], 1)
    ok = bool(torch.allclose(steps, whole, **DUAL_FORM_TOL))
    codes = [torch.clamp(torch.round(o * f["s_ra"]), -127, 127) for o in (steps, whole)]
    differ = int((codes[0] != codes[1]).sum())
    err = float((steps - whole).abs().max())
    print(f"  dual form at slot {slot} ({mixer}), {n} rows: the decode recurrence against the "
          f"cache-less form: max abs diff {err:.3g} (max |out| {float(whole.abs().max()):.3g}; "
          f"bound atol {DUAL_FORM_TOL['atol']}, rtol {DUAL_FORM_TOL['rtol']}), {differ} of "
          f"{whole.numel()} requantized codes differ")
    check(ok and bool(torch.isfinite(steps).all()),
          f"{cfg.name}: slot {slot} ({mixer}) decode recurrence != cache-less form")


def phase_recurrent(torch, name, kernels, guard):
    """xlstm-1.3b at its published widths at XLSTM_DEPTH of 48 layers (three
    of its six blocks of 1 sLSTM + 7 mLSTM; d 2048, 4 heads of 512, no
    FFN), or jamba-1.5-large at its published widths (d 8192, 64
    heads, 8 KV heads, d_ff 24,576, vocab 65,536, Mamba d_state 16, d_conv
    4, expand 2) at JAMBA_DEPTH of 72 layers (one super-block, ``m m m m a m
    m m``) and ``n_experts=0``: its 4 MoE slots of a super-block hold ~38.7 B
    parameters, and the calibration holds every float weight at once, so
    one super-block with its experts does not fit the card; every slot's
    FFN is then the dense SwiGLU at its published d_ff (the MoE slot is held
    at smoke size by ``phase_small_recurrent``).  Random weights from SEED,
    calibrated on (2, 32) and folded on the card; the float32 weight cache
    of the weight-only linears printed.

    The 8 requests (``RECURRENT_LENS``) through ``make_engine`` (``auto``
    resolves to the contiguous layout): finite logits, tokens in range,
    every prompt through the batch-1 decode loop (``loop_prefill_steps`` =
    the prompt tokens, no one-shot prefill), per forward ``quant_layernorm``
    25 times (xlstm) or 17 (jamba), jamba's ``int4_matmul`` 28 times on the
    path its M implies and ``decode_qattention`` once, no flash and no
    paged kernel.  The dual-form gates (``dual_form``): xlstm's slots 1
    (mLSTM) and 0 (sLSTM) over 128 rows, jamba's slot 0 (Mamba) over 200
    (two chunks and a ragged pad).  Then the ``LockstepEngine`` on the same
    prompts (its first divergence from the Engine's tokens printed, not
    gated: its prompts are left-padded, and its float products run at
    other M), profiles of a decode tick and a loop-prefill step, the
    cache-less forward at (1, 512) (jamba: one ``flash_qattention`` a
    forward, profiled) and, for xlstm, (1, 1024) (the chunked parallel
    mLSTM) timed; the recurrent state's bytes a slot.  Last, every shape
    the phase's forwards gave rows 1, 2, 6 and 9 held against the plain
    versions (``hold_forward_shapes``).  The weights are freed before it
    returns."""
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import slot_kinds
    from repro_torch.serve.engine import EngineConfig, LockstepEngine, Request, make_engine

    jamba = name.startswith("jamba")
    cfg, folded = load_arch(torch, name, **(dict(n_layers=JAMBA_DEPTH, n_experts=0)
                                            if jamba else dict(n_layers=XLSTM_DEPTH)))
    t0 = time.perf_counter()
    prep = S.prepare_folded(cfg, folded)
    torch.cuda.synchronize()
    print(f"  float32 weights of the weight-only linears (prepare_folded): "
          f"{S.float_weight_bytes(prep) / 2**30:.2f} GiB, {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    one = S.init_cache(cfg, 1, RECURRENT_MAX_LEN, device="cuda")
    state_bytes = sum(t.numel() * t.element_size() for c in one.values()
                      for k, t in c.items() if k not in ("k", "v"))
    stripe_bytes = sum(t.numel() * t.element_size() for c in one.values()
                       for k, t in c.items() if k in ("k", "v"))
    print(f"  recurrent state a slot: {state_bytes} bytes ({state_bytes / 2**20:.1f} MiB, "
          f"float32, any length)" + (f"; the attention slot's int8 K/V stripe {stripe_bytes} "
                                     f"bytes at max_len {RECURRENT_MAX_LEN}" if jamba else ""))
    kinds = slot_kinds(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds) * cfg.n_reps
    want_ln = (len(kinds) + sum(f != "none" for _, f in kinds)) * cfg.n_reps + 1
    want_gemm = len(forward_gemms(cfg, 1)) * cfg.n_reps
    prompts = _recurrent_prompts(cfg.vocab_size)
    finite = [True]

    def watch(eng):
        for attr in ("_decode", "_prefill_slot"):
            inner = getattr(eng, attr)

            def checked(*a, _inner=inner):
                out = _inner(*a)
                finite[0] = finite[0] and bool(np.isfinite(out).all())
                return out

            setattr(eng, attr, checked)

    r = serve(torch, cfg, prep, kernels, on_engine=watch, prompts=prompts,
              max_len=RECURRENT_MAX_LEN)
    forwards = list(r["forwards"])
    print_run(name, r, kernels)
    print_forward_launches(r)
    c = r["counters"]
    launches = dict(zip([k.__name__ for k in kernels], r["launches"]))
    check(r["layout"] == "contiguous", f"{name}: layout {r['layout']} (want contiguous)")
    check(finite[0], f"{name}: non-finite logits")
    check(c["oneshot_prefills"] == 0 and c["loop_prefill_steps"] == c["prefill_tokens"]
          == sum(RECURRENT_LENS),
          f"{name}: one-shot prefills {c['oneshot_prefills']}, loop prefill steps "
          f"{c['loop_prefill_steps']} (want 0 and {sum(RECURRENT_LENS)})")
    check(len(forwards) == c["loop_prefill_steps"] + c["decode_steps"],
          f"{name}: {len(forwards)} forwards for {c['loop_prefill_steps']} loop steps and "
          f"{c['decode_steps']} ticks")
    want = {"quant_layernorm": want_ln, "int4_matmul": want_gemm,
            "decode_qattention": n_attn, "flash_qattention": 0,
            "paged_prefill_qattention": 0, "paged_decode_qattention": 0}
    per_forward(name, forwards, want)
    check_paths(name, cfg, r["paths"], forwards)
    mixers = [("mamba", 0, 200)] if jamba else [("mlstm", 1, 128), ("slstm", 0, 128)]
    for mixer, slot, n in mixers:
        dual_form(torch, cfg, prep, slot, mixer, n)

    lock = LockstepEngine(cfg, prep, EngineConfig(batch_slots=8, max_len=RECURRENT_MAX_LEN))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lreqs = lock.generate([Request(prompt=p, max_new_tokens=32) for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    div = first_divergence(r["tokens"], [q.out.tolist() for q in lreqs])
    print(f"  LockstepEngine, the same prompts left-padded to {max(RECURRENT_LENS)}: "
          f"{32 * len(prompts) / wall:.1f} tok/s ({wall:.2f} s wall); first divergence from "
          f"the Engine's tokens (request, token): {div} (not gated: the pad tokens enter the "
          f"recurrent state, and the float products run at other M)")

    # a steady tick (2-token prompts: the recurrent slots' work does not
    # grow with the prompt) and one batch-1 step of the decode-loop prefill
    eng = make_engine(cfg, prep, EngineConfig(batch_slots=8, max_len=RECURRENT_MAX_LEN))
    for p in prompts:
        eng.submit(Request(prompt=p[:2], max_new_tokens=16))
    while eng.sched.waiting or eng.sched.prefilling:
        eng.poll()
    profile_steps(torch, eng.poll, f"{name} decode tick (batch 8)")
    tok = torch.as_tensor(prompts[0][:1].reshape(1, 1), device="cuda")
    profile_steps(torch, lambda: S.serve_forward(cfg, prep, tok, cache=one, pos_offset=5,
                                                 mode="decode"),
                  f"{name} decode-loop prefill step (batch 1)")
    del eng, lock, one

    reset_gemm_paths()
    rng = np.random.default_rng(SEED + 9)
    for s in (512,) if jamba else (512, 1024):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, s)).astype(np.int32),
                               device="cuda")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits, _ = S.serve_forward(cfg, prep, toks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check(tuple(logits.shape) == (1, s, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"{name} (1, {s}): logits")
        del logits
        lat = float(np.median(walls))
        print(f"  cache-less (1, {s}): median {lat * 1e3:.2f} ms over 3 forwards, the first "
              f"included ({s / lat:.0f} tokens/s; host clock)")
        if s == 512:
            profile_steps(torch, lambda t=toks: S.serve_forward(cfg, prep, t),
                          f"{name} (1, 512) cache-less forward", n=2 if jamba else 1)
    cacheless = [f for f in FORWARDS if f[2] == "prefill"]
    check(all(f[3]["flash_qattention"] == n_attn and f[3]["quant_layernorm"] == want_ln
              for f in cacheless), f"{name}: cache-less launches {[f[3] for f in cacheless]}")
    check_paths(f"{name} cache-less", cfg, gemm_paths(), cacheless)
    hold_forward_shapes(torch, cfg, forwards + cacheless, RECURRENT_MAX_LEN, guard, name)
    del folded, prep
    torch.cuda.empty_cache()
    return dict(launches=launches)


def phase_small_recurrent(torch):
    """Small xlstm-1.3b and small jamba-1.5-large (smoke widths, jamba with
    its 4 experts top-2) on the card (the kernels) and on the CPU (their
    plain versions, REPRO_TORCH_KERNELS=gpu) from the same folded weights:
    the Engine (``auto``: the decode-loop prefill) must give equal greedy
    tokens; then a cache-less prefill and 4 decode steps fed the CPU's
    tokens, with the logits that differ counted (the float cores run on
    cuBLAS on the card)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import EngineConfig, Request, make_engine

    prev = os.environ.get("REPRO_TORCH_KERNELS")
    os.environ["REPRO_TORCH_KERNELS"] = "gpu"
    try:
        for name in ("xlstm-1.3b", "jamba-1.5-large-398b"):
            cfg = smoke_config(name)
            folded_cpu = calibrated_folded(cfg, SEED, device="cpu")
            folded = {"cpu": folded_cpu, "cuda": tree_map(lambda t: t.to("cuda"), folded_cpu)}
            rng = np.random.default_rng(SEED)
            prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in (9, 30, 17, 12)]
            toks, loops = {}, {}
            for dev in ("cpu", "cuda"):
                eng = make_engine(cfg, folded[dev], EngineConfig(batch_slots=3, max_len=64))
                toks[dev] = [q.out.tolist() for q in eng.generate(
                    [Request(prompt=p, max_new_tokens=8) for p in prompts])]
                loops[dev] = (eng.layout, eng.counters["loop_prefill_steps"],
                              eng.counters["oneshot_prefills"])
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
            out, fed = {}, []
            for dev in ("cpu", "cuda"):
                logits, _ = S.serve_forward(cfg, folded[dev], prompt.to(dev))
                rows = [logits.reshape(-1, cfg.vocab_size).cpu()]
                cache = S.init_cache(cfg, 2, 64, device=dev)
                for step in range(4):
                    if dev == "cpu":
                        fed.append((prompt[:, -1:] if step == 0 else
                                    rows[-1].reshape(2, -1, cfg.vocab_size)[:, -1].argmax(
                                        -1, keepdim=True)).to(torch.int32))
                    logits, cache = S.serve_forward(
                        cfg, folded[dev], fed[step].to(dev), cache=cache,
                        pos_offset=torch.full((2,), step, dtype=torch.int32, device=dev),
                        mode="decode")
                    rows.append(logits.reshape(-1, cfg.vocab_size).cpu())
                out[dev] = torch.cat(rows)
            a, b = out["cpu"], out["cuda"]
            differ = int((a != b).sum())
            print(f"  small {name}, card vs CPU: (layout, loop prefill steps, one-shot "
                  f"prefills) {loops['cuda']}; Engine tokens equal {toks['cuda'] == toks['cpu']};"
                  f" cache-less prefill (2, 24) + 4 decode steps: {differ} of {a.numel()} "
                  f"logits differ")
            check(loops["cuda"] == loops["cpu"] == ("contiguous", 68, 0),
                  f"small {name}: (layout, loop steps, one-shot prefills) {loops}")
            check(bool(torch.isfinite(b).all()), f"small {name}: non-finite logits on the card")
            check(toks["cuda"] == toks["cpu"],
                  f"small {name}: the card's greedy tokens differ from the CPU's")
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_KERNELS"]
        else:
            os.environ["REPRO_TORCH_KERNELS"] = prev


# the vision stub's image: IMAGE_GRID x IMAGE_GRID patches (launch/dryrun.py's
# 256), then as many text tokens; musicgen's 8 streams of 64 prompt frames and
# 64 decoded, and its cache-less forward
IMAGE_GRID = 16
VISION_DECODE = 32
MUSIC_STREAMS, MUSIC_FRAMES, MUSIC_DECODE = 8, 64, 64


def image_pos3(torch, grid: int, text: int):
    """(1, grid^2 + text, 3) M-RoPE positions on the card: the image's (t 0,
    h the row, w the column), then the text at ``grid`` onwards on all
    three streams (Qwen2-VL's rule)."""
    g = torch.arange(grid * grid, dtype=torch.int32, device="cuda")
    img = torch.stack([torch.zeros_like(g), g // grid, g % grid], -1)
    txt = (grid + torch.arange(text, dtype=torch.int32, device="cuda"))[:, None].expand(text, 3)
    return torch.cat([img, txt])[None]


def per_forward(what, forwards, want):
    """Every recorded forward's launches of the kernels in ``want`` equal."""
    bad = [(b, s, mode, {k: got[k] for k in want}) for b, s, mode, got in forwards
           if any(got[k] != v for k, v in want.items())]
    check(not bad, f"{what}: per-forward launches {bad[:2]} != {want}")
    print(f"  {what}: per forward {want} (every one of the {len(forwards)} forwards)")


def frontend_launches(cfg, decode: bool):
    """The launches one forward of a frontend arch makes: the norms, the
    GEMMs, one stripe decode (``decode``) or one flash a layer."""
    return {"quant_layernorm": 2 * cfg.n_layers + 1,
            "int4_matmul": len(forward_gemms(cfg, 1)) * cfg.n_layers,
            "decode_qattention": cfg.n_layers if decode else 0,
            "flash_qattention": 0 if decode else cfg.n_layers,
            "paged_prefill_qattention": 0, "paged_decode_qattention": 0}


def phase_qwen2vl(torch, kernels, guard):
    """qwen2-vl-2b at full size (28 layers, d 1,536, 12 heads, 2 KV heads
    of 128, d_ff 8,960, vocab 151,936, tied embeddings, M-RoPE sections
    (16, 24, 24)), random weights from SEED, calibrated on (2, 32) text and
    folded on the card.  ``make_engine`` must hand it to the
    ``LockstepEngine``: the [contiguous] workload (8 prompts of 32 tokens,
    16 new, greedy and at T=0.7), each step one ``decode_qattention`` a
    layer (M-RoPE at its position on all three streams).  Then the vision
    stub: 256 image codes (random float patch embeddings quantized at the
    folded ``s_embed``) on a 16 x 16 ``pos3`` grid before 256 text tokens,
    the cache-less (1, 512) forward, then the same as a one-shot prefill
    into a 1,024-row stripe (its logits equal to the cache-less forward's:
    both run the flash at bkv 512) and 32 greedy decode steps from 512.
    Profiles of a lockstep step and of the one-shot prefill; every shape
    the phase's forwards gave rows 1, 2, 6 and 9 held (``hold_forward_
    shapes``).  The weights are freed before it returns."""
    from repro_torch.models import serve_int as S
    from repro_torch.serve.engine import EngineConfig, make_engine

    cfg, folded = load_arch(torch, "qwen2-vl-2b")
    prep = S.prepare_folded(cfg, folded)
    del folded
    lock = serve_lockstep(torch, cfg, prep, kernels, make=make_engine)
    names = [k.__name__ for k in kernels]
    launches = dict(zip(names, lock["launches"]))
    print(f"  lockstep through make_engine: {lock['tok_per_s']:.1f} tok/s ({lock['wall_s']:.2f} s"
          f" wall, {lock['steps']} decode steps at batch 8), launches {launches}")
    per_forward("qwen2vl lockstep", lock["forwards"], frontend_launches(cfg, decode=True))
    check_paths("qwen2vl lockstep", cfg, lock["paths"], lock["forwards"])
    forwards = list(lock["forwards"])
    hot = serve_lockstep(torch, cfg, prep, kernels, temperature=0.7, make=make_engine)
    print(f"  lockstep sampled (T=0.7): {hot['tok_per_s']:.1f} tok/s ({hot['wall_s']:.2f} s "
          f"wall); first divergence from greedy (request, token) "
          f"{first_divergence(lock['tokens'], hot['tokens'])}")
    check(hot["launches"] == lock["launches"], f"qwen2vl sampled: launches {hot['launches']}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    n_img = IMAGE_GRID * IMAGE_GRID
    emb = 0.02 * torch.randn((1, n_img, cfg.d_model), generator=gen, device="cuda")
    img = torch.clamp(torch.round(emb * prep["s_embed"]), -127, 127).to(torch.int8)
    text = torch.randint(0, cfg.vocab_size, (1, n_img), generator=gen, device="cuda",
                         dtype=torch.int32)
    vision = dict(extra_embeds_i8=img, pos3=image_pos3(torch, IMAGE_GRID, n_img))
    reset_gemm_paths()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    full, _ = S.serve_forward(cfg, prep, text, **vision)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    cache = S.init_cache(cfg, 1, 1024, device="cuda")
    t0 = time.perf_counter()
    oneshot, cache = S.serve_forward(cfg, prep, text, cache=cache, **vision)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    rows = 2 * n_img
    check(tuple(full.shape) == (1, rows, cfg.vocab_size) and bool(torch.isfinite(full).all()),
          f"qwen2vl vision forward: logits {tuple(full.shape)} or non-finite")
    check(torch.equal(oneshot, full), "qwen2vl: the one-shot stripe prefill's logits differ "
          "from the cache-less forward's (both run the flash at bkv 512)")
    tok = full[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks = []
    t0 = time.perf_counter()
    for step in range(VISION_DECODE):
        lg, cache = S.serve_forward(cfg, prep, tok, cache=cache, pos_offset=rows + step,
                                    mode="decode")
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    toks = torch.cat(toks, 1)[0].tolist()
    check(bool(torch.isfinite(lg).all()) and all(0 <= t < cfg.vocab_size for t in toks),
          "qwen2vl decode after the image: non-finite logits or out-of-vocab tokens")
    vis_fw = list(FORWARDS)
    per_forward("qwen2vl vision prefills", [f for f in vis_fw if f[2] == "prefill"],
                frontend_launches(cfg, decode=False))
    per_forward("qwen2vl vision decode", [f for f in vis_fw if f[2] == "decode"],
                frontend_launches(cfg, decode=True))
    check_paths("qwen2vl vision", cfg, gemm_paths(), vis_fw)
    forwards += vis_fw
    for name, k in zip(names, kernels):
        launches[name] += k.launches
    print(f"  vision stub, {n_img} image rows on a {IMAGE_GRID} x {IMAGE_GRID} grid + {n_img} "
          f"text tokens: cache-less (1, {rows}) {t_full * 1e3:.1f} ms, one-shot stripe prefill "
          f"{t_pre * 1e3:.1f} ms (logits equal), {VISION_DECODE} decode steps "
          f"{t_dec / VISION_DECODE * 1e3:.2f} ms each (host clock, first calls included); "
          f"tokens {toks[:8]}...")
    profile_steps(torch, lambda: S.serve_forward(cfg, prep, text, cache=cache, **vision),
                  "qwen2vl one-shot vision prefill (1, 512) into the stripe")
    eng = make_engine(cfg, prep, EngineConfig(batch_slots=8, max_len=1024))
    col = np.arange(8, dtype=np.int32)
    profile_steps(torch, lambda: eng._step(col, 40), "qwen2vl lockstep step (batch 8)")
    hold_forward_shapes(torch, cfg, forwards, 1024, guard, "qwen2vl")
    del prep, cache, eng
    torch.cuda.empty_cache()
    return dict(launches=launches)


def phase_musicgen(torch, kernels, guard):
    """musicgen-medium at full size (48 layers, d 1,536, 24 heads of 64
    (MHA), d_ff 6,144 GELU, LayerNorm, learned positions, 4 codebooks of
    2,048 summed at the input and 4 LM heads), random weights from SEED,
    calibrated on (2, 4, 32) codes and folded on the card.  ``make_engine``
    hands it to the ``LockstepEngine``, whose ``generate`` raises (the
    reference's fails); it is served as the reference serves it, through
    ``serve_forward``: 8 streams of 64 prompt frames one-shot into an 8 x
    1,024-row stripe (logits (8, 4, 64, 2,048), equal to the cache-less
    forward's over the same codes), then 64 greedy decode steps of (8, 4,
    1) codes, each head's argmax the next frame's code; the cache-less
    forward at (2, 4, 512).  Profiles of a decode step and of the prefill;
    every shape held (``hold_forward_shapes``).  The weights are freed
    before it returns."""
    from repro_torch.models import serve_int as S
    from repro_torch.serve.engine import EngineConfig, LockstepEngine, Request, make_engine

    cfg, folded = load_arch(torch, "musicgen-medium")
    prep = S.prepare_folded(cfg, folded)
    del folded
    eng = make_engine(cfg, prep, EngineConfig(batch_slots=8, max_len=1024))
    check(isinstance(eng, LockstepEngine), f"musicgen: make_engine built {type(eng)}")
    try:
        eng.generate([Request(prompt=np.arange(4, dtype=np.int32))])
        check(False, "musicgen: LockstepEngine.generate did not raise")
    except ValueError as e:
        print(f"  make_engine -> LockstepEngine; generate raises: {str(e)[:90]}...")
    del eng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    k_books = cfg.n_codebooks
    codes = torch.randint(0, cfg.vocab_size, (MUSIC_STREAMS, k_books, MUSIC_FRAMES),
                          generator=gen, device="cuda", dtype=torch.int32)
    reset_gemm_paths()
    for k in kernels:
        k.launches = 0
    cache = S.init_cache(cfg, MUSIC_STREAMS, 1024, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = S.serve_forward(cfg, prep, codes, cache=cache)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check(tuple(lg.shape) == (MUSIC_STREAMS, k_books, MUSIC_FRAMES, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()), f"musicgen prefill: logits {tuple(lg.shape)}")
    frames = []
    t0 = time.perf_counter()
    for step in range(MUSIC_DECODE):
        nxt = lg[..., -1, :].argmax(-1).to(torch.int32)[..., None]        # (8, 4, 1)
        frames.append(nxt)
        lg, cache = S.serve_forward(cfg, prep, nxt, cache=cache,
                                    pos_offset=MUSIC_FRAMES + step, mode="decode")
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    frames = torch.cat(frames, -1)
    check(tuple(lg.shape) == (MUSIC_STREAMS, k_books, 1, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()) and int(frames.min()) >= 0
          and int(frames.max()) < cfg.vocab_size, "musicgen decode: logits or codes")
    served = list(FORWARDS)
    launches = dict(zip([k.__name__ for k in kernels], [k.launches for k in kernels]))
    per_forward("musicgen prefill", [f for f in served if f[2] == "prefill"],
                frontend_launches(cfg, decode=False))
    per_forward("musicgen decode", [f for f in served if f[2] == "decode"],
                frontend_launches(cfg, decode=True))
    check_paths("musicgen", cfg, gemm_paths(), served)
    n_codes = MUSIC_STREAMS * k_books * MUSIC_DECODE
    print(f"  {MUSIC_STREAMS} streams x {MUSIC_FRAMES} prompt frames one-shot: "
          f"{t_pre * 1e3:.1f} ms; {MUSIC_DECODE} decode steps {t_dec * 1e3:.1f} ms "
          f"({MUSIC_STREAMS * MUSIC_DECODE / t_dec:.1f} frames/s, {n_codes / t_dec:.1f} codes/s;"
          f" host clock, first calls included); launches {launches}; stream 0's first frames "
          f"{frames[0, :, :4].tolist()}")
    full, _ = S.serve_forward(cfg, prep, codes)
    check(torch.equal(full, S.serve_forward(cfg, prep, codes, cache=S.init_cache(
        cfg, MUSIC_STREAMS, 1024, device="cuda"))[0]),
        "musicgen: the one-shot prefill's logits differ from the cache-less forward's")
    del full
    long_codes = torch.randint(0, cfg.vocab_size, (2, k_books, 512), generator=gen,
                               device="cuda", dtype=torch.int32)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = S.serve_forward(cfg, prep, long_codes)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(tuple(out.shape) == (2, k_books, 512, cfg.vocab_size)
          and bool(torch.isfinite(out).all()), f"musicgen (2, 4, 512): {tuple(out.shape)}")
    del out
    print(f"  cache-less (2, 4, 512): median {float(np.median(walls)) * 1e3:.2f} ms over 3 "
          "(host clock, the first included)")
    tok = frames[..., :1]
    profile_steps(torch, lambda: S.serve_forward(cfg, prep, tok, cache=cache, pos_offset=100,
                                                 mode="decode"),
                  "musicgen decode step (8 streams x 4 codebooks)")
    profile_steps(torch, lambda: S.serve_forward(cfg, prep, codes, cache=cache),
                  "musicgen one-shot prefill (8 x 64 frames)")
    hold_forward_shapes(torch, cfg, list(FORWARDS), 1024, guard, "musicgen")
    del prep, cache
    torch.cuda.empty_cache()
    return dict(launches=launches)


def phase_small_frontends(torch):
    """Small qwen2-vl (the published section proportions at head_dim 32,
    (4, 6, 6)) and small musicgen on the card (the kernels) and on the CPU
    (their plain versions, REPRO_TORCH_KERNELS=gpu) from the same folded
    weights: the cache-less forward, the one-shot stripe prefill and 6
    greedy decode steps (qwen2-vl: 16 image rows on a 4 x 4 grid before 8
    text tokens; musicgen: (2, 4, 12) codes, each head's argmax the next
    frame) and qwen2-vl's LockstepEngine must give equal greedy tokens; the
    logits that differ are counted."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import calibrated_folded
    from repro_torch.models import serve_int as S
    from repro_torch.models.transformer import tree_map
    from repro_torch.serve.engine import EngineConfig, Request, make_engine

    def run(cfg, folded, dev):
        rng = np.random.default_rng(SEED + 5)
        audio = cfg.frontend == "audio_codebooks"
        kw = {}
        if audio:
            prompt = rng.integers(0, cfg.vocab_size, (2, cfg.n_codebooks, 12))
        else:
            prompt = rng.integers(0, cfg.vocab_size, (2, 8))
            g = np.arange(16)
            pos3 = np.concatenate([np.stack([0 * g, g // 4, g % 4], -1),
                                   np.repeat(4 + np.arange(8)[:, None], 3, -1)])
            kw = dict(extra_embeds_i8=torch.as_tensor(
                rng.integers(-60, 61, (2, 16, cfg.d_model)).astype(np.int8), device=dev),
                pos3=torch.as_tensor(np.broadcast_to(pos3, (2, 24, 3)).astype(np.int32),
                                     device=dev))
        prompt = torch.as_tensor(prompt.astype(np.int32), device=dev)
        logits = [S.serve_forward(cfg, folded, prompt, **kw)[0]]
        lg, cache = S.serve_forward(cfg, folded, prompt, cache=S.init_cache(cfg, 2, 48,
                                                                             device=dev), **kw)
        logits.append(lg)
        toks, rows = [], lg.shape[-2]
        for step in range(6):
            toks.append(lg[..., -1, :].argmax(-1).to(torch.int32)[..., None])
            lg, cache = S.serve_forward(cfg, folded, toks[-1], cache=cache,
                                        pos_offset=rows + step, mode="decode")
            logits.append(lg)
        out = [t.cpu().tolist() for t in toks]
        if not audio:
            out.append([r.out.tolist() for r in make_engine(
                cfg, folded, EngineConfig(batch_slots=2, max_len=48)).generate(
                [Request(prompt=p, max_new_tokens=6)
                 for p in (np.arange(3, 12), np.arange(40, 45))])])
        return out, torch.cat([t.reshape(-1).cpu() for t in logits])

    prev = os.environ.get("REPRO_TORCH_KERNELS")
    os.environ["REPRO_TORCH_KERNELS"] = "gpu"
    try:
        for name, over in (("qwen2-vl-2b", dict(mrope_sections=(4, 6, 6))),
                           ("musicgen-medium", {})):
            cfg = smoke_config(name, **over)
            folded_cpu = calibrated_folded(cfg, SEED, device="cpu")
            on_card, a = run(cfg, tree_map(lambda t: t.to("cuda"), folded_cpu), "cuda")
            on_cpu, b = run(cfg, folded_cpu, "cpu")
            print(f"  small {name}, card vs CPU: greedy tokens equal {on_card == on_cpu}; "
                  f"{int((a != b).sum())} of {a.numel()} logits differ")
            check(bool(torch.isfinite(a).all()), f"small {name}: non-finite logits on the card")
            check(on_card == on_cpu, f"small {name}: the card's greedy tokens differ from the "
                  "CPU's")
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_KERNELS"]
        else:
            os.environ["REPRO_TORCH_KERNELS"] = prev


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
            check_paths(f"bert {name} ({b}, {s})", cfg, paths, FORWARDS)
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


TRAIN_BERT_STEPS = 60
TRAIN_BERT_SHAPE = (32, 128)
TRAIN_YI_DEPTH = 8          # of 32 layers
TRAIN_YI_SHAPE = (4, 1024)
TRAIN_YI_STEPS = 5
TRAIN_XLSTM_SHAPE = (2, 1024)
TRAIN_XLSTM_STEPS = 2         # 3 before [mesh]: cut to keep the script in its time


def _nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (a TrainState, nested dicts)."""
    from repro_torch.train.checkpoint import _paths

    return sum(t.numel() * t.element_size() for _, t in _paths(tree))


def check_checkpoint_roundtrip(torch, state, what: str):
    """Save ``state`` with ``train/checkpoint.py`` and restore it onto the
    card: every leaf must come back equal bit for bit."""
    import tempfile

    from repro_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, int(state.step), state, meta={"data_step": int(state.step)})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, meta = ckpt.restore(d, int(state.step), state)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    leaves, got = ckpt._paths(state), ckpt._paths(back)
    differ = [p for (p, a), (_, b) in zip(leaves, got, strict=True)
              if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b)]
    print(f"  {what} checkpoint: {len(leaves)} leaves, {_nbytes(state) / 2**20:.1f} MiB, "
          f"save {t_save:.2f} s, restore {t_load:.2f} s, {len(differ)} leaves differ")
    check(not differ and meta["data_step"] == int(state.step),
          f"{what}: the checkpoint round trip changed {differ[:5]}")


def train_bert(torch, kernels, guard):
    """BERT-base at full size under POLICY_FQ: the paper's fine-tuning step
    on the synthetic SST-2 task, its checkpoint, the fold of the trained
    backbone with the trained EMA amax, and the integer forward through
    rows 1, 2 and 5, equal to the plain versions on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import POLICY_FP32
    from repro_torch.launch import train_bert_sst2 as SST
    from repro_torch.models import bert as B
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as St

    cfg = get_config("bert-base")
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.remat) == (12, 768, 30522, True),
          "bert-base is not full size")
    b, s = TRAIN_BERT_SHAPE
    opt = AdamWConfig(lr=1e-3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    state = St.init_bert_train_state(cfg, gen, opt)
    step = St.make_bert_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(TRAIN_BERT_STEPS):
        batch = SST.to_device(SST.make_batch(cfg.vocab_size, i, b, s), "cuda")
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, acc = float(m["loss"]), float(m["acc"])    # waits for the card
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if i % 10 == 0 or i == TRAIN_BERT_STEPS - 1:
            print(f"  bert-base step {i:3d}: loss {loss:.4f} acc {acc:.3f} "
                  f"({walls[-1] * 1e3:.1f} ms)")
    ms = float(np.median(walls[1:])) * 1e3
    print(f"  bert-base ({b}, {s}) QAT step: median {ms:.1f} ms ({b * s / ms * 1e3:.0f} tokens/s, "
          f"first step {walls[0] * 1e3:.0f} ms), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"  bert-base mean loss: first 10 steps {first:.4f}, last 10 {last:.4f}")
    check(all(np.isfinite(losses)), f"bert-base: a loss is not finite: {losses}")
    check(last < first, f"bert-base: the loss did not fall ({first:.4f} -> {last:.4f})")
    batch = SST.to_device(SST.make_batch(cfg.vocab_size, TRAIN_BERT_STEPS, b, s), "cuda")
    profile_steps(torch, lambda: step(state, batch), "bert-base QAT train step", n=1)
    check_checkpoint_roundtrip(torch, state, "bert-base")

    # held-out accuracy of the QAT forward beside the fp32 policy (paper
    # Table I; printed, not gated)
    accs = {"FQ (QAT)": [], "fp32 policy": []}
    with torch.no_grad():
        for i in range(1000, 1010):
            batch = SST.to_device(SST.make_batch(cfg.vocab_size, i, b, s), "cuda")
            for name, c in (("FQ (QAT)", cfg), ("fp32 policy", dataclasses.replace(
                    cfg, quant=POLICY_FP32))):
                lg, _, _ = B.bert_classify(c, state.params, state.amax, batch["tokens"],
                                           batch["mask"])
                accs[name].append(float((lg.argmax(-1) == batch["labels"]).float().mean()))
    print("  bert-base held-out accuracy (10 batches): "
          + ", ".join(f"{k} {np.mean(v):.3f}" for k, v in accs.items()))

    out = serve_trained_bert(torch, cfg, state, kernels, guard, ((1, 128), (8, 512)),
                             "trained bert-base")
    del state
    torch.cuda.empty_cache()
    return out


def serve_trained_bert(torch, cfg, state, kernels, guard, shapes, what):
    """The trained backbone of ``state``, folded with its trained EMA amax
    and served as integers at each (B, S) of ``shapes``: every forward's
    launches of rows 1, 2 and 5 (``kernels``) as ``BERT_LAUNCHES`` says, no
    plain version on the card, and logits equal to the plain versions'.
    Returns the first shape's launches."""
    from repro_torch.models import fold as F
    from repro_torch.models import serve_int as S

    amax = {k: state.amax[k] for k in ("blocks", "embed_out", "head_in")}
    folded = S.prepare_folded(cfg, F.fold_params(cfg, state.params["backbone"], amax))
    rng = np.random.default_rng(SEED + 1)
    want = {"quant_softmax": BERT_LAUNCHES["quant_softmax"], "int4_matmul": BERT_LAUNCHES["gemm"],
            "quant_layernorm": BERT_LAUNCHES["quant_layernorm"]}
    out = {}
    for fb, fs in shapes:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (fb, fs)).astype(np.int32),
                               device="cuda")
        before = dict(guard.n)
        logits, launches = bert_forward_once(torch, S, cfg, folded, toks, kernels)
        # BERT's bidirectional rows are the ref datapath's materialized
        # attention by design (its products have no TPU kernel); no plain
        # version of a kernel may run
        plain = {k: n - before[k] for k, n in guard.n.items() if n != before[k]}
        check(set(plain) <= {"_attn_rows_q8"},
              f"{what} ({fb}, {fs}): plain versions ran on the card: {plain}")
        check(launches == want, f"{what} ({fb}, {fs}): launches {launches} != {want}")
        check_paths(f"{what} ({fb}, {fs})", cfg, gemm_paths("int4_matmul"), FORWARDS)
        with guard.paused():
            os.environ["REPRO_TORCH_KERNELS"] = "ref"
            try:
                plain, _ = S.serve_forward(cfg, folded, toks)
            finally:
                del os.environ["REPRO_TORCH_KERNELS"]
        torch.cuda.synchronize()
        differ = int((logits != plain).sum())
        print(f"  {what} integer forward ({fb}, {fs}): launches {launches}, "
              f"finite {bool(torch.isfinite(logits).all())}, {differ} of {logits.numel()} "
              "logits differ from the plain versions' on the card")
        check(bool(torch.isfinite(logits).all()) and differ == 0,
              f"{what} ({fb}, {fs}): the kernels' logits differ from the plain versions'")
        if not out:
            out = launches
    del folded
    torch.cuda.empty_cache()
    return out


def train_yi6b(torch):
    """yi-6b at its published widths and TRAIN_YI_DEPTH of 32 layers: bf16
    params, float32 moments, remat, TRAIN_YI_STEPS steps of
    ``make_train_step`` on one SyntheticLM batch, profiled."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, apply_updates
    from repro_torch.train import steps as St

    cfg = get_config("yi-6b")
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
           cfg.param_dtype, cfg.remat) == (4096, 32, 4, 128, 11008, 64000, "bfloat16", True),
          "yi-6b is not at its published widths")
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_YI_DEPTH)
    b, s = TRAIN_YI_SHAPE
    opt = AdamWConfig(lr=3e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    state = St.init_train_state(cfg, gen, opt)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    big = max(tree_leaves(state.params["blocks"]), key=lambda t: t.numel())
    print(f"  yi-6b ({cfg.n_layers} layers): {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s; reckoned: params {_nbytes(state.params) / 2**30:.2f}"
          f" GiB bf16 + gradients as much + moments {_nbytes(state.opt) / 2**30:.2f} GiB float32 "
          f"= {(2 * _nbytes(state.params) + _nbytes(state.opt)) / 2**30:.2f} GiB; the largest "
          f"stacked leaf {tuple(big.shape)} updated one layer at a time "
          f"({big[0].numel() * 4 / 2**20:.0f} MiB a float32 temporary, "
          f"{big.numel() * 4 / 2**30:.2f} GiB for the whole leaf); the lm_head's "
          f"({b}, {s}, {cfg.vocab_size}) float32 logits {b * s * cfg.vocab_size * 4 / 2**30:.2f} "
          "GiB")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in SyntheticLM(cfg.vocab_size, s, b, seed=SEED).batch_at(0).items()}
    step = St.make_train_step(cfg, opt)
    losses, gns, walls = [], [], []
    for i in range(TRAIN_YI_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        gns.append(gn)
        print(f"  yi-6b step {i}: loss {loss:.4f} grad norm {gn:.4f} ({walls[-1] * 1e3:.0f} ms)")
    ms = float(np.median(walls[1:])) * 1e3
    print(f"  yi-6b ({b}, {s}) QAT step: median {ms:.0f} ms, {b * s / ms * 1e3:.0f} tokens/s "
          f"(first step {walls[0] * 1e3:.0f} ms), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    check(all(np.isfinite(losses)) and all(np.isfinite(gns)),
          f"yi-6b: a loss or grad norm is not finite: {losses} {gns}")
    check(losses[-1] < losses[0], f"yi-6b: the loss did not fall ({losses})")
    profile_steps(torch, lambda: step(state, batch), "yi-6b QAT train step", n=1)
    _, _, grads = St.lm_loss_and_grads(cfg, state.params, state.amax, batch)
    profile_steps(torch, lambda: apply_updates(state.params, grads, state.opt, opt),
                  "of which the AdamW update alone", n=1)
    del state, grads
    torch.cuda.empty_cache()
    return {"ms": ms, "losses": losses, "gns": gns}


def slstm_loop_ms(torch, cfg, params, s: int):
    """One sLSTM layer's loop at the step's shapes, on the trained slot-0
    recurrent matrix: wall and device ms of a forward, its recomputation
    and the backward (what a remat step runs per sLSTM layer)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import xlstm as Xl

    b, d = TRAIN_XLSTM_SHAPE[0], cfg.d_model
    r = params["blocks"]["slot0"]["mixer"]["r"][0].to(torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    gates = [torch.randn((b, s, d), generator=gen, device="cuda").requires_grad_(True)
             for _ in range(4)]

    def run():
        with torch.no_grad():
            Xl.slstm_scan(*gates, r, cfg.n_heads)          # the recomputation's twin
        hs, _ = Xl.slstm_scan(*gates, r, cfg.n_heads)
        hs.sum().backward()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = sum(us for us, _, _ in device_rows(torch, prof)) / 1e3
    return wall, busy


def train_xlstm(torch):
    """xlstm-1.3b at its full published size: bf16 params, float32 moments,
    remat, TRAIN_XLSTM_STEPS steps of ``make_train_step`` on one SyntheticLM
    batch at TRAIN_XLSTM_SHAPE, a step profiled and the sLSTM loop's share
    of it."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps as St

    cfg = get_config("xlstm-1.3b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.pattern, cfg.vocab_size, cfg.param_dtype,
           cfg.remat) == (48, 2048, 4, ("s",) + ("x",) * 7, 50304, "bfloat16", True),
          "xlstm-1.3b is not at its full published size")
    b, s = TRAIN_XLSTM_SHAPE
    opt = AdamWConfig(lr=3e-4)
    check(not opt.quantize_moments, "xlstm-1.3b: the moments must be float32")
    gc.collect()                 # an earlier phase's state held only by reference cycles
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"  before xlstm-1.3b's init: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    state = St.init_train_state(cfg, gen, opt)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"  xlstm-1.3b ({cfg.n_layers} layers): {n_params / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.1f} s; reckoned: params {_nbytes(state.params) / 2**30:.2f}"
          f" GiB bf16 + gradients as much + moments {_nbytes(state.opt) / 2**30:.2f} GiB float32 "
          f"= {(2 * _nbytes(state.params) + _nbytes(state.opt)) / 2**30:.2f} GiB; the lm_head's "
          f"({b}, {s}, {cfg.vocab_size}) float32 logits {b * s * cfg.vocab_size * 4 / 2**30:.2f} "
          "GiB")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in SyntheticLM(cfg.vocab_size, s, b, seed=SEED).batch_at(0).items()}
    step = St.make_train_step(cfg, opt)
    losses, gns, walls = [], [], []
    for i in range(TRAIN_XLSTM_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        gns.append(gn)
        print(f"  xlstm-1.3b step {i}: loss {loss:.4f} grad norm {gn:.4f} "
              f"({walls[-1] * 1e3:.0f} ms)")
    ms = float(np.median(walls)) * 1e3
    print(f"  xlstm-1.3b ({b}, {s}) QAT step: median {ms:.0f} ms, {b * s / ms * 1e3:.0f} "
          f"tokens/s (first step {walls[0] * 1e3:.0f} ms), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    check(all(np.isfinite(losses)) and all(np.isfinite(gns)),
          f"xlstm-1.3b: a loss or grad norm is not finite: {losses} {gns}")
    check(losses[-1] < losses[0], f"xlstm-1.3b: the loss did not fall ({losses})")
    wall, busy = slstm_loop_ms(torch, cfg, state.params, s)
    n_s = cfg.n_reps * cfg.pattern.count("s")
    print(f"  one sLSTM layer's loop over {s} steps (forward, recompute, backward): "
          f"{wall:.0f} ms wall, {busy:.1f} ms device; x {n_s} layers = {n_s * wall:.0f} ms "
          f"wall ({100 * n_s * wall / ms:.1f} % of the median step)")
    profile_steps(torch, lambda: step(state, batch), "xlstm-1.3b QAT train step", n=1,
                  wall_ms=ms)
    del state
    torch.cuda.empty_cache()
    return {"ms": ms, "losses": losses, "slstm_ms": n_s * wall}


def phase_sst2(torch):
    """The paper's Table I experiment as the port's example runs it
    (``launch/train_bert_sst2.py`` at its defaults: d_model 128, 2 layers,
    150 QAT steps at (16, 32), lr 1e-3) on the card: every 25th step's loss
    and accuracy, the held-out accuracy under FQ and fp32 execution (printed,
    not gated: the card's float products differ from the CPU's), the wall
    time; every loss must be finite."""
    from repro_torch.launch import train_bert_sst2 as SST

    t0 = time.perf_counter()
    _, history, accs = SST.main([])          # prints the example's own lines
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [loss for loss, _ in history]
    print(f"  {len(history)} steps and the held-out evaluation in {wall:.1f} s "
          f"({wall / len(history) * 1e3:.1f} ms a step with the evaluation)")
    check(all(np.isfinite(losses)), f"sst2: a loss is not finite: {losses}")
    return dict(accs, wall_s=wall, loss_first=losses[0], loss_last=losses[-1])


MESH_RANKS = 4
MESH_BERT_STEPS = 3
MESH_YI_STEPS = 2
# bounds written before [mesh] first ran on the card (PERF.md §6)
MESH_LOSS_RTOL = 1e-3      # yi-6b's first (4, 1) loss against [train]'s unsharded one
# the (4, 1) steps against ``blocked_step`` on the same row blocks (the
# tests' EXACT): losses and grad norms relative; the moments' leaves within
# this much of each leaf's largest element; BERT's final params within
# MESH_PARAM_LRS x lr (a hundredth of the most one AdamW step can move one)
MESH_RTOL = 1e-5
MESH_PARAM_LRS = 1e-2
# yi-6b's second loss and first grad norm against [train]'s (its ranks'
# bf16 gradients are rounded one rank at a time, then summed)
MESH_TRAIN_RTOL = 1e-2


def rank_bytes(shards) -> list:
    """Each rank's bytes of its shards."""
    from repro_torch.sharding import partition as Pt

    return [sum(t.numel() * t.element_size() for _, t in Pt.tree_paths(s)) for s in shards]


def leaves_differ(torch, a, b) -> list:
    from repro_torch.sharding import partition as Pt

    pa, pb = Pt.tree_paths(a, sort_keys=True), Pt.tree_paths(b, sort_keys=True)
    return [p for (p, x), (_, y) in zip(pa, pb, strict=True)
            if x.dtype != y.dtype or not torch.equal(x, y)]


def _filled(torch, amax, obs):
    """``amax`` with its zero sites set to ``obs``'s, as the sharded step
    fills them."""
    from repro_torch.sharding import partition as Pt

    a, o = Pt.tree_paths(amax, sort_keys=True), Pt.tree_paths(obs, sort_keys=True)
    return Pt.tree_rebuild(amax, [torch.where(x > 0, x, y) for (_, x), (_, y) in zip(a, o)],
                           sort_keys=True)


def rows_island(torch, logits_fn, amax, batch, rows: int, dense=None) -> str:
    """The float island a data rank meets: the first ``rows`` rows computed
    alone against the same rows inside the whole batch, at the amax the
    batch's zero sites take (its observed max), no gradient.  Every
    activation fake-quant site (``layers.fake_quant_act``) of the two
    forwards is compared in call order: the first site whose input differs,
    whether every site before it agreed in input and codes, how many of its
    codes flip, how many sites end with flipped codes, and how many still
    quantize with their own rows' max (an amax of 0 after the fill).
    ``dense(x)``, the first layer's first projection, is run on the first
    site's output for the whole batch and for the first ``rows`` alone: one
    product at two row counts, the same operands."""
    from repro_torch.models import layers as L

    orig = L.fake_quant_act
    part_sites, stats, own_max = [], [], [0]

    def on_part(x, a, bits, enabled):
        y, ob = orig(x, a, bits, enabled)
        part_sites.append((x, y))
        own_max[0] += int(bool((a == 0).any()))
        return y, ob

    def on_full(x, a, bits, enabled):
        y, ob = orig(x, a, bits, enabled)
        px, py = part_sites[len(stats)]
        fx, fy = x[:rows], y[:rows]
        dx = int((fx != px).sum())
        rel = float((fx.float() - px.float()).abs().max() / fx.float().abs().max().clamp(min=1e-30))
        stats.append((tuple(x.shape), dx, rel, int((fy != py).sum()), px.numel(),
                      y if not stats else None))
        return y, ob

    part_batch = {k: v[:rows] for k, v in batch.items()}
    with torch.no_grad():
        _, obs, _ = logits_fn(amax, batch)
        filled = _filled(torch, amax, obs)
        try:
            L.fake_quant_act = on_part
            part, _, _ = logits_fn(filled, part_batch)
            L.fake_quant_act = on_full
            full, _, _ = logits_fn(filled, batch)
        finally:
            L.fake_quant_act = orig
        probe = ""
        if dense is not None:
            x0 = stats[0][5]
            yf, yp = dense(x0)[:rows], dense(x0[:rows])
            probe = (f"; the first projection of site 0's output at {x0[:rows].numel() // x0.shape[-1]}"
                     f" rows against {x0.numel() // x0.shape[-1]}: {int((yf != yp).sum())} of "
                     f"{yp.numel()} outputs differ, max |diff| "
                     f"{float((yf.float() - yp.float()).abs().max()):.3g}")
    full = full[:rows].float()
    differ = int((full != part.float()).sum())
    rel = float((full - part.float()).abs().max() / full.abs().max())
    first = next((i for i, st in enumerate(stats) if st[1]), None)
    where = "no site's input differs" if first is None else (
        f"the first site whose input differs is #{first} of {len(stats)}, {stats[first][0]}: "
        f"{stats[first][1]} of {stats[first][4]} inputs differ, max |diff| "
        f"{stats[first][2]:.3g} of its largest; sites before it equal in input and codes: "
        f"{all(st[1] == 0 and st[3] == 0 for st in stats[:first])}; codes flipped there "
        f"{stats[first][3]}")
    return (f"{differ} of {part.numel()} logits of rows 0-{rows - 1} differ between a "
            f"{rows}-row forward and the whole batch's, max |diff| {rel:.3g} of the largest; "
            f"{where}; sites with flipped codes {sum(1 for st in stats if st[3])} of "
            f"{len(stats)}; sites quantizing with their own rows' max {own_max[0]}" + probe)


def blocked_step(torch, cfg, opt, state, batch, n: int, bert: bool = False):
    """The sharded step's math without its sharding, on the unsharded
    ``state``, for ``n`` data ranks: while an amax is 0, the whole batch's
    observed max at those sites (one no-grad forward); the loss's gradient
    on each of the ``n`` row blocks at the unsharded params, summed in
    float32 in block order and divided by ``n``; the blocks' losses likewise;
    the observations' max; then the unsharded step's AdamW and EMA.  For a
    MoE arch the blocks run as the ``n`` data ranks of one
    ``collectives.DataRanks``, a thread each (``steps._meeting``), so every
    MoE layer routes the whole batch through ``moe.route`` and ``moe.plan``
    with every block's counts, as the sharded step does.  What
    ``jit_train_step`` computes on an (n, 1) mesh, less its gathers, reduce
    and scatters.  Returns (state, {"loss", "grad_norm", "aux"})."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import collectives as C
    from repro_torch.train import steps as St

    loss_fn = St.bert_loss if bert else St.lm_loss
    amax = state.amax
    if any(bool((t == 0).any()) for t in T.tree_leaves(amax)):
        with torch.no_grad():
            _, aux = loss_fn(cfg, state.params, amax, batch)
        amax = _filled(torch, amax, aux["obs"])
    b = next(iter(batch.values())).shape[0]
    passes = [functools.partial(
        St.value_and_grad, lambda p, r={key: v[k * b // n:(k + 1) * b // n]
                                        for key, v in batch.items()}: loss_fn(cfg, p, amax, r),
        state.params) for k in range(n)]
    gsum, loss, obs, aux_sum = None, None, [], 0.0
    for lk, aux, g in (St._meeting(passes) if cfg.n_experts and not bert
                       else (f() for f in passes)):
        if gsum is None:
            gsum = T.tree_map(lambda t: t.to(torch.float32, copy=True), g)
        else:
            for s_, t in zip(T.tree_leaves(gsum), T.tree_leaves(g), strict=True):
                s_.add_(t.to(torch.float32))
        loss = lk if loss is None else loss + lk
        obs.append(aux["obs"])
        aux_sum = aux_sum + aux.get("aux", 0.0)
        del g
    for t in T.tree_leaves(gsum):
        t.div_(n)
    new, gn = St._finish(cfg, opt, 0.99, state, gsum, C.max_over_ranks(obs))
    return new, {"loss": loss / n, "grad_norm": gn, "aux": aux_sum / n}


def _of_largest(gap: float, largest: float) -> float:
    """``gap`` as a share of ``largest`` (an all-zero leaf: 0 if equal)."""
    return gap / largest if largest > 0 else (0.0 if gap == 0 else float("inf"))


def leaf_gaps(torch, a, b) -> dict:
    """{path: (max |a - b|, max |b|)} of two trees' leaves, in float64."""
    from repro_torch.sharding import partition as Pt

    return {p: (float((x.double() - y.double()).abs().max()), float(y.double().abs().max()))
            for (p, x), (_, y) in zip(Pt.tree_paths(a, sort_keys=True),
                                      Pt.tree_paths(b, sort_keys=True), strict=True)}


@contextlib.contextmanager
def collective_spans(torch):
    """Device time of each collective call of the sharded step, by CUDA
    events recorded around it on the current stream; yields {name: ms}
    filled in when the block ends (after a synchronise)."""
    from repro_torch.sharding import collectives as C

    names = ("all_gather", "reduce_scatter_add", "scatter")
    originals = {n: getattr(C, n) for n in names}
    spans, out = [], {}

    def timed(name, fn):
        def call(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **k)
            e1.record()
            spans.append((name, e0, e1))
            return r
        return call

    for n in names:
        setattr(C, n, timed(n, originals[n]))
    try:
        yield out
    finally:
        for n in names:
            setattr(C, n, originals[n])
        torch.cuda.synchronize()
        for name, e0, e1 in spans:
            out[name] = out.get(name, 0.0) + e0.elapsed_time(e1)


def timed_step(torch, step, shards, batch):
    t0 = time.perf_counter()
    shards, m = step(shards, batch)
    metrics = {k: float(v) for k, v in m.items()}      # waits for the card
    return shards, metrics, (time.perf_counter() - t0) * 1e3


def mesh_bert(torch, smi, cfg=None, dev="cuda", shape=TRAIN_BERT_SHAPE):
    """BERT-base on (1, 1) and (4, 1) against the unsharded step, the shard
    bytes, and the elastic resize through a checkpoint."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import ranks as R
    from repro_torch.launch import train_bert_sst2 as SST
    from repro_torch.launch.elastic_resume import data_mesh
    from repro_torch.launch.dryrun import rank_bytes as rank_bytes_of_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import partition as Pt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps as St

    if cfg is None:
        cfg = get_config("bert-base")
        check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (12, 768, 30522),
              "bert-base is not full size")
    b, s = shape
    opt = AdamWConfig(lr=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state0 = St.init_bert_train_state(cfg, gen, opt)
    batches = [SST.to_device(SST.make_batch(cfg.vocab_size, i, b, s), dev)
               for i in range(MESH_BERT_STEPS)]
    plain = St.make_bert_train_step(cfg, opt)
    want, want_losses, plain_ms = state0, [], []
    for bt in batches:
        t0 = time.perf_counter()
        want, m = plain(want, bt)
        want_losses.append(float(m["loss"]))
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    m11 = data_mesh(dev, 1)
    step11, sh11, _ = St.jit_train_step(cfg, m11, opt, batches[0], bert=True, donate=False)
    shards, losses11, ms11, after2 = Pt.split_tree(state0, sh11), [], [], None
    for i, bt in enumerate(batches):
        shards, m, ms = timed_step(torch, step11, shards, bt)
        losses11.append(m["loss"])
        ms11.append(ms)
        if i == 1:
            after2 = shards
    differ = leaves_differ(torch, shards[0], want)
    print(f"  [{smi}] bert-base (1, 1) mesh, {MESH_BERT_STEPS} steps: losses {losses11} "
          f"(unsharded {want_losses}); {len(differ)} leaves differ from the unsharded state; "
          f"ms a step {[round(x, 1) for x in ms11]} (unsharded {[round(x, 1) for x in plain_ms]})")
    check(not differ and losses11 == want_losses,
          f"bert-base: the (1, 1) mesh differs from the unsharded step at {differ[:5]}")

    from repro_torch.models import bert as B

    wq0 = state0.params["backbone"]["blocks"]["slot0"]["attn"]["wq"][0]
    print(f"  [{smi}] bert-base rows' float island at step 0: " + rows_island(
        torch, lambda a, bt: B.bert_classify(cfg, state0.params, a, bt["tokens"], bt["mask"]),
        state0.amax, batches[0], b // MESH_RANKS, dense=lambda x: x @ wq0))
    m41 = data_mesh(dev, MESH_RANKS)
    step41, sh41, _ = St.jit_train_step(cfg, m41, opt, batches[0], bert=True, fsdp=True)
    shards = Pt.split_tree(state0, sh41)
    got, reckoned = rank_bytes(shards), rank_bytes_of_specs(state0, sh41)
    print(f"  [{smi}] bert-base (4, 1) shard bytes a rank {got}, reckoned from the specs "
          f"{reckoned}; unsharded {rank_bytes([state0])[0]}")
    check(all(n == reckoned for n in got), f"bert-base: shard bytes {got} != {reckoned}")
    met41, ms41, after1 = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, bt in enumerate(batches):
        shards, m, ms = timed_step(torch, step41, shards, bt)
        met41.append(m)
        ms41.append(ms)
        if i == 0:
            after1 = Pt.gather_tree(shards, sh41)
    peak41 = torch.cuda.max_memory_allocated()
    digests41 = [R.digest(x) for x in shards]
    new = Pt.gather_tree(shards, sh41)
    del shards
    # the same steps on the same 8-row blocks without the sharding
    ref, met_ref, ref1 = state0, [], None
    for i, bt in enumerate(batches):
        ref, m = blocked_step(torch, cfg, opt, ref, bt, MESH_RANKS, bert=True)
        met_ref.append({k: float(v) for k, v in m.items()})
        if i == 0:
            ref1 = ref
    rel = {k: [abs(x[k] - w[k]) / abs(w[k]) for x, w in zip(met41, met_ref)]
           for k in ("loss", "grad_norm")}
    grad1 = max(_of_largest(*g) for g in leaf_gaps(torch, after1.opt["m"], ref1.opt["m"]).values())
    moments = max(_of_largest(*g) for g in leaf_gaps(torch, new.opt, ref.opt).values())
    dp = max(d for d, _ in leaf_gaps(torch, new.params, ref.params).values())
    same = len(leaves_differ(torch, new, ref))
    print(f"  [{smi}] bert-base (4, 1) mesh, {MESH_BERT_STEPS} steps against the same steps on "
          f"the same {b // MESH_RANKS}-row blocks unsharded: losses {[x['loss'] for x in met41]}"
          f" (blocks {[w['loss'] for w in met_ref]}), grad norms "
          f"{[x['grad_norm'] for x in met41]} (blocks {[w['grad_norm'] for w in met_ref]}); "
          f"relative {rel} (bound {MESH_RTOL}); step 1's gradient (m / (1 - b1)) {grad1:.3g} of "
          f"each leaf's largest, the final moments {moments:.3g} (bound {MESH_RTOL}); the final "
          f"params max |diff| {dp / opt.lr:.3g} x lr (bound {MESH_PARAM_LRS} x lr); {same} "
          f"leaves of the final state differ; ms a step {[round(x, 1) for x in ms41]}")
    check(max(max(v) for v in rel.values()) <= MESH_RTOL and grad1 <= MESH_RTOL
          and moments <= MESH_RTOL and dp <= MESH_PARAM_LRS * opt.lr,
          f"bert-base: the (4, 1) mesh left its bounds against the unsharded blocks ({rel}, "
          f"gradient {grad1}, moments {moments}, params {dp / opt.lr} lr)")
    # the 32-row unsharded step holds other float sums (rows_island): printed
    rel32 = [abs(x["loss"] - w) / abs(w) for x, w in zip(met41, want_losses)]
    far = sum(int(((x.double() - y.double()).abs() > 0.1 * opt.lr).sum()) for (_, x), (_, y) in
              zip(Pt.tree_paths(new.params, sort_keys=True),
                  Pt.tree_paths(want.params, sort_keys=True)))
    d32 = max(d for d, _ in leaf_gaps(torch, new.params, want.params).values())
    n_params = sum(t.numel() for _, t in Pt.tree_paths(want.params))
    print(f"  [{smi}] bert-base (4, 1) against the 32-row unsharded step (not gated): losses "
          f"relative {[f'{r:.3g}' for r in rel32]}, final params max |diff| {d32 / opt.lr:.3g} x "
          f"lr, {far} of {n_params} beyond 0.1 lr")
    del after1, ref1, ref, new

    # elastic resize: (1, 1) after 2 steps -> checkpoint -> (4, 1) -> 1 step
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, 2, after2, meta={"data_step": 2}, shardings=sh11)
        restored, meta = ckpt.restore(d, 2, St.state_shape(cfg, opt, bert=True), shardings=sh41)
        io_s = time.perf_counter() - t0
    saved_differ = leaves_differ(torch, Pt.gather_tree(restored, sh41), after2[0])
    in_memory = Pt.split_tree(after2[0], sh41)
    a, ma, _ = timed_step(torch, step41, restored, batches[2])
    c, mc, _ = timed_step(torch, step41, in_memory, batches[2])
    differ = [p for r in range(MESH_RANKS) for p in leaves_differ(torch, a[r], c[r])]
    print(f"  [{smi}] bert-base elastic resize (1, 1) -> checkpoint -> (4, 1): save + restore "
          f"{io_s:.2f} s, {len(saved_differ)} restored leaves differ from the saved ones; step "
          f"3 loss {ma['loss']} against {mc['loss']} re-split in memory, {len(differ)} rank "
          "leaves differ")
    check(meta["data_step"] == 2 and not saved_differ and not differ
          and ma["loss"] == mc["loss"], "bert-base: the elastic resize differs from the "
          f"in-memory re-split ({saved_differ[:3]}, {differ[:3]})")
    return {"ms_11": float(np.median(ms11)), "ms_41": float(np.median(ms41)),
            "ms_plain": float(np.median(plain_ms)), "rel": rel, "ms": ms41, "metrics": met41,
            "digests": digests41, "peak_gib": peak41 / 2**30}


def mesh_yi6b(torch, smi, trained, cfg=None, dev="cuda", shape=TRAIN_YI_SHAPE):
    """yi-6b at [train]'s depth, shape and seed on (4, 1) with FSDP, against
    ``blocked_step`` on the same row blocks and against [train]'s unsharded
    steps (``trained``: its losses, grad norms and median ms)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.dryrun import rank_bytes as rank_bytes_of_specs
    from repro_torch.launch.elastic_resume import data_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import partition as Pt
    from repro_torch.train import steps as St

    if cfg is None:
        cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_YI_DEPTH)
        check((cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.param_dtype, cfg.remat)
              == (4096, 11008, 64000, "bfloat16", True), "yi-6b is not at its published widths")
    b, s = shape
    opt = AdamWConfig(lr=3e-4)
    gc.collect()
    torch.cuda.empty_cache()

    def init():
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return St.init_train_state(cfg, gen, opt)

    state = init()
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(cfg.vocab_size, s, b, seed=SEED).batch_at(0).items()}
    wq0 = state.params["blocks"]["slot0"]["attn"]["wq"][0]
    print(f"  [{smi}] yi-6b rows' float island at step 0: " + rows_island(
        torch, lambda a, bt: T.forward(cfg, state.params, a, bt["tokens"]), state.amax, batch,
        b // MESH_RANKS, dense=lambda x: x @ wq0))
    mesh = data_mesh(dev, MESH_RANKS)
    step, sh, _ = St.jit_train_step(cfg, mesh, opt, batch, fsdp=True)
    params_b, opt_b = rank_bytes([state.params])[0], rank_bytes([state.opt])[0]
    want = {"params": rank_bytes_of_specs(state.params, sh.params),
            "moments": rank_bytes_of_specs(state.opt, sh.opt),
            "all": rank_bytes_of_specs(state, sh)}
    shards = Pt.split_tree(state, sh)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    got = {"params": rank_bytes([x.params for x in shards]),
           "moments": rank_bytes([x.opt for x in shards]), "all": rank_bytes(shards)}
    n_params = params_b // 2
    # the peak reckoned before the run: the shards, one gathered bf16 copy of
    # the params, one rank's bf16 gradients, the float32 reduce buffers (the
    # owners' blocks: one float32 copy of the params in all), and batch-1
    # activations with remat (the (1, S, V) float32 logits and their
    # gradient, the recomputed layer's)
    act = 2 * s * cfg.vocab_size * 4 + 16 * s * cfg.d_ff * 2
    reckoned_peak = sum(got["all"]) + 2 * params_b + 4 * n_params + act
    print(f"  [{smi}] yi-6b ({cfg.n_layers} layers) on (4, 1), FSDP: params {params_b / 2**30:.2f}"
          f" GiB bf16 + moments {opt_b / 2**30:.2f} GiB unsharded; a rank holds params "
          f"{[round(x / 2**30, 3) for x in got['params']]} GiB, moments "
          f"{[round(x / 2**30, 3) for x in got['moments']]} GiB (specs: {want['params'] / 2**30:.3f}"
          f" and {want['moments'] / 2**30:.3f}); peak reckoned {reckoned_peak / 2**30:.2f} GiB")
    check(all(x == want[k] for k in want for x in got[k]),
          f"yi-6b: shard bytes {got} differ from the specs' {want}")
    torch.cuda.reset_peak_memory_stats()
    mets, walls, spans = [], [], []
    for _ in range(MESH_YI_STEPS):
        with collective_spans(torch) as sp:
            shards, m, ms = timed_step(torch, step, shards, batch)
        mets.append(m)
        walls.append(ms)
        spans.append(sp)
        print(f"  [{smi}] yi-6b (4, 1) step: loss {m['loss']:.6f} grad norm {m['grad_norm']:.4f}"
              f" ({ms:.0f} ms; collectives' device ms " + ", ".join(
                  f"{k} {v:.1f}" for k, v in sp.items()) + ")")
    peak = torch.cuda.max_memory_allocated()
    profile_steps(torch, lambda: step(shards, batch), f"[{smi}] yi-6b (4, 1) mesh train step",
                  n=1, wall_ms=walls[-1])
    del shards
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps on the same 1-row blocks without the sharding
    state, met_ref = init(), []
    for _ in range(MESH_YI_STEPS):
        state, m = blocked_step(torch, cfg, opt, state, batch, MESH_RANKS)
        met_ref.append({k: float(v) for k, v in m.items()})
    del state
    gc.collect()
    torch.cuda.empty_cache()
    rel = {k: [abs(x[k] - w[k]) / abs(w[k]) for x, w in zip(mets, met_ref)]
           for k in ("loss", "grad_norm")}
    print(f"  [{smi}] yi-6b (4, 1) against the same steps on the same {b // MESH_RANKS}-row "
          f"blocks unsharded: losses {[x['loss'] for x in mets]} (blocks "
          f"{[w['loss'] for w in met_ref]}), grad norms {[x['grad_norm'] for x in mets]} (blocks "
          f"{[w['grad_norm'] for w in met_ref]}), relative {rel} (bound {MESH_RTOL})")
    tl, tg = trained["losses"], trained["gns"]
    rel_t = {"loss 0": abs(mets[0]["loss"] - tl[0]) / abs(tl[0]),
             "loss 1": abs(mets[1]["loss"] - tl[1]) / abs(tl[1]),
             "grad norm 0": abs(mets[0]["grad_norm"] - tg[0]) / abs(tg[0]),
             "grad norm 1 (not gated)": abs(mets[1]["grad_norm"] - tg[1]) / abs(tg[1])}
    print(f"  [{smi}] yi-6b (4, 1) against [train]'s unsharded steps (losses {tl[:2]}, grad norms "
          f"{tg[:2]}): relative " + ", ".join(f"{k} {v:.3g}" for k, v in rel_t.items())
          + f" (bounds: loss 0 {MESH_LOSS_RTOL}, loss 1 and grad norm 0 {MESH_TRAIN_RTOL}); ms a "
          f"step {[round(w) for w in walls]} against [train]'s median {trained['ms']:.0f}; peak "
          f"{peak / 2**30:.2f} GiB allocated (reckoned {reckoned_peak / 2**30:.2f})")
    check(all(np.isfinite([x[k] for x in mets for k in ("loss", "grad_norm")])),
          f"yi-6b: a (4, 1) loss or grad norm is not finite: {mets}")
    check(max(max(v) for v in rel.values()) <= MESH_RTOL,
          f"yi-6b: the (4, 1) mesh left {MESH_RTOL} of the unsharded blocks' steps: {rel}")
    check(rel_t["loss 0"] <= MESH_LOSS_RTOL and rel_t["loss 1"] <= MESH_TRAIN_RTOL
          and rel_t["grad norm 0"] <= MESH_TRAIN_RTOL,
          f"yi-6b: the (4, 1) mesh left its bounds against [train]'s steps: {rel_t}")
    return {"ms": walls, "losses": [x["loss"] for x in mets], "peak_gib": peak / 2**30,
            "spans": spans}


MESH_MOE_DEPTH = 2        # of qwen2-moe-a2.7b's 24 layers
MESH_MOE_STEPS = 2


class MoeRouting:
    """While open, records each MoE layer's routing (``moe.plan``'s dest and
    cap) of each forward, keyed by data rank (None outside one); a
    recomputed layer's replay is not recorded."""

    def __enter__(self):
        from repro_torch.models import moe as M
        from repro_torch.sharding import collectives as C

        self.seen, self.inner = {}, M.plan

        def recorded(probs, idx, cap, *a):
            res = self.inner(probs, idx, cap, *a)
            me = C._current()
            if me is None or me.source is None:
                self.seen.setdefault(None if me is None else me.rank, []).append((res[0], cap))
            return res

        M.plan = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M

        M.plan = self.inner


@contextlib.contextmanager
def exchange_host_ms():
    """Host ms spent in ``collectives.all_gather_counts`` (every rank's,
    waiting for the others included); yields a one-element list."""
    from repro_torch.sharding import collectives as C

    inner, total = C.all_gather_counts, [0.0]

    def timed(counts):
        t0 = time.perf_counter()
        out = inner(counts)
        total[0] += (time.perf_counter() - t0) * 1e3
        return out

    C.all_gather_counts = timed
    try:
        yield total
    finally:
        C.all_gather_counts = inner


def mesh_moe(torch, smi, cfg=None, dev="cuda", shape=TRAIN_YI_SHAPE):
    """qwen2-moe-a2.7b at its published widths, MESH_MOE_DEPTH of 24 layers,
    on (4, 1) with FSDP: its ranks route each MoE layer over the whole batch
    (the counts exchange).  MESH_MOE_STEPS steps against ``blocked_step`` on
    the same row blocks and against the unsharded step on the same batch;
    the routing choices that differ from the unsharded forward's and the
    choices dropped, per layer; ms a step and the exchange's host ms; peak
    memory and each rank's bytes against the specs'."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import ranks as R
    from repro_torch.launch.dryrun import rank_bytes as rank_bytes_of_specs
    from repro_torch.launch.elastic_resume import data_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import partition as Pt
    from repro_torch.train import steps as St

    if cfg is None:
        cfg = get_config("qwen2-moe-a2.7b")
        check((cfg.d_model, cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.moe_d_ff,
               cfg.vocab_size, cfg.param_dtype, cfg.remat)
              == (2048, 60, 4, 4, 1408, 151936, "bfloat16", True),
              "qwen2-moe-a2.7b is not at its published widths")
        cfg = dataclasses.replace(cfg, n_layers=MESH_MOE_DEPTH)
    b, s = shape
    opt = AdamWConfig(lr=3e-4)
    e_cap = cfg.n_experts
    gc.collect()
    torch.cuda.empty_cache()

    def init():
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return St.init_train_state(cfg, gen, opt)

    def dropped(routes):
        return [int((d == e_cap * cap).sum()) for d, cap in routes]

    state = init()
    n_params = sum(t.numel() for t in T.tree_leaves(state.params))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(cfg.vocab_size, s, b, seed=SEED).batch_at(0).items()}
    wq0 = state.params["blocks"]["slot0"]["attn"]["wq"][0]
    print(f"  [{smi}] qwen2-moe ({cfg.n_layers} layers, {n_params / 1e9:.3f} B params) rows' "
          "float island at step 0 (the rows alone route at their own capacity, so from the "
          "first MoE layer on they differ by routing too): " + rows_island(
              torch, lambda a, bt: T.forward(cfg, state.params, a, bt["tokens"]), state.amax,
              batch, b // MESH_RANKS, dense=lambda x: x @ wq0))
    plain = St.make_train_step(cfg, opt)
    want, plain_ms = [], []
    for i in range(MESH_MOE_STEPS):
        t0 = time.perf_counter()
        with MoeRouting() as rt:
            state, m = plain(state, batch)
        want.append({k: float(v) for k, v in m.items()})
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            whole = rt.seen[None][:cfg.n_layers]
    del state
    gc.collect()
    torch.cuda.empty_cache()

    state = init()
    mesh = data_mesh(dev, MESH_RANKS)
    step, sh, _ = St.jit_train_step(cfg, mesh, opt, batch, fsdp=True)
    want_b = rank_bytes_of_specs(state, sh)
    shards = Pt.split_tree(state, sh)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    got_b = rank_bytes(shards)
    check(all(x == want_b for x in got_b),
          f"qwen2-moe: shard bytes {got_b} differ from the specs' {want_b}")
    torch.cuda.reset_peak_memory_stats()
    mets, walls, exch = [], [], []
    for i in range(MESH_MOE_STEPS):
        with MoeRouting() as rt, exchange_host_ms() as ex:
            shards, m, ms = timed_step(torch, step, shards, batch)
        mets.append(m)
        walls.append(ms)
        exch.append(ex[0])
        if i == 0:
            ranks = [rt.seen[r][:cfg.n_layers] for r in range(MESH_RANKS)]
    peak = torch.cuda.max_memory_allocated()
    digests = [R.digest(x) for x in shards]
    del shards
    gc.collect()
    torch.cuda.empty_cache()
    differ, rows_differ, mesh_drops = [], [], []
    for layer, (dest, cap) in enumerate(whole):
        got = torch.cat([ranks[r][layer][0] for r in range(MESH_RANKS)], 1)
        check(all(ranks[r][layer][1] == cap for r in range(MESH_RANKS)),
              f"qwen2-moe: layer {layer}'s capacity differs between the ranks and the batch")
        expert = [torch.where(d == e_cap * cap, -1, torch.div(d, cap, rounding_mode="floor"))
                  for d in (got, dest)]
        differ.append(int((expert[0] != expert[1]).sum()))
        rows_differ.append(int((got != dest).sum()))
        mesh_drops.append(int((got == e_cap * cap).sum()))
    print(f"  [{smi}] qwen2-moe (4, 1) routing at step 0, per MoE layer, of "
          f"{whole[0][0].numel()} (choice, token) pairs: expert or drop differing from the "
          f"unsharded forward's {differ}, destination row differing {rows_differ}; dropped at "
          f"capacity {whole[0][1]}: unsharded {dropped(whole)}, mesh {mesh_drops}")

    state, met_ref = init(), []
    for _ in range(MESH_MOE_STEPS):
        state, m = blocked_step(torch, cfg, opt, state, batch, MESH_RANKS)
        met_ref.append({k: float(v) for k, v in m.items()})
    del state
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("loss", "grad_norm", "aux")
    rel = {k: [abs(x[k] - w[k]) / abs(w[k]) for x, w in zip(mets, met_ref)] for k in keys}
    rel_t = {"loss 0": abs(mets[0]["loss"] - want[0]["loss"]) / abs(want[0]["loss"]),
             "loss 1": abs(mets[1]["loss"] - want[1]["loss"]) / abs(want[1]["loss"]),
             "grad norm 0": abs(mets[0]["grad_norm"] - want[0]["grad_norm"])
             / abs(want[0]["grad_norm"]),
             "aux 0 (not gated)": abs(mets[0]["aux"] - want[0]["aux"]) / abs(want[0]["aux"])}
    print(f"  [{smi}] qwen2-moe (4, 1) against the same steps on the same {b // MESH_RANKS}-row "
          f"blocks unsharded (blocked_step, its blocks routing together): "
          + "; ".join(f"{k} {[x[k] for x in mets]} (blocks {[w[k] for w in met_ref]})"
                      for k in keys) + f"; relative {rel} (bound {MESH_RTOL})")
    print(f"  [{smi}] qwen2-moe (4, 1) against the unsharded steps (losses "
          f"{[w['loss'] for w in want]}, grad norms {[w['grad_norm'] for w in want]}, aux "
          f"{[w['aux'] for w in want]}): relative "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel_t.items())
          + f" (bounds: loss 0 {MESH_LOSS_RTOL}, loss 1 and grad norm 0 {MESH_TRAIN_RTOL}); ms a "
          f"step {[round(w) for w in walls]} against unsharded {[round(w) for w in plain_ms]}; "
          f"the counts exchange's host ms a step (4 ranks' calls, waiting included) "
          f"{[round(x, 1) for x in exch]}; peak {peak / 2**30:.2f} GiB allocated; bytes a rank "
          f"{got_b} (specs {want_b})")
    check(all(np.isfinite([x[k] for x in mets for k in keys])),
          f"qwen2-moe: a (4, 1) metric is not finite: {mets}")
    check(all(x["aux"] > 0 for x in mets), f"qwen2-moe: the aux loss is not positive: {mets}")
    check(max(max(v) for v in rel.values()) <= MESH_RTOL,
          f"qwen2-moe: the (4, 1) mesh left {MESH_RTOL} of blocked_step: {rel}")
    check(rel_t["loss 0"] <= MESH_LOSS_RTOL and rel_t["loss 1"] <= MESH_TRAIN_RTOL
          and rel_t["grad norm 0"] <= MESH_TRAIN_RTOL,
          f"qwen2-moe: the (4, 1) mesh left its bounds against the unsharded steps: {rel_t}")
    return {"ms": walls, "plain_ms": plain_ms, "exchange_ms": exch, "peak_gib": peak / 2**30,
            "differ": differ, "rows_differ": rows_differ, "dropped": mesh_drops,
            "metrics": mets, "digests": digests}


MESH_PROCS = 4           # ranks, one process each, sharing the one card over gloo
MESH_PROCS_TIMEOUT_S = 600.0


def reckon_step_collectives(state, shardings, n_data: int, moe_layers: int = 0,
                            k: int = 0, e: int = 0, accum: int = 1) -> dict:
    """One rank's collectives in one step of the process backend (float
    moments), reckoned from the specs: {(kind, function): [calls, bytes]}
    as ``collectives.tally`` counts them.  Each split param leaf is
    gathered whole for the forward and, as the reduced float32 gradient,
    for the norm; each leaf's gradient is reduced once a microbatch (a
    rank's float32 block; an all-reduce where no rank splits the leaf);
    each amax leaf is maxed; each MoE layer's (n, k, E) int32 counts are
    gathered once a microbatch."""
    from repro_torch.sharding import partition as Pt

    out = {}

    def add(key, nbytes, times=1):
        c = out.setdefault(key, [0, 0])
        c[0] += times
        c[1] += nbytes * times

    sole = n_data * accum == 1
    for (_, v), (_, sh) in zip(Pt.tree_paths(state.params, sort_keys=True),
                               Pt.tree_paths(shardings.params, sort_keys=True), strict=True):
        split = any(n > 1 for _, n in Pt.block_index(sh, 0, v.dim()))
        if split:
            add(("all-gather", "all_gather"), v.numel() * v.element_size())
            add(("all-gather", "all_gather"), v.numel() * (v.element_size() if sole else 4))
        if not sole:
            add(("reduce-scatter" if split else "all-reduce", "reduce_scatter_add"),
                math.prod(Pt.shard_shape(tuple(v.shape), sh)) * 4, accum)
    for _, a in Pt.tree_paths(state.amax):
        add(("all-reduce", "max_over_ranks"), a.numel() * a.element_size())
    if moe_layers and n_data > 1:
        add(("all-gather", "all_gather_counts"), n_data * k * e * 4, moe_layers * accum)
    return out


def mesh_processes(torch, smi, ref_bert, ref_moe, kernels, guard, bert_cfg=None, moe_cfg=None,
                   device_type="cuda"):
    """[mesh]'s training by MESH_PROCS processes, one a rank, on the one
    card over gloo (``launch/ranks.py``; the parent holds no tensor on the
    card while they run): BERT-base as ``mesh_bert``'s (4, 1) run, with its
    checkpoint written by rank 0, and qwen2-moe as ``mesh_moe``'s (4, 1)
    run, the routing counts exchanged between the processes.  Every rank's
    params, moments, amax and steps (by ``ranks.digest``) and every metric
    must equal those one-process runs' (``ref_bert``, ``ref_moe``) bit for
    bit; each rank's tally of collectives must equal the reckoning from the
    specs.  Rank 0's checkpoint, restored here, must equal the one-process
    run's final state leaf for leaf, and its fold's integer forward at (1,
    128) launches rows 1, 2 and 5, each equal to its plain version.
    Printed: each rank's own peak against the one-process peak, ms a step
    against the one-process step's, each collective kind's host ms and
    bytes a rank, and the op routes."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import ranks as R
    from repro_torch.launch import train_bert_sst2 as SST
    from repro_torch.launch.dryrun import rank_bytes as rank_bytes_of_specs
    from repro_torch.launch.elastic_resume import data_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import partition as Pt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps as St

    print(f"  [{smi}] the process backend's op routes (collectives.ROUTES, a CUDA tensor under "
          f"each backend): {sorted(C.ROUTES.items())}")
    bert_cfg = bert_cfg or get_config("bert-base")
    moe_cfg = moe_cfg or dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                                             n_layers=MESH_MOE_DEPTH)
    bert_opt, moe_opt = AdamWConfig(lr=1e-3), AdamWConfig(lr=3e-4)
    b, s = TRAIN_BERT_SHAPE
    bert_batches = [SST.make_batch(bert_cfg.vocab_size, i, b, s) for i in range(MESH_BERT_STEPS)]
    mb, ms = TRAIN_YI_SHAPE
    moe_batch = SyntheticLM(moe_cfg.vocab_size, ms, mb, seed=SEED).batch_at(0)
    meta_mesh = data_mesh("meta", MESH_PROCS)
    shapes = {"bert": St.state_shape(bert_cfg, bert_opt, bert=True),
              "moe": St.state_shape(moe_cfg, moe_opt)}
    shs = {"bert": St.state_shardings(meta_mesh, shapes["bert"]),
           "moe": St.state_shardings(meta_mesh, shapes["moe"])}
    reckoned = {"bert": reckon_step_collectives(shapes["bert"], shs["bert"], MESH_PROCS),
                "moe": reckon_step_collectives(shapes["moe"], shs["moe"], MESH_PROCS,
                                               moe_cfg.n_layers, moe_cfg.top_k,
                                               moe_cfg.n_experts)}
    # each qwen2-moe rank's bytes, reckoned before the run
    n_params = sum(t.numel() for t in T.tree_leaves(shapes["moe"].params))
    parts = {"its state's shard": rank_bytes_of_specs(shapes["moe"], shs["moe"]),
             "the params gathered whole (bf16)": 2 * n_params,
             "its data block's gradient (bf16)": 2 * n_params,
             "its float32 gradient block": 4 * n_params // MESH_PROCS,
             "the (1, 1,024) logits, float32 copy and gradient": mb // MESH_PROCS * ms
             * moe_cfg.vocab_size * (2 + 4 + 4)}
    print(f"  [{smi}] qwen2-moe a rank's bytes reckoned before the run: "
          + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in parts.items())
          + f"; in all {sum(parts.values()) / 2**30:.2f} GiB a rank, "
          f"{MESH_PROCS * sum(parts.values()) / 2**30:.2f} GiB for {MESH_PROCS} ranks")
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = R.run(R.in_turn, MESH_PROCS, backend="gloo", device_type=device_type, args=([
            functools.partial(R.train_steps, bert_cfg, bert_opt, bert_batches,
                              device_type=device_type, bert=True, seed=SEED, keep="digest",
                              ckpt_dir=d),
            functools.partial(R.train_steps, moe_cfg, moe_opt, [moe_batch] * MESH_MOE_STEPS,
                              device_type=device_type, seed=SEED, keep="digest")],),
            timeout_s=MESH_PROCS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        restored, meta = ckpt.restore(d, MESH_BERT_STEPS, shapes["bert"], device_type)
    for name, ref in (("bert", ref_bert), ("moe", ref_moe)):
        i = 0 if name == "bert" else 1
        what = {"bert": "bert-base", "moe": f"qwen2-moe ({moe_cfg.n_layers} layers)"}[name]
        ranks = [r[i] for r in res]
        differ = [(r, p) for r, x in enumerate(ranks) for p, dg in x["digest"].items()
                  if dg != ref["digests"][r][p]]
        same_metrics = all(x["metrics"] == ref["metrics"] for x in ranks)
        peaks = [x["peak_bytes"] / 2**30 if x["peak_bytes"] is not None else float("nan")
                 for x in ranks]
        kinds = sorted({k for x in ranks for st in x["host_ms"] for k in st})
        host = {f"{kind} ({fn})": [[round(st.get((kind, fn), 0.0), 1) for st in x["host_ms"]]
                                   for x in ranks] for kind, fn in kinds}
        tally_ok = all(st == reckoned[name] for x in ranks for st in x["tally"])
        print(f"  [{smi}] {what} on {MESH_PROCS} processes (4, 1) over gloo on one card, "
              f"{len(ranks[0]['metrics'])} steps: metrics {ranks[0]['metrics']} (one process: "
              f"{ref['metrics']}), equal on every rank {same_metrics}; {len(differ)} of "
              f"{MESH_PROCS * len(ranks[0]['digest'])} rank leaves differ from the one-process "
              f"(4, 1) run's {differ[:4]}; ms a step by rank "
              f"{[[round(m) for m in x['ms']] for x in ranks]} against one process "
              f"{[round(m) for m in ref['ms']]} (one card time-slices its {MESH_PROCS} "
              f"processes: no gain expected); each rank's own peak "
              f"{[f'{p:.2f}' for p in peaks]} GiB allocated against the one-process peak "
              f"{ref['peak_gib']:.2f} GiB; shard bytes a rank {[x['rank_bytes'] for x in ranks]}")
        print(f"  [{smi}] {what} collectives a rank a step, host ms by rank and step: {host}; "
              f"bytes a rank a step (tally, each step): {ranks[0]['tally'][0]}; reckoned from the "
              f"specs {reckoned[name]}: every rank's every step equal {tally_ok}")
        check(not differ and same_metrics, f"{what}: the {MESH_PROCS}-process step differs "
              f"from the one-process step ({differ[:4]}, metrics {same_metrics})")
        check(tally_ok, f"{what}: a rank's collectives differ from the specs' reckoning")
    # rank 0's checkpoint against the one-process run's final state, then served
    sh41 = St.state_shardings(data_mesh(device_type, MESH_PROCS), shapes["bert"])
    back = [R.digest(x) for x in Pt.split_tree(restored, sh41)]
    differ = [(r, p) for r, dg in enumerate(back) for p in dg if dg[p] != ref_bert["digests"][r][p]]
    print(f"  [{smi}] bert-base: rank 0's checkpoint (step {meta['data_step']}) restored here: "
          f"{len(differ)} leaves differ from the one-process (4, 1) run's final state; "
          f"{MESH_PROCS} processes took {wall:.1f} s in all")
    check(not differ and meta["data_step"] == MESH_BERT_STEPS,
          f"bert-base: rank 0's checkpoint differs from the one-process state at {differ[:4]}")
    if device_type == "cuda":
        serve_trained_bert(torch, bert_cfg, restored, kernels, guard, ((1, 128),),
                           f"[{smi}] bert-base trained by {MESH_PROCS} processes")
    return {"wall_s": wall, "ranks": res}


def phase_mesh(torch, smi, trained, kernels, guard):
    t0 = time.perf_counter()
    bert = mesh_bert(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    yi = mesh_yi6b(torch, smi, trained["yi6b"])
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    moe = mesh_moe(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    procs = mesh_processes(torch, smi, bert, moe, kernels, guard)
    print(f"  [mesh] seconds: bert-base {t1 - t0:.1f}, yi-6b {t2 - t1:.1f}, qwen2-moe "
          f"{t3 - t2:.1f}, {MESH_PROCS} processes {time.perf_counter() - t3:.1f}")
    return {"bert": bert, "yi6b": yi, "moe": moe, "processes": procs}


def phase_train(torch, kernels, guard):
    bert = train_bert(torch, kernels, guard)
    yi = train_yi6b(torch)
    xlstm = train_xlstm(torch)
    return {"bert_launches": bert, "yi6b": yi, "xlstm": xlstm}


def main() -> int:
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
    engine_wrappers = [fn for fn, *_ in table[:4]]      # the engine's kernels
    # the contiguous layout's two as well: the recurrent phases count them
    # per forward
    record_forwards(engine_wrappers + [da.decode_qattention, fa.flash_qattention])
    rows = []
    for fn, phase, *_ in table:
        print(f"[kernel] {fn.__name__}")
        row = phase(torch, gen)
        print(f"  mismatches vs plain: {row['mismatches']} (max abs err {row['max_abs_err']})")
        check(row["mismatches"] == 0, f"{fn.__name__}: kernel != plain version")
        rows.append(row)
    torch.cuda.empty_cache()
    stamp("kernel phases")
    print("[autotune] the launch tuner (kernels/autotune.py): every candidate of every knob at "
          "the served GEMM shapes and the attention phases' cases, and the picks of its three "
          "modes")
    phase_autotune(torch, gen)
    torch.cuda.empty_cache()
    stamp("autotune")

    # the served paths must reach no plain version on a CUDA tensor: every
    # such call from here on is counted, outside a phase's paused comparisons
    guard = PlainGuard()
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
    print(f"[tp] yi-6b, full width, tensor parallelism over {TP} ranks on the one card "
          f"(Hkv {cfg.n_kv_heads // TP} a rank): the [serve], [kv4] and [spec] requests, "
          "each against its tp=1 run")
    tp = phase_tp(torch, cfg, folded, served, kv4, spec["prompt lookup"],
                  {fn.__name__: row for (fn, *_), row in zip(table, rows)})
    stamp("tp")
    print("[contiguous] yi-6b, full width, the contiguous stripe and the LockstepEngine")
    contiguous = phase_contiguous(torch, cfg, folded)
    print(f"  TTFT p50: paged int8 one-shot {served['ttft_p50_s']:.3f} s, kv4 one-shot "
          f"{kv4['ttft_p50_s']:.3f} s, contiguous {contiguous['ttft_p50_s']:.3f} s")
    stamp("contiguous")
    print("[eval] yi-6b, full width, the cache-less causal forward at (1, 512) and (2, 1024)")
    evals = phase_eval(torch, cfg, folded)
    stamp("eval")
    print("[analysis] yi-6b, full width: the integer-datapath audit of every hot step of the six "
          "engine presets, the kernel lint on the card and the fixtures' self-test")
    phase_analysis(torch, cfg, folded, guard)
    stamp("analysis")
    print("[autotune] yi-6b, full width: the GEMMs' launches x ms under each mode over the "
          "one-shot run and a qwen2-moe tick; a prefill chunk and a decode tick under each mode")
    phase_autotune_served(torch, gen, cfg, folded, served, guard)
    stamp("autotune served")
    del folded
    torch.cuda.empty_cache()
    print("[qwen3] qwen3-4b, full size (36 layers, qk-norm), 8 requests x 32 new tokens, "
          "one-shot and chunked")
    phase_arch(torch, "qwen3-4b", engine_wrappers)
    stamp("qwen3")
    print(f"[moe] qwen2-moe-a2.7b, published widths at {MOE_DEPTH} of 24 layers (60 routed "
          "experts top-4 + 4 shared), "
          "8 requests x 32 new tokens, one-shot and chunked")
    phase_arch(torch, "qwen2-moe-a2.7b", engine_wrappers, n_layers=MOE_DEPTH)
    stamp("moe")
    print(f"[mixtral] mixtral-8x22b, published widths at {MIXTRAL_DEPTH} of 56 layers (8 "
          "experts top-2, a 4,096-row sliding window), 9 requests on the contiguous ring")
    mixtral = phase_mixtral(torch, engine_wrappers[:2] + [da.decode_qattention,
                                                          fa.flash_qattention]
                            + engine_wrappers[2:], guard)
    stamp("mixtral")
    recurrent = {}
    print(f"[xlstm] xlstm-1.3b, published widths at {XLSTM_DEPTH} of 48 layers (21 mLSTM + 3 "
          "sLSTM, d 2048), 8 requests "
          f"of {min(RECURRENT_LENS)}-{max(RECURRENT_LENS)} prompt tokens x 32 new, the "
          "decode-loop prefill")
    recurrent["xlstm"] = phase_recurrent(torch, "xlstm-1.3b", engine_wrappers[:2] + [
        da.decode_qattention, fa.flash_qattention] + engine_wrappers[2:], guard)
    stamp("xlstm")
    print(f"[jamba] jamba-1.5-large, published widths at {JAMBA_DEPTH} of 72 layers (one "
          "super-block: 7 Mamba + 1 attention) with n_experts=0 (dense SwiGLU FFNs at d_ff "
          "24,576): the 4 MoE slots of one super-block hold ~38.7 B parameters and the "
          "calibration holds every float weight, more than the card; 8 requests, the "
          "decode-loop prefill")
    recurrent["jamba"] = phase_recurrent(torch, "jamba-1.5-large-398b", engine_wrappers[:2] + [
        da.decode_qattention, fa.flash_qattention] + engine_wrappers[2:], guard)
    stamp("jamba")
    frontends = {}
    print("[qwen2vl] qwen2-vl-2b, full size (28 layers, M-RoPE, tied head): the LockstepEngine "
          "through make_engine, then the vision stub's 256 image rows + 256 text tokens, "
          "cache-less, one-shot into the stripe and 32 decode steps")
    frontends["qwen2vl"] = phase_qwen2vl(torch, engine_wrappers[:2] + [
        da.decode_qattention, fa.flash_qattention] + engine_wrappers[2:], guard)
    stamp("qwen2vl")
    print("[musicgen] musicgen-medium, full size (48 layers, MHA 24 x 64, 4 codebooks of "
          "2,048, 4 LM heads): 8 streams x 64 frames one-shot, 64 decode steps of (8, 4, 1) "
          "codes, the cache-less (2, 4, 512) forward")
    frontends["musicgen"] = phase_musicgen(torch, engine_wrappers[:2] + [
        da.decode_qattention, fa.flash_qattention] + engine_wrappers[2:], guard)
    stamp("musicgen")
    print(f"  plain versions on a CUDA tensor on the served paths ([serve] to [musicgen]): "
          f"{guard.ran() or 'none'}")
    check(not guard.ran(), f"plain versions ran on the card on the served paths: "
          f"{guard.ran()}")
    print("[check] small model against the CPU")
    phase_small_reference(torch)
    print("[check] small stablelm-1.6b, qwen3-4b and qwen2-moe-a2.7b against the CPU")
    phase_small_archs(torch)
    print("[check] small mixtral-8x22b (window 16) against the CPU")
    phase_small_mixtral(torch)
    print("[check] small xlstm-1.3b and jamba-1.5-large (4 experts) against the CPU")
    phase_small_recurrent(torch)
    print("[check] small qwen2-vl-2b (sections (4, 6, 6)) and musicgen-medium against the CPU")
    phase_small_frontends(torch)
    print("[bert] bert-base, full width, W4A8 and W8A8, cache-less integer forward")
    bert = phase_bert(torch)
    print("[check] small bert-base against the CPU")
    phase_small_bert_reference(torch)
    stamp("bert")
    print(f"[train] bert-base at full size: {TRAIN_BERT_STEPS} QAT fine-tuning steps at "
          f"{TRAIN_BERT_SHAPE} on the synthetic SST-2 task, the checkpoint, the fold and the "
          f"integer forward; yi-6b at its published widths, {TRAIN_YI_DEPTH} of 32 layers, bf16: "
          f"{TRAIN_YI_STEPS} steps at {TRAIN_YI_SHAPE}; xlstm-1.3b at full size (6 sLSTM + 42 "
          f"mLSTM layers), bf16: {TRAIN_XLSTM_STEPS} steps at {TRAIN_XLSTM_SHAPE}")
    trained = phase_train(torch, [sm.quant_softmax, mm.int4_matmul, ln.quant_layernorm], guard)
    stamp("train")
    print("[sst2] the paper's Table I experiment, launch/train_bert_sst2.py at its defaults: "
          "bert-base at d_model 128, 2 layers, 150 QAT steps at (16, 32), held-out FQ vs fp32")
    sst2 = phase_sst2(torch)
    print(f"  held-out accuracy FQ {sst2['fq']:.3f}, fp32 {sst2['fp32']:.3f} (not gated)")
    stamp("sst2")
    print(f"[mesh] training over a (data, model) mesh, {MESH_RANKS} data ranks on the one card: "
          f"bert-base at full size, {MESH_BERT_STEPS} steps at {TRAIN_BERT_SHAPE} on (1, 1) and "
          f"(4, 1) against the unsharded step, the elastic resize; yi-6b at {TRAIN_YI_DEPTH} of 32"
          f" layers, {MESH_YI_STEPS} steps at {TRAIN_YI_SHAPE} on (4, 1) with FSDP; "
          f"qwen2-moe-a2.7b at {MESH_MOE_DEPTH} of 24 layers, {MESH_MOE_STEPS} steps at "
          f"{TRAIN_YI_SHAPE} on (4, 1), its ranks routing the whole batch; then bert-base and "
          f"qwen2-moe again on {MESH_PROCS} processes, one a rank, sharing the card over gloo")
    phase_mesh(torch, smi, trained, [sm.quant_softmax, mm.int4_matmul, ln.quant_layernorm],
               guard)
    stamp("all phases")

    # launches: each kernel's count on its own main path (yi-6b one-shot
    # serving for the engine's four, the kv4 one-shot run for the packed
    # pool's two, the contiguous engine's run for decode_qattention and
    # flash_qattention; the [eval] phase's per-layer calls of the public
    # flash_qdecode; BERT at (1, 128) for the other two)
    launches = dict(zip([fn.__name__ for fn in engine_wrappers], served["launches"]))
    rows[2]["verify"].update(launches_per_forward=cfg.n_layers,
                             forwards=spec["oracle"]["verify_forwards"])
    launches["paged_prefill_qattention_q4"], launches["paged_decode_qattention_q4"] = \
        kv4["launches"][:2]
    launches["decode_qattention"], launches["flash_qattention"] = contiguous["launches"][:2]
    # [tp]: rows 3 and 4 in its int8 run, rows 8 and 7 in its kv4 run
    launches_tp = dict(zip(["paged_prefill_qattention", "paged_decode_qattention"],
                           tp["int8"]["launches"][:2]))
    launches_tp.update(zip(["paged_prefill_qattention_q4", "paged_decode_qattention_q4"],
                           tp["kv4"]["launches"][2:]))
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
            **({"launches_tp": launches_tp[fn.__name__]} if fn.__name__ in launches_tp else {}),
            **({"launches_mixtral": mixtral["launches"][fn.__name__]}
               if fn.__name__ in mixtral["launches"] else {}),
            **({"launches_train": trained["bert_launches"][fn.__name__]}
               if fn.__name__ in trained["bert_launches"] else {}),
            **{f"launches_{arch}": r["launches"][fn.__name__]
               for arch, r in {**recurrent, **frontends}.items() if fn.__name__ in r["launches"]},
            **({"launch_floor_ms": row["launch_floor_ms"]} if "launch_floor_ms" in row else {}),
            **{case: {k: row[case][k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "mismatches",
                                                "launches_per_forward", "forwards",
                                                "skip_margin", "ms_no_window",
                                                "ms_from_block_0")
                      if k in row[case]}
               for case in ("chunk", "long", "last_chunk", "verify", "tp_rank", "qwen3", "expert",
                            "expert_chunk", "g1_moe", "g1_stablelm", "mixtral",
                            "mixtral_prefill", "mixtral_attn", "mixtral_attn_prefill",
                            "mixtral_forward", "g6_ring", "xlstm", "xlstm_loop", "jamba",
                            "jamba_loop", "jamba_prefill", "qwen2vl", "qwen2vl_prefill",
                            "qwen2vl_b1", "musicgen", "musicgen_prefill", "musicgen_b1",
                            "musicgen_forward",
                            *(label for label, *_ in WINDOW_CASES)) if case in row}})
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
