"""One OS process per rank: ``run`` starts the ranks of a
``launch.mesh.ProcessMesh`` and gathers what each returns.

    results = run(fn, 4, backend="gloo", device_type="cpu", args=(...,))

Each rank is a process of its own, started by ``torch.multiprocessing`` with
the ``spawn`` method (CUDA forbids ``fork``).  The ranks meet through a
``FileStore`` in a temporary directory (``file://`` rendezvous: no port, no
network; the processes' own sockets bind to the loopback device), join a
``torch.distributed`` process group of ``backend`` with a timeout, call
``fn(*args)`` (``functools.partial`` binds keywords) and write its result
to a file that the parent reads back (tensors come back on the CPU).  Each rank's device is
``mesh.process_devices``': gloo on the CPU, gloo with every rank on one
shared card, NCCL only when each rank has a card of its own (asking for
NCCL with fewer cards than ranks raises here, before any process starts;
nothing falls back to gloo, to the CPU or to one process).

A rank that raises writes its traceback and exits; the parent then stops
every other rank (a rank blocked in a collective would wait for the group's
timeout) and raises ``RankFailed`` naming the first rank that failed.  No
child outlives ``run``.

The rank programs below are what the launcher, the tests and
``chip_smoke.py`` run in the ranks: ``train_steps`` (steps of
``train/steps.py::jit_train_step`` on a process mesh), ``check_collectives``
(each of ``sharding/collectives.py``'s process collectives on given
inputs), ``train_on_ranks`` (``train/trainer.py::train``), ``in_turn`` (a
list of programs in one start) and ``fail_on`` (the failure path).
"""
from __future__ import annotations

import datetime
import gc
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import make_process_mesh, process_devices

CHUNK = 1 << 24          # int64 words a digest reduces at once


class RankFailed(RuntimeError):
    """A rank of ``run`` failed: ``rank`` names it, ``pids`` are every
    rank's processes, all ended."""

    def __init__(self, rank: int, detail: str, pids: Sequence[int]):
        super().__init__(f"rank {rank} failed: {detail}")
        self.rank, self.pids = rank, list(pids)


def _rank_main(rank: int, world: int, backend: str, device_type: str, init: str, out: str,
               timeout_s: float, fn, args):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)        # the ranks share the host's cores
    try:
        dev = process_devices(world, backend, device_type)[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(*args)
        tmp = Path(out) / f"rank{rank}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, Path(out) / f"rank{rank}.pt")
        if backend == "nccl":       # no rank leaves the group while another uses it
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent, then the process ends
        err = Path(out) / f"rank{rank}.err"
        err.with_suffix(".tmp").write_text(f"{time.time()!r}\n{traceback.format_exc()}")
        os.replace(err.with_suffix(".tmp"), err)
        os._exit(1)


def _failure(procs, out: Path) -> Optional[Tuple[int, str]]:
    """The first failed rank and why (by the time its error was written),
    or None while none has failed."""
    errs = []
    for r, p in enumerate(procs):
        f = out / f"rank{r}.err"
        if f.exists():
            when, _, text = f.read_text().partition("\n")
            errs.append((float(when), r, text.strip()))
        elif p.exitcode not in (None, 0):
            errs.append((float("inf"), r, f"exit code {p.exitcode}, no error written"))
    return min(errs)[1:] if errs else None


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def run(fn, nproc: int, *, backend: str = "gloo", device_type: str = "cuda", args=(),
        timeout_s: float = 300.0) -> List:
    """``fn(*args)`` in each of ``nproc`` rank processes (``fn`` a module-
    level function, pickled by name), each on one torch thread; returns
    their results in rank order.  ``timeout_s`` bounds the rendezvous and
    each collective, so a rank stuck in one raises.  Raises ``RankFailed``
    naming the first rank that failed."""
    import torch.multiprocessing as mp

    process_devices(nproc, backend, device_type)      # raises before any process starts
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as d:
        out = Path(d)
        init = f"file://{out / 'rendezvous'}"
        procs = [ctx.Process(target=_rank_main, name=f"rank {r}",
                             args=(r, nproc, backend, device_type, init, d, timeout_s, fn,
                                   args))
                 for r in range(nproc)]
        try:
            for p in procs:
                p.start()
            while True:
                failed = _failure(procs, out)
                if failed is not None or all(p.exitcode == 0 for p in procs):
                    break
                time.sleep(0.02)
        finally:
            _stop(procs)
        pids = [p.pid for p in procs]
        if failed is not None:
            raise RankFailed(*failed, pids)
        return [torch.load(out / f"rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(nproc)]


# --- rank programs ----------------------------------------------------------------------

def in_turn(calls: Sequence) -> List:
    """Each of ``calls`` (rank programs bound to their arguments with
    ``functools.partial``) in order, in one start of the ranks; their
    results in order."""
    return [call() for call in calls]


def fail_on(rank: int, message: str = "a rank failed on purpose"):
    """Raises ``RuntimeError(message)`` on ``rank``; every other rank waits
    at a barrier for it, as a rank waits in a collective for a peer."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(message)
    dist.barrier()


def digest(tree) -> Dict[str, Tuple]:
    """{path: (dtype, shape, two 64-bit sums, the trailing bytes)} of each
    leaf's bytes, reduced on the leaf's device: the bytes as int64 words
    w_i, summed plain and weighted by 2i + 1 (modulo 2^64).  Any one word
    that differs moves both sums; two leaves with equal digests hold equal
    bytes but for a difference built to cancel both."""
    from repro_torch.sharding import partition as Pt

    out = {}
    for path, t in Pt.tree_paths(tree, sort_keys=True):
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.storage_offset() % 8:
            b = b.clone()
        n = b.numel() // 8
        words, s1, s2 = b[:n * 8].view(torch.int64), 0, 0
        for i in range(0, n, CHUNK):
            w = words[i:i + CHUNK]
            k = torch.arange(i, i + w.numel(), dtype=torch.int64, device=w.device) * 2 + 1
            s1 += int(w.sum())
            s2 += int((w * k).sum())
        out[path] = (str(t.dtype), tuple(t.shape), s1 % 2**64, s2 % 2**64,
                     bytes(b[n * 8:].cpu().numpy()))
    return out


def _cpu(tree):
    from repro_torch.sharding import partition as Pt

    return Pt.tree_rebuild(tree, [t.cpu() for _, t in Pt.tree_paths(tree)])


def train_steps(cfg, opt_cfg, batches: Sequence[Dict[str, np.ndarray]], *,
                mesh_shape: Optional[Sequence[int]] = None, device_type: str = "cuda",
                bert: bool = False, accum_steps: int = 1, state: Optional[str] = None,
                seed: int = 0, keep: str = "state", ckpt_dir: Optional[str] = None,
                model_compute: str = "gather") -> Dict:
    """A rank's steps of ``jit_train_step`` (FSDP, donating) on a
    ``mesh_shape`` process mesh (default ``(world, 1)``), one a global batch
    of ``batches``, from the
    whole state saved at ``state`` (``torch.save``) or drawn from ``seed``
    on this rank's device (``steps.init_rank_state``).  Returns {"metrics",
    "ms", "tally", "host_ms"} per step, the peak bytes this process
    allocated on its card (None on the CPU), this rank's shard bytes, and
    its final shard on the CPU (``keep="state"``) or its ``digest``
    (``keep="digest"``); with ``ckpt_dir``, the final state is saved there
    as a checkpoint of the step count.  ``model_compute`` as
    ``jit_train_step``'s; under "split" the record also holds "replicas",
    each step's digest of this rank's gradient of each replicated leaf
    (``step.replicas``)."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import partition as Pt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import steps as St

    mesh = make_process_mesh(mesh_shape, device_type)
    dev = mesh.device
    if dev.type == "cuda":          # what an earlier program of the start left behind
        gc.collect()
        torch.cuda.empty_cache()
    example = {k: torch.empty(v.shape, dtype=torch.as_tensor(v[:0]).dtype, device="meta")
               for k, v in batches[0].items()}
    step, sh, _ = St.jit_train_step(cfg, mesh, opt_cfg, example, bert=bert,
                                    accum_steps=accum_steps, model_compute=model_compute)
    if state is not None:
        whole = torch.load(state, map_location=dev, weights_only=False)
        shard = Pt.rank_tree(whole, sh, mesh.rank)
        del whole
    else:
        shard = St.init_rank_state(cfg, opt_cfg, sh, mesh, seed, bert=bert)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {"metrics": [], "ms": [], "tally": [], "host_ms": []}
    if model_compute == "split":
        step.replicas = rec["replicas"] = []
    for batch in batches:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with C.tally() as tally, C.host_ms() as clock:
            t0 = time.perf_counter()
            shard, m = step(shard, batch)
            m = {k: float(v) for k, v in m.items()}      # waits for the device
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["metrics"].append(m)
        rec["tally"].append(dict(tally))
        rec["host_ms"].append(dict(clock))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    rec["rank_bytes"] = sum(t.numel() * t.element_size() for _, t in Pt.tree_paths(shard))
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, len(batches), shard, meta={"data_step": len(batches)},
                  shardings=sh)
    rec[keep] = _cpu(shard) if keep == "state" else digest(shard)
    return rec


def check_collectives(inputs: Dict, mesh_shape: Sequence[int], device_type: str = "cuda") -> Dict:
    """Each process collective on ``inputs`` (numpy, every rank's: "leaf"
    split per "spec"; "grads", per microbatch per data block the gradient
    of that leaf; "trees", per data block a dict of arrays; "counts", per
    data block a (k, E) int32 table), with the tally of each call:
    {"gathered", "sums" (after each microbatch), "sole", "max", "counts"},
    and {name: tally}."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import partition as Pt

    mesh = make_process_mesh(mesh_shape, device_type)
    proc, dev = C.Process(mesh), mesh.device
    me = proc.block[mesh.rank]
    sh = Pt.NamedSharding(mesh, inputs["spec"])

    def t(a):
        return torch.as_tensor(a, device=dev)

    out, tallies = {}, {}
    with C.tally() as tallies["all_gather"]:
        out["gathered"] = proc.all_gather(Pt.block_of(t(inputs["leaf"]), sh, mesh.rank),
                                          sh).cpu()
    owner, out["sums"] = None, []
    with C.tally() as tallies["reduce_scatter_add"]:
        for grads in inputs["grads"]:
            owner = proc.reduce_scatter_add(owner, t(grads[me]), sh)
            out["sums"].append(owner.cpu().clone())
    with C.tally() as tallies["sole"]:
        out["sole"] = proc.reduce_scatter_add(None, t(inputs["grads"][0][0]), sh,
                                               sole=True).cpu()
    with C.tally() as tallies["max_over_ranks"]:
        tree = inputs["trees"][me]
        out["max"] = _cpu(proc.max_over_ranks(
            Pt.tree_rebuild(tree, [t(v) for _, v in Pt.tree_paths(tree)])))
    with C.tally() as tallies["all_gather_counts"], C.data_rank(proc, me):
        table, rank = C.all_gather_counts(t(inputs["counts"][me]))
        out["counts"] = (table.cpu(), rank)
    return {**out, "tally": {k: dict(v) for k, v in tallies.items()}}


def train_on_ranks(cfg, shape, opt_cfg, tcfg, *, mesh_shape: Optional[Sequence[int]] = None,
                   device_type: str = "cuda", fsdp: bool = True, log: bool = False,
                   model_compute: str = "gather"):
    """``train/trainer.py::train`` on a ``mesh_shape`` process mesh: this
    rank's (state on the CPU, history); rank 0 prints each logged step
    when ``log``."""
    from repro_torch.train.trainer import train

    mesh = make_process_mesh(mesh_shape, device_type)

    def log_fn(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
              f"gnorm {m['grad_norm']:.3f} {m['step_s'] * 1e3:.0f} ms", flush=True)

    state, history = train(cfg, shape, opt_cfg, tcfg, mesh=mesh, fsdp=fsdp,
                           log_fn=log_fn if log and mesh.rank == 0 else None,
                           model_compute=model_compute)
    return _cpu(state), history
