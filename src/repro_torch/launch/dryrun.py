"""Multi-pod dry run on the ``meta`` device: for every (architecture x input
shape) cell, the production mesh's state and batch shardings, each rank's
bytes, and one data rank's step traced with tensors that allocate nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both

The counterpart of the reference's ``launch/dryrun.py``, which compiles the
step for 256 or 512 forced host devices: here 256 or 512 ``meta`` devices
form the mesh.  A train cell builds ``jit_train_step``'s shardings (int8
moments, FSDP unless ``--no-fsdp``, ``REPRO_ACCUM`` microbatches, default
4) and traces one data rank's loss and backward at its microbatch (for
train_4k on one pod, 256 / 16 / 4 = 4 rows).  A serve cell folds the params
on ``meta`` and traces one data rank's integer prefill or decode forward.
Each records its ranks' bytes of params, moments, batch and cache from the
specs (every rank holds as much), ``ok``, or the error; a failing cell is
recorded and the sweep goes on.  A MoE arch's traced rank routes as rank 0
of its data ranks: its counts exchange returns a ``meta`` table, so its
capacity counts the global microbatch as the step's does.

A train cell also records what the reference reads from XLA's compiled HLO,
from the port's own eager step instead (both say so in the JSON):
``collectives``, per kind under the reference's names, the calls and the
bytes of their results on one rank in one step, counted at each
``sharding/collectives.py`` call from the shardings' specs (the forward's
gather of every split param once a step; each microbatch's reduce of every
gradient leaf into its owners' blocks and each MoE layer's counts
exchange, x the microbatches; the max of the observations once; the update's
gathers onto rank 0 belong to the one process that drives every rank and
are not counted);
and ``hlo_cost``, the bytes by dtype of the traced rank's loss and backward
(``analysis/graph_audit.record`` on ``meta``, ``analysis/cost.py``'s eager
traffic model), or ``hlo_cost_error`` where recording fails.  Beside them,
``collectives_split`` (and ``collectives_split_by_call``) count the same
for the step under ``model_compute="split"``: each model-split param
gathered over the data axes only into model rank 0's block, the rest as
above, and per microbatch the traced pass of model coordinate 0 alone
(``collectives.TracedModelRank``: its model group's sums, maxima and
all-to-alls, its peers taken to hold parts of its shapes) and the reduce
of every gradient leaf; where ``train/steps.py::check_split`` refuses the
cell, ``collectives_split_error`` holds its message instead.
One JSON per cell under ``results/dryrun/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import cost, graph_audit
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, cell_is_runnable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt
from repro_torch.train import steps as St

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun"
META = torch.device("meta")


def input_specs(cfg, shape: ShapeConfig):
    """The cell's global batch as ``meta`` tensors."""
    b, s = shape.global_batch, shape.seq_len

    def i32(*dims):
        return torch.empty(dims, dtype=torch.int32, device=META)

    if shape.kind == "train":
        if cfg.frontend == "audio_codebooks":
            return {"tokens": i32(b, cfg.n_codebooks, s)}
        if cfg.frontend == "vision_stub":
            n_img = 256  # stub: 256 patch embeddings per example
            return {"tokens": i32(b, s - n_img),
                    "extra_embeds": torch.empty((b, n_img, cfg.d_model), dtype=cfg.dtype,
                                                device=META),
                    "pos3": i32(b, s, 3)}
        return {"tokens": i32(b, s)}
    if shape.kind == "prefill":
        if cfg.frontend == "audio_codebooks":
            return {"tokens": i32(b, cfg.n_codebooks, s)}
        return {"tokens": i32(b, s)}
    # decode: one new token against a cache of seq_len
    if cfg.frontend == "audio_codebooks":
        return {"tokens": i32(b, cfg.n_codebooks, 1)}
    return {"tokens": i32(b, 1)}


def rank_bytes(tree, shardings) -> int:
    """One rank's bytes of ``tree`` split per ``shardings``."""
    shs = dict(Pt.tree_paths(shardings, sort_keys=True))
    return sum(Pt.shard_nbytes(v, shs[p]) for p, v in Pt.tree_paths(tree, sort_keys=True))


def _rank_batch(mesh, batch):
    """One data rank's rows of ``batch`` (``meta``) and the data ranks."""
    ranks = St.data_ranks(mesh, {k: tuple(v.shape) for k, v in batch.items()})
    rows = ranks[0][0]
    return {k: torch.empty((rows.stop - rows.start, *v.shape[1:]), dtype=v.dtype, device=META)
            for k, v in batch.items()}, len(ranks)


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
COLLECTIVES_NOTE = ("the port's eager step, counted at each sharding/collectives.py call from "
                    "the specs: the result bytes on one rank in one step; not XLA's numbers")
HLO_COST_NOTE = ("one data rank's loss and backward on one microbatch: the port's eager ops on "
                 "meta, each reading its operands and writing its results once "
                 "(analysis/cost.py); not XLA's loop-aware HLO cost")


def collectives_record(*tallies):
    """{kind: {count, bytes}} under the reference's names, and {function:
    {count, bytes}}, of ``(tally, times)`` pairs."""
    kinds = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
    calls = {}
    for t, times in tallies:
        for (kind, fn), (n, nbytes) in t.items():
            for rec in (kinds[kind], calls.setdefault(fn, {"count": 0, "bytes": 0})):
                rec["count"] += n * times
                rec["bytes"] += nbytes * times
    return kinds, calls


def train_cell(cfg, shape, mesh, fsdp=True, accum_steps=4) -> dict:
    opt_cfg = AdamWConfig(quantize_moments=True)
    batch = input_specs(cfg, shape)
    _, state_sh, batch_sh = St.jit_train_step(cfg, mesh, opt_cfg, batch, fsdp=fsdp,
                                              accum_steps=accum_steps)
    state = St.state_shape(cfg, opt_cfg)
    micro = {k: torch.empty((v.shape[0] // accum_steps, *v.shape[1:]), dtype=v.dtype,
                            device=META) for k, v in batch.items()}
    rows, n_data = _rank_batch(mesh, micro)
    p_sh = dict(Pt.tree_paths(state_sh.params, sort_keys=True))
    rec = {}
    t0 = time.time()
    with C.tally() as per_step:             # the forward's gather, once a step
        for p, v in Pt.tree_paths(state.params, sort_keys=True):
            C.all_gather(Pt.split_leaf(v, p_sh[p]), p_sh[p], META)

    def rank_pass():
        with C.data_rank(C.DataRanks(n_data), 0):
            return St.lm_loss_and_grads(cfg, state.params, state.amax, rows)

    with C.tally() as per_micro:
        try:
            (loss, aux, grads), audit = graph_audit.record(rank_pass, ())
            rec["hlo_cost"] = {"bytes_by_dtype": cost.bytes_by_dtype(audit.ops),
                               "op_counts": cost.op_counts(audit.ops), "note": HLO_COST_NOTE}
        except Exception as e:  # noqa: BLE001 -- recorded, as the reference records its own
            rec["hlo_cost_error"] = f"{type(e).__name__}: {e}"
            per_micro.clear()
            loss, aux, grads = rank_pass()
        for p, g in Pt.tree_paths(grads, sort_keys=True):
            C.reduce_scatter_add(None, g, p_sh[p])
    with C.tally() as per_step_max:
        C.max_over_ranks([aux["obs"]] * n_data)
    kinds, calls = collectives_record((per_step, 1), (per_micro, accum_steps), (per_step_max, 1))
    rec.update(split_collectives(cfg, mesh, state, p_sh, rows, n_data, accum_steps, per_step_max))
    ok = loss.shape == () and all(
        g.shape == p.shape for (_, g), (_, p) in zip(Pt.tree_paths(grads),
                                                     Pt.tree_paths(state.params)))
    return {"trace_s": round(time.time() - t0, 1), "data_ranks": n_data,
            "microbatch": list(next(iter(rows.values())).shape), "accum_steps": accum_steps,
            "grads_match_params": ok,
            "rank_bytes": {"params": rank_bytes(state.params, state_sh.params),
                           "moments": rank_bytes(state.opt, state_sh.opt),
                           "amax": rank_bytes(state.amax, state_sh.amax),
                           "batch": rank_bytes(batch, batch_sh)},
            "collectives": kinds, "collectives_by_call": calls,
            "collectives_note": COLLECTIVES_NOTE, **rec}


def split_collectives(cfg, mesh, state, p_sh, rows, n_data: int, accum_steps: int,
                      per_step_max) -> dict:
    """``train_cell``'s record of the "split" step's collectives a rank (the
    module docstring), or ``check_split``'s refusal."""
    try:
        St.check_split(cfg, mesh)
    except ValueError as e:
        return {"collectives_split_error": str(e)}
    group = C.TracedModelRank(mesh.shape["model"], 0)
    leaves = Pt.tree_paths(state.params, sort_keys=True)
    with C.tally() as per_step:
        mine = []
        for p, v in leaves:
            blocks, sh = Pt.split_leaf(v, p_sh[p]), p_sh[p]
            mine.append({"0": C.gather_model_block(blocks, sh, 0, META)}
                        if Pt.model_dim(sh) is not None else C.all_gather(blocks, sh, META))
    params = Pt.tree_rebuild(state.params, mine, sort_keys=True)
    with C.tally() as per_micro:
        with C.data_rank(C.DataRanks(n_data), 0), Pt.model_split(group):
            St.lm_loss_and_grads(cfg, params, state.amax, rows)
        for p, v in leaves:     # a model block's gradient reduces as the leaf's own block
            C.reduce_scatter_add(None, torch.empty(v.shape, dtype=v.dtype, device=META), p_sh[p])
    kinds, calls = collectives_record((per_step, 1), (per_micro, accum_steps), (per_step_max, 1))
    return {"collectives_split": kinds, "collectives_split_by_call": calls}


def serve_cell(cfg, shape, mesh) -> dict:
    from repro_torch.models import fold as F
    from repro_torch.models import serve_int as S

    state = St.state_shape(cfg, AdamWConfig())
    folded = F.fold_params(cfg, state.params, state.amax)
    f_sh = Pt.make_param_shardings(mesh, folded, mode="serve")
    batch = input_specs(cfg, shape)
    tok_sh = Pt.batch_sharding(mesh, batch["tokens"].ndim, tuple(batch["tokens"].shape))
    rows, n_data = _rank_batch(mesh, batch)
    rec = {"data_ranks": n_data, "batch_rows": list(rows["tokens"].shape),
           "rank_bytes": {"folded": rank_bytes(folded, f_sh),
                          "tokens": Pt.shard_nbytes(batch["tokens"], tok_sh)}}
    t0 = time.time()
    with torch.no_grad():
        if shape.kind == "prefill":
            logits, _ = S.serve_forward(cfg, folded, rows["tokens"], mode="prefill")
        else:
            cache = S.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
            rec["rank_bytes"]["cache"] = rank_bytes(cache, Pt.cache_sharding(mesh, cache))
            rank_cache = S.init_cache(cfg, rows["tokens"].shape[0], shape.seq_len, device=META)
            logits, _ = S.serve_forward(cfg, folded, rows["tokens"], cache=rank_cache,
                                        pos_offset=shape.seq_len - 1, mode="decode")
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["logits"] = list(logits.shape)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, fsdp=True, save=True,
             cfg_overrides=None, tag=""):
    shape = SHAPES[shape_name]
    cfg = get_config(arch, **(cfg_overrides or {}))
    mesh = make_production_mesh(multi_pod=multi_pod, devices=[META] * (512 if multi_pod else 256))
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "chips": mesh.size,
           "fsdp": fsdp, "tag": tag, **({"cfg_overrides": cfg_overrides} if cfg_overrides else {})}
    try:
        Pt.set_mesh_ctx(mesh)
        rec.update(train_cell(cfg, shape, mesh, fsdp=fsdp,
                              accum_steps=int(os.environ.get("REPRO_ACCUM", "4")))
                   if shape.kind == "train" else serve_cell(cfg, shape, mesh))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        Pt.set_mesh_ctx(None)
    rec["total_s"] = round(time.time() - t0, 1)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        mp = "multipod" if multi_pod else "pod"
        suffix = f"-{tag}" if tag else ""
        (RESULTS / f"{arch}--{shape_name}--{mp}{suffix}.json").write_text(json.dumps(rec, indent=1))
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {arch} x {shape_name} x {'2pod' if multi_pod else '1pod'}"
          f" total={rec['total_s']}s"
          + (f" params/rank={rec['rank_bytes'].get('params', rec['rank_bytes'].get('folded'))}"
             if rec["ok"] else f"  {rec['error'][:200]}"), flush=True)
    return rec


ALL_ARCHS = [
    "qwen2-moe-a2.7b", "mixtral-8x22b", "llama3-405b", "qwen3-4b", "yi-6b",
    "stablelm-1.6b", "jamba-1.5-large-398b", "xlstm-1.3b", "qwen2-vl-2b",
    "musicgen-medium",
]
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = ALL_SHAPES if (args.all or not args.shape) else [args.shape]
    cells = [(a, sh, mp) for a in archs for sh in shapes if cell_is_runnable(a, sh)
             for mp in pods]
    n_fail = 0
    for a, sh, mp in cells:
        rec = run_cell(a, sh, mp, fsdp=not args.no_fsdp, tag=args.tag)
        n_fail += 0 if rec["ok"] else 1
    print(f"done: {len(cells) - n_fail}/{len(cells)} cells OK")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
