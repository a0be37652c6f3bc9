"""The port's dry run (``launch/dryrun.py``) on ``meta`` devices: yi-6b,
llama3-405b, qwen2-moe-a2.7b and mixtral-8x22b ``train_4k`` on the 256-rank
pod and the 512-rank two-pod mesh trace one data rank's loss and backward at
its microbatch (256 / 16 / 4 = 4 rows on one pod, 256 / 32 / 4 = 2 on two;
a MoE arch's rank routes as rank 0 of its data ranks, its counts exchange
included), and each rank's bytes of params, moments and batch equal those
JAX's ``NamedSharding.shard_shape`` gives for the reference's shardings on
an ``AbstractMesh`` of the same shape.  The cell's ``collectives`` equal
the step's worked out from those shardings: an all-gather of every split
param (its whole bytes), and per microbatch a reduce-scatter of each split
param's float32 block or an all-reduce of a whole one, and each MoE layer's
(data ranks, k, E) int32 counts gathered; one all-reduce of each observed
max.  ``hlo_cost`` holds the traced rank's bytes by dtype.  The "split"
step's collectives (``collectives_split``) of a MoE cell equal those worked
out from the same shardings and the config: a model-split param gathered
over the data axes into its model block, the others as above, and per
microbatch model coordinate 0's model-group collectives
(``test_torch_megatron_moe.model_group_collectives``, as its process ranks
are held to); a cell whose mesh ``check_split`` refuses records the refusal.

Every config runs at its published widths and one layer
(``cfg_overrides``): a traced layer at S = 4,096 costs ~1 s of meta ops,
and the bytes of a deeper stack add per layer what one layer adds.  A cell
forced to fail is recorded as failing and the sweep goes on; a decode cell
records its cache's bytes per rank.
"""
import json
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.sharding import partition as JPt
from repro.train import steps as JSt
from repro_torch.launch import dryrun as D
from test_torch_megatron_moe import model_group_collectives

ONE_LAYER = {"n_layers": 1}
_CELLS = {}     # (arch, multi_pod) -> the cell's record, traced once a module


def _rank_bytes(tree, shardings):
    return sum(int(np.prod(s.shard_shape(v.shape))) * np.dtype(v.dtype).itemsize
               for v, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)))


def _mesh(multi_pod):
    return (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("arch", ["yi-6b", "llama3-405b", "qwen2-moe-a2.7b", "mixtral-8x22b"])
def test_train_cells_trace_with_the_reference_bytes_per_rank(arch, multi_pod, tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    rec = _CELLS[(arch, multi_pod)] = D.run_cell(arch, "train_4k", multi_pod,
                                                 cfg_overrides=ONE_LAYER)
    saved = json.loads((tmp_path / f"{arch}--train_4k--{'multipod' if multi_pod else 'pod'}"
                        ".json").read_text())
    assert saved == rec
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == (512 if multi_pod else 256) and rec["grads_match_params"]
    assert rec["data_ranks"] == (32 if multi_pod else 16)
    assert rec["microbatch"] == [256 // rec["data_ranks"] // 4, 4096]
    cfg, mesh = j_get_config(arch, **ONE_LAYER), _mesh(multi_pod)
    state = jax.eval_shape(lambda k: JSt.init_train_state(
        cfg, k, JA.AdamWConfig(quantize_moments=True)), jax.random.PRNGKey(0))
    p_sh = JPt.make_param_shardings(mesh, state.params)
    want = {"params": _rank_bytes(state.params, p_sh),
            "moments": sum(_rank_bytes(state.opt[k], JPt.make_param_shardings(mesh, state.opt[k]))
                           for k in ("m", "v")) + 4,
            "amax": _rank_bytes(state.amax, jax.tree.map(lambda _: JPt.replicated(mesh),
                                                          state.amax)),
            "batch": 256 * 4096 * 4 // rec["data_ranks"]}
    print(f"  {arch} train_4k on {rec['chips']} ranks: bytes a rank {rec['rank_bytes']}")
    assert rec["rank_bytes"] == want
    accum, n_data = rec["accum_steps"], rec["data_ranks"]
    coll = {k: {"count": 0, "bytes": 0} for k in D.COLLECTIVE_KINDS}

    def add(kind, n, nbytes):
        coll[kind]["count"] += n
        coll[kind]["bytes"] += nbytes

    for v, sh in zip(jax.tree.leaves(state.params), jax.tree.leaves(p_sh)):
        block = sh.shard_shape(v.shape)
        if tuple(block) != tuple(v.shape):
            add("all-gather", 1, math.prod(v.shape) * np.dtype(v.dtype).itemsize)
            add("reduce-scatter", accum, accum * math.prod(block) * 4)
        else:
            add("all-reduce", accum, accum * math.prod(v.shape) * 4)
    for a in jax.tree.leaves(state.amax):
        add("all-reduce", 1, math.prod(a.shape) * 4)
    n_moe = cfg.n_reps * sum(f == "moe" for _, f in JT.slot_kinds(cfg))
    add("all-gather", accum * n_moe, accum * n_moe * n_data * cfg.top_k * cfg.n_experts * 4)
    print(f"  {arch} train_4k on {rec['chips']} ranks: collectives a rank a step "
          f"{rec['collectives']}; bytes by dtype {rec['hlo_cost']['bytes_by_dtype']}")
    assert rec["collectives"] == coll
    assert rec["collectives_by_call"].get("all_gather_counts", {"count": 0})["count"] == \
        accum * n_moe
    assert "hlo_cost_error" not in rec and rec["hlo_cost"]["bytes_by_dtype"]["float32"] > 0


def test_a_failing_cell_is_recorded_and_serve_cells_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)

    def fails(*a, **k):
        raise FloatingPointError("a cell forced to fail")

    with monkeypatch.context() as m:
        m.setattr(D.St, "lm_loss_and_grads", fails)
        moe = D.run_cell("qwen2-moe-a2.7b", "train_4k", False, cfg_overrides=ONE_LAYER)
    assert not moe["ok"] and moe["error"] == "FloatingPointError: a cell forced to fail"
    rec = D.run_cell("yi-6b", "decode_32k", False, cfg_overrides=ONE_LAYER)
    assert rec["ok"], rec.get("traceback")
    assert rec["batch_rows"] == [128 // 16, 1] and rec["logits"] == [8, 1, 64000]
    cfg, mesh = j_get_config("yi-6b", **ONE_LAYER), _mesh(False)
    cache = jax.eval_shape(lambda: JS.init_cache(cfg, 128, 32768))
    assert rec["rank_bytes"]["cache"] == _rank_bytes(cache, JPt.cache_sharding(mesh, cache))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen2-moe-a2.7b--train_4k--pod.json", "yi-6b--decode_32k--pod.json"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_moe_train_cell_records_the_split_steps_collectives(multi_pod, tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    arch = "qwen2-moe-a2.7b"
    rec = _CELLS.get((arch, multi_pod)) or D.run_cell(arch, "train_4k", multi_pod,
                                                       cfg_overrides=ONE_LAYER)
    mixtral = _CELLS.get(("mixtral-8x22b", multi_pod)) or D.run_cell(
        "mixtral-8x22b", "train_4k", multi_pod, cfg_overrides=ONE_LAYER)
    assert rec["ok"] and mixtral["ok"], (rec.get("traceback"), mixtral.get("traceback"))
    assert "collectives_split" not in mixtral
    assert mixtral["collectives_split_error"] == ("model_compute='split' needs n_kv_heads = 8 to "
                                                  "divide by the model axis of 16")
    cfg, mesh = j_get_config(arch, **ONE_LAYER), _mesh(multi_pod)
    tcfg = D.get_config(arch, **ONE_LAYER)
    state = jax.eval_shape(lambda k: JSt.init_train_state(
        cfg, k, JA.AdamWConfig(quantize_moments=True)), jax.random.PRNGKey(0))
    p_sh = JPt.make_param_shardings(mesh, state.params)
    accum, n_data, m = rec["accum_steps"], rec["data_ranks"], mesh.shape["model"]
    want = {}

    def add(key, nbytes, times=1):
        if times:
            c = want.setdefault(key, [0, 0])
            c[0] += times
            c[1] += nbytes * times

    for v, sh in zip(jax.tree.leaves(state.params), jax.tree.leaves(p_sh)):
        block, size = sh.shard_shape(v.shape), np.dtype(v.dtype).itemsize
        model = [i for i, ax in enumerate(sh.spec)
                 if "model" in (ax if isinstance(ax, tuple) else (ax,))]
        whole = list(v.shape)
        for i in model:
            whole[i] //= m
        if tuple(block) != tuple(whole):        # split over the data axes
            add(("all-gather", "all_gather_data" if model else "all_gather"),
                math.prod(whole) * size)
        add(("reduce-scatter" if tuple(block) != tuple(v.shape) else "all-reduce",
             "reduce_scatter_add"), math.prod(block) * 4, accum)
    for a in jax.tree.leaves(state.amax):
        add(("all-reduce", "max_over_ranks"), math.prod(a.shape) * 4)
    for _ in range(accum):
        model_group_collectives(tcfg, m, n_data, tuple(rec["microbatch"]), True, add)
    kinds = {k: {"count": 0, "bytes": 0} for k in D.COLLECTIVE_KINDS}
    for (kind, _), (n, nbytes) in want.items():
        kinds[kind]["count"] += n
        kinds[kind]["bytes"] += nbytes
    calls = {}
    for (_, fn), (n, nbytes) in want.items():
        c = calls.setdefault(fn, {"count": 0, "bytes": 0})
        c["count"] += n
        c["bytes"] += nbytes
    print(f"  {arch} train_4k on {rec['chips']} ranks, \"split\": a rank's collectives a step "
          f"{rec['collectives_split_by_call']}; \"gather\": {rec['collectives_by_call']}")
    assert rec["collectives_split_by_call"] == calls
    assert rec["collectives_split"] == kinds
    assert "gather_from_model" not in calls and calls["model_sum"]["count"] > 0
