"""The training mesh run one OS process per rank (``launch/ranks.py``,
``launch/mesh.py::ProcessMesh``, ``sharding/collectives.py::Process``) on
the CPU over gloo, against the one-process mesh that drives every rank
itself (the ``local`` backend) and, in one case, the reference.

Two starts of the ranks run every case: one of 4 processes and one of 2,
each rank on one torch thread; the failure path takes a third, of 2.  The
cases, at smoke size (yi-6b: 2 layers, d_model 64, vocab 128, (4, 32)
batches; BERT: (4, 24); qwen2-moe: 4 experts top-2, (4, 16)):

* (a) each process collective against the local backend on the same inputs
  on (2, 1) and (2, 2), bit for bit (the gathered leaf, the owners' float32
  sums after each of two microbatches, the sole block, the max, the counts
  table and the caller's rank), and each call's tally equal to the local
  backend's tally of one rank's part of it;
* (b) 2 steps of ``jit_train_step`` on a process mesh against the same
  steps on the one-process mesh of that shape, every rank's every leaf and
  every metric bit for bit: yi-6b on (2, 1), (4, 1) and (2, 2), with 2
  microbatches on (2, 1), with int8 moments and gradient compression on
  (2, 1), BERT on (2, 1), qwen2-moe with remat on (2, 1);
* (c) one step on (2, 1) from the reference's initial state against the
  reference's jitted step, at the bounds
  ``test_torch_mesh_train.py::_against_reference`` holds the one-process
  mesh to;
* (d) the trainer: 2 steps on 4 processes with a checkpoint, equal leaf
  for leaf to the one-process (4, 1) trainer's checkpoint; a resume of it
  on 2 processes (elastic) to step 3, equal bit for bit to the one-process
  elastic resume;
* (e) a rank that raises ends the run within the group's timeout, with an
  error naming it and no child left running;
* (f) NCCL asked for without a card for each rank raises before any
  process starts.
"""
import dataclasses
import functools
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as LM
from repro_torch.launch import ranks as R
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as St
from repro_torch.train.trainer import TrainerConfig, train
from test_torch_mesh_train import SHAPE, _against_reference, _cfgs, _leaves_equal, _mesh
from test_torch_train import LR, _jinit, _torch_state

TIMEOUT_S = 120.0
BERT_OPT = A.AdamWConfig(lr=3e-3, grad_clip=1e9)
MOE_SHAPE = (4, 16)
TRAIN_SHAPE = ShapeConfig("t", SHAPE[1], SHAPE[0], "train")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The parent's one-process steps at smoke size gain nothing from
    intra-op threads (the ranks take one each); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yi_batches(cfg, n=2):
    src = JSyntheticLM(cfg.vocab_size, SHAPE[1], SHAPE[0], seed=0)
    return [src.batch_at(i) for i in range(n)]


def _bert_batches(cfg, n=2):
    out = []
    for i in range(n):
        rng = np.random.default_rng(i)
        mask = np.ones((4, 24), bool)
        mask[:, 20:] = False
        out.append({"tokens": rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32),
                    "mask": mask, "labels": np.asarray([0, 1, 0, 1], np.int32)})
    return out


def _moe_cfg():
    return dataclasses.replace(smoke_config("qwen2-moe-a2.7b"), remat=True)


def _moe_batches(cfg, n=2):
    src = JSyntheticLM(cfg.vocab_size, MOE_SHAPE[1], MOE_SHAPE[0], seed=0)
    return [src.batch_at(i) for i in range(n)]


def _collective_inputs(shape, seed):
    """Every rank's inputs of ``ranks.check_collectives`` on a ``shape``
    mesh: an (8, 6) float32 leaf split over (data, model), two microbatches
    of bf16 gradients and a tree and a counts table per data block."""
    rng = np.random.default_rng(seed)
    data = shape[0]
    grads = [[rng.normal(size=(8, 6)).astype(np.float32) for _ in range(data)]
             for _ in range(2)]
    return {"spec": ("data", "model"), "leaf": rng.normal(size=(8, 6)).astype(np.float32),
            "grads": [[torch.from_numpy(g).to(torch.bfloat16) for g in mb] for mb in grads],
            "trees": [{"a": rng.random(3).astype(np.float32),
                       "b": {"c": rng.random((2, 2)).astype(np.float32)}} for _ in range(data)],
            "counts": [rng.integers(0, 9, (2, 4)).astype(np.int32) for _ in range(data)]}


# --- the runs ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's initial state and its jitted step on the (4, 32)
    batch, fp32 moments, from zero amax."""
    jcfg, cfg = _cfgs()
    jstate = _jinit(jcfg, JA.AdamWConfig(lr=LR))
    jnew, jm = jax.jit(JSt.make_train_step(jcfg, JA.AdamWConfig(lr=LR)))(
        jstate, _yi_batches(jcfg, 1)[0])
    return cfg, jstate, jnew, jm


def _step_cases(cfg, state_path):
    """name -> (mesh shape, cfg, opt, batches, keywords of train_steps)."""
    opt = A.AdamWConfig(lr=LR)
    yi = dict(state=state_path)
    bert = smoke_config("bert-base")
    return {"yi-2x1": ((2, 1), cfg, opt, _yi_batches(cfg), yi),
            "yi-4x1": ((4, 1), cfg, opt, _yi_batches(cfg), yi),
            "yi-2x2": ((2, 2), cfg, opt, _yi_batches(cfg), yi),
            "yi-2x1-accum2": ((2, 1), cfg, opt, _yi_batches(cfg), dict(yi, accum_steps=2)),
            "yi-2x1-reference": ((2, 1), cfg, opt, _yi_batches(cfg, 1), yi),
            "yi-2x1-int8-moments-compressed": (
                (2, 1), _cfgs(grad_compress_bits=8)[1], A.AdamWConfig(lr=LR, quantize_moments=True),
                _yi_batches(cfg), {}),
            "bert-2x1": ((2, 1), bert, BERT_OPT, _bert_batches(bert), dict(bert=True)),
            "qwen2-moe-remat-2x1": ((2, 1), _moe_cfg(), opt, _moe_batches(_moe_cfg()), {})}


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Every case's per-rank results: the 4-process start, then the
    2-process one (whose trainer resumes the 4 processes' checkpoint)."""
    cfg, jstate = reference[0], reference[1]
    d = tmp_path_factory.mktemp("dist")
    state_path = str(d / "state.pt")
    torch.save(_torch_state(jstate, A.AdamWConfig(lr=LR)), state_path)
    cases = _step_cases(cfg, state_path)
    tcfg = functools.partial(TrainerConfig, ckpt_every=2, log_every=100)
    calls = {4: {}, 2: {}}
    for name, (shape, c, opt, batches, kw) in cases.items():
        calls[shape[0] * shape[1]][name] = functools.partial(
            R.train_steps, c, opt, batches, mesh_shape=shape, device_type="cpu", **kw)
    for n, shape, seed in ((4, (2, 2), 1), (2, (2, 1), 2)):
        calls[n][f"collectives-{shape[0]}x{shape[1]}"] = functools.partial(
            R.check_collectives, _collective_inputs(shape, seed), shape, "cpu")
    calls[4]["trainer-4x1"] = functools.partial(
        R.train_on_ranks, cfg, TRAIN_SHAPE, A.AdamWConfig(lr=LR),
        tcfg(steps=2, ckpt_dir=str(d / "ck4")), device_type="cpu")
    calls[2]["trainer-2x1"] = functools.partial(
        R.train_on_ranks, cfg, TRAIN_SHAPE, A.AdamWConfig(lr=LR),
        tcfg(steps=3, ckpt_dir=str(d / "ck2")), device_type="cpu")
    out, seconds = {}, {}
    for n in (4, 2):
        if n == 2:
            shutil.copytree(d / "ck4", d / "ck2")
        t0 = time.perf_counter()
        res = R.run(R.in_turn, n, backend="gloo", device_type="cpu",
                    args=(list(calls[n].values()),), timeout_s=TIMEOUT_S)
        seconds[n] = time.perf_counter() - t0
        for i, name in enumerate(calls[n]):
            out[name] = [r[i] for r in res]
    print(f"  the 4- and 2-process starts took {seconds[4]:.1f} and {seconds[2]:.1f} s")
    return {"cases": cases, "results": out, "dir": d, "state": state_path}


def _one_process(shape, cfg, opt, batches, kw, state_path):
    """The same steps on the one-process mesh of ``shape``: (the ranks'
    states, metrics per step)."""
    b0 = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    step, sh, _ = St.jit_train_step(cfg, _mesh(*shape), opt, b0, bert=kw.get("bert", False),
                                    accum_steps=kw.get("accum_steps", 1))
    if kw.get("state"):
        state = torch.load(state_path, weights_only=False)
    else:
        gen = torch.Generator()
        gen.manual_seed(0)
        state = (St.init_bert_train_state if kw.get("bert") else St.init_train_state)(
            cfg, gen, opt)
    shards, metrics = Pt.split_tree(state, sh), []
    for b in batches:
        shards, m = step(shards, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return shards, metrics, sh


# --- (a) the collectives -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_collectives_equal_the_local_backend(runs, shape):
    name = f"collectives-{shape[0]}x{shape[1]}"
    inputs = _collective_inputs(shape, 2 if shape == (2, 1) else 1)
    mesh = _mesh(*shape)
    sh = Pt.NamedSharding(mesh, inputs["spec"])
    leaf = torch.from_numpy(inputs["leaf"])
    want_tally = {}
    with C.tally() as want_tally["all_gather"]:
        gathered = C.all_gather(Pt.split_leaf(leaf, sh), sh)
    owners, sums = None, []
    for i, mb in enumerate(inputs["grads"]):
        for k, g in enumerate(mb):
            if i == 0 and k == 0:
                with C.tally() as want_tally["reduce_scatter_add"]:   # one rank's part
                    owners = C.reduce_scatter_add(owners, g, sh)
            else:
                owners = C.reduce_scatter_add(owners, g, sh)
        sums.append([o.clone() for o in owners])
    with C.tally() as want_tally["sole"]:
        sole = C.reduce_scatter_add(None, inputs["grads"][0][0], sh, sole=True)
    trees = [{"a": torch.from_numpy(t["a"]), "b": {"c": torch.from_numpy(t["b"]["c"])}}
             for t in inputs["trees"]]
    with C.tally() as want_tally["max_over_ranks"]:
        mx = C.max_over_ranks(trees)
    table = torch.stack([torch.from_numpy(c) for c in inputs["counts"]])
    want_tally["all_gather_counts"] = {("all-gather", "all_gather_counts"):
                                       [1, table.numel() * table.element_size()]}
    got = runs["results"][name]
    assert len(got) == shape[0] * shape[1]
    for r, res in enumerate(got):
        data = mesh.coords(r)["data"]
        assert torch.equal(res["gathered"], gathered)
        for i in range(2):
            assert res["sums"][i].dtype == torch.float32
            assert torch.equal(res["sums"][i], sums[i][r]), (r, i)
        assert res["sole"].dtype == torch.bfloat16 and torch.equal(res["sole"], sole[r])
        assert not _leaves_equal(res["max"], mx)
        assert torch.equal(res["counts"][0], table) and res["counts"][1] == data
        # each process call counts as the local backend counts one rank's part
        assert {k: v for k, v in res["tally"].items() if k != "reduce_scatter_add"} == \
            {k: v for k, v in want_tally.items() if k != "reduce_scatter_add"}
        calls, nbytes = want_tally["reduce_scatter_add"][("reduce-scatter",
                                                          "reduce_scatter_add")]
        assert res["tally"]["reduce_scatter_add"] == {
            ("reduce-scatter", "reduce_scatter_add"): [2 * calls, 2 * nbytes]}


# --- (b), (c) the step --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["yi-2x1", "yi-4x1", "yi-2x2", "yi-2x1-accum2", "bert-2x1",
                                  "qwen2-moe-remat-2x1", "yi-2x1-int8-moments-compressed"])
def test_process_step_equals_the_one_process_step(runs, name):
    shape, cfg, opt, batches, kw = runs["cases"][name]
    shards, metrics, _ = _one_process(shape, cfg, opt, batches, kw, runs["state"])
    got = runs["results"][name]
    assert len(got) == len(shards)
    for r, res in enumerate(got):
        assert res["metrics"] == metrics, (r, res["metrics"], metrics)
        differ = _leaves_equal(res["state"], shards[r])
        assert not differ, (r, differ[:5])
        assert res["rank_bytes"] == sum(t.numel() * t.element_size()
                                        for _, t in Pt.tree_paths(shards[r]))
        assert res["peak_bytes"] is None and len(res["ms"]) == len(batches)
    print(f"  {name}: {len(got)} ranks x {len(batches)} steps equal the one-process mesh's; "
          f"metrics {metrics}")
    if name.startswith("qwen2-moe"):
        assert all(m["aux"] > 0 for m in metrics)
        exchanges = got[0]["tally"][0][("all-gather", "all_gather_counts")][0]
        assert exchanges == cfg.n_layers        # one a MoE layer, not again in the recompute


def test_process_step_matches_reference(runs, reference):
    cfg, jstate, jnew, jm = reference
    shape, _, opt, batches, kw = runs["cases"]["yi-2x1-reference"]
    _, _, sh = _one_process(shape, cfg, opt, batches, kw, runs["state"])
    got = runs["results"]["yi-2x1-reference"]
    new = Pt.gather_tree([r["state"] for r in got], sh)
    want, wm = St.make_train_step(cfg, opt)(_torch_state(jstate, opt),
                                            {k: torch.as_tensor(v) for k, v in batches[0].items()})
    _against_reference("yi-6b on 2 processes (2, 1)", jstate, jnew, jm, new,
                       got[0]["metrics"][0], want, wm)


# --- (d) checkpoints and the trainer ----------------------------------------------------

def test_checkpoints_restore_elastically_and_the_trainer_resumes_exactly(runs, tmp_path):
    cfg = runs["cases"]["yi-2x1"][1]
    opt = A.AdamWConfig(lr=LR)
    tcfg = functools.partial(TrainerConfig, ckpt_every=2, log_every=100)
    shards4, hist4 = train(cfg, TRAIN_SHAPE, opt, tcfg(steps=2, ckpt_dir=str(tmp_path / "one")),
                           mesh=_mesh(4))
    shape = St.state_shape(cfg, opt)
    want, _ = ck.restore(tmp_path / "one", 2, shape, "cpu")
    got, meta = ck.restore(runs["dir"] / "ck4", 2, shape, "cpu")
    assert meta == {"data_step": 2, "arch": cfg.name}
    assert not _leaves_equal(got, want)
    for r, (state, hist) in enumerate(runs["results"]["trainer-4x1"]):
        assert [{k: v for k, v in h.items() if k != "step_s"} for h in hist] == \
            [{k: v for k, v in h.items() if k != "step_s"} for h in hist4]
        assert not _leaves_equal(state, shards4[r])
    # the elastic resume of the 4 processes' checkpoint on 2, one process and two
    shutil.copytree(runs["dir"] / "ck4", tmp_path / "elastic")
    shards2, hist2 = train(cfg, TRAIN_SHAPE, opt, tcfg(steps=3, ckpt_dir=str(tmp_path / "elastic")),
                           mesh=_mesh(2))
    assert len(hist2) == 1
    for r, (state, hist) in enumerate(runs["results"]["trainer-2x1"]):
        assert [{k: v for k, v in h.items() if k != "step_s"} for h in hist] == \
            [{k: v for k, v in h.items() if k != "step_s"} for h in hist2]
        assert not _leaves_equal(state, shards2[r]) and int(state.step) == 3
    saved, _ = ck.restore(runs["dir"] / "ck2", 3, shape, "cpu")
    want, _ = ck.restore(tmp_path / "elastic", 3, shape, "cpu")
    assert not _leaves_equal(saved, want)


# --- (e), (f) failure and refusal -------------------------------------------------------

def test_a_failing_rank_ends_the_run_naming_it():
    t0 = time.perf_counter()
    with pytest.raises(R.RankFailed, match="rank 1 failed") as e:
        R.run(R.fail_on, 2, backend="gloo", device_type="cpu", args=(1, "rank 1 gives up"),
              timeout_s=TIMEOUT_S)
    took = time.perf_counter() - t0
    print(f"  a failing rank ended the run in {took:.1f} s")
    assert e.value.rank == 1 and "rank 1 gives up" in str(e.value)
    assert took < TIMEOUT_S
    for pid in e.value.pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_nccl_without_a_card_per_rank_raises(monkeypatch):
    with pytest.raises(ValueError, match="NCCL runs between CUDA cards"):
        R.run(R.fail_on, 2, backend="nccl", device_type="cpu", args=(0,))
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        LM.process_devices(2, "nccl", "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs a card for each rank: 4 ranks, 1 card"):
        LM.process_devices(4, "nccl", "cuda")
    assert LM.process_devices(4, "gloo", "cuda") == (torch.device("cuda", 0),) * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert LM.process_devices(4, "nccl", "cuda") == tuple(torch.device("cuda", r)
                                                          for r in range(4))
    with pytest.raises(ValueError, match="backend must be gloo or nccl"):
        LM.process_devices(2, "mpi", "cpu")


def test_launcher_starts_the_ranks(monkeypatch):
    """``--nproc 2 --device cpu`` hands ``ranks.train_on_ranks`` to
    ``ranks.run`` over gloo on 2 CPU ranks; ``--nproc 0`` keeps the
    one-process path."""
    seen = {}

    def fake_run(fn, nproc, **kw):
        seen.update(fn=fn, nproc=nproc, **kw)
        return [(None, [])] * nproc

    monkeypatch.setattr(R, "run", fake_run)
    launch_train.main(["--arch", "yi-6b", "--smoke", "--steps", "2", "--nproc", "2",
                       "--device", "cpu"])
    assert seen["nproc"] == 2 and seen["backend"] == "gloo" and seen["device_type"] == "cpu"
    assert seen["fn"].func is R.train_on_ranks
    assert seen["fn"].keywords["mesh_shape"] == (2, 1)
