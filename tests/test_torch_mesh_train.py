"""The port's train step over a device mesh (``train/steps.py::
jit_train_step``), its trainer on a mesh and the elastic restore, against the
reference at smoke size (yi-6b: 2 layers, d_model 64, vocab 128, (4, 32)
batches), on the same weights carried across as numpy.

A port mesh names the CPU once per rank, so every mesh shape runs here.
The reference runs its step jitted without a mesh: sharding changes where
its values live, not what they are (GSPMD), so its unsharded step is the
oracle for every mesh, built once per module.

Tolerances (stated before the tests first ran, except where said):

* A sharded step against the port's unsharded step: ``EXACT`` of
  ``test_torch_train.py`` (loss and grad norm at rtol 1e-5, each gradient
  leaf within 1e-5 of its largest element, read as the first moment, the new
  amax at rtol 1e-5).  The port sums the data ranks' gradients in its own
  float order, so it is held at a tolerance, not bit for bit; the (1, 1)
  mesh equals the unsharded step bit for bit, and so does a mesh that splits
  only the state (data 1).
* Against the reference: on this draw (the (4, 32) batch) the port's
  unsharded step itself crosses the norms' float island of ROADMAP §3 (found
  when these tests first ran: norm2's gamma gradient 0.41 % of its leaf's
  largest element apart, 63.8 % of the gradient elements beyond 1e-5, the
  loss 3.0e-6), so every step against the reference is held at the bounds
  ``test_torch_train.py`` states for that island, ``NORM_ISLAND`` (loss and
  grad norm 1e-4, gradients 2e-2 of the leaf's largest, amax 2e-2; params
  within 2 x lr), and against the unsharded port at ``EXACT``.
* Gradient compression quantizes the reduced gradient: a float-order
  difference can move an element across a rounding boundary, one code step.
  Against the unsharded step, at most 0.1 % of the gradient's elements may
  differ beyond 1e-5 of their leaf's largest, none by more than one code
  step.
* The trainer: the first step from a common state at ``NORM_ISLAND``; a
  later step drifts, since AdamW moves a parameter whose gradient is near 0
  by about lr in the sign of its gradient, which a float difference can
  flip: losses within 2e-4 and grad norms within 2e-2, relative.

Each of the reference's global reductions has a test that fails when the
rank-local shortcut is taken (checked by mutating a copy of the step): the
observed max at a zero amax, the compression's amax, the grad norm and its
clip, an int8 moment's per-vector scale.
"""
import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import bert as JB
from repro.optim import adamw as JA
from repro.train import checkpoint as jck
from repro.train import steps as JSt
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import train as jtrain
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_source
from repro_torch.launch import elastic_resume
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as St
from repro_torch.train.trainer import TrainerConfig, train
from test_torch_train import (EXACT, ISLAND, KEY, LR, _flat, _held, _jinit, _np,
                              _t, _torch_state)

CPU = torch.device("cpu")
NORM_ISLAND = ISLAND["llama3-405b"]     # the norms' float island's bounds
SMOKE = dict(n_layers=2, d_model=64, vocab_size=128)
SHAPE = (4, 32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(data, model=1):
    return Mesh(np.array([CPU] * (data * model), dtype=object).reshape(data, model),
                ("data", "model"))


def _cfgs(**quant):
    jcfg, cfg = j_smoke("yi-6b", **SMOKE), smoke_config("yi-6b", **SMOKE)
    if quant:
        jcfg = dataclasses.replace(jcfg, quant=dataclasses.replace(jcfg.quant, **quant))
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, **quant))
    return jcfg, cfg


def _batch(cfg, step=0):
    return JSyntheticLM(cfg.vocab_size, SHAPE[1], SHAPE[0], seed=0).batch_at(step)


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _run_mesh(cfg, opt, state, batch, mesh, **kw):
    """One step of ``jit_train_step`` on ``mesh`` from the unsharded
    ``state``: (the new state gathered whole, metrics, the ranks' states)."""
    step, sh, _ = St.jit_train_step(cfg, mesh, opt, _tb(batch), donate=False, **kw)
    shards, m = step(Pt.split_tree(state, sh), _tb(batch))
    return Pt.gather_tree(shards, sh), m, shards


def _leaves_equal(a, b):
    pa, pb = Pt.tree_paths(a, sort_keys=True), Pt.tree_paths(b, sort_keys=True)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return [p for (p, x), (_, y) in zip(pa, pb) if x.dtype != y.dtype or not torch.equal(x, y)]


@pytest.fixture(scope="module")
def reference():
    """The reference's state and its jitted step's result, fp32 moments,
    from zero amax."""
    jcfg, cfg = _cfgs()
    opt = JA.AdamWConfig(lr=LR)
    jstate = _jinit(jcfg, opt)
    jnew, jm = jax.jit(JSt.make_train_step(jcfg, opt))(jstate, _batch(jcfg))
    return cfg, jstate, jnew, jm


def _against_reference(what, jstate, jnew, jm, new, m, want, wm, tol=NORM_ISLAND):
    """The sharded step's new state and metrics against the reference's at
    ``tol`` and against the port's unsharded step (``want``, ``wm``) at
    ``EXACT``."""
    for k in ("loss", "grad_norm"):
        print(f"  {what} {k}: reference {float(jm[k])!r}, unsharded {float(wm[k])!r}, "
              f"mesh {float(m[k])!r}")
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol[0])
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=EXACT[0])
    _held(f"{what} gradients against the reference", _np(jnew.opt["m"]), new.opt["m"], tol[1])
    _held(f"{what} gradients against the unsharded port", want.opt["m"], new.opt["m"], EXACT[1])
    jp, tp, up = _flat(_np(jnew.params)), _flat(new.params), _flat(want.params)
    assert max(float(np.max(np.abs(jp[k] - tp[k]))) for k in jp) <= 2 * LR
    assert max(float(np.max(np.abs(up[k] - tp[k]))) for k in up) <= 2 * LR
    for ref, rtol in ((_flat(_np(jnew.amax)), tol[2]), (_flat(want.amax), EXACT[2])):
        got = _flat(new.amax)
        worst = max(float(np.max(np.abs(ref[k] - got[k]) / np.maximum(np.abs(ref[k]), 1e-30)))
                    for k in ref)
        assert worst <= rtol, (what, worst)
    assert int(new.step) == 1 and int(new.opt["step"]) == 1


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
def test_mesh_step_matches_reference(reference, shape):
    cfg, jstate, jnew, jm = reference
    opt = A.AdamWConfig(lr=LR)
    want, wm = St.make_train_step(cfg, opt)(_torch_state(jstate, opt), _tb(_batch(cfg)))
    new, m, shards = _run_mesh(cfg, opt, _torch_state(jstate, opt), _batch(cfg), _mesh(*shape))
    _against_reference(f"yi-6b on {shape}", jstate, jnew, jm, new, m, want, wm)
    # every rank holds its block of the split leaves, on its device
    wq = [s.params["blocks"]["slot0"]["attn"]["wq"] for s in shards]
    assert all(w.is_contiguous() and w.device == CPU for w in wq)
    assert wq[0].shape == (cfg.n_reps, cfg.d_model // shape[0], cfg.n_heads * cfg.hd // shape[1])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_state_only_mesh_equals_unsharded_step(reference, shape, accum):
    """One data rank: the (1, 1) mesh, and a model axis that splits only
    the state, give the unsharded step's loss, metrics and every leaf bit for
    bit."""
    cfg, jstate, _, _ = reference
    opt = A.AdamWConfig(lr=LR)
    batch = _batch(cfg)
    want, wm = St.make_train_step(cfg, opt, accum_steps=accum)(_torch_state(jstate, opt),
                                                               _tb(batch))
    got, m, _ = _run_mesh(cfg, opt, _torch_state(jstate, opt), batch, _mesh(*shape),
                          accum_steps=accum)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in wm.items()}
    assert not _leaves_equal(got, want)


def test_mesh_accumulation_matches_unsharded_step(reference):
    """Microbatch i is rows [i B/a, (i+1) B/a) of the global batch, split
    over the data ranks: on (2, 1) with 2 microbatches, the unsharded
    step's at ``EXACT`` (against the reference in
    ``test_mesh_accumulation_compression_and_int8_moments_match_reference``)."""
    cfg, jstate, _, _ = reference
    opt = A.AdamWConfig(lr=LR)
    want, wm = St.make_train_step(cfg, opt, accum_steps=2)(_torch_state(jstate, opt),
                                                          _tb(_batch(cfg)))
    new, m, _ = _run_mesh(cfg, opt, _torch_state(jstate, opt), _batch(cfg), _mesh(2),
                          accum_steps=2)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=EXACT[0])
    _held("2 microbatches on (2, 1) against the unsharded port", want.opt["m"], new.opt["m"],
          EXACT[1])


def test_mesh_bert_step_matches_reference():
    """BERT on (2, 1): against the reference at the island bounds every
    BERT step crosses (``ISLAND``), and against the port's unsharded step at
    ``EXACT``."""
    jcfg, cfg = j_smoke("bert-base"), smoke_config("bert-base")
    opt, topt = JA.AdamWConfig(lr=3e-3, grad_clip=1e9), A.AdamWConfig(lr=3e-3, grad_clip=1e9)
    params = jax.jit(lambda k: JB.init_bert_params(jcfg, k))(KEY)
    jstate = JSt.TrainState(params, JA.init_state(params, opt), JB.init_bert_amax(jcfg),
                            jax.numpy.zeros((), jax.numpy.int32))
    rng = np.random.default_rng(0)
    mask = np.ones((4, 24), bool)
    mask[:, 20:] = False
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32),
             "mask": mask, "labels": np.asarray([0, 1, 0, 1], np.int32)}
    jnew, jm = jax.jit(JSt.make_bert_train_step(jcfg, opt))(jstate, batch)
    new, m, _ = _run_mesh(cfg, topt, _torch_state(jstate, topt), batch, _mesh(2), bert=True)
    loss_rtol, grad_tol, _ = ISLAND["bert-base"]
    print(f"  bert-base on (2, 1): loss {float(m['loss'])!r}, reference {float(jm['loss'])!r}")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=loss_rtol)
    assert float(m["acc"]) == float(jm["acc"])
    _held("bert-base on (2, 1) gradients", _np(jnew.opt["m"]), new.opt["m"], grad_tol)
    want, wm = St.make_bert_train_step(cfg, topt)(_torch_state(jstate, topt), _tb(batch))
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=EXACT[0])
    _held("bert-base on (2, 1) against the port unsharded", want.opt["m"], new.opt["m"], EXACT[1])
    assert int(new.step) == 1


def test_mesh_accumulation_compression_and_int8_moments_match_reference(reference):
    """(2, 2) with 2 microbatches, int8 gradient compression and int8
    moments against the reference's step at ``NORM_ISLAND`` (the dequantized first moment within
    2e-2 of each leaf's largest element: one compression code step is 1/127
    of it), and against the port's unsharded step: the params within 2 x lr
    and every moment code equal but at most 0.5 % of them, each one code
    apart.  The compressed gradient takes discrete values, so a moment often
    sits on a rounding tie, where an ulp of the reduction's order flips its
    code: 396 of 361,088 (0.11 %) when this test first ran without the
    microbatches, against a bound of 0.1 % stated before that run; without
    compression none flips (``test_int8_moments_take_whole_vectors``)."""
    jcfg, cfg = _cfgs(grad_compress_bits=8)
    opt = JA.AdamWConfig(lr=LR, quantize_moments=True)
    topt = A.AdamWConfig(lr=LR, quantize_moments=True)
    j0 = reference[1]
    jstate = JSt.TrainState(j0.params, JA.init_state(j0.params, opt), j0.amax, j0.step)
    jnew, jm = jax.jit(JSt.make_train_step(jcfg, opt, accum_steps=2))(jstate, _batch(jcfg))
    want, wm = St.make_train_step(cfg, topt, accum_steps=2)(_torch_state(jstate, topt),
                                                           _tb(_batch(cfg)))
    new, m, _ = _run_mesh(cfg, topt, _torch_state(jstate, topt), _batch(cfg), _mesh(2, 2),
                          accum_steps=2)
    for k in ("loss", "grad_norm"):
        print(f"  2 microbatches, compressed, int8 moments on (2, 2) {k}: reference "
              f"{float(jm[k])!r}, unsharded {float(wm[k])!r}, mesh {float(m[k])!r}")
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=NORM_ISLAND[0])
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=EXACT[0])

    def dequant(tree):
        return T.tree_map(lambda q: np.asarray(q[0], np.float64) / np.asarray(q[1], np.float64),
                          tree)

    _held("compressed, int8 m against the reference", dequant(_np(jnew.opt["m"])),
          dequant(T.tree_map(lambda q: (q.codes.numpy(), q.scale.numpy()), new.opt["m"])),
          NORM_ISLAND[1], NORM_ISLAND[1])
    jp, tp, up = _flat(_np(jnew.params)), _flat(new.params), _flat(want.params)
    assert max(float(np.max(np.abs(jp[k] - tp[k]))) for k in jp) <= 2 * LR
    assert max(float(np.max(np.abs(up[k] - tp[k]))) for k in up) <= 2 * LR
    off = total = 0
    for mom in ("m", "v"):
        for a, b in zip(T.tree_leaves(want.opt[mom]), T.tree_leaves(new.opt[mom])):
            d = (a.codes.int() - b.codes.int()).abs()
            assert int(d.max()) <= 1
            off, total = off + int((d > 0).sum()), total + d.numel()
    print(f"  compressed, int8 moments on (2, 2): {off} of {total} moment codes differ from "
          "the unsharded port's")
    assert off <= 5e-3 * total


# --- the global reductions, each against its rank-local shortcut ---------------------

def _unsharded_and_mesh(cfg, opt, state_fn, batch, mesh, **kw):
    want, wm = St.make_train_step(cfg, opt)(state_fn(), _tb(batch))
    got, m, shards = _run_mesh(cfg, opt, state_fn(), batch, mesh, **kw)
    return want, wm, got, m, shards


def test_zero_amax_quantizes_with_the_global_max(reference):
    """From zero amax every site quantizes with the global batch's observed
    max: on (2, 1) the loss equals the unsharded step's to 1e-6, and the new
    amax (the EMA of the max over ranks) to 1e-6.  A rank's own max moves
    the loss by ~1e-4."""
    cfg, jstate, _, _ = reference
    opt = A.AdamWConfig(lr=LR)
    assert all(bool((t == 0).all()) for t in T.tree_leaves(_torch_state(jstate, opt).amax))
    want, wm, got, m, _ = _unsharded_and_mesh(cfg, opt, lambda: _torch_state(jstate, opt),
                                              _batch(cfg), _mesh(2))
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-6)
    for a, b in zip(T.tree_leaves(want.amax), T.tree_leaves(got.amax)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)


def test_compression_quantizes_the_reduced_gradient(reference):
    """The compression's per-leaf amax is the reduced gradient's: on (2, 1)
    the compressed gradient (read as the first moment) equals the unsharded
    step's but for at most 0.1 % of elements, each one code step apart.
    Compressing each rank's gradient before the reduction moves most
    elements."""
    _, jstate, _, _ = reference
    _, cfg = _cfgs(grad_compress_bits=8)
    opt = A.AdamWConfig(lr=LR)
    want, _, got, _, _ = _unsharded_and_mesh(cfg, opt, lambda: _torch_state(jstate, opt),
                                             _batch(cfg), _mesh(2))
    off = total = 0
    for a, b in zip(T.tree_leaves(want.opt["m"]), T.tree_leaves(got.opt["m"])):
        step = float(a.abs().max()) / 127          # one code step of (1 - b1) g
        d = (a.double() - b.double()).abs()
        assert float(d.max()) <= step * 1.01
        off, total = off + int((d > 1e-5 * float(a.abs().max())).sum()), total + d.numel()
    print(f"  compression on (2, 1): {off} of {total} gradient elements a code step apart")
    assert off <= 1e-3 * total


def test_grad_norm_and_clip_are_global(reference):
    """At grad_clip 0.1 (every step clips) the grad norm is the reduced
    gradient's, in ``adamw.global_norm``'s order: equal to the unsharded
    step's to 1e-6 on (2, 2), and the clipped gradient (the first moment)
    within ``EXACT`` of it."""
    cfg, jstate, _, _ = reference
    opt = A.AdamWConfig(lr=LR, grad_clip=0.1)
    want, wm, got, m, _ = _unsharded_and_mesh(cfg, opt, lambda: _torch_state(jstate, opt),
                                              _batch(cfg), _mesh(2, 2))
    assert float(wm["grad_norm"]) > 10 * opt.grad_clip
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=1e-6)
    _held("clipped gradients on (2, 2)", want.opt["m"], got.opt["m"], EXACT[1])


def test_int8_moments_take_whole_vectors(reference):
    """int8 moments on (1, 2): wq's codes split on their last axis (the
    vectors the scales span), and the step equals the unsharded one bit for
    bit, so each scale is its whole vector's."""
    cfg, jstate, _, _ = reference
    opt = A.AdamWConfig(lr=LR, quantize_moments=True)
    want, wm, got, m, shards = _unsharded_and_mesh(cfg, opt, lambda: _torch_state(jstate, opt),
                                                   _batch(cfg), _mesh(1, 2))
    codes = [s.opt["m"]["blocks"]["slot0"]["attn"]["wq"] for s in shards]
    n = cfg.n_heads * cfg.hd
    assert all(c.codes.shape[-1] == n // 2 and c.scale.shape[-1] == 1 for c in codes)
    assert torch.equal(torch.cat([c.codes for c in codes], -1),
                       want.opt["m"]["blocks"]["slot0"]["attn"]["wq"].codes)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in wm.items()}
    assert not _leaves_equal(got, want)


def test_int8_moment_init_equals_reference(reference):
    """The int8 moments' initial codes and per-vector scales (built without
    quantizing the zeros) equal the reference's ``init_state``, leaf for
    leaf."""
    _, jstate, _, _ = reference
    want = JA.init_state(jstate.params, JA.AdamWConfig(quantize_moments=True))
    params = _torch_state(jstate, A.AdamWConfig()).params
    got = A.init_state(params, A.AdamWConfig(quantize_moments=True))
    for mom in ("m", "v"):
        w = dict(jck._paths(want[mom]))
        g = dict(Pt.tree_paths(got[mom], sort_keys=True))
        assert w.keys() == g.keys()
        for k in w:
            assert str(np.asarray(w[k]).dtype) == str(g[k].dtype)[6:], k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("donate", [False, True])
def test_donation(reference, donate):
    """``donate=False`` leaves every tensor of the given state as it was;
    ``donate=True`` writes the new params and moments into the given
    shards."""
    cfg, jstate, _, _ = reference
    opt = A.AdamWConfig(lr=LR)
    step, sh, _ = St.jit_train_step(cfg, _mesh(2), opt, _tb(_batch(cfg)), donate=donate)
    shards = Pt.split_tree(_torch_state(jstate, opt), sh)
    before = [Pt.tree_rebuild(s, [v.clone() for _, v in Pt.tree_paths(s)]) for s in shards]
    new, _ = step(shards, _tb(_batch(cfg)))
    same = [bool(torch.equal(a, b)) for s, c in zip(shards, before)
            for (_, a), (_, b) in zip(Pt.tree_paths(s), Pt.tree_paths(c))]
    wq = [(s.params["blocks"]["slot0"]["attn"]["wq"], n.params["blocks"]["slot0"]["attn"]["wq"])
          for s, n in zip(shards, new)]
    if donate:
        assert not all(same)
        assert all(a is b for a, b in wq)
    else:
        assert all(same)
        assert all(a.data_ptr() != b.data_ptr() for a, b in wq)


# --- the trainer, the elastic restore, the launcher's meshes -------------------------

def test_trainer_matches_reference_through_a_resume(reference, tmp_path):
    """Both trainers start from the reference's initial state (a step-0
    checkpoint).  The reference trains 5 steps on an Auto-axes (1, 1) mesh
    (its ``make_host_mesh`` fails under jax 0.9, ROADMAP §3), checkpointing
    at 3 and 5; the port trains 3 steps on a (1, 1) mesh, then resumes to
    5.  The first step at ``NORM_ISLAND``, later steps within the stated
    drift; and the port resumed from the reference's own step-3 checkpoint
    runs exactly step 3 (exactly-once data), at ``NORM_ISLAND`` of the
    reference's step 3."""
    jcfg, cfg = _cfgs()
    opt, topt = JA.AdamWConfig(lr=LR), A.AdamWConfig(lr=LR)
    jck.save(tmp_path / "ref", 0, reference[1], meta={"data_step": 0})
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, want = jtrain(jcfg, JShapeConfig("t", SHAPE[1], SHAPE[0], "train"), jmesh, opt,
                     JTrainerConfig(steps=5, ckpt_every=3, ckpt_dir=str(tmp_path / "ref"),
                                    log_every=100))
    shape = ShapeConfig("t", SHAPE[1], SHAPE[0], "train")
    got = []
    for steps in (3, 5):
        shards, hist = train(cfg, shape, topt, TrainerConfig(
            steps=steps, ckpt_every=3, ckpt_dir=str(tmp_path / "port"), log_every=100),
            mesh=_mesh(1))
        got += hist
    assert len(want) == len(got) == 5 and int(shards[0].step) == 5
    shutil.copytree(tmp_path / "ref" / "step_000003", tmp_path / "from_ref" / "step_000003")
    _, resumed = train(cfg, shape, topt, TrainerConfig(
        steps=4, ckpt_dir=str(tmp_path / "from_ref"), log_every=100), mesh=_mesh(1))
    assert len(resumed) == 1
    for i, (a, b) in enumerate(zip(want, got)):
        rel = [abs(a[k] - b[k]) / abs(a[k]) for k in ("loss", "grad_norm")]
        print(f"  step {i}: reference loss {a['loss']!r} gn {a['grad_norm']!r}; port "
              f"{b['loss']!r} {b['grad_norm']!r}; relative {rel[0]:.3g} {rel[1]:.3g}")
        if i == 0:
            assert max(rel) <= NORM_ISLAND[0]
        else:
            assert rel[0] <= 2e-4 and rel[1] <= 2e-2
    rel = [abs(want[3][k] - resumed[0][k]) / abs(want[3][k]) for k in ("loss", "grad_norm")]
    print(f"  step 3 resumed from the reference's checkpoint: relative {rel}")
    assert max(rel) <= NORM_ISLAND[0]
    for d in ("ref", "port"):
        assert ck.latest_step(tmp_path / d) == 5
    jm = json.loads((tmp_path / "ref" / "step_000005" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "step_000005" / "manifest.json").read_text())
    assert [(x["path"], x["shape"], x["dtype"]) for x in jm["leaves"]] == \
        [(x["path"], x["shape"], x["dtype"]) for x in tm["leaves"]]
    assert jm["meta"] == tm["meta"] == {"data_step": 5, "arch": cfg.name}


def test_elastic_restore_equals_the_in_memory_resplit(tmp_path):
    """3 steps on (1, 1) with a checkpoint, then a resume on (2, 1) to step
    5: the restored shards equal the saved leaves, and the run equals the
    same (1, 1) state re-split in memory and stepped on batches 3 and 4, bit
    for bit, every rank's every leaf (exactly-once data: 2 steps run)."""
    _, cfg = _cfgs()
    opt = A.AdamWConfig(lr=LR)
    shape = ShapeConfig("t", SHAPE[1], SHAPE[0], "train")
    state, _ = train(cfg, shape, opt, TrainerConfig(steps=3, ckpt_every=3,
                                                    ckpt_dir=str(tmp_path), log_every=100),
                     device="cpu")
    step, sh, _ = St.jit_train_step(cfg, _mesh(2), opt, _tb(_batch(cfg)))
    restored, meta = ck.restore(tmp_path, 3, St.state_shape(cfg, opt), shardings=sh)
    assert meta["data_step"] == 3 and len(restored) == 2
    saved, _ = ck.restore(tmp_path, 3, state)
    assert not _leaves_equal(Pt.gather_tree(restored, sh), saved)
    assert not _leaves_equal(saved, state)
    shards, hist = train(cfg, shape, opt, TrainerConfig(steps=5, ckpt_dir=str(tmp_path),
                                                        log_every=100), mesh=_mesh(2))
    assert len(hist) == 2 and int(shards[0].step) == int(shards[1].step) == 5
    source = make_source(cfg, shape, seed=0)
    mem, losses = Pt.split_tree(state, sh), []
    for i in (3, 4):
        mem, m = step(mem, {k: torch.as_tensor(v) for k, v in source.batch_at(i).items()})
        losses.append(float(m["loss"]))
    assert losses == [h["loss"] for h in hist]
    for a, b in zip(shards, mem):
        assert not _leaves_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1)])
def test_one_data_rank_reduces_without_a_float32_copy(shape):
    """A sole contribution (one data rank, one microbatch) has no sum to
    take: each rank's block is the gradient's own, in its dtype; over more
    data ranks the owners' sums are float32 tensors of their own."""
    g = torch.arange(32, dtype=torch.bfloat16).reshape(4, 8)
    sh = Pt.NamedSharding(_mesh(*shape), ("data", "model"))
    sole = shape[0] == 1
    blocks = C.reduce_scatter_add(None, g, sh, sole=sole)
    assert [b.shape for b in blocks] == [(4 // shape[0], 8 // shape[1])] * (shape[0] * shape[1])
    assert torch.equal(Pt.gather_leaf(blocks, sh).to(torch.float32), g.to(torch.float32))
    for b in blocks:
        assert (b.dtype, b.untyped_storage().data_ptr() == g.untyped_storage().data_ptr()) \
            == ((torch.bfloat16, True) if sole else (torch.float32, False))


def test_meshes_and_the_launcher_refusing_a_production_mesh():
    host = make_host_mesh(device_type="cpu")
    assert host.shape == {"data": 1, "model": 1} and host.devices == (CPU,)
    meta = [torch.device("meta")] * 512
    pod, multi = make_production_mesh(devices=meta), make_production_mesh(True, devices=meta)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.coords(511) == {"pod": 1, "data": 15, "model": 15}
    assert multi.coords(17) == {"pod": 0, "data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 256 devices, found 1"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs a multiple of 2"):
        make_host_mesh(2, device_type="cpu")


def test_elastic_resume_example_runs_on_two_ranks(capsys):
    shards, hist = elastic_resume.main(["--ranks", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "phase 2 (elastic resume on mesh 2x1)" in out
    assert len(shards) == 2 and int(shards[0].step) == 10 and len(hist) == 4
    assert "ran 4 new steps" in out
