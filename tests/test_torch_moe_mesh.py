"""The port's MoE train step over more than one data rank
(``train/steps.py::jit_train_step``), qwen2-moe and mixtral at smoke size
(2 layers, d_model 128, 4 experts top-2), on one (4, 16) batch, against the
port's unsharded step and the reference's unsharded step (jitted without a
mesh: GSPMD keeps its global math, so it is the oracle for every mesh), on
the same weights carried across as numpy.

Each MoE layer's capacity, choice positions and aux loss count the whole
(micro)batch: the data ranks, one thread each, gather each other's (k, E)
routing counts at every MoE layer (``collectives.all_gather_counts``,
``moe.route``).  The draw drops choices in the unsharded step (asserted), so
a rank-local capacity (a quarter or half of the global one), a rank-local
fill (the ranks ahead not counted) or a rank-local load in the aux loss
moves the routing or the aux: each fails ``test_ranks_route_as_the_whole_
batch`` and the step comparisons (checked by mutating a copy of
``moe.route``).

Bounds, stated before these tests first ran:

* Against the port's unsharded step: ``EXACT`` of ``test_torch_train.py``
  (loss, grad norm and aux at rtol 1e-5; each gradient leaf, read as the
  first moment, within 1e-5 of its largest element; the new amax at rtol
  1e-5; params within 2 x lr).  The data ranks' gradients are summed in
  float32 in rank order, so a tolerance, not bit equality.
* Against the reference's unsharded step: ``EXACT`` with two microbatches;
  with one, the bounds of the float island that the port's own unsharded
  step crosses on this draw (``NORM_ISLAND`` of ``test_torch_mesh_train.py``:
  loss and grad norm 1e-4, gradients 2e-2 of the leaf's largest, amax 2e-2),
  measured before these bounds were written: qwen2-moe's worst gradient
  element 7.5e-4 of its leaf's largest (slot 0's expert ``wg``), mixtral's
  grad norm 1.2e-5 apart, with every MoE slot's routing identical in the two
  packages and each slot's output bit-equal given the reference's slot input.
  The aux loss at rtol 1e-5 in both cases.
* On (2, 2) each rank's blocks of the expert stacks and the router are
  ``Pt.split_tree``'s blocks of the unsharded new state: the shapes equal,
  the params within 2 x lr, the first moments within 1e-5 of the whole
  leaf's largest element.
* remat on (each super-block recomputed in the backward, the recomputation
  replaying the counts its forward received), and two remat groups, equal
  remat off bit for bit on (2, 1).
* Each rank's routing (dest, cap) equals its rows of the unsharded
  forward's routing bit for bit, on (2, 1) and (4, 1).
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.models import moe as M
from repro_torch.optim import adamw as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt
from repro_torch.train import steps as St
from test_torch_mesh_train import NORM_ISLAND, _leaves_equal, _mesh, _run_mesh, _tb
from test_torch_train import EXACT, LR, _flat, _held, _jinit, _np, _torch_state

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]
SHAPE = (4, 16)
REFERENCE_TOL = {1: NORM_ISLAND, 2: EXACT}      # by microbatches


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's initial state, the batch, and its jitted unsharded
    step with one and with two microbatches, built once per arch."""
    arch = request.param
    jcfg = j_smoke(arch)
    opt = JA.AdamWConfig(lr=LR)
    jstate = _jinit(jcfg, opt)
    batch = JSyntheticLM(jcfg.vocab_size, SHAPE[1], SHAPE[0], seed=0).batch_at(0)
    steps = {a: jax.jit(JSt.make_train_step(jcfg, opt, accum_steps=a))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}) for a in (1, 2)}
    return arch, smoke_config(arch), jstate, batch, steps


def _worst_rel(want, got):
    fw, fg = _flat(want), _flat(got)
    return max(float(np.max(np.abs(fw[k] - fg[k]) / np.maximum(np.abs(fw[k]), 1e-30)))
               for k in fw)


@pytest.mark.parametrize("shape,accum", [((2, 1), 1), ((2, 2), 1), ((4, 1), 1), ((2, 1), 2)],
                         ids=["2x1", "2x2", "4x1", "2x1-accum2"])
def test_moe_mesh_step_matches_both_unsharded_steps(reference, shape, accum):
    arch, cfg, jstate, batch, steps = reference
    jnew, jm = steps[accum]
    opt = A.AdamWConfig(lr=LR)
    want, wm = St.make_train_step(cfg, opt, accum_steps=accum)(_torch_state(jstate, opt),
                                                               _tb(batch))
    new, m, shards = _run_mesh(cfg, opt, _torch_state(jstate, opt), batch, _mesh(*shape),
                               accum_steps=accum)
    what, tol = f"{arch} on {shape} x {accum}", REFERENCE_TOL[accum]
    for k in ("loss", "grad_norm", "aux"):
        print(f"  {what} {k}: reference {float(jm[k])!r}, unsharded {float(wm[k])!r}, "
              f"mesh {float(m[k])!r}")
        rtol = EXACT[0] if k == "aux" else tol[0]
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol)
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=EXACT[0])
    if accum == 1:
        assert float(m["aux"]) > 0
    _held(f"{what} gradients against the reference", _np(jnew.opt["m"]), new.opt["m"], tol[1])
    _held(f"{what} gradients against the unsharded port", want.opt["m"], new.opt["m"],
          EXACT[1])
    jp, tp, up = _flat(_np(jnew.params)), _flat(new.params), _flat(want.params)
    assert max(float(np.max(np.abs(jp[k] - tp[k]))) for k in jp) <= 2 * LR
    assert max(float(np.max(np.abs(up[k] - tp[k]))) for k in up) <= 2 * LR
    assert _worst_rel(_np(jnew.amax), new.amax) <= tol[2]
    assert _worst_rel(want.amax, new.amax) <= EXACT[2]
    assert int(new.step) == 1 and int(new.opt["step"]) == 1
    if shape == (2, 2):
        _, sh, _ = St.jit_train_step(cfg, _mesh(*shape), opt, _tb(batch), donate=False)
        blocks, held = Pt.split_tree(want, sh), 0
        for r, s in enumerate(shards):
            for tree in ("params", "opt"):
                got = dict(Pt.tree_paths(getattr(s, tree), sort_keys=True))
                exp = dict(Pt.tree_paths(getattr(blocks[r], tree), sort_keys=True))
                whole = dict(Pt.tree_paths(getattr(want, tree), sort_keys=True))
                for p in got:
                    if "/moe/" not in f"/{p}/" or "/v/" in f"/{p}/":
                        continue
                    assert got[p].shape == exp[p].shape, (r, p)
                    gap = float((got[p] - exp[p]).abs().max())
                    assert gap <= (2 * LR if tree == "params"
                                   else EXACT[1] * float(whole[p].abs().max())), (r, p, gap)
                    held += 1
        n_moe = sum("/moe/" in f"/{p}/" for p, _ in Pt.tree_paths(want.params))
        assert n_moe >= 4 and held == len(shards) * 2 * n_moe     # params and m, every rank


def test_remat_gives_bit_equal_mesh_steps(reference):
    _, cfg0, jstate, batch, _ = reference
    opt = A.AdamWConfig(lr=LR)
    runs = {}
    for remat, groups in ((False, 0), (True, 0), (True, 2)):
        cfg = dataclasses.replace(cfg0, remat=remat, remat_groups=groups)
        new, m, _ = _run_mesh(cfg, opt, _torch_state(jstate, opt), batch, _mesh(2))
        runs[(remat, groups)] = (new, {k: float(v) for k, v in m.items()})
    base, bm = runs[(False, 0)]
    for key, (new, m) in runs.items():
        assert m == bm, key
        assert not _leaves_equal(new, base), key


def _routing(fn):
    """Runs ``fn()`` recording every MoE layer's plan: {rank or None:
    [(dest, cap), ...]} in call order (None: no data rank)."""
    seen, inner = {}, M.plan

    def recorded(probs, idx, cap, *a):
        res = inner(probs, idx, cap, *a)
        me = C._current()
        seen.setdefault(None if me is None else me.rank, []).append((res[0].clone(), cap))
        return res

    M.plan = recorded
    try:
        fn()
    finally:
        M.plan = inner
    return seen


@pytest.mark.parametrize("data", [2, 4])
def test_ranks_route_as_the_whole_batch(reference, data):
    """Each data rank's (dest, cap) at each MoE layer equals its rows of the
    unsharded step's, bit for bit; the unsharded step drops choices."""
    arch, cfg, jstate, batch, _ = reference
    opt = A.AdamWConfig(lr=LR)
    whole = _routing(lambda: St.make_train_step(cfg, opt)(_torch_state(jstate, opt),
                                                          _tb(batch)))[None]
    dropped = [int((d == cfg.n_experts * cap).sum()) for d, cap in whole]
    print(f"  {arch}: the unsharded step drops {dropped} choices at its MoE layers")
    assert sum(dropped) > 0
    seen = _routing(lambda: _run_mesh(cfg, opt, _torch_state(jstate, opt), batch,
                                      _mesh(data)))
    assert sorted(k for k in seen if k is not None) == list(range(data))
    for layer, (dest, cap) in enumerate(whole):
        t = dest.shape[1] // data
        for r in range(data):
            got, got_cap = seen[r][layer]
            assert got_cap == cap, (layer, r)
            assert torch.equal(got, dest[:, r * t:(r + 1) * t]), (layer, r)


def test_moe_mesh_errors_and_one_data_rank(reference, monkeypatch):
    """What still raises: a microbatch count that does not divide the batch,
    and a data rank's own error, which stops the others at their next
    exchange and reaches the caller.  One data rank (the (1, 2) mesh, and 4
    rows that do not split 8 ways) runs the ranks' path without threads,
    equal to the unsharded step bit for bit."""
    _, cfg, jstate, batch, _ = reference
    opt = A.AdamWConfig(lr=LR)
    with pytest.raises(ValueError, match="accum_steps=3"):
        St.jit_train_step(cfg, _mesh(2), opt, _tb(batch), accum_steps=3)
    want, wm = St.make_train_step(cfg, opt)(_torch_state(jstate, opt), _tb(batch))
    for mesh in (_mesh(1, 2), _mesh(8)):
        got, m, _ = _run_mesh(cfg, opt, _torch_state(jstate, opt), batch, mesh)
        assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in wm.items()}
        assert not _leaves_equal(got, want)
    inner = M.router_softmax

    def failing(logits):
        me = C._current()
        if me is not None and me.rank == 1:
            raise ArithmeticError("rank 1 failed in its router")
        return inner(logits)

    monkeypatch.setattr(M, "router_softmax", failing)
    raised = []

    def run():
        try:
            _run_mesh(cfg, opt, _torch_state(jstate, opt), batch, _mesh(2))
        except ArithmeticError as e:
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the step hung after a data rank failed"
    assert len(raised) == 1 and "rank 1 failed" in str(raised[0])


def test_counts_exchange_under_contention():
    """12 ranks (more than the cores) meet 200 times with the interpreter
    switching threads every microsecond: every rank receives every rank's
    table of each call, in rank order, and the group keeps nothing after."""
    n, calls = 12, 200
    group, errors = C.DataRanks(n), []
    tables = [[torch.full((2, 3), 1000 * c + r, dtype=torch.int32) for r in range(n)]
              for c in range(calls)]

    def rank(r):
        try:
            with C.data_rank(group, r):
                for c in range(calls):
                    got, me = C.all_gather_counts(tables[c][r])
                    assert me == r and torch.equal(got, torch.stack(tables[c]))
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)
            group.abort()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert not group._posted and not group._read
