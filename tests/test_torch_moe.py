"""The MoE slot of the port (``models/moe.py``, the fold's expert groups,
``serve_int._moe_int``) against the reference, on the smoke
qwen2-moe-a2.7b (4 routed experts, top-2, 2 shared experts) with the
reference's weights carried across as numpy.

* ``capacity``; ``topk_routing`` on the same logits (equal destinations,
  the gates an ulp away at most: its ``exp`` is torch's, an island; the
  flips counted); the dispatch and the combine exactly.
* The calibration forward's observations allclose, the fold equal leaf
  for leaf.
* ``_moe_int`` with the reference's routing injected: equal int8 codes;
  then with its own routing, the flipped routing choices and codes
  counted; the whole cache-less forward's differing logits counted.
* The ``ref`` engines on the paged one-shot, chunked, kv4, contiguous and
  ``spec_k=3`` layouts: equal events, tokens, counters and ``stats()``.
* The ``gpu`` backend's control flow (the plain kernel versions on CPU
  tensors): chunked prefill gives the one-shot tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import fold as JF
from repro.models import moe as JM
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.models import fold as F
from repro_torch.models import moe as M
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke(ARCH)
    params = JT.init_params(jcfg, KEY)
    amax = JT.init_amax(jcfg)
    calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
    _, obs, aux = JT.forward(jcfg, params, amax, calib)
    jfolded = JF.fold_params(jcfg, params, obs)
    return dict(jcfg=jcfg, params=params, amax=amax, calib=calib, obs=obs, aux=aux,
                jfolded=jfolded, cfg=smoke_config(ARCH),
                tfolded=F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu"))


@pytest.mark.parametrize("tokens,experts,top_k", [
    (8, 60, 4), (32, 60, 4), (96, 60, 4), (512, 60, 4), (16, 4, 2), (1, 4, 2), (700, 8, 2)])
def test_capacity_matches_reference(tokens, experts, top_k):
    assert M.capacity(tokens, experts, top_k) == JM.capacity(tokens, experts, top_k)


@pytest.mark.parametrize("t,e,k,cap", [(48, 4, 2, 4), (48, 4, 2, 30), (64, 60, 4, 6),
                                       (512, 60, 4, 43)])
def test_topk_routing_matches_reference(t, e, k, cap):
    """Equal destinations (drops included), gates within an ulp (the
    softmax's exp is an island; the count printed), aux allclose."""
    logits = (np.random.default_rng(t + e + cap).standard_normal((t, e)) * 2).astype(np.float32)
    jd, jg, jaux = JM.topk_routing(jnp.asarray(logits), k, cap)
    td, tg, taux = M.topk_routing(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jg, tg = np.asarray(jg), tg.numpy()
    np.testing.assert_allclose(tg, jg, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    print(f"routing T={t} E={e} k={k} cap={cap}: {int((tg != jg).sum())} of {tg.size} gates "
          f"differ by an ulp; {int((td.numpy() == e * cap).sum())} choices dropped")


def test_dispatch_and_combine_equal_reference():
    rng = np.random.default_rng(3)
    t, e, k, cap, d = 40, 4, 2, 12, 16
    logits = rng.standard_normal((t, e)).astype(np.float32)
    dest, gates, _ = JM.topk_routing(jnp.asarray(logits), k, cap)
    dest_t, gates_t = torch.from_numpy(np.array(dest)), torch.from_numpy(np.array(gates))
    x = rng.integers(-127, 128, (t, d)).astype(np.int8)
    want = np.asarray(JM.scatter_dispatch(jnp.asarray(x), dest, e, cap))
    np.testing.assert_array_equal(M.scatter_dispatch(torch.from_numpy(x), dest_t, e, cap).numpy(),
                                  want)
    ye = rng.integers(-127, 128, (e * cap, d)).astype(np.float32) / np.float32(128.0)
    want = np.asarray(JM.gather_combine(jnp.asarray(ye), dest, gates, jnp.float32))
    np.testing.assert_array_equal(
        M.gather_combine(torch.from_numpy(ye), dest_t, gates_t, torch.float32).numpy(), want)


def test_calibration_obs_allclose(model):
    cfg = model["cfg"]
    params = F.params_from_numpy(jax.tree.map(np.asarray, model["params"]), "cpu")
    amax = F.params_from_numpy(jax.tree.map(np.asarray, model["amax"]), "cpu")
    logits, obs, aux = T.forward(cfg, params, amax, torch.from_numpy(np.array(model["calib"])))
    want, got = _flat(jax.tree.map(np.asarray, model["obs"])), _flat(obs)
    assert want.keys() == got.keys()
    assert "/blocks/slot0/exp_in" in got and "/blocks/slot0/shr_h" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    np.testing.assert_allclose(float(aux), float(model["aux"]), rtol=1e-5)
    assert logits.shape == (2, 16, cfg.vocab_size)


def test_fold_gives_equal_integers(model):
    cfg = model["cfg"]
    params = F.params_from_numpy(jax.tree.map(np.asarray, model["params"]), "cpu")
    obs = F.params_from_numpy(jax.tree.map(np.asarray, model["obs"]), "cpu")
    got = _flat(F.fold_params(cfg, params, obs))
    want = _flat(jax.tree.map(np.asarray, model["jfolded"]))
    assert got.keys() == want.keys()
    assert got["/blocks/slot0/experts/wg/w"].shape == (cfg.n_reps, cfg.n_experts,
                                                       cfg.d_model // 2, cfg.moe_d_ff)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("b,s", [(3, 1), (1, 48), (2, 16)])
def test_moe_int_with_reference_routing_is_exact(model, b, s):
    """One MoE slot on random int8 rows: with the reference's ``dest`` and
    ``gates`` injected, the port's dispatch, experts and combine give the
    reference's codes exactly; with its own router the flipped choices and
    codes are counted (none expected, at most 0.1 % of codes allowed)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jf = jax.tree.map(lambda a: a[0], model["jfolded"]["blocks"])["slot0"]
    tf = S.layer_views(model["tfolded"], cfg.n_reps)[0]["slot0"]
    x = np.random.default_rng(b * 100 + s).integers(-127, 128, (b, s, cfg.d_model)
                                                    ).astype(np.int8)
    want = np.asarray(JS._moe_int(jnp.asarray(x), jf, jcfg))
    t = b * s
    jh = JS._ln(jnp.asarray(x), jf["ln2"], jcfg).reshape(t, cfg.d_model)
    jdest, jgates, _ = JM.topk_routing((jh.astype(jnp.float32) * jf["inv_s_mi"]) @ jf["router"],
                                       cfg.top_k, JM.capacity(t, cfg.n_experts, cfg.top_k))
    h = S._ln(torch.from_numpy(x), tf["ln2"], cfg).reshape(t, cfg.d_model)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    cap = M.capacity(t, cfg.n_experts, cfg.top_k)
    got = S._moe_experts(h, tf, cfg, torch.from_numpy(np.array(jdest)),
                         torch.from_numpy(np.array(jgates)), cap).reshape(b, s, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    dest, _, _ = S._moe_route(h, tf, cfg)
    own = S._moe_int(torch.from_numpy(x), tf, cfg).numpy()
    moved = int((dest.numpy() != np.asarray(jdest)).sum())
    diff = np.abs(own.astype(int) - want.astype(int))
    print(f"MoE slot ({b}, {s}), own router: {moved} of {dest.numel()} routing choices and "
          f"{int((diff > 0).sum())} of {diff.size} codes differ from the reference")
    assert (diff > 0).sum() <= 1e-3 * diff.size


def test_cacheless_forward_logits_flips_counted(model):
    """The whole cache-less forward on the same tokens: the logits that
    differ from the reference's are counted (the router and the flash
    prefill are float islands); greedy argmax agrees on every row."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 48)).astype(np.int32)
    want = np.asarray(JS.serve_forward(jcfg, model["jfolded"], jnp.asarray(toks))[0])
    got = S.serve_forward(cfg, model["tfolded"], torch.from_numpy(toks))[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"MoE cache-less forward (3, 48): {int((got != want).sum())} of {got.size} logits "
          f"differ; argmax agrees on {agree:.4f} of rows")
    assert agree == 1.0


def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _cycle(vocab, lens, seed=7, period=3):
    """Prompts that tile a short cycle, so prompt lookup proposes drafts."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, period), n // period + 1)[:n].astype(np.int32)
            for n in lens]


CASES = {
    "default_paged": (dict(batch_slots=3, max_len=64), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4]),
    "chunked": (dict(batch_slots=3, max_len=64, page_size=4, max_prefill_chunk=8,
                     max_batched_tokens=16), [30, 5, 19, 12], [5, 6, 4, 5]),
    "kv4": (dict(batch_slots=3, max_len=64, kv_bits=4), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4]),
    "contiguous": (dict(batch_slots=3, max_len=64, cache_layout="contiguous"),
                   [3, 11, 6, 17, 5], [4, 6, 3, 5, 4]),
    "spec_k3": (dict(batch_slots=2, max_len=64, page_size=4, spec_k=3), [3, 11, 6, 17, 5],
                [6, 8, 5, 4, 7]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference(model, case):
    kw, lens, max_new = CASES[case]
    vocab = model["cfg"].vocab_size
    prompts = _cycle(vocab, lens) if kw.get("spec_k") else _prompts(vocab, lens)
    runs = []
    for mod, cfg, folded in ((JE, model["jcfg"], model["jfolded"]),
                             (E, model["cfg"], model["tfolded"])):
        eng = mod.Engine(cfg, folded, mod.EngineConfig(**kw))
        reqs = [mod.Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, max_new)]
        for r in reqs:
            eng.submit(r)
        ticks = []
        while eng.has_work:
            ticks.append([_event(e) for e in eng.poll()])
        runs.append((eng, reqs, ticks))
    (jeng, jreqs, jticks), (teng, treqs, tticks) = runs
    assert tticks == jticks
    for j, t in zip(jreqs, treqs):
        assert t.status.value == j.status.value and t.finish_reason == j.finish_reason
        np.testing.assert_array_equal(t.out, j.out)
    assert teng.counters == jeng.counters
    assert teng.stats(check=True) == jeng.stats(check=True)
    c = teng.counters
    assert c["completed"] == len(lens)
    if case == "chunked":
        assert c["chunked_prefills"] > 0
    if case == "spec_k3":
        assert c["drafted"] > 0 and c["drafted"] == c["accepted"] + c["rejected"]


def test_gpu_backend_chunked_equals_oneshot_on_cpu(model, monkeypatch):
    """The q7 kernels' control flow (their plain versions on CPU tensors):
    chunks of 8 rows route their experts at capacity 4 like a decode tick,
    the one-shot prompts at their own; the tokens agree."""
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    cfg, tfolded = model["cfg"], model["tfolded"]
    prompts = _prompts(cfg.vocab_size, [23, 4, 13, 9], seed=5)

    def run(**kw):
        eng = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64, page_size=4,
                                                    **kw))
        reqs = eng.generate([E.Request(prompt=p, max_new_tokens=5) for p in prompts])
        return [r.out.tolist() for r in reqs], eng.counters

    one, _ = run()
    chunked, c = run(max_prefill_chunk=8, max_batched_tokens=12)
    assert c["chunked_prefills"] >= 1
    assert one == chunked
