"""The port's continuous-batching engine against the reference engine, on the
same folded weights (carried across as numpy) and the same requests.

On the CPU the port takes its ``ref`` kernel backend, the row-exact q8
datapath of the reference's ``ref`` backend, so the two engines must agree
tick by tick: the same TokenEvent stream, the same greedy tokens and the
same counters.  Then the port's ``gpu`` backend control flow (the plain
versions standing in for the CUDA kernels on CPU tensors): chunked and
one-shot prefill give the same tokens.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import fold as JF
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import fold as F
from repro_torch.serve import engine as E
from repro_torch.serve.prefix import SharedPrefixTier

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folded():
    jcfg = j_smoke("yi-6b")
    params = JT.init_params(jcfg, KEY)
    calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
    _, obs, _ = JT.forward(jcfg, params, JT.init_amax(jcfg), calib)
    jfolded = JF.fold_params(jcfg, params, obs)
    tfolded = F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu")
    return jcfg, jfolded, smoke_config("yi-6b"), tfolded


def _prompts(vocab, lens, seed=0, prefix=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, prefix)
    return [np.concatenate([head, rng.integers(0, vocab, n)]).astype(np.int32) for n in lens]


def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _drive(eng, reqs, cancel=None):
    """Submit everything, poll to the end; ``cancel=(tick, rid)`` cancels
    ``rid`` right after that tick.  Returns the per-tick event stream."""
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.has_work:
        ticks.append([_event(e) for e in eng.poll()])
        if cancel is not None and len(ticks) == cancel[0]:
            assert eng.cancel(cancel[1])
    return ticks


def _both(folded, kw, prompts, max_new, eos=None, cancel=None):
    jcfg, jfolded, cfg, tfolded = folded
    jeng = JE.Engine(jcfg, jfolded, JE.EngineConfig(**kw))
    teng = E.Engine(cfg, tfolded, E.EngineConfig(**kw))
    jreqs = [JE.Request(prompt=p, max_new_tokens=m, eos_token=eos)
             for p, m in zip(prompts, max_new)]
    treqs = [E.Request(prompt=p, max_new_tokens=m, eos_token=eos)
             for p, m in zip(prompts, max_new)]
    jt = _drive(jeng, jreqs, cancel)
    tt = _drive(teng, treqs, cancel)
    assert tt == jt
    for j, t in zip(jreqs, treqs):
        assert t.status.value == j.status.value and t.finish_reason == j.finish_reason
        np.testing.assert_array_equal(t.out, j.out)
    assert teng.counters == jeng.counters
    assert teng.stats(check=True) == jeng.stats(check=True)
    return teng, treqs


CASES = {
    "default_paged": (dict(batch_slots=3, max_len=64), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4], 0),
    "shared_prefix": (dict(batch_slots=2, max_len=64, page_size=8), [5, 9, 3], [4, 4, 3], 16),
    "chunked": (dict(batch_slots=3, max_len=64, page_size=4, max_prefill_chunk=8,
                     max_batched_tokens=16), [30, 5, 19, 12], [5, 6, 4, 5], 0),
    "starved_pool": (dict(batch_slots=3, max_len=64, page_size=4, n_pages=8),
                     [6, 5, 7], [12, 12, 12], 0),
    "full_reserve": (dict(batch_slots=3, max_len=64, page_size=4, n_pages=9,
                          reserve_policy="full"), [6, 5, 7, 3], [10, 10, 10, 4], 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference(folded, case):
    kw, lens, max_new, prefix = CASES[case]
    eng, _ = _both(folded, kw, _prompts(folded[2].vocab_size, lens, prefix=prefix), max_new)
    c = eng.counters
    assert c["completed"] == len(lens)
    if case == "shared_prefix":
        assert c["prefix_hits"] > 0
    if case == "chunked":
        assert c["chunked_prefills"] > 0
    if case == "starved_pool":
        assert c["preemptions"] >= 1 and c["restores"] == c["preemptions"]
    if case == "full_reserve":
        assert c["pool_wait_ticks"] > 0 and c["preemptions"] == c["grown_pages"] == 0


def test_engine_cancel_mid_decode_matches_reference(folded):
    prompts = _prompts(folded[2].vocab_size, [4, 9, 6])
    eng, reqs = _both(folded, dict(batch_slots=3, max_len=64), prompts, [8, 8, 8],
                      cancel=(3, 1))
    assert reqs[1].status is E.RequestStatus.CANCELLED and 0 < len(reqs[1].out) < 8
    with pytest.raises(E.RequestCancelled):
        reqs[1].result()
    assert eng.counters["cancelled"] == 1 and eng.counters["completed"] == 2


def test_engine_deadline_shed_matches_reference(folded):
    """One slot: the third request is still waiting at its deadline tick
    and is shed through the cancellation path, in both engines alike."""
    jcfg, jfolded, cfg, tfolded = folded
    prompts = _prompts(cfg.vocab_size, [4, 5, 6])
    kw = dict(batch_slots=1, max_len=64)
    out = []
    for mod, c, f in ((JE, jcfg, jfolded), (E, cfg, tfolded)):
        eng = mod.Engine(c, f, mod.EngineConfig(**kw))
        reqs = [mod.Request(prompt=p, max_new_tokens=3, deadline_tick=d)
                for p, d in zip(prompts, (None, None, 2))]
        out.append((_drive(eng, reqs), [r.status.value for r in reqs], eng.counters))
    assert out[1] == out[0]
    assert out[1][1] == ["finished", "finished", "cancelled"]
    assert out[1][2]["shed_deadline"] == 1


def test_engine_eos_matches_reference(folded):
    """EOS is the third greedy token of request 0, at its FIRST occurrence in
    the stream (a token may repeat before index 2)."""
    cfg = folded[2]
    prompts = _prompts(cfg.vocab_size, [7, 5])
    eng = E.Engine(cfg, folded[3], E.EngineConfig(batch_slots=2, max_len=64))
    (free, _) = eng.generate([E.Request(prompt=p, max_new_tokens=6) for p in prompts])
    eos = int(free.out[2])
    first = free.out.tolist().index(eos)
    _, reqs = _both(folded, dict(batch_slots=2, max_len=64), prompts, [6, 6], eos=eos)
    assert reqs[0].finish_reason == "eos"
    assert reqs[0].out.tolist() == free.out[:first + 1].tolist()


def test_stats_schema_keys_match_reference(folded):
    jcfg, jfolded, cfg, tfolded = folded
    jst = JE.Engine(jcfg, jfolded, JE.EngineConfig(batch_slots=2, max_len=32)).stats()
    tst = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=32)).stats()
    assert tst.keys() == jst.keys() and tst["counters"].keys() == jst["counters"].keys()


@pytest.mark.parametrize("kw,what", [
    (dict(mesh=TPMesh((torch.device("cpu"),) * 2)), "prefix tier under TP.*ROADMAP"),
    (dict(mesh=object()), "mesh must be a launch.mesh.TPMesh"),
])
def test_unported_options_raise_naming_the_roadmap(folded, kw, what):
    """What the port refuses: a shared prefix tier under TP, which the
    reference refuses too naming its ROADMAP (a tensor-parallel engine
    itself is served, ``tests/test_torch_tp.py``), and a mesh that is not a
    ``TPMesh``."""
    with pytest.raises(E.EngineConfigError, match=what):
        eng = E.Engine(folded[2], folded[3], E.EngineConfig(**kw))
        eng.attach_prefix_tier(SharedPrefixTier(page_size=eng.page_size))


def test_keyword_options_raise_type_error(folded):
    with pytest.raises(TypeError, match="EngineConfig"):
        E.Engine(folded[2], folded[3], btach_slots=2)
    with pytest.raises(TypeError, match="EngineConfig"):
        E.LockstepEngine(folded[2], folded[3], btach_slots=2)


def test_gpu_backend_chunked_equals_oneshot_on_cpu(folded, monkeypatch):
    """The ``gpu`` backend's control flow (q7 paged prefill and decode
    kernels, here computed by their plain versions on CPU tensors)."""
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    cfg, tfolded = folded[2], folded[3]
    prompts = _prompts(cfg.vocab_size, [23, 4, 13, 9], prefix=8)

    def run(**kw):
        eng = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64, page_size=4,
                                                    **kw))
        reqs = eng.generate([E.Request(prompt=p, max_new_tokens=5) for p in prompts])
        return [r.out.tolist() for r in reqs], eng.counters

    one, c1 = run()
    chunked, c2 = run(max_prefill_chunk=8, max_batched_tokens=12)
    assert one == chunked
    assert c1["prefix_hits"] >= 1 and c2["chunked_prefills"] >= 1
