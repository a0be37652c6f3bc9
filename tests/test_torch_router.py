"""The port's replica router, asyncio server and shared prefix tier against
the reference, on the smoke yi-6b with the reference's folded weights
carried across as numpy.

Each router case of ``tests/test_serve_api.py`` runs through the port's
``ReplicaRouter`` over the port's ``ref`` engines and through the
reference's over its own: the per-tick event stream, the tokens, the
router's counters and every replica's counters must be equal, so dispatch
and affinity place each request on the same replica.  The reference's
engines are built once per shape and ``reset()`` between cases (a reset
engine is a fresh one: the tier is detached by hand).  Then the asyncio
server (stream, cancel, timeout), the tier at the engine level, and a kv4
engine whose tier round-trips its page-scale leaves.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import fold as JF
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import router as JR
from repro_torch.configs import smoke_config
from repro_torch.models import fold as F
from repro_torch.serve import engine as E
from repro_torch.serve import router as R
from repro_torch.serve import stats as SS
from repro_torch.serve.prefix import SharedPrefixTier
from repro_torch.serve.server import AsyncServer

KEY = jax.random.PRNGKey(0)
PAGED = dict(batch_slots=2, max_len=64, cache_layout="paged", page_size=4)


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


@pytest.fixture(scope="module")
def jax_engines(folded):
    """``get(n, **kw)``: n reference engines of one shape, built once (their
    compiled graphs kept) and reset to a fresh state with no tier."""
    jcfg, jfolded = folded[:2]
    pool = {}

    def get(n, **kw):
        key = tuple(sorted(kw.items()))
        engines = pool.setdefault(key, [])
        while len(engines) < n:
            engines.append(JE.Engine(jcfg, jfolded, JE.EngineConfig(**dict(PAGED, **kw))))
        for eng in engines[:n]:
            eng.reset()
            eng.prefix_tier = None
        return engines[:n]
    return get


def _port_engines(folded, n, **kw):
    return [E.Engine(folded[2], folded[3], E.EngineConfig(**dict(PAGED, **kw)))
            for _ in range(n)]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (ln,)).astype(np.int32) for ln in lens]


def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _run(router, reqs, max_ticks=500):
    """Submit, poll to the end (per-tick stats checked); returns the events
    of every tick."""
    for r in reqs:
        router.submit(r)
    ticks = []
    while router.has_work:
        assert len(ticks) < max_ticks, "router livelocked"
        ticks.append([_event(e) for e in router.poll()])
        router.stats()
        for rep in router.replicas:
            rep.stats(check=True)
    return ticks


def _both(folded, jax_engines, n, prompts, max_new, rcfg=None, prepare=None):
    """The same trace through the reference's router and the port's: equal
    events, tokens, statuses, router counters and replica counters.
    ``prepare(module, replicas)`` runs on both replica sets before routing."""
    out = []
    for mod_e, mod_r, reps in ((JE, JR, jax_engines(n)), (E, R, _port_engines(folded, n))):
        if prepare is not None:
            prepare(mod_e, reps)
        router = mod_r.ReplicaRouter(reps, mod_r.RouterConfig(**(rcfg or {})))
        reqs = [mod_e.Request(prompt=p.copy(), max_new_tokens=m) for p, m in zip(prompts, max_new)]
        ticks = _run(router, reqs)
        out.append((ticks, [(r.status.value, r.finish_reason, r.out.tolist()) for r in reqs],
                    dict(router.counters), [dict(rep.counters) for rep in reps], router, reqs))
    (jt, jr, jc, jrc, _, _), (tt, tr, tc, trc, router, reqs) = out
    assert tt == jt
    assert tr == jr
    assert tc == jc
    assert trc == jrc
    return router, reqs


def _truth(folded, prompts, max_new):
    eng = _port_engines(folded, 1)[0]
    return [r.out.tolist() for r in eng.generate(
        [E.Request(prompt=p.copy(), max_new_tokens=m) for p, m in zip(prompts, max_new)])]


def test_router_two_replicas_identical_to_single_engine(folded, jax_engines):
    prompts = _prompts(folded[2].vocab_size, [6, 10, 4, 8, 6, 12])
    router, reqs = _both(folded, jax_engines, 2, prompts, [8] * 6)
    assert [r.result().tolist() for r in reqs] == _truth(folded, prompts, [8] * 6)
    c = router.counters
    assert c["submitted"] == c["dispatched"] == c["completed"] == len(reqs)
    assert all(rep.counters["completed"] >= 1 for rep in router.replicas)
    SS.validate_router_stats(router.stats())


def test_router_bounded_queue_rejects(folded, jax_engines):
    prompts = _prompts(folded[2].vocab_size, [6] * 5)
    results = []
    for mod_e, mod_r, reps in ((JE, JR, jax_engines(1, batch_slots=1)),
                               (E, R, _port_engines(folded, 1, batch_slots=1))):
        router = mod_r.ReplicaRouter(reps, mod_r.RouterConfig(max_queue=2))
        accepted, rejected = [], 0
        for p in prompts:
            r = mod_e.Request(prompt=p.copy(), max_new_tokens=4)
            try:
                router.submit(r)
                accepted.append(r)
            except mod_r.RouterBusy:
                rejected += 1
        ticks = _run(router, [])
        results.append((rejected, ticks, [r.out.tolist() for r in accepted],
                        dict(router.counters)))
        assert all(r.status.value == "finished" for r in accepted)
    assert results[1] == results[0]
    assert results[1][0] == 3 and results[1][3]["rejected"] == 3


def test_router_failed_dispatch_surfaces_as_failed(folded, jax_engines):
    prompts = _prompts(folded[2].vocab_size, [8])
    router, (bad,) = _both(folded, jax_engines, 1, prompts, [500])
    assert bad.status is E.RequestStatus.FAILED and bad.finish_reason.startswith("error:")
    with pytest.raises(E.RequestFailed):
        bad.result()
    assert not router.has_work


def test_router_cancel_queued_and_dispatched(folded, jax_engines):
    prompts = _prompts(folded[2].vocab_size, [6, 6, 6])
    results = []
    for mod_e, mod_r, reps in ((JE, JR, jax_engines(1, batch_slots=1)),
                               (E, R, _port_engines(folded, 1, batch_slots=1))):
        router = mod_r.ReplicaRouter(reps)
        reqs = [mod_e.Request(prompt=p.copy(), max_new_tokens=8) for p in prompts]
        rids = [router.submit(r) for r in reqs]
        first = [_event(e) for e in router.poll()]          # dispatches r0 (one slot)
        ok = [router.cancel(rids[2]), router.cancel(rids[0])]   # queued, then dispatched
        ticks = _run(router, [])
        results.append((first, ok, ticks, [(r.status.value, r.out.tolist()) for r in reqs],
                        dict(router.counters), router.cancel(999), reps[0].alloc.live))
    assert results[1] == results[0]
    _, ok, _, states, counters, unknown, live = results[1]
    assert ok == [True, True] and [s for s, _ in states] == ["cancelled", "finished", "cancelled"]
    assert counters["cancelled"] == 2 and unknown is False and live == 0


def test_router_config_validates(folded):
    for kw, what in ((dict(max_queue=0), "max_queue"), (dict(min_free_pages=-1), "thresholds"),
                     (dict(max_affinity_pages=0), "max_affinity_pages"),
                     (dict(shared_tier_pages=0), "shared_tier_pages"),
                     (dict(shed_policy="yolo"), "shed_policy")):
        with pytest.raises(R.RouterConfigError, match=what):
            R.RouterConfig(**kw).validate()
    eng = _port_engines(folded, 1)[0]
    with pytest.raises(R.RouterConfigError, match="max_queue"):
        R.ReplicaRouter([eng], R.RouterConfig(max_queue=0))
    # the reference's one-release keyword shim is not ported: keywords name the config
    with pytest.raises(TypeError, match="RouterConfig"):
        R.ReplicaRouter([eng], max_queue=2)
    with pytest.raises(ValueError, match="at least one replica"):
        R.ReplicaRouter([])


@pytest.mark.parametrize("affinity", [True, False])
def test_router_affinity_steers_to_prefix_holder(folded, jax_engines, affinity):
    """Replica 1 already holds the prompt's chain: affinity places the
    request there (over the least-loaded preference for replica 0), and on
    replica 0 without it; placement and counters equal the reference's."""
    prompt = _prompts(folded[2].vocab_size, [14])[0]
    truth = _truth(folded, [prompt], [6])

    def warm(mod_e, reps):
        warm_req = mod_e.Request(prompt=prompt.copy(), max_new_tokens=6)
        reps[1].submit(warm_req)
        reps[1].run()
        assert warm_req.result().tolist() == truth[0]
        assert reps[1].prefix_store.match([int(t) for t in prompt]).n_pages == 13 // 4

    router, (req,) = _both(folded, jax_engines, 2, [prompt], [6],
                           rcfg=dict(affinity=affinity), prepare=warm)
    target = 1 if affinity else 0
    assert req.result().tolist() == truth[0]
    assert (router.counters["affinity_hits"], router.counters["affinity_misses"]) == \
        ((1, 0) if affinity else (0, 0))
    assert router.replicas[target].counters["completed"] == 1 + target
    assert router.replicas[1].counters["prefix_hits"] == (1 if affinity else 0)


def test_router_dispatch_is_deterministic_and_matches_reference(folded, jax_engines):
    base = _prompts(folded[2].vocab_size, [8], seed=21)[0]
    prompts = [np.concatenate([base, t])
               for t in _prompts(folded[2].vocab_size, [6, 4, 6, 4, 8], seed=22)]
    router, reqs = _both(folded, jax_engines, 2, prompts, [6] * 5)
    again = R.ReplicaRouter(_port_engines(folded, 2))
    reqs2 = [E.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    _run(again, reqs2)
    assert [r.out.tolist() for r in reqs2] == [r.out.tolist() for r in reqs]
    assert [rep.counters for rep in again.replicas] == [rep.counters for rep in router.replicas]
    assert again.counters == router.counters
    assert router.counters["affinity_hits"] + router.counters["affinity_misses"] == 5


def test_router_shared_tier_adoption_identical_to_single_engine(folded, jax_engines):
    """Replica 0 publishes the first request's chain; its registry is then
    reclaimed, so the second same-prefix request adopts the chain from the
    tier.  Tokens equal one engine's; published and adopted pages equal the
    reference's."""
    base = _prompts(folded[2].vocab_size, [12], seed=31)[0]
    prompts = [np.concatenate([base, t])
               for t in _prompts(folded[2].vocab_size, [6, 6], seed=32)]
    truth = _truth(folded, prompts, [6, 6])
    out = []
    for mod_e, mod_r, reps in ((JE, JR, jax_engines(2)), (E, R, _port_engines(folded, 2))):
        router = mod_r.ReplicaRouter(reps, mod_r.RouterConfig(shared_tier=True))
        assert all(rep.prefix_tier is router.prefix_tier for rep in reps)
        first = mod_e.Request(prompt=prompts[0].copy(), max_new_tokens=6)
        t1 = _run(router, [first])
        published = router.prefix_tier.n_pages
        assert published > 0 and reps[0].counters["published_pages"] == published
        taken = reps[0].alloc.alloc(reps[0].alloc.available())    # reclaim the registry
        reps[0].alloc.free_pages(taken)
        assert reps[0].prefix_store.match([int(t) for t in base]).n_pages == 0
        second = mod_e.Request(prompt=prompts[1].copy(), max_new_tokens=6)
        t2 = _run(router, [second])
        out.append((t1, t2, [first.out.tolist(), second.out.tolist()],
                    [dict(rep.counters) for rep in reps], dict(router.counters),
                    router.stats()["shared_tier_pages"]))
    assert out[1] == out[0]
    _, _, toks, counters, rc, tier_pages = out[1]
    assert toks == truth
    assert sum(c["adopted_pages"] for c in counters) > 0
    adopter = counters[1] if counters[1]["adopted_pages"] else counters[0]
    assert adopter["prefix_hits"] >= 1
    assert tier_pages >= counters[0]["published_pages"]
    assert rc["affinity_hits"] + rc["affinity_misses"] == 2


def test_router_shared_tier_rejects_ineligible_replicas(folded):
    contiguous = E.Engine(folded[2], folded[3], E.EngineConfig(
        batch_slots=2, max_len=64, cache_layout="contiguous"))
    with pytest.raises(R.RouterConfigError, match="paged"):
        R.ReplicaRouter([contiguous], R.RouterConfig(shared_tier=True))
    mixed = _port_engines(folded, 1) + _port_engines(folded, 1, page_size=8)
    with pytest.raises(R.RouterConfigError, match="page_size"):
        R.ReplicaRouter(mixed, R.RouterConfig(shared_tier=True))
    with pytest.raises(E.EngineConfigError, match="paged"):
        contiguous.attach_prefix_tier(SharedPrefixTier(page_size=4))
    paged = _port_engines(folded, 1)[0]
    with pytest.raises(E.EngineConfigError, match="page_size"):
        paged.attach_prefix_tier(SharedPrefixTier(page_size=8))
    assert paged.prefix_tier is None and contiguous.prefix_store is None


# --- the tier at the engine level ----------------------------------------------------

def _run_one(eng, prompt, max_new=6, mod=E):
    req = mod.Request(prompt=np.asarray(prompt, np.int32), max_new_tokens=max_new)
    eng.submit(req)
    while eng.has_work:
        eng.poll()
        eng.stats(check=True)
    return req.result().tolist()


def test_adopted_chain_identical_to_cold_replica(folded, jax_engines):
    """A publishes its chain, B adopts it: B's tokens equal a cold engine's
    with less prefill, and A's and B's counters equal the reference's."""
    from repro.serve.prefix import SharedPrefixTier as JTier

    prompt = np.random.default_rng(11).integers(0, folded[2].vocab_size, (18,)).astype(np.int32)
    out = []
    for mod, (cold, a, b), tier in ((JE, jax_engines(3), JTier(page_size=4)),
                                    (E, _port_engines(folded, 3), SharedPrefixTier(page_size=4))):
        truth = _run_one(cold, prompt, mod=mod)
        a.attach_prefix_tier(tier)
        assert _run_one(a, prompt, mod=mod) == truth
        b.attach_prefix_tier(tier)
        assert _run_one(b, prompt, mod=mod) == truth
        assert b.counters["prefill_tokens"] < cold.counters["prefill_tokens"]
        out.append((truth, dict(a.counters), dict(b.counters), tier.n_pages))
    assert out[1] == out[0]
    _, ca, cb, n = out[1]
    assert ca["published_pages"] == n == (18 - 1) // 4
    assert cb["adopted_pages"] == n and cb["prefix_hits"] == 1 and cb["published_pages"] == 0
    assert cb["shared_rows"] == 4 * n and cb["suffix_prefills"] == 1


def test_adoption_skipped_under_pool_pressure(folded):
    """A dry pool turns adoption into a no-op (the prompt recomputes), never
    a preemption or a crash; the tokens are the same either way."""
    prompt = np.random.default_rng(13).integers(0, folded[2].vocab_size, (18,)).astype(np.int32)
    cold, a, b = _port_engines(folded, 3)
    truth = _run_one(cold, prompt)
    tier = SharedPrefixTier(page_size=4)
    a.attach_prefix_tier(tier)
    assert _run_one(a, prompt) == truth
    b.attach_prefix_tier(tier)
    hold = b.alloc.alloc(b.alloc.available())
    req = E.Request(prompt=prompt.copy(), max_new_tokens=6)
    b.submit(req)
    b.poll()
    assert b.counters["adopted_pages"] == 0
    b.alloc.free_pages(hold)
    while b.has_work:
        b.poll()
        b.stats(check=True)
    assert req.result().tolist() == truth and b.alloc.live == 0


def test_kv4_tier_round_trips_scale_leaves(folded):
    """On the int4-packed pool the sealed payload carries every layer's
    packed rows AND page scales ('slot0.k', 'slot0.ks', ...); the adopter's
    pages hold the publisher's bytes exactly, and its tokens equal a cold
    kv4 engine's."""
    cfg, tfolded = folded[2], folded[3]
    prompt = np.random.default_rng(14).integers(0, cfg.vocab_size, (18,)).astype(np.int32)
    cold, a, b = _port_engines(folded, 3, kv_bits=4)
    truth = _run_one(cold, prompt)
    tier = SharedPrefixTier(page_size=4)
    a.attach_prefix_tier(tier)
    assert _run_one(a, prompt) == truth
    sealed = tier.adopt([int(t) for t in prompt], 4)
    assert sealed is not None and sealed.n_pages == 4
    names = {f"slot{i}.{leaf}" for i in range(len(a.cache)) for leaf in ("k", "v", "ks", "vs")}
    assert set(sealed.payload) == names
    assert sealed.payload["slot0.ks"].dtype == np.float32
    assert sealed.payload["slot0.k"].dtype == np.uint8
    src = a.alloc.prefix.match([int(t) for t in prompt], 4).pages
    b.attach_prefix_tier(tier)
    assert _run_one(b, prompt) == truth
    assert b.counters["adopted_pages"] == 4
    dst = b.alloc.prefix.match([int(t) for t in prompt], 4).pages
    for name, t in b._pool_leaves():
        leaf_a = dict(a._pool_leaves())[name]
        assert torch.equal(t[:, list(dst)], leaf_a[:, list(src)]), name


# --- the asyncio server ---------------------------------------------------------------

def _serve(core, coro_fn):
    async def run():
        server = AsyncServer(core)
        task = asyncio.ensure_future(server.serve_forever())
        try:
            return await asyncio.wait_for(coro_fn(server), timeout=120)
        finally:
            server.stop()
            await task
    return asyncio.run(run())


@pytest.mark.parametrize("core", ["engine", "router"])
def test_async_server_streams_match_reference(folded, jax_engines, core):
    prompts = _prompts(folded[2].vocab_size, [6, 10, 4])
    jeng = jax_engines(1)[0]
    truth = [r.out.tolist() for r in jeng.generate(
        [JE.Request(prompt=p.copy(), max_new_tokens=8) for p in prompts])]
    reps = _port_engines(folded, 2 if core == "router" else 1)
    target = R.ReplicaRouter(reps) if core == "router" else reps[0]

    async def go(server):
        handles = [await server.submit(E.Request(prompt=p.copy(), max_new_tokens=8))
                   for p in prompts]
        return [await h.tokens() for h in handles], [h.result().tolist() for h in handles]

    streams, results = _serve(target, go)
    assert streams == truth and results == truth


def test_async_server_cancel_mid_stream(folded):
    prompts = _prompts(folded[2].vocab_size, [6, 6])
    truth = _truth(folded, prompts, [12, 12])

    async def go(server):
        victim = E.Request(prompt=prompts[0].copy(), max_new_tokens=12)
        other = E.Request(prompt=prompts[1].copy(), max_new_tokens=12)
        hv = await server.submit(victim)
        ho = await server.submit(other)
        got = []
        async for tok in hv:
            got.append(tok)
            if len(got) == 3:
                assert hv.cancel()
        return victim, got, await ho.tokens()

    victim, got, out = _serve(_port_engines(folded, 1)[0], go)
    assert victim.status is E.RequestStatus.CANCELLED
    assert len(got) >= 3 and got == truth[0][:len(got)] and victim.out.tolist() == got
    assert out == truth[1]


def test_async_server_timeout_cancels(folded):
    prompt = _prompts(folded[2].vocab_size, [6])[0]
    eng = _port_engines(folded, 1)[0]

    async def go(server):
        req = E.Request(prompt=prompt.copy(), max_new_tokens=12)
        h = await server.submit(req, timeout=0.0)    # fires on the next loop turn
        return req, await h.tokens()

    req, toks = _serve(eng, go)
    assert req.status is E.RequestStatus.CANCELLED and req.finish_reason == "cancelled"
    assert toks == req.out.tolist() and len(toks) < 12
    assert eng.alloc.live == 0 and eng.counters["cancelled"] == 1


def test_async_server_bounds_requests_in_flight(folded):
    """``max_inflight=1``: a second submitter waits until the first
    request's stream has ended, and both get their single-engine tokens."""
    prompts = _prompts(folded[2].vocab_size, [6, 9])
    truth = _truth(folded, prompts, [5, 5])

    async def go(server):
        order = []

        async def one(i):
            h = await server.submit(E.Request(prompt=prompts[i].copy(), max_new_tokens=5))
            order.append(("admitted", i))
            toks = await h.tokens()
            order.append(("done", i))
            return toks

        first = asyncio.ensure_future(one(0))
        await asyncio.sleep(0)
        second = asyncio.ensure_future(one(1))
        return [await first, await second], order

    async def run():
        server = AsyncServer(_port_engines(folded, 1)[0], max_inflight=1)
        task = asyncio.ensure_future(server.serve_forever())
        try:
            return await asyncio.wait_for(go(server), timeout=120)
        finally:
            server.stop()
            await task

    outs, order = asyncio.run(run())
    assert outs == truth
    assert order.index(("done", 0)) < order.index(("admitted", 1))
