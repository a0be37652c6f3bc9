"""The port's tensor-parallel engine: the paged pool split over its KV
heads, one shard per rank, under one host-side scheduler.  The counterpart
of the reference's ``tests/test_tp_shard.py``: sharded greedy outputs and
counters equal the unsharded engine's on every workload shape (plain
mixed-length traffic, shared-prefix reuse, a chunked long prompt, overload
with preemption, speculative decoding, the packed pool), and the per-tick
stats invariants and allocator sweep hold.

The ranks of a port mesh are places on one or more devices; here a
``TPMesh`` names the CPU 2 or 4 times, so the tp = 4 cases run in every
lane (the reference's skip here without its forced-device flag).  The plain,
kv4 and speculative workloads are held against the JAX engine unsharded (the
reference's claim is that tp = N equals tp = 1), each built once per
module; the others against the port at tp = 1, which
``tests/test_torch_engine.py`` holds against the JAX engine.
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
from repro_torch.core import packing
from repro_torch.launch.mesh import TPMesh
from repro_torch.launch.serve import calibrated_folded
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.serve import engine as E
from repro_torch.serve.router import ReplicaRouter, RouterConfig, RouterConfigError
from repro_torch.sharding import partition as Pt

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
PAGED = dict(max_len=64, cache_layout="paged", page_size=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(tp):
    return TPMesh((CPU,) * tp)


@pytest.fixture(scope="module")
def folded():
    jcfg = j_smoke("yi-6b")            # nh = nkv = 4: tp = 4 leaves one head a rank
    params = JT.init_params(jcfg, KEY)
    calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
    _, obs, _ = JT.forward(jcfg, params, JT.init_amax(jcfg), calib)
    jfolded = JF.fold_params(jcfg, params, obs)
    return jcfg, jfolded, smoke_config("yi-6b"), \
        F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu")


def _requests(mod, cfg, lens, max_news, seed=0, prefix_len=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (prefix_len,)).astype(np.int32)
    return [mod.Request(prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, (ln,)).astype(np.int32)]), max_new_tokens=mn)
        for ln, mn in zip(lens, max_news)]


def _cycle_requests(mod, cfg, lens, max_news, seed=7, period=3):
    """Prompt-lookup-friendly prompts (tiled short cycles), so speculative
    runs make multi-token verify forwards."""
    rng = np.random.default_rng(seed)
    reqs = []
    for ln, mn in zip(lens, max_news):
        pat = rng.integers(0, cfg.vocab_size, (period,)).astype(np.int32)
        reqs.append(mod.Request(prompt=np.tile(pat, ln // period + 1)[:ln], max_new_tokens=mn))
    return reqs


def _drive(eng, requests, max_ticks=3000):
    """Submit everything and step to the end, holding the stats invariants
    and the allocator sweep every tick (a rank-divergent scheduling decision
    shows the tick it happens)."""
    for r in requests:
        eng.submit(r)
    ticks = 0
    while eng.sched.has_work:
        assert ticks < max_ticks, "engine livelocked"
        ticks += 1
        eng.step()
        g = eng.stats(check=True)
        assert g["decode_slots_active"] + g["prefill_slots"] + g["free_slots"] == eng.batch
        assert g["pages_in_use"] + g["pages_free"] + g["pages_cached_lru"] \
            == g["pages_capacity"]
    return [r.out.tolist() for r in requests]


# the workloads: (requests, EngineConfig fields beside PAGED).  The first
# three are also held against the JAX engine: prompt-lookup-friendly prompts
# of 5-8 tokens, so every prefill pads to one 8-row shape (the reference
# compiles once per shape), the 4th request admitted mid-flight; "spec" must
# also give "plain"'s tokens
CYCLE = (lambda m, c: _cycle_requests(m, c, [5, 7, 6, 8], [8, 6, 8, 6]))
LONG = (lambda m, c: _requests(m, c, [24, 4, 4], [4, 8, 8]))
TWO = (lambda m, c: _requests(m, c, [4, 4], [12, 12]))
WORKLOADS = {
    "plain": (CYCLE, dict(batch_slots=3)),
    "kv4": (CYCLE, dict(batch_slots=3, kv_bits=4)),
    "spec": (CYCLE, dict(batch_slots=3, spec_k=3)),
    "prefix": (lambda m, c: _requests(m, c, [4, 4, 6], [6, 6, 4], prefix_len=9),
               dict(batch_slots=2)),
    "chunked": (LONG, dict(batch_slots=3, max_batched_tokens=16, max_prefill_chunk=8)),
    "oneshot": (LONG, dict(batch_slots=3)),
    "starved": (TWO, dict(batch_slots=2, n_pages=6)),
    "ample": (TWO, dict(batch_slots=2)),
    "prefix_chunked": (lambda m, c: _requests(m, c, [5, 9, 3], [6, 4, 8], prefix_len=5),
                       dict(batch_slots=2, max_batched_tokens=16, max_prefill_chunk=8)),
}
JAX_CASES = ("plain", "kv4", "spec")


@pytest.fixture(scope="module")
def reference(folded):
    """The JAX engine's tokens and counters per case, run once."""
    jcfg, jfolded = folded[:2]
    runs = {}

    def get(case):
        if case not in runs:
            mk, kw = WORKLOADS[case]
            eng = JE.Engine(jcfg, jfolded, JE.EngineConfig(**kw, **PAGED))
            runs[case] = (_drive(eng, mk(JE, jcfg)), eng.counters)
        return runs[case]
    return get


@pytest.fixture(scope="module")
def port(folded):
    """The port's (tokens, engine) per workload, unsharded (``tp`` None) or
    over a ``tp``-rank mesh (1 is an explicit one-rank mesh), run once."""
    cfg, tfolded = folded[2], folded[3]
    runs = {}

    def get(name, tp=None):
        if (name, tp) not in runs:
            mk, kw = WORKLOADS[name]
            mesh = None if tp is None else _mesh(tp)
            eng = E.Engine(cfg, tfolded, E.EngineConfig(mesh=mesh, **kw, **PAGED))
            runs[name, tp] = (_drive(eng, mk(E, cfg)), eng)
        return runs[name, tp]
    return get


def _port(folded, mk, mesh=None, **kw):
    cfg, tfolded = folded[2], folded[3]
    eng = E.Engine(cfg, tfolded, E.EngineConfig(mesh=mesh, **kw))
    return _drive(eng, mk(E, cfg)), eng


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_token_identity_against_reference(reference, port, case, tp):
    """Sharded tokens and counters equal the JAX engine's unsharded ones
    (counter equality: the sharded engine made the same decisions)."""
    out, eng = port(case, tp)
    want, counters = reference(case)
    assert out == want
    assert eng.counters == counters
    assert eng.stats()["tp"] == tp and eng.mesh.size == tp
    if case == "spec":
        # speculative greedy outputs equal plain decode, and drafts were made
        assert out == reference("plain")[0]
        assert eng.counters["drafted"] > 0


def _ab(port, name, tp):
    """The port unsharded and over a ``tp``-rank mesh on one workload:
    tokens and counters equal.  Returns (tokens, unsharded, sharded)."""
    out_ref, ref = port(name)
    out_tp, eng = port(name, tp)
    assert out_tp == out_ref
    assert eng.counters == ref.counters
    return out_ref, ref, eng


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_prefix_reuse_token_identity(port, tp):
    """A shared system prompt: the one block table maps the same cached
    pages on every rank, so prefix hits and suffix-only prefills survive."""
    _, _, eng = _ab(port, "prefix", tp)
    assert eng.counters["prefix_hits"] >= 1


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_longprompt_chunked_token_identity(port, tp):
    """Every rank runs the same page-aligned chunk on its heads: sharded
    chunked equals unsharded chunked and unsharded one-shot."""
    out, _, eng = _ab(port, "chunked", tp)
    assert eng.counters["chunked_prefills"] >= 1
    assert out == port("oneshot")[0]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_overload_preemption_token_identity(port, tp):
    """A pool sized to force preemption on growth: spill and restore are
    decided once on the host for every rank; the starved sharded run
    preempts as the unsharded one does and both equal an ample pool's."""
    truth, ample = port("ample")
    assert ample.counters["preemptions"] == 0
    out, _, eng = _ab(port, "starved", tp)
    assert eng.counters["preemptions"] >= 1
    assert eng.counters["restores"] == eng.counters["preemptions"]
    assert out == truth


def test_tp1_degenerate_identity(port):
    """An explicit one-rank mesh drives the sharded path (the slice of every
    head, one shard) on a prefix + chunked workload."""
    _, ref, eng = _ab(port, "prefix_chunked", 1)
    assert eng.mesh is not None and eng.tp == 1 and ref.mesh is None
    assert isinstance(eng.cache, list) and isinstance(ref.cache, dict)
    assert eng.counters["prefix_hits"] >= 1 and eng.counters["chunked_prefills"] >= 1


def test_tp1_degenerate_speculative_identity(reference, port):
    out, ref, eng = _ab(port, "spec", 1)
    assert out == reference("plain")[0]
    assert eng.mesh is not None and ref.mesh is None
    assert eng.counters["drafted"] > 0


def test_tp_rejects_indivisible_heads(folded):
    cfg, tfolded = folded[2], folded[3]          # nkv = 4: three ranks cannot split it
    with pytest.raises(E.EngineConfigError, match="n_kv_heads"):
        E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, mesh=_mesh(3), **PAGED))
    with pytest.raises(E.EngineConfigError, match="disagrees"):
        E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, tp=4, mesh=_mesh(2), **PAGED))


def test_tp_mesh_must_sit_on_the_weights_device(folded):
    """No rank runs where the weights do not live: a rank on another
    device type is refused, so a mesh of card ranks never runs a rank on
    the CPU (here the other way round)."""
    cfg, tfolded = folded[2], folded[3]
    with pytest.raises(E.EngineConfigError, match="must be cpu devices"):
        E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, mesh=TPMesh((CPU, "meta")),
                                              **PAGED))


def test_tp_requires_paged_layout(folded):
    cfg, tfolded = folded[2], folded[3]
    with pytest.raises(E.EngineConfigError, match="paged"):
        E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64,
                                              cache_layout="contiguous", mesh=_mesh(1)))
    # a sliding-window arch's "auto" resolves to the stripe: refused at the engine
    swa = smoke_config("mixtral-8x22b")
    with pytest.raises(E.EngineConfigError, match="paged"):
        E.Engine(swa, calibrated_folded(swa, 0, device="cpu"),
                 E.EngineConfig(batch_slots=2, max_len=64, mesh=_mesh(2)))


@pytest.mark.parametrize("case", ["plain", "kv4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_pool_is_actually_sharded(folded, port, tp, case):
    """Each rank's shard is its own contiguous (n_reps, n_pages, P, Hkv/tp,
    hd) tensor on its device, holding its heads of EVERY page; after a
    workload the shards reassemble into the unsharded engine's pool bit for
    bit, and kv4's scale replicas equal each other and the unsharded
    scales."""
    cfg = folded[2]
    _, ref, eng = _ab(port, case, tp)
    hd = cfg.hd // 2 if case == "kv4" else cfg.hd
    assert len(eng.cache) == tp
    ptrs = set()
    for shard in eng.cache:
        for leaves in shard.values():
            for name in ("k", "v"):
                t = leaves[name]
                assert t.shape == (cfg.n_reps, eng.n_pages, eng.page_size,
                                   cfg.n_kv_heads // tp, hd)
                assert t.is_contiguous() and t.device == CPU
                ptrs.add(t.data_ptr())
    assert len(ptrs) == tp * 2 * len(ref.cache)          # no two ranks share storage
    back = Pt.gather_pool(eng.cache, eng.mesh)
    for slot, leaves in ref.cache.items():
        for name, t in leaves.items():
            assert torch.equal(back[slot][name], t), (slot, name)
            if t.dim() == 2:
                assert all(torch.equal(shard[slot][name], t) for shard in eng.cache)


def test_kv4_page_scales_come_from_every_head(folded, port, monkeypatch):
    """The kv4 page scale is taken over every head of a page's codes before
    the heads are split.  On these pages each rank's own heads have a
    smaller largest code than the whole page somewhere (so a scale from a
    rank's slice would differ), yet every rank's scale replicas equal the
    unsharded engine's scales, and the sharded payload its payload."""
    cfg = folded[2]
    tp = 4
    seen = []
    scale = packing.kv_page_scale

    def spy(codes, dims):
        seen.append(codes.clone())
        return scale(codes, dims)

    monkeypatch.setattr(packing, "kv_page_scale", spy)
    mk, kw = WORKLOADS["kv4"]
    out_tp, eng = _port(folded, mk, _mesh(tp), **kw, **PAGED)
    assert seen and all(c.shape[-2] == cfg.n_kv_heads for c in seen)
    h = cfg.n_kv_heads // tp
    for r in range(tp):
        assert any(bool((c[..., r * h:(r + 1) * h, :].abs().amax(dim=(-3, -2, -1))
                         < c.abs().amax(dim=(-3, -2, -1))).any()) for c in seen), r
    monkeypatch.setattr(packing, "kv_page_scale", scale)
    out, ref = port("kv4")
    assert out_tp == out and eng.counters == ref.counters
    for slot, leaves in ref.cache.items():
        for name in ("ks", "vs"):
            assert all(torch.equal(shard[slot][name], leaves[name]) for shard in eng.cache)
        back = Pt.gather_pool(eng.cache, eng.mesh)[slot]
        assert torch.equal(back["k"], leaves["k"]) and torch.equal(back["v"], leaves["v"])


def test_prefix_tier_under_tp_is_refused(folded):
    """A shared prefix tier needs a rank holding whole pages: attaching one
    to a tensor-parallel engine raises, and the router's tier takes only
    single-rank paged replicas (none here)."""
    cfg, tfolded = folded[2], folded[3]
    eng = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, mesh=_mesh(2), **PAGED))
    from repro_torch.serve.prefix import SharedPrefixTier
    with pytest.raises(E.EngineConfigError, match="prefix tier under TP"):
        eng.attach_prefix_tier(SharedPrefixTier(page_size=eng.page_size))
    with pytest.raises(RouterConfigError, match="tp=1 replica"):
        ReplicaRouter([eng], RouterConfig(shared_tier=True))
    single = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, **PAGED))
    router = ReplicaRouter([eng, single], RouterConfig(shared_tier=True))
    assert single.prefix_tier is router.prefix_tier and eng.prefix_tier is None


@pytest.mark.parametrize("mode", ["prefill", "decode", "verify"])
def test_serve_forward_over_ranks_equals_unsharded(folded, mode):
    """``serve_forward`` with a 4-rank mesh on split shards of a filled
    pool: the logits and every rank's written shard equal the unsharded
    forward's and its pool, split."""
    cfg, tfolded = folded[2], folded[3]
    mesh = _mesh(4)
    rng = np.random.default_rng(5)
    pool = S.init_paged_cache(cfg, 17, 4, device="cpu")
    for leaves in pool.values():
        for t in leaves.values():
            t.copy_(torch.as_tensor(rng.integers(-127, 128, t.shape), dtype=torch.int8))
    shards = Pt.split_pool(pool, mesh)
    btab = torch.as_tensor(rng.permutation(np.arange(1, 17))[:16].reshape(2, 8),
                           dtype=torch.int32)
    s = {"prefill": 8, "decode": 1, "verify": 4}[mode]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, s)), dtype=torch.int32)
    kw = dict(block_tables=btab, mode=mode, pos_offset=8 if mode == "prefill" else
              torch.tensor([13, 21], dtype=torch.int32))
    if mode == "verify":
        kw["verify_rows"] = torch.tensor([4, 2], dtype=torch.int32)
    want, _ = S.serve_forward(cfg, tfolded, toks, cache=pool, **kw)
    got, _ = S.serve_forward(cfg, tfolded, toks, cache=shards, mesh=mesh, **kw)
    assert torch.equal(got, want)
    for r, shard in enumerate(Pt.split_pool(pool, mesh)):
        for name in ("k", "v"):
            assert torch.equal(shards[r]["slot0"][name], shard["slot0"][name])
    with pytest.raises(ValueError, match="one pool shard per rank"):
        S.serve_forward(cfg, tfolded, toks, cache=shards[:2], mesh=mesh, **kw)
    with pytest.raises(ValueError, match="KV heads"):
        S.serve_forward(cfg, tfolded, toks, cache=Pt.split_pool(pool, _mesh(2)) * 2,
                        mesh=mesh, **kw)
