"""The dense archs beyond yi-6b in the port against the reference, at smoke
size, with the reference's weights carried across as numpy:
stablelm-1.6b (LayerNorm, partial rotary 0.25, MHA at head_dim 64 in full
size), llama3-405b (GQA, theta 5e5) and qwen3-4b (qk-norm: an RMSNorm of
q and k inside the RoPE island).

* Every config of ``configs/`` is served; what still refuses (tensor
  parallelism) names the ROADMAP.
* The calibration forward's observations allclose, the fold equal leaf
  for leaf.
* The qk-norm island: the port's ``_rope_island`` against the reference's
  on the same codes, the flipped codes counted (its ``rsqrt`` and, for
  rows of at most 32, its sum are an ulp from XLA's); the integer stages
  with the reference's island output injected, bit for bit.
* The ``ref`` engines on the paged one-shot, chunked, kv4 and contiguous
  layouts, and qwen3-4b at ``spec_k=3``: equal events, tokens, counters
  and ``stats()``.  The reference's side is built once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import list_configs, smoke_config
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
ARCHS = ("stablelm-1.6b", "llama3-405b", "qwen3-4b")
SERVED = ARCHS + ("yi-6b", "qwen2-moe-a2.7b", "mixtral-8x22b", "bert-base",
                  "jamba-1.5-large-398b", "xlstm-1.3b", "qwen2-vl-2b", "musicgen-medium")
FLIP_FRACTION = 1e-3


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
def models():
    """Per arch: the reference's config, params, calibration tokens, obs and
    folded tree, and the port's config and folded tree, built on first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = j_smoke(arch)
            params = JT.init_params(jcfg, KEY)
            amax = JT.init_amax(jcfg)
            calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
            _, obs, _ = JT.forward(jcfg, params, amax, calib)
            jfolded = JF.fold_params(jcfg, params, obs)
            built[arch] = dict(
                jcfg=jcfg, params=params, amax=amax, calib=calib, obs=obs, jfolded=jfolded,
                cfg=smoke_config(arch),
                tfolded=F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu"))
        return built[arch]
    return get


def test_every_config_is_served_or_refused_naming_the_roadmap():
    """Every config is served: its smoke model inits, folds and runs a
    cache-less forward on the CPU.  What is refused: ``tp > 1`` on the
    lockstep engine, which has no tensor-parallel path, more ranks than the
    CPU has devices on the continuous one, and a ``serve_forward`` mesh
    without the paged pool."""
    assert set(SERVED) == set(list_configs())
    gen = torch.Generator().manual_seed(0)
    for name in SERVED:
        cfg = smoke_config(name)
        params = T.init_params(cfg, gen)
        rows = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
        toks = torch.randint(0, cfg.vocab_size, (1, *rows, 8), generator=gen)
        _, obs, _ = T.forward(cfg, params, T.init_amax(cfg, "cpu"), toks)
        logits, _ = S.serve_forward(cfg, F.fold_params(cfg, params, obs), toks)
        assert logits.shape[-2:] == (8, cfg.vocab_size) and torch.isfinite(logits).all(), name
    cfg = smoke_config("yi-6b")
    params = T.init_params(cfg, gen)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    folded = F.fold_params(cfg, params, T.forward(cfg, params, T.init_amax(cfg, "cpu"), toks)[1])
    with pytest.raises(E.EngineConfigError, match="no tensor-parallel path"):
        E.LockstepEngine(cfg, folded, E.EngineConfig(batch_slots=2, max_len=32, tp=2))
    with pytest.raises(ValueError, match="TP=2 needs 2 cpu devices, found 1"):
        E.Engine(cfg, folded, E.EngineConfig(batch_slots=2, max_len=32, tp=2))
    with pytest.raises(ValueError, match="paged KV pool"):
        S.serve_forward(cfg, folded, toks, mesh=TPMesh((torch.device("cpu"),) * 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_obs_allclose_and_fold_equal(models, arch):
    m = models(arch)
    cfg = m["cfg"]
    params = F.params_from_numpy(jax.tree.map(np.asarray, m["params"]), "cpu")
    amax = F.params_from_numpy(jax.tree.map(np.asarray, m["amax"]), "cpu")
    logits, obs, _ = T.forward(cfg, params, amax, torch.from_numpy(np.array(m["calib"])))
    want, got = _flat(jax.tree.map(np.asarray, m["obs"])), _flat(obs)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    assert logits.shape == (2, 16, cfg.vocab_size)
    obs_ref = F.params_from_numpy(jax.tree.map(np.asarray, m["obs"]), "cpu")
    got = _flat(F.fold_params(cfg, params, obs_ref))
    want = _flat(jax.tree.map(np.asarray, m["jfolded"]))
    assert got.keys() == want.keys()
    if cfg.qk_norm:
        assert "/blocks/slot0/attn_q/qn" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("hd", [32, 128])
def test_qk_norm_island_flips_counted(hd):
    """The port's qk-norm RoPE island against the reference's on the same
    int8 codes: +-1 codes on at most 0.1 %, the count printed."""
    jcfg = dataclasses.replace(j_smoke("qwen3-4b"), head_dim=hd)
    cfg = dataclasses.replace(smoke_config("qwen3-4b"), head_dim=hd)
    rng = np.random.default_rng(hd)
    h = rng.integers(-127, 128, (4, 64, 8, hd)).astype(np.int8)
    pos = (np.arange(64, dtype=np.int32)[None] + rng.integers(0, 400, (4, 1))).astype(np.int32)
    qn = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    inv, s_out = np.float32(0.0123), np.float32(90.7)
    want = np.asarray(JS._rope_island(jnp.asarray(h), inv, s_out, jnp.asarray(pos), jcfg,
                                      jnp.asarray(qn)))
    got = S._rope_island(torch.from_numpy(h), torch.tensor(inv), torch.tensor(s_out),
                         torch.from_numpy(pos), cfg, torch.from_numpy(qn)).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"qk-norm island (hd={hd}): {int((diff > 0).sum())} of {diff.size} codes differ")
    assert diff.max() <= 1 and (diff > 0).sum() <= FLIP_FRACTION * diff.size


def test_qk_norm_integer_stages_with_the_reference_island(models, monkeypatch):
    """qwen3-4b: a paged prefill chunk then 3 decode steps on the ref
    backend with the reference's island output injected into the port
    (``_rope_island`` computed by JAX): equal logits and pools, bit for
    bit.  The port's own island is then run on the same steps and its
    flipped logits counted."""
    m = models("qwen3-4b")
    jcfg, cfg, jfolded, tfolded = m["jcfg"], m["cfg"], m["jfolded"], m["tfolded"]
    own_island = S._rope_island

    def reference_island(h_i8, inv_s_in, s_out, pos, _cfg, qn=None):
        out = JS._rope_island(jnp.asarray(h_i8.numpy()), np.asarray(inv_s_in),
                              np.asarray(s_out), jnp.asarray(pos.numpy()), jcfg,
                              None if qn is None else jnp.asarray(qn.numpy()))
        return torch.from_numpy(np.array(out))

    psize, n_pages = 8, 12
    btab = np.asarray([[3, 7, 1, 0], [2, 5, 9, 0]], np.int32)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jcache = JS.init_paged_cache(jcfg, n_pages, psize)
    jl, jcache = JS.serve_forward(jcfg, jfolded, jnp.asarray(prompt), cache=jcache,
                                  pos_offset=jnp.int32(0), block_tables=jnp.asarray(btab))
    steps = [np.asarray(jl)]
    toks = []
    pos = np.array([16, 16], np.int32)
    for _ in range(3):
        toks.append(steps[-1][:, -1].argmax(-1).astype(np.int32)[:, None])
        jl, jcache = JS.serve_forward(jcfg, jfolded, jnp.asarray(toks[-1]), cache=jcache,
                                      pos_offset=jnp.asarray(pos), mode="decode",
                                      block_tables=jnp.asarray(btab))
        steps.append(np.asarray(jl))
        pos = pos + 1
    flips = {}
    for island in (reference_island, own_island):
        monkeypatch.setattr(S, "_rope_island", island)
        tcache = S.init_paged_cache(cfg, n_pages, psize, device="cpu")
        tl, tcache = S.serve_forward(cfg, tfolded, torch.from_numpy(prompt), cache=tcache,
                                     pos_offset=0, block_tables=torch.from_numpy(btab))
        got = [tl.numpy()]
        pos = np.array([16, 16], np.int32)
        for tok in toks:
            tl, tcache = S.serve_forward(cfg, tfolded, torch.from_numpy(tok), cache=tcache,
                                         pos_offset=torch.from_numpy(pos), mode="decode",
                                         block_tables=torch.from_numpy(btab))
            got.append(tl.numpy())
            pos = pos + 1
        if island is reference_island:
            for g, w in zip(got, steps):
                np.testing.assert_array_equal(g, w)
            want, have = _flat(jax.tree.map(np.asarray, jcache)), _flat(tcache)
            for k in want:
                np.testing.assert_array_equal(have[k], want[k], err_msg=k)
        flips[island.__name__] = sum(int((g != w).sum()) for g, w in zip(got, steps))
    print(f"qwen3-4b paged prefill + 3 decode steps: logits differing from the reference's "
          f"{flips} of {sum(w.size for w in steps)} (reference island injected / own island)")
    assert flips["reference_island"] == 0


def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _prompts(vocab, lens, seed=0, prefix=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, prefix)
    return [np.concatenate([head, rng.integers(0, vocab, n)]).astype(np.int32) for n in lens]


def engine_parity(m, kw, prompts, max_new):
    """The reference's and the port's ``ref`` engines on the same requests:
    equal per-tick events, tokens, statuses, counters and ``stats()``.
    Returns the port's engine."""
    runs = []
    for mod, cfg, folded in ((JE, m["jcfg"], m["jfolded"]), (E, m["cfg"], m["tfolded"])):
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
    return teng


LAYOUTS = {
    "default_paged": (dict(batch_slots=3, max_len=64), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4]),
    "chunked": (dict(batch_slots=3, max_len=64, page_size=4, max_prefill_chunk=8,
                     max_batched_tokens=16), [30, 5, 19, 12], [5, 6, 4, 5]),
    "kv4": (dict(batch_slots=3, max_len=64, kv_bits=4), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4]),
    "contiguous": (dict(batch_slots=3, max_len=64, cache_layout="contiguous"),
                   [3, 11, 6, 17, 5], [4, 6, 3, 5, 4]),
}


def test_qk_norm_spec_engine_matches_reference(models):
    """qwen3-4b at ``spec_k=3`` (prompt lookup over prompts that tile a
    short cycle, so drafts are proposed): the verify forward runs the
    qk-norm island at each slot's cursor."""
    m = models("qwen3-4b")
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(0, m["cfg"].vocab_size, 3), n // 3 + 1)[:n].astype(np.int32)
               for n in (3, 11, 6, 17, 5)]
    eng = engine_parity(m, dict(batch_slots=2, max_len=64, page_size=4, spec_k=3), prompts,
                        [6, 8, 5, 4, 7])
    c = eng.counters
    assert c["drafted"] > 0 and c["drafted"] == c["accepted"] + c["rejected"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(models, arch, layout):
    kw, lens, max_new = LAYOUTS[layout]
    m = models(arch)
    eng = engine_parity(m, kw, _prompts(m["cfg"].vocab_size, lens), max_new)
    assert eng.counters["completed"] == len(lens)
    if layout == "chunked":
        assert eng.counters["chunked_prefills"] > 0
    if layout == "kv4":
        assert eng.kv_bits == 4
