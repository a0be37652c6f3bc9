"""The contiguous KV stripe of the port against the reference, on the same
numpy inputs: the contiguous decode kernel's plain version, the continuous
engine at ``cache_layout="contiguous"`` and the ``LockstepEngine``.

The decode kernel's result depends on its KV block ``bkv`` (the fp32 carry
updates once per block, with the max over the whole block), so its plain
version is block-online at ``bkv`` and is held against the reference's
Pallas kernel in interpret mode at ``bkv < Smax``, within +-1 code on at
most 0.1 % of elements (the fp32 ``exp``; the count is printed); at
``bkv == Smax`` it equals the reference's row-wise oracle.  On the ``ref``
backend both engines must equal the reference's: events, tokens, counters
and stats for the continuous engine, greedy and sampled tokens for the
lockstep one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import fixedpoint as jfx
from repro.core import qsoftmax as jqs
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_qattention as j_decode
from repro.models import fold as JF
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_qattention
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.serve import engine as E

FLIP_FRACTION = 1e-3
KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_inputs(b, hkv, g, d, smax, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (b, hkv, g, d)).astype(np.int8)
    k = rng.integers(-127, 128, (b, smax, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, smax, hkv, d)).astype(np.int8)
    s_logit = 1.0 / (rng.uniform(0.02, 0.08) * np.sqrt(d))
    M, sh = jfx.quantize_multiplier(1.0 / (s_logit * jqs.LUT_DELTA))
    return (q, k, v, np.asarray(lengths, np.int32), M, sh,
            np.float32(1.0 / s_logit), np.float32(rng.uniform(0.5, 2.0)))


def _jax(args):
    q, k, v, lens, M, sh, inv, osc = args
    return (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), jnp.int32(M),
            jnp.int32(sh), jnp.asarray(jref.make_exp_lut_q7()), jnp.float32(inv),
            jnp.float32(osc))


def _torch(args):
    q, k, v, lens, M, sh, inv, osc = args
    return (_t(q), _t(k), _t(v), _t(lens), torch.tensor(M, dtype=torch.int32),
            torch.tensor(sh, dtype=torch.int32), _t(tref.make_exp_lut_q7()),
            torch.tensor(inv), torch.tensor(osc))


@pytest.mark.parametrize("hkv,g,d,smax,bkv,lengths", [
    (2, 4, 32, 64, 16, [1, 16, 17, 64]),      # lengths on and across block bounds
    (1, 8, 32, 96, 32, [5, 40, 0, 96]),       # GQA 8, an empty (inactive) slot
    (2, 2, 64, 128, 64, [128, 3, 65]),        # two blocks, ragged
])
def test_decode_plain_vs_reference_kernel(hkv, g, d, smax, bkv, lengths):
    args = _decode_inputs(len(lengths), hkv, g, d, smax, lengths, seed=smax + bkv)
    got = decode_qattention(*_torch(args), bkv=bkv).numpy()      # CPU tensors: plain
    want = np.asarray(j_decode(*_jax(args), bkv=bkv, interpret=True), np.int32)
    diff = np.abs(got.astype(np.int32) - want)
    flips = int((diff > 0).sum())
    print(f"contiguous decode bkv={bkv} < Smax={smax} vs pallas: {flips} of {diff.size} "
          "codes differ by +-1 (fp32 exp island)")
    assert diff.max(initial=0) <= 1 and flips <= FLIP_FRACTION * diff.size


@pytest.mark.parametrize("lengths", [[1, 30, 64], [64, 64, 2]])
def test_decode_plain_with_one_block_equals_row_wise_oracle(lengths):
    """With one block covering the row the online carry is a row softmax:
    the reference's row-wise oracle (cache as (B, Hkv, Smax, D)) agrees."""
    args = _decode_inputs(len(lengths), 2, 4, 32, 64, lengths, seed=len(lengths))
    got = decode_qattention(*_torch(args), bkv=64).numpy()
    q, k, v, lens, M, sh, lut, _, osc = _jax(args)
    want = jref.decode_qattention_ref(q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
                                      lens, M, sh, lut, osc)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_result_depends_on_the_block():
    """The carry's per-block max makes bkv part of the function: on these
    inputs 8 codes move between one block of 256 keys and blocks of 16, so
    the serving path has to pass the reference's divisor_tile(512, Smax)."""
    args = _torch(_decode_inputs(4, 2, 8, 32, 256, [256, 250, 200, 177], seed=15))
    a, b = decode_qattention(*args, bkv=16), decode_qattention(*args, bkv=256)
    assert int((a != b).sum()) == 8
    assert torch.equal(ops.decode_attention_q(*args, bkv=16, impl="ref"),
                       ops.decode_attention_q(*args, bkv=16, impl="gpu"))


# --- the engines ---------------------------------------------------------------

@pytest.fixture(scope="module")
def folded():
    jcfg = j_smoke("yi-6b")
    params = JT.init_params(jcfg, KEY)
    calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
    _, obs, _ = JT.forward(jcfg, params, JT.init_amax(jcfg), calib)
    jfolded = JF.fold_params(jcfg, params, obs)
    tfolded = F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu")
    return jcfg, jfolded, smoke_config("yi-6b"), tfolded


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _drive(eng, reqs, cancel=None):
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.has_work:
        ticks.append([(e.rid, e.token, e.index, e.final, e.finish_reason) for e in eng.poll()])
        if cancel is not None and len(ticks) == cancel[0]:
            assert eng.cancel(cancel[1])
    return ticks


ENGINE_CASES = {
    "ragged": (dict(batch_slots=3, max_len=64), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4], None),
    "buckets": (dict(batch_slots=2, max_len=48, prefill_bucket=8), [8, 9, 30, 1],
                [5, 3, 6, 4], None),
    "cancel": (dict(batch_slots=3, max_len=64), [4, 9, 6], [8, 8, 8], (3, 1)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_contiguous_engine_matches_reference(folded, case):
    jcfg, jfolded, cfg, tfolded = folded
    kw, lens, max_new, cancel = ENGINE_CASES[case]
    kw = dict(kw, cache_layout="contiguous")
    prompts = _prompts(cfg.vocab_size, lens)
    jeng = JE.Engine(jcfg, jfolded, JE.EngineConfig(**kw))
    teng = E.Engine(cfg, tfolded, E.EngineConfig(**kw))
    jreqs = [JE.Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    treqs = [E.Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    assert _drive(teng, treqs, cancel) == _drive(jeng, jreqs, cancel)
    for j, t in zip(jreqs, treqs):
        assert t.status.value == j.status.value
        np.testing.assert_array_equal(t.out, j.out)
    assert teng.counters == jeng.counters
    assert teng.stats(check=True) == jeng.stats(check=True)
    assert teng.layout == "contiguous" and teng.alloc is None
    assert teng.counters["oneshot_prefills"] == len(lens)


@pytest.mark.parametrize("lens", [[7, 7, 7], [5, 12, 3, 9]])
def test_lockstep_greedy_matches_reference(folded, lens):
    """Left-padded prompts replayed through the decode forward, then greedy
    decode at one shared position: the reference's tokens."""
    jcfg, jfolded, cfg, tfolded = folded
    prompts = _prompts(cfg.vocab_size, lens, seed=3)
    kw = dict(batch_slots=4, max_len=48)
    jreqs = JE.LockstepEngine(jcfg, jfolded, JE.EngineConfig(**kw)).generate(
        [JE.Request(prompt=p, max_new_tokens=6) for p in prompts])
    treqs = E.LockstepEngine(cfg, tfolded, E.EngineConfig(**kw)).generate(
        [E.Request(prompt=p, max_new_tokens=6) for p in prompts])
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.out, j.out)
        assert t.status is E.RequestStatus.FINISHED and t.finish_reason == "length"


def test_lockstep_equals_contiguous_engine_on_equal_prompts(folded):
    """On ``ref`` the one-shot prefill rows are decode rows, so for prompts
    of one length the lockstep replay and the continuous engine agree."""
    cfg, tfolded = folded[2], folded[3]
    prompts = _prompts(cfg.vocab_size, [9, 9, 9], seed=4)
    lock = E.LockstepEngine(cfg, tfolded, E.EngineConfig(batch_slots=3, max_len=32)).generate(
        [E.Request(prompt=p, max_new_tokens=5) for p in prompts])
    cont = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=3, max_len=32,
                                                 cache_layout="contiguous")).generate(
        [E.Request(prompt=p, max_new_tokens=5) for p in prompts])
    assert [r.out.tolist() for r in lock] == [r.out.tolist() for r in cont]


def test_gpu_backend_contiguous_and_lockstep_on_cpu(folded, monkeypatch):
    """The ``gpu`` backend's control flow on the stripe (the contiguous
    decode kernel at bkv = divisor_tile(512, Smax), the blocked flash
    prefill), here through the plain versions on CPU tensors: both engines
    serve every request its full budget, the lockstep engine is
    deterministic, and no launch is counted."""
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    cfg, tfolded = folded[2], folded[3]
    prompts = _prompts(cfg.vocab_size, [23, 4, 13, 9], seed=5)
    n0 = decode_qattention.launches
    eng = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64,
                                                cache_layout="contiguous"))
    reqs = eng.generate([E.Request(prompt=p, max_new_tokens=5) for p in prompts])
    assert all(len(r.out) == 5 for r in reqs)
    assert eng.counters["oneshot_prefills"] == 4 and eng.counters["completed"] == 4

    def lockstep():
        le = E.LockstepEngine(cfg, tfolded, E.EngineConfig(batch_slots=4, max_len=64))
        return [r.out.tolist() for r in le.generate(
            [E.Request(prompt=p, max_new_tokens=4) for p in prompts])]

    assert lockstep() == lockstep()
    assert decode_qattention.launches == n0


@pytest.mark.parametrize("temperature,seed", [(1.0, 0), (0.7, 3)])
def test_lockstep_sampling_matches_reference(folded, temperature, seed):
    """Sampled decode draws the reference's tokens: the same threefry key,
    split once per sampled step, and the same categorical draw."""
    jcfg, jfolded, cfg, tfolded = folded
    prompts = _prompts(cfg.vocab_size, [5, 9, 7], seed=4)
    kw = dict(batch_slots=3, max_len=40, seed=seed)
    jreqs = JE.LockstepEngine(jcfg, jfolded, JE.EngineConfig(**kw)).generate(
        [JE.Request(prompt=p, max_new_tokens=8, temperature=temperature) for p in prompts])
    treqs = E.LockstepEngine(cfg, tfolded, E.EngineConfig(**kw)).generate(
        [E.Request(prompt=p, max_new_tokens=8, temperature=temperature) for p in prompts])
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.out, j.out)
    greedy = E.LockstepEngine(cfg, tfolded, E.EngineConfig(**kw)).generate(
        [E.Request(prompt=p, max_new_tokens=8) for p in prompts])
    assert any(not np.array_equal(g.out, t.out) for g, t in zip(greedy, treqs))


def test_lockstep_sampling_is_seeded(folded):
    cfg, tfolded = folded[2], folded[3]
    prompts = _prompts(cfg.vocab_size, [6, 6], seed=6)

    def run(seed):
        le = E.LockstepEngine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=32,
                                                           seed=seed))
        return [r.out.tolist() for r in le.generate(
            [E.Request(prompt=p, max_new_tokens=6, temperature=1.0) for p in prompts])]

    a = run(0)
    assert a == run(0) and all(len(o) == 6 for o in a)


@pytest.mark.parametrize("kw,field", [
    (dict(cache_layout="contiguous", kv_bits=4), "kv_bits"),
    (dict(cache_layout="contiguous", max_prefill_chunk=16), "chunked prefill"),
    (dict(cache_layout="contiguous", reserve_policy="ondemand"), "reserve_policy"),
])
def test_contiguous_refuses_paged_only_options(folded, kw, field):
    with pytest.raises(E.EngineConfigError, match=field):
        E.Engine(folded[2], folded[3], E.EngineConfig(batch_slots=2, max_len=32, **kw))


def test_contiguous_stripe_layout(folded):
    cfg, tfolded = folded[2], folded[3]
    cache = S.init_cache(cfg, 3, 40, device="cpu")
    assert tuple(cache["slot0"]["k"].shape) == (cfg.n_reps, 3, 40, cfg.n_kv_heads, cfg.hd)
    eng = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=3, max_len=40,
                                                cache_layout="contiguous"))
    assert eng.stats()["counters"]["completed"] == 0 and "pages_capacity" not in eng.stats()
    assert eng._bucket_len(1) == 16 and eng._bucket_len(17) == 32 and eng._bucket_len(39) == 40


def test_launcher_serves_the_contiguous_layout(capsys):
    from repro_torch.launch import serve as launcher

    launcher.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--prompts", "2",
                   "--max-new", "3", "--layout", "contiguous"])
    assert "layout=contiguous, kv_bits=8" in capsys.readouterr().out
