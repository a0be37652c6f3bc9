"""The int4-packed paged KV pool (``kv_bits=4``) of the port against the
reference, on the same numpy inputs.

The packing formulas (page scale, quantize, dequantize) must equal the
reference's as it runs them: jitted, where XLA turns the scale's division
by 7 into a multiply by float32(1/7).  The plain versions of the two
packed-pool kernels must equal the reference's oracles and its Pallas
kernels in interpret mode, except for +-1 codes on at most 0.1 % of
elements (the fp32 ``exp`` of the online carry; the count is printed).
The port's ``ref`` engine at ``kv_bits=4`` must equal the reference's
``ref`` engine in events, tokens, counters and stats.  Then the ``gpu``
backend's control flow (the plain versions standing in for the CUDA
kernels on CPU tensors) serves kv4 one-shot and chunked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import fixedpoint as jfx
from repro.core import packing as jpk
from repro.core import qsoftmax as jqs
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_qattention_q4 as j_decode_q4
from repro.kernels.prefill_attention import paged_prefill_qattention_q4 as j_prefill_q4
from repro.models import fold as JF
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.core import packing as tpk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import paged_decode_qattention_q4
from repro_torch.kernels.prefill_attention import paged_prefill_qattention_q4
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.serve import engine as E

FLIP_FRACTION = 1e-3
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_lsb_flips(got, want, what):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    flips = int((diff > 0).sum())
    print(f"{what}: {flips} of {diff.size} codes differ by +-1 (fp32 exp island)")
    assert diff.max(initial=0) <= 1, what
    assert flips <= FLIP_FRACTION * diff.size, (what, flips)


# --- packing -----------------------------------------------------------------

def _amax_rows():
    """Row a holds codes whose largest magnitude is a, for a in 0..127."""
    codes = np.zeros((128, 6), np.int8)
    for a in range(128):
        codes[a] = [a, -(a // 2), 0, a // 3, -a, 1 if a else 0]
    return codes


def test_kv_page_scale_equals_jitted_reference_for_every_amax():
    codes = _amax_rows()
    jitted = np.asarray(jax.jit(jax.vmap(jpk.kv_page_scale))(jnp.asarray(codes)))
    port = tpk.kv_page_scale(_t(codes), dims=(1,)).numpy()
    assert port.dtype == np.float32
    np.testing.assert_array_equal(port, jitted)
    # the trap: eager JAX divides by 7 exactly, and lands elsewhere on 69
    # of the 127 nonzero values of amax
    eager = np.array([np.asarray(jpk.kv_page_scale(jnp.asarray(c))) for c in codes])
    assert int((eager != jitted).sum()) == 69


@pytest.mark.parametrize("shape", [(5, 8, 2, 32), (3, 16, 4, 128), (2, 4, 1, 64)])
def test_quantize_dequantize_page_equals_reference(shape):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    codes[0] = 0                                   # an all-zero page: scale 1/7
    codes[-1, :, :, ::3] = 127                     # the largest codes
    jscale = jax.jit(jax.vmap(jpk.kv_page_scale))(jnp.asarray(codes))
    jq = jax.jit(jpk.quantize_kv_page)(jnp.asarray(codes), jscale[:, None, None, None])
    jd = jax.jit(jpk.dequantize_kv_page)(jq, jscale[:, None, None, None])
    tscale = tpk.kv_page_scale(_t(codes), dims=(1, 2, 3))
    tq = tpk.quantize_kv_page(_t(codes), tscale[:, None, None, None])
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tpk.dequantize_kv_page(tq, tscale[:, None, None, None]).numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tpk.dequantize_kv_pool(tq, tscale).numpy(),
                                  np.asarray(jpk.dequantize_kv_pool(jq, jscale)))


def test_every_int4_code_dequantizes_as_the_reference():
    """All 16 nibble codes in both planes under a spread of scales."""
    lo, hi = np.meshgrid(np.arange(16), np.arange(16))
    packed = (lo | (hi << 4)).astype(np.uint8).reshape(1, 256, 1, 1)
    scales = np.float32([1 / 7, 0.5, 3 / 7, 9.857142, 18.142857]).reshape(-1, 1, 1, 1)
    packed = np.broadcast_to(packed, (len(scales), 256, 1, 1)).copy()
    want = jpk.dequant_int4_codes(jpk.unpack_int4_planar(jnp.asarray(packed), axis=-1),
                                  jnp.asarray(scales))
    got = tpk.dequantize_kv_page(_t(packed), _t(scales))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the two packed-pool kernels' plain versions --------------------------------

def _pack_pool(pool):
    scale = jax.jit(jax.vmap(jpk.kv_page_scale))(jnp.asarray(pool))
    packed = jpk.quantize_kv_page(jnp.asarray(pool), scale[:, None, None, None])
    return np.asarray(packed), np.asarray(scale)


def _scalars(d):
    s_logit = 1.0 / (0.05 * np.sqrt(d))
    M, sh = jfx.quantize_multiplier(1.0 / (s_logit * jqs.LUT_DELTA))
    return M, sh, np.float32(1.0 / s_logit), np.float32(1.0)


def _chains(rng, rows, nb, n_pages, psize):
    perm = iter(rng.permutation(np.arange(1, n_pages)))
    btab = np.zeros((len(rows), nb), np.int32)
    for bb, ln in enumerate(rows):
        for i in range(-(-int(ln) // psize)):
            btab[bb, i] = next(perm)
    return btab


def _both_args(arrays, scal):
    M, sh, inv, osc = scal
    jargs = (*[jnp.asarray(a) for a in arrays], jnp.int32(M), jnp.int32(sh),
             jnp.asarray(jref.make_exp_lut_q7()), jnp.float32(inv), jnp.float32(osc))
    targs = (*[_t(a) for a in arrays], torch.tensor(M, dtype=torch.int32),
             torch.tensor(sh, dtype=torch.int32), _t(tref.make_exp_lut_q7()),
             torch.tensor(inv), torch.tensor(osc))
    return jargs, targs


@pytest.mark.parametrize("psize,lengths", [
    (64, [1, 37, 64]),          # one page covers every slot
    (16, [1, 23, 48]),          # cross-page fp32 carry
    (8, [5, 17, 40]),           # many ragged pages
])
def test_paged_decode_q4_plain_vs_reference(psize, lengths):
    b, hkv, g, d = 3, 2, 4, 64
    nb = 64 // psize
    n_pages = b * nb + 1
    rng = np.random.default_rng(psize)
    q = rng.integers(-64, 65, (b, hkv, g, d)).astype(np.int8)
    kp, ks = _pack_pool(rng.integers(-64, 65, (n_pages, psize, hkv, d)).astype(np.int8))
    vp, vs = _pack_pool(rng.integers(-64, 65, (n_pages, psize, hkv, d)).astype(np.int8))
    btab = _chains(rng, lengths, nb, n_pages, psize)
    jargs, targs = _both_args((q, kp, vp, ks, vs, btab, np.int32(lengths)), _scalars(d))
    got = paged_decode_qattention_q4(*targs).numpy()          # CPU tensors: plain
    _assert_lsb_flips(got, jref.paged_decode_qattention_q4_ref(*jargs), "q4 decode vs oracle")
    _assert_lsb_flips(got, j_decode_q4(*jargs, interpret=True), "q4 decode vs pallas")


@pytest.mark.parametrize("psize,sq,pos0,bq", [
    (16, 16, [0, 16], 16),        # single q block, chunk continuation
    (8, 16, [8, 32], 8),          # multi q block, mid-chain chunks
    (8, 24, [0, 16], 4),          # bq < page, ragged grid mix
    (64, 32, [5, 64], 32),        # one page per 64 rows, unaligned pos0
])
def test_paged_prefill_q4_plain_vs_reference(psize, sq, pos0, bq):
    b, h, hkv, d = 2, 4, 2, 64
    nb = -(-(max(pos0) + sq) // psize) + 1             # + a trailing trash entry
    n_pages = b * nb + 1
    rng = np.random.default_rng(sq + psize)
    q = rng.integers(-64, 65, (b, h, sq, d)).astype(np.int8)
    kp, ks = _pack_pool(rng.integers(-64, 65, (n_pages, psize, hkv, d)).astype(np.int8))
    vp, vs = _pack_pool(rng.integers(-64, 65, (n_pages, psize, hkv, d)).astype(np.int8))
    btab = _chains(rng, [p + sq for p in pos0], nb, n_pages, psize)
    jargs, targs = _both_args((q, kp, vp, ks, vs, btab, np.int32(pos0)), _scalars(d))
    got = paged_prefill_qattention_q4(*targs).numpy()
    _assert_lsb_flips(got, jref.paged_prefill_qattention_q4_ref(*jargs),
                      "q4 prefill vs oracle")
    _assert_lsb_flips(got, j_prefill_q4(*jargs, bq=bq, interpret=True), "q4 prefill vs pallas")


def test_q4_ops_backends_agree_on_cpu():
    """On CPU tensors the ``gpu`` backend's wrappers compute the plain
    versions, so both backends give the same arrays and count no launch."""
    rng = np.random.default_rng(5)
    psize, nb, hkv, d = 8, 4, 2, 32
    n_pages = 2 * nb + 1
    kp, ks = _pack_pool(rng.integers(-90, 91, (n_pages, psize, hkv, d)).astype(np.int8))
    vp, vs = _pack_pool(rng.integers(-90, 91, (n_pages, psize, hkv, d)).astype(np.int8))
    btab = _chains(rng, [30, 9], nb, n_pages, psize)
    _, scal = _both_args((), _scalars(d))
    pool = (_t(kp), _t(vp), _t(ks), _t(vs), _t(btab))
    n0 = (paged_decode_qattention_q4.launches, paged_prefill_qattention_q4.launches)
    qd = _t(rng.integers(-127, 128, (2, hkv, 3, d)).astype(np.int8))
    lens = torch.tensor([30, 9], dtype=torch.int32)
    outs = [ops.paged_decode_attention_q4(qd, *pool, lens, *scal, impl=i) for i in ("ref", "gpu")]
    assert torch.equal(*outs)
    qp = _t(rng.integers(-127, 128, (2, 2 * hkv, 8, d)).astype(np.int8))
    p0 = torch.tensor([16, 0], dtype=torch.int32)
    outs = [ops.paged_prefill_attention_q4(qp, *pool, p0, *scal, impl=i) for i in ("ref", "gpu")]
    assert torch.equal(*outs)
    assert (paged_decode_qattention_q4.launches, paged_prefill_qattention_q4.launches) == n0


# --- the engine ----------------------------------------------------------------

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


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.has_work:
        ticks.append([(e.rid, e.token, e.index, e.final, e.finish_reason) for e in eng.poll()])
    return ticks


ENGINE_CASES = {
    "default": (dict(batch_slots=3, max_len=64), [3, 11, 6, 17, 5], [4, 6, 3, 5, 4], 0),
    "shared_prefix": (dict(batch_slots=2, max_len=64, page_size=8), [5, 9, 3], [4, 4, 3], 16),
    "chunked": (dict(batch_slots=3, max_len=64, page_size=4, max_prefill_chunk=8,
                     max_batched_tokens=16), [30, 5, 19, 12], [5, 6, 4, 5], 0),
    "starved_pool": (dict(batch_slots=3, max_len=64, page_size=4, n_pages=8),
                     [6, 5, 7], [12, 12, 12], 0),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_kv4_engine_matches_reference(folded, case):
    jcfg, jfolded, cfg, tfolded = folded
    kw, lens, max_new, prefix = ENGINE_CASES[case]
    kw = dict(kw, kv_bits=4)
    prompts = _prompts(cfg.vocab_size, lens, prefix=prefix)
    jeng = JE.Engine(jcfg, jfolded, JE.EngineConfig(**kw))
    teng = E.Engine(cfg, tfolded, E.EngineConfig(**kw))
    jreqs = [JE.Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    treqs = [E.Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    assert _drive(teng, treqs) == _drive(jeng, jreqs)
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.out, j.out)
    assert teng.counters == jeng.counters
    assert teng.stats(check=True) == jeng.stats(check=True)
    assert teng.kv_bits == 4 and teng.counters["completed"] == len(lens)
    assert teng.alloc.bytes_per_page == jeng.alloc.bytes_per_page
    if case == "starved_pool":
        assert teng.counters["preemptions"] >= 1


def test_kv4_pool_layout_and_page_bytes(folded):
    cfg, tfolded = folded[2], folded[3]
    cache = S.init_paged_cache(cfg, 5, 16, kv_bits=4, device="cpu")
    leaf = cache["slot0"]
    assert leaf["k"].dtype == torch.uint8
    assert tuple(leaf["k"].shape) == (cfg.n_reps, 5, 16, cfg.n_kv_heads, cfg.hd // 2)
    assert tuple(leaf["ks"].shape) == (cfg.n_reps, 5)
    assert bool((leaf["ks"] == np.float32(1) / np.float32(7)).all())
    e4 = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64, kv_bits=4))
    e8 = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64))
    assert e4.alloc.bytes_per_page == S.paged_page_nbytes(cfg, 16, 4)
    assert e4.alloc.bytes_per_page < 0.6 * e8.alloc.bytes_per_page
    # yi-6b at full width, 16-row pages: 262,400 against 524,288 bytes
    from repro_torch.configs import get_config
    full = get_config("yi-6b")
    assert (S.paged_page_nbytes(full, 16, 4), S.paged_page_nbytes(full, 16, 8)) == \
        (262_400, 524_288)


def test_kv4_gpu_backend_oneshot_and_chunked_on_cpu(folded, monkeypatch):
    """The ``gpu`` backend's kv4 control flow (the packed prefill and decode
    kernels, here computed by their plain versions on CPU tensors), one-shot
    and chunked.  As in the reference, only the int8 pool holds chunked to
    one-shot token for token: a decode-written page's scale comes from its
    first row, a prefill-written page's from the whole page.  What must
    hold here is what the reference holds for kv4: every request completes
    with its full budget, the counters balance and the pool drains."""
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    cfg, tfolded = folded[2], folded[3]
    prompts = _prompts(cfg.vocab_size, [23, 4, 13, 9], prefix=8)
    n = [k.launches for k in (paged_decode_qattention_q4, paged_prefill_qattention_q4)]

    def run(kv_bits, **kw):
        eng = E.Engine(cfg, tfolded, E.EngineConfig(batch_slots=2, max_len=64, page_size=4,
                                                    kv_bits=kv_bits, **kw))
        reqs = eng.generate([E.Request(prompt=p, max_new_tokens=5) for p in prompts])
        assert all(len(r.out) == 5 for r in reqs)
        assert eng.alloc.live == 0 and eng.counters["completed"] == len(prompts)
        return [r.out.tolist() for r in reqs], eng.counters

    one, c1 = run(4)
    chunked, c2 = run(4, max_prefill_chunk=8, max_batched_tokens=12)
    assert c1["prefix_hits"] >= 1 and c2["chunked_prefills"] >= 1
    assert c1["decode_tokens"] == c2["decode_tokens"]
    assert run(8)[0] == run(8, max_prefill_chunk=8, max_batched_tokens=12)[0]
    # CPU tensors: the wrappers computed the plain versions, no launch counted
    assert [k.launches for k in (paged_decode_qattention_q4, paged_prefill_qattention_q4)] == n
    print(f"kv4 one-shot {one}\nkv4 chunked  {chunked}")


def test_launcher_serves_the_packed_pool(capsys):
    from repro_torch.launch import serve as launcher

    launcher.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--prompts", "2",
                   "--max-new", "3", "--kv-bits", "4"])
    assert "layout=paged, kv_bits=4" in capsys.readouterr().out
