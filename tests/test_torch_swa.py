"""The sliding window (mixtral-8x22b) in the port against the reference, at
smoke size (window 16, 2 layers, 4 experts top-2), with the reference's
weights carried across as numpy; the reference's side is built once per
module.

* The blocked flash with a ``window``: the port's plain version against
  the reference's ``flash_qattention_jax(window=)`` for windows 4 and 16,
  blocks below and above the window, ``q_offset > 0``, G = 1 and 2, at a
  logit scale where a tile may skip the blocks below its window and at one
  where it may not (+-1 code on at most 0.1 % of elements, the fp32
  ``exp`` rule; the count printed).  The CUDA kernel's decomposition
  (``ref.flash_qattention_tiled_ref``: 16-row tiles, 32-key steps, a tile
  starting at its first live block where ``window_skip_margin`` allows)
  equal to the block-serial plain version, bit for bit.
* Quant-free, a token outside the window does not move the last row.
* The calibration forward's observations allclose, the fold equal leaf for
  leaf.
* ``serve_forward`` on ``ref``: a one-shot stripe prefill, then decode
  steps past the window through the ring, logits and ring equal to the
  reference's; the cache-less windowed prefill's logits too.
* The ``ref`` engines on ``cache_layout="auto"`` (contiguous for SWA): a
  one-shot prompt, prompts longer than the window through the batch-1
  decode loop, decode past the window; events, tokens, counters and
  ``stats()`` equal.  ``LockstepEngine`` tokens equal.  The paged pool is
  refused, as in the reference.
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
from repro.kernels.flash_qattention import flash_qattention_jax
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.core.policy import POLICY_FP32
from repro_torch.kernels import ref
from repro_torch.kernels.flash_qattention import flash_qattention_torch
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
ARCH = "mixtral-8x22b"
FLIP_FRACTION = 1e-3
LUT = jref.make_exp_lut_q7()


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
    calib = jax.random.randint(KEY, (2, 24), 0, jcfg.vocab_size)     # past the window
    _, obs, _ = JT.forward(jcfg, params, amax, calib)
    jfolded = JF.fold_params(jcfg, params, obs)
    return dict(jcfg=jcfg, params=params, amax=amax, calib=calib, obs=obs, jfolded=jfolded,
                cfg=smoke_config(ARCH),
                tfolded=F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu"))


# --- the windowed flash ---------------------------------------------------------

def _flash_inputs(h, hkv, sq, skv, d, inv_scale, seed):
    """int8 q (H, Sq, D), k/v (Hkv, Skv, D) and the scalars.  The logit
    scale gives logits of a few units times ``1 / inv_scale``; at 1000 a
    masked key still clips to the table's zero entry, but the carry factor
    that would scale a masked prefix away is no longer exactly 0."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-127, 128, shape).astype(np.int8)
               for shape in ((h, sq, d), (hkv, skv, d), (hkv, skv, d)))
    s_logit = 73.0 * 73.0 * np.sqrt(d) / 1.5 * inv_scale
    M, sh = jfx.quantize_multiplier(1.0 / (s_logit * jqs.LUT_DELTA))
    return q, k, v, M, sh, np.float32(1.0 / s_logit), np.float32(1.3)


# (H, Hkv, Sq, Skv, q_offset, bkv, window)
FLASH_CASES = {
    "w4_bkv16": (4, 2, 64, 64, 0, 16, 4),
    "w4_bkv2": (4, 2, 48, 48, 0, 2, 4),
    "w16_bkv8": (4, 2, 64, 64, 0, 8, 16),
    "w16_bkv32_g1": (4, 4, 64, 64, 0, 32, 16),
    "w16_q_offset": (4, 2, 24, 96, 72, 16, 16),
    "w16_bkv12_q_offset_g1": (2, 2, 40, 96, 56, 12, 16),
    "w4_whole_row_block": (4, 2, 40, 40, 0, 40, 4),
}
SCALES = {"skip": 1.0, "from_block_0": 1000.0}


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_windowed_flash_equals_reference(name, scale):
    h, hkv, sq, skv, q_offset, bkv, window = FLASH_CASES[name]
    q, k, v, M, sh, inv, osc = _flash_inputs(h, hkv, sq, skv, 32, SCALES[scale],
                                             sum(map(ord, name)))
    assert (ref.window_skip_margin(inv, 32) > 1) == (scale == "skip")
    want = np.asarray(flash_qattention_jax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(M), jnp.int32(sh),
        jnp.asarray(LUT), inv, osc, q_offset=q_offset, bkv=bkv, window=window))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(M, dtype=torch.int32), torch.tensor(sh, dtype=torch.int32),
            torch.from_numpy(LUT), torch.tensor(inv), torch.tensor(osc))
    got = flash_qattention_torch(*args, q_offset=q_offset, bkv=bkv, window=window).numpy()
    diff = np.abs(got.astype(np.int64) - want)
    n = int((diff > 0).sum())
    print(f"windowed flash {name} ({scale}): {n} of {diff.size} codes differ from the "
          f"reference's by at most {int(diff.max())}")
    assert diff.max() <= 1 and n <= FLIP_FRACTION * diff.size
    tiled = ref.flash_qattention_tiled_ref(*args, q_offset=q_offset, bkv=bkv, window=window)
    assert np.array_equal(tiled.numpy(), got)


def test_windowed_flash_keys_outside_the_window_do_not_count():
    """Changing every key and value outside row 47's window leaves that
    row's output (skipping branch), but moves it without the window."""
    q, k, v, M, sh, inv, osc = _flash_inputs(4, 2, 48, 48, 32, 1.0, 9)
    args = (torch.tensor(M, dtype=torch.int32), torch.tensor(sh, dtype=torch.int32),
            torch.from_numpy(LUT), torch.tensor(inv), torch.tensor(osc))
    k2, v2 = k.copy(), v.copy()
    k2[:, :40] = -k2[:, :40]
    v2[:, :40] = -v2[:, :40]
    outs = {}
    for window in (8, None):
        outs[window] = [flash_qattention_torch(torch.from_numpy(q), torch.from_numpy(kk),
                                               torch.from_numpy(vv), *args, bkv=16,
                                               window=window)[:, -1]
                        for kk, vv in ((k, v), (k2, v2))]
    assert torch.equal(*outs[8]) and not torch.equal(*outs[None])


# --- the model ------------------------------------------------------------------

def test_sliding_window_restricts_attention():
    """Quant-free (dynamic calibration would couple every position through
    the shared scale): a token outside the window of the last position
    does not move its logits."""
    cfg = smoke_config(ARCH, sliding_window=4, n_layers=1, n_experts=0, top_k=0, d_ff=64,
                       quant=POLICY_FP32)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen)
    amax = T.init_amax(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen)
    toks2 = toks.clone()
    toks2[0, 2] = (toks[0, 2] + 1) % cfg.vocab_size
    lg1, _, _ = T.forward(cfg, params, amax, toks)
    lg2, _, _ = T.forward(cfg, params, amax, toks2)
    torch.testing.assert_close(lg1[0, -1], lg2[0, -1], atol=1e-5, rtol=0)
    assert not torch.equal(lg1[0, 3], lg2[0, 3])          # inside the window: it does


def test_calibration_obs_allclose_and_fold_equal(model):
    cfg = model["cfg"]
    assert cfg.sliding_window == 16 and model["calib"].shape[1] > cfg.sliding_window
    params = F.params_from_numpy(jax.tree.map(np.asarray, model["params"]), "cpu")
    amax = F.params_from_numpy(jax.tree.map(np.asarray, model["amax"]), "cpu")
    logits, obs, _ = T.forward(cfg, params, amax, torch.from_numpy(np.array(model["calib"])))
    want, got = _flat(jax.tree.map(np.asarray, model["obs"])), _flat(obs)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    assert logits.shape == (2, 24, cfg.vocab_size)
    obs_ref = F.params_from_numpy(jax.tree.map(np.asarray, model["obs"]), "cpu")
    got = _flat(F.fold_params(cfg, params, obs_ref))
    want = _flat(jax.tree.map(np.asarray, model["jfolded"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_decode_past_the_window_equals_reference(model):
    """A one-shot prefill of 12 rows into a 2-slot stripe (a ring of 16),
    then 14 decode steps fed the reference's greedy tokens, the slots at
    different positions: every step's logits and the final ring equal the
    reference's (the integer stages and the islands, RoPE and the MoE
    router, all agree here; differing logits would be counted first)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jcache = JS.init_cache(jcfg, 2, 64)
    tcache = S.init_cache(cfg, 2, 64, device="cpu")
    assert tcache["slot0"]["k"].shape[2] == 16 == jcache["slot0"]["k"].shape[2]
    jl, jcache = JS.serve_forward(jcfg, model["jfolded"], jnp.asarray(prompt), cache=jcache)
    tl, tcache = S.serve_forward(cfg, model["tfolded"], torch.from_numpy(prompt), cache=tcache)
    steps = [(np.asarray(jl), tl.numpy())]
    pos = np.array([12, 12], np.int32)
    for step in range(14):
        tok = steps[-1][0][:, -1].argmax(-1).astype(np.int32)[:, None]
        jl, jcache = JS.serve_forward(jcfg, model["jfolded"], jnp.asarray(tok), cache=jcache,
                                      pos_offset=jnp.asarray(pos), mode="decode")
        tl, tcache = S.serve_forward(cfg, model["tfolded"], torch.from_numpy(tok),
                                     cache=tcache, pos_offset=torch.from_numpy(pos),
                                     mode="decode")
        steps.append((np.asarray(jl), tl.numpy()))
        pos = pos + np.array([1, 1 + step % 2], np.int32)       # slot 1 runs ahead
    assert pos.max() > 2 * cfg.sliding_window
    differ = sum(int((w != g).sum()) for w, g in steps)
    print(f"mixtral prefill + 14 decode steps past the window: {differ} of "
          f"{sum(w.size for w, _ in steps)} logits differ from the reference's")
    assert differ == 0
    want, have = _flat(jax.tree.map(np.asarray, jcache)), _flat(tcache)
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_cacheless_windowed_prefill_equals_reference(model):
    """The cache-less causal forward over 40 tokens (the windowed blocked
    flash at bkv = 40 on ``ref``): logits equal, or the fp32 ``exp`` flips
    counted within the rule."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = np.asarray(JS.serve_forward(jcfg, model["jfolded"], jnp.asarray(toks))[0])
    got = S.serve_forward(cfg, model["tfolded"], torch.from_numpy(toks))[0].numpy()
    differ = int((want != got).sum())
    print(f"mixtral cache-less prefill (2, 40): {differ} of {want.size} logits differ")
    assert differ <= FLIP_FRACTION * want.size
    assert (want.argmax(-1) == got.argmax(-1)).all()


# --- the engines ------------------------------------------------------------------

def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def test_engine_on_auto_matches_reference(model):
    """``cache_layout="auto"`` resolves to the stripe (a ring of 16 rows);
    prompts of 5, 12 and 16 rows prefill one-shot, of 20 and 30 through the
    batch-1 decode loop (``loop_prefill_steps`` = 50, ``oneshot_prefills``
    3), and every request decodes past the window."""
    lens, max_new = [5, 20, 12, 30, 16], [16, 9, 10, 6, 8]
    runs = []
    for mod, cfg, folded in ((JE, model["jcfg"], model["jfolded"]),
                             (E, model["cfg"], model["tfolded"])):
        eng = mod.Engine(cfg, folded, mod.EngineConfig(batch_slots=3, max_len=64))
        reqs = [mod.Request(prompt=p, max_new_tokens=n)
                for p, n in zip(_prompts(cfg.vocab_size, lens, 5), max_new)]
        for r in reqs:
            eng.submit(r)
        ticks = []
        while eng.has_work:
            ticks.append([_event(e) for e in eng.poll()])
        runs.append((eng, reqs, ticks))
    (jeng, jreqs, jticks), (teng, treqs, tticks) = runs
    assert teng.layout == jeng.layout == "contiguous" and teng.smax == 16
    assert tticks == jticks
    for j, t in zip(jreqs, treqs):
        assert t.status.value == j.status.value and t.finish_reason == j.finish_reason
        np.testing.assert_array_equal(t.out, j.out)
    assert teng.counters == jeng.counters
    assert teng.stats(check=True) == jeng.stats(check=True)
    c = teng.counters
    assert c["loop_prefill_steps"] == 50 and c["oneshot_prefills"] == 3
    assert all(n + m > 16 for n, m in zip(lens, max_new))


def test_lockstep_engine_matches_reference(model):
    """Prompts left-padded to 12, 10 new tokens: the shared position runs to
    21, past the 16-row ring."""
    kw = dict(batch_slots=3, max_len=64)
    prompts = _prompts(model["cfg"].vocab_size, [5, 12, 9], 6)
    jreqs = JE.LockstepEngine(model["jcfg"], model["jfolded"], JE.EngineConfig(**kw)).generate(
        [JE.Request(prompt=p, max_new_tokens=10) for p in prompts])
    treqs = E.LockstepEngine(model["cfg"], model["tfolded"], E.EngineConfig(**kw)).generate(
        [E.Request(prompt=p, max_new_tokens=10) for p in prompts])
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.out, j.out)
        assert t.status is E.RequestStatus.FINISHED


def test_paged_layout_and_its_options_refused(model):
    """The paged pool, and with it the options only it serves, refused for
    a sliding-window arch as in the reference; kv_bits=4 on ``auto`` falls
    back to 8 with a warning."""
    cfg, folded = model["cfg"], model["tfolded"]
    for kw in (dict(cache_layout="paged"), dict(spec_k=2)):
        with pytest.raises(E.EngineConfigError):
            E.Engine(cfg, folded, E.EngineConfig(batch_slots=2, max_len=64, **kw))
        with pytest.raises(JE.EngineConfigError):
            JE.Engine(model["jcfg"], model["jfolded"],
                      JE.EngineConfig(batch_slots=2, max_len=64, **kw))
    with pytest.raises(ValueError, match="non-SWA"):
        S.init_paged_cache(cfg, 9, 16, device="cpu")
    with pytest.warns(UserWarning, match="falling back to kv_bits=8"):
        eng = E.Engine(cfg, folded, E.EngineConfig(batch_slots=2, max_len=64, kv_bits=4))
    assert eng.kv_bits == 8 and eng.layout == "contiguous"
