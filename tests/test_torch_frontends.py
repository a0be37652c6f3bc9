"""The frontend archs in the port against the reference, at smoke size, with
the reference's weights carried across as numpy: qwen2-vl-2b (M-RoPE, the
vision stub's patch embeddings prepended) and musicgen-medium (four
codebooks summed at the input, four stacked LM heads).  The reference's
side is built once per module.

The smoke qwen2-vl has head_dim 32: its 16 frequency bands would all fall
in the first of the published sections (16, 24, 24), so the h and w
streams would never reach the rotation.  These tests take the published
proportions at head_dim 32, ``mrope_sections=(4, 6, 6)``, and the image's
positions are a 4 x 4 grid (t 0, h the row, w the column), the text
following at 4 on all three streams (Qwen2-VL's rule).

* ``apply_mrope``: the requantized codes of the M-RoPE island against the
  reference's, the flips counted; with t = h = w equal to ``apply_rope``.
* ``init_params`` shapes and dtypes; the calibration's obs allclose, the
  fold equal leaf for leaf (codebooks and every head included).
* ``serve_forward`` on ``ref``: the cache-less forward with the image rows
  and ``pos3`` (qwen2-vl) or (B, K, S) codes in, (B, K, S, V) out
  (musicgen), then the one-shot stripe prefill and 8 decode steps, with
  the reference's island injected bit for bit, and with the port's own
  island the same greedy tokens.
* ``make_engine`` routing and warnings; qwen2-vl's ``LockstepEngine``
  greedy and sampled; musicgen's ``generate`` raising (the reference's
  AssertionError, the port's ValueError); verify and ``tp_axis`` raising.
"""
import warnings

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
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import TPMesh
from repro_torch.models import fold as F
from repro_torch.models import layers as L
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
ARCHS = ("qwen2-vl-2b", "musicgen-medium")
FLIP_FRACTION = 1e-3
SECTIONS = (4, 6, 6)            # the published (16, 24, 24) at head_dim 32
GRID = 4                        # the image: GRID x GRID patches
TEXT = 8                        # text tokens after the image
MAX_LEN = 48
STEPS = 8


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _extra(arch):
    return dict(mrope_sections=SECTIONS) if arch == "qwen2-vl-2b" else {}


def image_pos3(b: int, grid: int, text: int) -> np.ndarray:
    """(B, grid^2 + text, 3) M-RoPE positions: the image's (t 0, h the row,
    w the column), then the text at ``grid`` onwards on all three streams."""
    g = np.arange(grid * grid)
    img = np.stack([np.zeros_like(g), g // grid, g % grid], -1)
    txt = np.repeat((grid + np.arange(text))[:, None], 3, -1)
    return np.broadcast_to(np.concatenate([img, txt]), (b, grid * grid + text, 3)
                           ).astype(np.int32).copy()


def _inputs(cfg, b, s, seed):
    """Token ids (B, S), or (B, K, S) codebook codes for the audio arch."""
    rows = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, *rows, s)
                                                ).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """Per arch: the reference's config, params, calibration inputs, obs,
    folded tree and jitted decode step, and the port's config, params and
    folded tree, built on first use.  qwen2-vl calibrates with 16 image
    rows (float embeddings) and ``pos3``."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = j_smoke(arch, **_extra(arch))
            params = JT.init_params(jcfg, KEY)
            amax = JT.init_amax(jcfg)
            calib = _inputs(jcfg, 2, 16, 1)
            kw = {}
            if arch == "qwen2-vl-2b":
                emb = np.random.default_rng(2).standard_normal((2, GRID * GRID, jcfg.d_model))
                kw = dict(extra_embeds=(0.02 * emb).astype(np.float32),
                          pos3=image_pos3(2, GRID, 16))
            _, obs, _ = JT.forward(jcfg, params, amax, jnp.asarray(calib),
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
            jfolded = JF.fold_params(jcfg, params, obs)
            np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
            jdecode = jax.jit(lambda f, c, t, p: JS.serve_forward(
                jcfg, f, t, cache=c, pos_offset=p, mode="decode"))
            built[arch] = dict(
                jcfg=jcfg, params=params, amax=amax, calib=calib, calib_kw=kw, obs=obs,
                jfolded=jfolded, jdecode=jdecode, cfg=smoke_config(arch, **_extra(arch)),
                tparams=F.params_from_numpy(np_tree(params), "cpu"),
                tfolded=F.folded_from_numpy(np_tree(jfolded), "cpu"))
        return built[arch]
    return get


def _image_codes(m, b, seed):
    """The vision stub's int8 codes: random float patch embeddings quantized
    at the folded ``s_embed``, as a caller of ``serve_forward`` makes them."""
    emb = 0.02 * np.random.default_rng(seed).standard_normal((b, GRID * GRID, m["cfg"].d_model))
    s = float(np.asarray(m["jfolded"]["s_embed"]))
    return np.clip(np.round(emb.astype(np.float32) * np.float32(s)), -127, 127).astype(np.int8)


# --- M-RoPE ---------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(32, SECTIONS), (128, (16, 24, 24))])
def test_mrope_island_flips_counted_and_equal_to_rope_on_the_diagonal(hd, sections):
    """The M-RoPE island (dequant -> rotate -> requant) against the
    reference's on the same codes over an image grid and text: +-1 codes on
    at most 0.1 %, the count printed.  With t = h = w, ``apply_mrope`` is
    ``apply_rope`` bit for bit."""
    jcfg = j_smoke("qwen2-vl-2b", head_dim=hd, mrope_sections=sections)
    cfg = smoke_config("qwen2-vl-2b", head_dim=hd, mrope_sections=sections)
    rng = np.random.default_rng(hd)
    pos3 = image_pos3(3, 16, 200) + rng.integers(0, 300, (3, 1, 1)).astype(np.int32)
    h = rng.integers(-127, 128, (3, pos3.shape[1], 4, hd)).astype(np.int8)
    inv, s_out = np.float32(0.0123), np.float32(90.7)
    want = np.asarray(jax.jit(lambda x, p: JS._rope_island(x, inv, s_out, p, jcfg))(
        jnp.asarray(h), jnp.asarray(pos3)))
    got = S._rope_island(_t(h), torch.tensor(inv), torch.tensor(s_out), _t(pos3), cfg).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    n = int((diff > 0).sum())
    print(f"M-RoPE island (hd={hd}, sections={sections}): {n} of {diff.size} codes differ")
    assert diff.max() <= 1 and n <= FLIP_FRACTION * diff.size
    x = torch.from_numpy(rng.standard_normal((3, pos3.shape[1], 4, hd)).astype(np.float32))
    pos = _t(pos3[..., 0])
    diag = pos[..., None].expand(*pos.shape, 3)
    assert torch.equal(L.apply_mrope(x, diag, 1e6, sections), L.apply_rope(x, pos, 1e6))
    # the (B, S) decode positions rotate all three streams alike
    assert torch.equal(S._rope_island(_t(h), torch.tensor(inv), torch.tensor(s_out), pos, cfg),
                       S._rope_island(_t(h), torch.tensor(inv), torch.tensor(s_out), diag, cfg))


# --- init, calibration, fold ------------------------------------------------------

def test_init_params_shapes_and_dtypes_equal_reference():
    for arch in ARCHS:
        want = _flat(JT.init_params(j_smoke(arch), KEY))
        got = _flat(T.init_params(smoke_config(arch), torch.Generator().manual_seed(0)))
        assert want.keys() == got.keys(), arch
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (arch, k)
    assert "/embed/codebooks" in got and got["/lm_head"].shape == (4, 128, 512)


# musicgen's rep-0 attention sites, held at 1e-5 like every site of qwen2-vl;
# its QAT attention's float island (the softmax simulator and the float
# P.V and wo products, which XLA fuses and orders its own way in the
# scanned forward) moves a context code in rep 0, so every site after it
# is held at ISLAND_RTOL, its deviation printed (ROADMAP §3)
PRE_ISLAND = ("attn_in", "q_pre", "k_pre", "q", "k", "v", "attn_out_in")
ISLAND_RTOL = 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_obs_allclose_and_fold_equal(models, arch):
    """The calibration forward (qwen2-vl with the image rows and ``pos3``,
    musicgen on (2, 4, 16) codes): obs within 1e-5 (musicgen: up to its
    first float-island flip, ``PRE_ISLAND``), the logits' shape; the fold
    from the reference's obs equal leaf for leaf."""
    m = models(arch)
    cfg = m["cfg"]
    amax = F.params_from_numpy(jax.tree.map(np.asarray, m["amax"]), "cpu")
    logits, obs, _ = T.forward(cfg, m["tparams"], amax, _t(m["calib"]),
                               **{k: _t(v) for k, v in m["calib_kw"].items()})
    want, got = _flat(jax.tree.map(np.asarray, m["obs"])), _flat(obs)
    assert want.keys() == got.keys()
    past = {}
    for k in want:
        rel = np.abs(got[k].astype(np.float64) / want[k] - 1)
        site = k.split("/")[-1]
        if arch == "qwen2-vl-2b" or k == "/embed_out" or site in PRE_ISLAND:
            held = rel[:1] if arch == "musicgen-medium" and k != "/embed_out" else rel
            assert held.max() <= 1e-5, (k, held)
        past[k] = float(rel.max())
    print(f"{arch}: obs differ from the reference's by at most {max(past.values()):.3g} "
          f"relative ({sum(v > 1e-5 for v in past.values())} of {len(past)} sites above 1e-5)")
    assert max(past.values()) <= (ISLAND_RTOL if arch == "musicgen-medium" else 1e-5)
    shape = {"qwen2-vl-2b": (2, 32, 512), "musicgen-medium": (2, 4, 16, 512)}[arch]
    assert tuple(logits.shape) == shape and torch.isfinite(logits).all()
    obs_ref = F.params_from_numpy(jax.tree.map(np.asarray, m["obs"]), "cpu")
    got = _flat(F.fold_params(cfg, m["tparams"], obs_ref))
    want = _flat(jax.tree.map(np.asarray, m["jfolded"]))
    assert got.keys() == want.keys()
    if arch == "musicgen-medium":
        assert want["/embed/codebooks_i8"].shape == (4, 512, 128)
        assert want["/lm_head/w"].shape == (4, 64, 512) and want["/lm_head/inv_acc"].shape == (4,)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the serving forward ----------------------------------------------------------

def _reference_island(jcfg):
    """The reference's ``_rope_island`` (jitted, as in its scanned forward)
    on the port's inputs; (B, S) positions broadcast to the three streams
    as its ``_decode_qkv`` does."""
    fn = jax.jit(lambda h, inv, s, p: JS._rope_island(h, inv, s, p, jcfg))

    def island(h_i8, inv_s_in, s_out, pos, _cfg, qn=None):
        p = pos.numpy()
        p = p if p.ndim == 3 else np.broadcast_to(p[..., None], (*p.shape, 3))
        return _t(fn(jnp.asarray(h_i8.numpy()), np.asarray(inv_s_in), np.asarray(s_out),
                     jnp.asarray(p)))

    return island


def _reference_run(m, prompt, extra):
    """The reference: the cache-less forward, then the one-shot prefill into
    a (2, MAX_LEN) stripe and STEPS greedy decode steps (musicgen: each
    head's argmax is the next frame's code).  Returns (logits per call,
    the tokens fed to each decode step)."""
    jcfg, jfolded = m["jcfg"], m["jfolded"]
    kw = {k: jnp.asarray(v) for k, v in extra.items()}
    want = [np.asarray(JS.serve_forward(jcfg, jfolded, jnp.asarray(prompt), **kw)[0])]
    lg, jcache = JS.serve_forward(jcfg, jfolded, jnp.asarray(prompt),
                                  cache=JS.init_cache(jcfg, 2, MAX_LEN), **kw)
    want.append(np.asarray(lg))
    rows = lg.shape[-2]
    toks = []
    for step in range(STEPS):
        toks.append(_next(want[-1]))
        lg, jcache = m["jdecode"](jfolded, jcache, jnp.asarray(toks[-1]),
                                  jnp.full((2,), rows + step, jnp.int32))
        want.append(np.asarray(lg))
    return want, toks


def _next(logits):
    """The greedy next input: (B, 1) tokens, or (B, K, 1) codes from K heads."""
    return logits[..., -1, :].argmax(-1).astype(np.int32)[..., None]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_forward_equals_reference(models, arch, monkeypatch):
    """On ``ref``: the cache-less forward (qwen2-vl: 16 image rows and
    ``pos3`` before 8 text tokens; musicgen: (2, 4, 24) codes, (2, 4, 24,
    512) logits), then the one-shot prefill into the contiguous stripe and 8
    greedy decode steps fed the reference's tokens.  With the reference's
    M-RoPE island injected, every logit and the stripe equal bit for bit
    (musicgen has no island); with the port's own island, the differing
    logits counted and every greedy token equal."""
    m = models(arch)
    cfg, tfolded = m["cfg"], m["tfolded"]
    if arch == "qwen2-vl-2b":
        prompt = _inputs(cfg, 2, TEXT, 3)
        extra = dict(extra_embeds_i8=_image_codes(m, 2, 4), pos3=image_pos3(2, GRID, TEXT))
    else:
        prompt, extra = _inputs(cfg, 2, 24, 3), {}
    want, toks = _reference_run(m, prompt, extra)
    assert want[0].shape == ((2, 24, 512) if arch == "qwen2-vl-2b" else (2, 4, 24, 512))
    islands = [("own island", S._rope_island)]
    if cfg.mrope_sections is not None:
        islands.insert(0, ("reference island", _reference_island(m["jcfg"])))
    flips = {}
    for label, island in islands:
        monkeypatch.setattr(S, "_rope_island", island)
        kw = {k: _t(v) for k, v in extra.items()}
        got = [S.serve_forward(cfg, tfolded, _t(prompt), **kw)[0].numpy()]
        cache = S.init_cache(cfg, 2, MAX_LEN, device="cpu")
        lg, cache = S.serve_forward(cfg, tfolded, _t(prompt), cache=cache, **kw)
        got.append(lg.numpy())
        rows = lg.shape[-2]
        for step, tok in enumerate(toks):
            lg, cache = S.serve_forward(cfg, tfolded, _t(tok), cache=cache,
                                        pos_offset=torch.full((2,), rows + step,
                                                              dtype=torch.int32),
                                        mode="decode")
            got.append(lg.numpy())
        if label == "reference island" or cfg.mrope_sections is None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        flips[label] = sum(int((g != w).sum()) for g, w in zip(got, want))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_next(g), _next(w), err_msg=label)
    print(f"{arch} cache-less forward + one-shot stripe prefill + {STEPS} decode steps: "
          f"logits differing from the reference's {flips} of {sum(w.size for w in want)}")


def test_stripe_fit_counts_the_image_rows(models):
    """The one-shot prefill's rows are the image's and the text's: 16 + 8
    rows do not fit a 20-row stripe."""
    m = models("qwen2-vl-2b")
    cfg = m["cfg"]
    with pytest.raises(ValueError, match="24 rows does not fit"):
        S.serve_forward(cfg, m["tfolded"], _t(_inputs(cfg, 2, TEXT, 3)),
                        cache=S.init_cache(cfg, 2, 20, device="cpu"),
                        extra_embeds_i8=_t(_image_codes(m, 2, 4)),
                        pos3=_t(image_pos3(2, GRID, TEXT)))


# --- the engines ------------------------------------------------------------------

def test_make_engine_routes_frontends_to_lockstep_with_the_reference_warnings(models):
    """Both archs go to ``LockstepEngine``; each continuous-only field set
    away from its default (``tp`` included) is named in the reference's
    warning and reset; nothing set, nothing said.  A token-LM arch gets the
    continuous ``Engine``."""
    for arch in ARCHS:
        m = models(arch)
        for kw in (dict(prefill_bucket=8, tp=2), dict(cache_layout="paged", page_size=8),
                   dict(kv_bits=4, n_pages=64), dict(spec_k=2, max_batched_tokens=32)):
            said = {}
            for mod, cfg, folded in ((JE, m["jcfg"], m["jfolded"]), (E, m["cfg"], m["tfolded"])):
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    eng = mod.make_engine(cfg, folded, mod.EngineConfig(
                        batch_slots=2, max_len=MAX_LEN, **kw))
                assert isinstance(eng, mod.LockstepEngine)
                assert eng.config == mod.EngineConfig(batch_slots=2, max_len=MAX_LEN)
                said[mod] = [str(x.message) for x in w if x.category is UserWarning]
            assert said[E] == said[JE] and len(said[E]) == 1, said
            assert all(f in said[E][0] for f in kw), said
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eng = E.make_engine(m["cfg"], m["tfolded"], E.EngineConfig(batch_slots=2,
                                                                       max_len=MAX_LEN))
        assert isinstance(eng, E.LockstepEngine)
        with pytest.raises(E.EngineConfigError, match="LockstepEngine"):
            E.Engine(m["cfg"], m["tfolded"], E.EngineConfig(batch_slots=2, max_len=MAX_LEN))
    yi = smoke_config("yi-6b")
    from repro_torch.launch.serve import calibrated_folded
    eng = E.make_engine(yi, calibrated_folded(yi, 0, device="cpu"),
                        E.EngineConfig(batch_slots=2, max_len=MAX_LEN))
    assert isinstance(eng, E.Engine)


def test_qwen2vl_lockstep_generate_equals_reference(models):
    """qwen2-vl's text through ``LockstepEngine``, greedy then sampled
    (T=0.7) after ``reset``: the reference's tokens."""
    m = models("qwen2-vl-2b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, m["cfg"].vocab_size, n).astype(np.int32) for n in (5, 9)]
    out = {}
    for mod, cfg, folded in ((JE, m["jcfg"], m["jfolded"]), (E, m["cfg"], m["tfolded"])):
        eng = mod.make_engine(cfg, folded, mod.EngineConfig(batch_slots=2, max_len=MAX_LEN))
        if mod is JE:   # its scalar position as the (B,) vector the jitted step takes
            eng._decode = lambda f, c, t, p: m["jdecode"](f, c, t,
                                                          jnp.broadcast_to(p, t.shape[:1]))
        runs = []
        for temperature in (0.0, 0.7):
            eng.reset(0)
            reqs = eng.generate([mod.Request(prompt=p, max_new_tokens=6,
                                             temperature=temperature) for p in prompts])
            runs.append([r.out.tolist() for r in reqs])
        out[mod] = runs
    assert out[E] == out[JE]
    print(f"qwen2-vl lockstep greedy {out[E][0]}, sampled {out[E][1]}")


def test_musicgen_generate_raises_as_the_reference_fails(models):
    """The reference's ``LockstepEngine.generate`` on musicgen fails with an
    AssertionError (a (B, 1) token column where (B, K, S) codes are due);
    the port raises a ValueError naming the (B, K, 1) decode instead."""
    m = models("musicgen-medium")
    prompt = np.arange(5, dtype=np.int32)
    jeng = JE.make_engine(m["jcfg"], m["jfolded"], JE.EngineConfig(batch_slots=2, max_len=16))
    with pytest.raises(AssertionError):
        jeng.generate([JE.Request(prompt=prompt, max_new_tokens=2)])
    eng = E.make_engine(m["cfg"], m["tfolded"], E.EngineConfig(batch_slots=2, max_len=16))
    with pytest.raises(ValueError, match=r"\(B, 4, 1\) codes"):
        eng.generate([E.Request(prompt=prompt, max_new_tokens=2)])


def test_verify_and_tp_axis_still_raise(models):
    """The verify forward refuses M-RoPE (the reference asserts), and a
    tensor-parallel mesh without the paged pool raises (the reference
    asserts a block table under ``tp_axis``)."""
    m = models("qwen2-vl-2b")
    cfg, tfolded = m["cfg"], m["tfolded"]
    toks = _t(_inputs(cfg, 2, 4, 7))
    btab = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cache = S.init_paged_cache(cfg, 5, 16, device="cpu")
    with pytest.raises(ValueError, match="M-RoPE"):
        S.serve_forward(cfg, tfolded, toks, cache=cache, mode="verify", block_tables=btab,
                        pos_offset=torch.tensor([3, 5], dtype=torch.int32),
                        verify_rows=torch.tensor([4, 4], dtype=torch.int32))
    jcache = JS.init_paged_cache(m["jcfg"], 5, 16)
    with pytest.raises(AssertionError, match="mrope"):
        JS.serve_forward(m["jcfg"], m["jfolded"], jnp.asarray(toks.numpy()), cache=jcache,
                         mode="verify", block_tables=jnp.asarray(btab.numpy()),
                         pos_offset=jnp.asarray([3, 5], jnp.int32),
                         verify_rows=jnp.asarray([4, 4], jnp.int32))
    with pytest.raises(ValueError, match="paged KV pool"):
        S.serve_forward(cfg, tfolded, toks, mesh=TPMesh((torch.device("cpu"),) * 2))
