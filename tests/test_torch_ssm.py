"""The recurrent archs in the port against the reference, at smoke size:
xlstm-1.3b (d 128, 2 heads of 64, sLSTM at slot 0 and mLSTM at 1-7) and
jamba-1.5-large (d 128, Mamba with d_state 8, attention at slot 4, 4
experts top-2 at the odd slots), with the reference's weights carried
across as numpy; the reference's side is built once per module.

* The float cores on the same numpy inputs: ``causal_conv``,
  ``ssm_chunked`` at S = 8, 128, 200 (a ragged pad) and 300 (three
  chunks), ``mlstm_parallel`` at S = 16 and 1,024 (512-row chunks), and
  the three QAT mixers (outputs and obs), each within ``ISLAND_RTOL`` of
  the reference's largest magnitude.
* The calibration forward's observations allclose, the fold equal leaf
  for leaf from the reference's obs.
* The integer forward: ``_lin_wonly``; ``_mamba_int`` / ``_xlstm_int`` in
  decode and cache-less prefill, their int8 codes +-1 on at most
  ``FLIP_FRACTION`` (the count printed) and their states allclose; the
  integer stages bit for bit with the reference's islands injected;
  ``init_cache``'s leaves; decode over 8 tokens and the cache-less
  prefill against the reference.
* The ``ref`` engines: ``Engine`` on ``auto`` (the contiguous layout, every
  prompt through the batch-1 decode loop) with events, tokens, counters
  and ``stats()`` equal, ``LockstepEngine`` tokens equal, the continuous
  engine equal to per-request lockstep (the reference's
  ``test_continuous_matches_lockstep_hybrid_arch``); the refusals and
  kv4's fallback; a cached prefill raising; ``launch/serve.py`` on both.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import fold as JF
from repro.models import layers as JL
from repro.models import mamba as JMb
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro.models import xlstm as JXl
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import fold as F
from repro_torch.models import mamba as Mb
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as Xl
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
ARCHS = ("xlstm-1.3b", "jamba-1.5-large-398b")
FLIP_FRACTION = 1e-3
ISLAND_RTOL = 1e-5          # float islands: atol = ISLAND_RTOL * max|reference|


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_island(got, want, what: str, rtol=ISLAND_RTOL):
    """``got`` within ``rtol * max|want|`` of ``want`` elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"{what}: max abs diff {err:.3g} ({err / max(scale, 1e-30):.3g} of max|ref| "
          f"{scale:.3g})")
    assert got.shape == want.shape and err <= rtol * scale, what


def assert_codes(got, want, what: str):
    """int8 codes: +-1 on at most ``FLIP_FRACTION`` of them, the count printed."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    n = int((diff > 0).sum())
    print(f"{what}: {n} of {diff.size} codes differ from the reference's")
    assert diff.max(initial=0) <= 1 and n <= FLIP_FRACTION * diff.size, what
    return n


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
def models():
    """Per arch: the reference's config, params, calibration tokens, obs and
    folded tree, and the port's config, params and folded tree, built on
    first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = j_smoke(arch)
            params = JT.init_params(jcfg, KEY)
            amax = JT.init_amax(jcfg)
            calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
            _, obs, _ = JT.forward(jcfg, params, amax, calib)
            jfolded = JF.fold_params(jcfg, params, obs)
            np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
            # the reference engines' decode graph, compiled once per batch
            # shape and shared by every reference run of the module
            jdecode = jax.jit(lambda f, c, t, p: JS.serve_forward(
                jcfg, f, t, cache=c, pos_offset=p, mode="decode"), donate_argnums=(1,))
            built[arch] = dict(
                jcfg=jcfg, params=params, amax=amax, calib=calib, obs=obs, jfolded=jfolded,
                jdecode=jdecode, cfg=smoke_config(arch),
                tparams=F.params_from_numpy(np_tree(params), "cpu"),
                tfolded=F.folded_from_numpy(np_tree(jfolded), "cpu"))
        return built[arch]
    return get


# --- the float cores --------------------------------------------------------------

def test_causal_conv_equals_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for state in (None, st):
        jy, jst = JMb._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if state is None else jnp.asarray(state))
        ty, tst = Mb.causal_conv(_t(x), _t(w), None if state is None else _t(state))
        assert_island(ty.numpy(), jy, f"causal_conv (state {state is not None})")
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def _ssm_inputs(s, seed, d_in=24, n=8, bt=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, s, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, d_in)) - 3.0)).astype(np.float32)
    B = rng.standard_normal((bt, s, n)).astype(np.float32)
    C = rng.standard_normal((bt, s, n)).astype(np.float32)
    A = -np.exp(np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (d_in, n))))
    D = np.ones(d_in, np.float32)
    return x, dt, B, C, A.astype(np.float32), D


@pytest.mark.parametrize("s", [8, 128, 200, 300])
def test_ssm_chunked_equals_reference(s):
    """One chunk, one whole chunk, two chunks with a ragged pad, three."""
    args = _ssm_inputs(s, s)
    want = np.asarray(JMb._ssm_chunked(*map(jnp.asarray, args)))
    got = Mb.ssm_chunked(*map(_t, args)).numpy()
    assert_island(got, want, f"ssm_chunked S={s}")


def test_ssm_step_equals_the_chunked_scan():
    """The single-step recurrence from a zero state over 40 rows gives the
    chunked scan's rows (the dual form the decode loop relies on)."""
    x, dt, B, C, A, D = map(_t, _ssm_inputs(40, 1))
    want = Mb.ssm_chunked(x, dt, B, C, A, D)
    h = torch.zeros(2, 24, 8)
    ys = []
    for t in range(40):
        y, h = Mb.ssm_step(x[:, t:t + 1], dt[:, t:t + 1], B[:, t:t + 1], C[:, t:t + 1], A, D, h)
        ys.append(y)
    assert_island(torch.cat(ys, 1).numpy(), want.numpy(), "ssm_step vs ssm_chunked", 1e-5)


@pytest.mark.parametrize("s", [16, 1024])
def test_mlstm_parallel_equals_reference(s):
    """S = 1,024 runs in two 512-row chunks."""
    rng = np.random.default_rng(s)
    qh, kh, vh = (rng.standard_normal((1, s, 2, 64)).astype(np.float32) for _ in range(3))
    kh = kh / np.float32(8.0)
    gi = rng.standard_normal((1, s, 2)).astype(np.float32)
    logf = -np.log1p(np.exp(-(rng.standard_normal((1, s, 2)) + 3.0))).astype(np.float32)
    args = (qh, kh, vh, gi, logf)
    want = np.asarray(JXl.mlstm_parallel(*map(jnp.asarray, args)))
    got = Xl.mlstm_parallel(*map(_t, args)).numpy()
    assert_island(got, want, f"mlstm_parallel S={s}")


MIXERS = {"mamba": ("jamba-1.5-large-398b", JMb.mamba_qat, Mb.mamba_qat, JMb.MAMBA_SITES),
          "mlstm": ("xlstm-1.3b", JXl.mlstm_qat, Xl.mlstm_qat, JXl.MLSTM_SITES),
          "slstm": ("xlstm-1.3b", JXl.slstm_qat, Xl.slstm_qat, JXl.SLSTM_SITES)}


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_qat_mixer_equals_reference(mixer):
    """One QAT mixer over (2, 24) rows on the same weights: obs allclose,
    the output within the island tolerance (its fake-quantized sites
    flipping no code here); ``Mb.MAMBA_SITES`` etc. equal the reference's."""
    arch, jfn, tfn, sites = MIXERS[mixer]
    assert {"mamba": Mb.MAMBA_SITES, "mlstm": Xl.MLSTM_SITES,
            "slstm": Xl.SLSTM_SITES}[mixer] == sites
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    p = JT.init_slot_params(jcfg, mixer, "none", jax.random.PRNGKey(3))["mixer"]
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, 24, jcfg.d_model)) * 0.5)
    amax = {s: jnp.zeros(()) for s in sites}
    jout, jobs, _ = jax.jit(lambda x, p, a: jfn(x, p, a, jcfg.quant, jcfg))(jnp.asarray(x), p, amax)
    tp = F.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    tout, tobs, _ = tfn(_t(x), tp, {s: torch.zeros(()) for s in sites}, cfg.quant, cfg)
    assert tobs.keys() == jobs.keys()
    for k in jobs:
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), rtol=1e-5, err_msg=k)
    assert_island(tout.numpy(), jout, f"{mixer}_qat output")


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_qat_recurrent_form_equals_reference(mixer):
    """The three QAT mixers with a state, step by step over 6 rows
    (quant-free, as the reference's dual-form test): outputs and states."""
    arch, jfn, tfn, sites = MIXERS[mixer]
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    pol_j = dataclasses.replace(jcfg.quant, quantize_wa=False)
    pol_t = dataclasses.replace(cfg.quant, quantize_wa=False)
    p = JT.init_slot_params(jcfg, mixer, "none", jax.random.PRNGKey(5))["mixer"]
    tp = F.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (2, 6, jcfg.d_model)) * 0.5)
    dh = jcfg.d_model // jcfg.n_heads
    d_in, _ = Mb.mamba_dims(cfg)
    shapes = {"mlstm": {"C": (2, 2, dh, dh), "n": (2, 2, dh), "m": (2, 2)},
              "slstm": {k: (2, 2, dh) for k in ("c", "n", "h", "m")},
              "mamba": {"h": (2, d_in, cfg.mamba_d_state),
                        "conv": (2, cfg.mamba_d_conv - 1, d_in)}}[mixer]
    jst = {k: jnp.zeros(v) for k, v in shapes.items()}
    tst = {k: torch.zeros(v) for k, v in shapes.items()}
    for t in range(6):
        jy, _, jst = jfn(jnp.asarray(x[:, t:t + 1]), p, {s: jnp.zeros(()) for s in sites},
                         pol_j, jcfg, state=jst)
        ty, _, tst = tfn(_t(x[:, t:t + 1]), tp, {s: torch.zeros(()) for s in sites}, pol_t,
                         cfg, state=tst)
        assert_island(ty.numpy(), jy, f"{mixer}_qat step {t}")
    for k in shapes:
        assert_island(tst[k].numpy(), jst[k], f"{mixer} state {k}")


# --- calibration and fold ------------------------------------------------------------

def test_every_mixer_kind_is_in_the_smoke_archs(models):
    kinds = {m for a in ARCHS for m, _ in T.slot_kinds(models(a)["cfg"])}
    assert kinds == {"attn", "mamba", "mlstm", "slstm"}
    assert {f for m, f in T.slot_kinds(models(ARCHS[1])["cfg"])} == {"dense", "moe"}


def _slot_walk(m):
    """The reference's calibration forward slot by slot, the port's
    ``_apply_slot`` fed each slot's reference input.  Returns per (rep,
    slot): the largest relative obs difference and the number of the slot
    output's residual-grid codes that differ."""
    jcfg, cfg, params, amax = m["jcfg"], m["cfg"], m["params"], m["amax"]
    tamax = F.params_from_numpy(jax.tree.map(np.asarray, amax), "cpu")
    x = jnp.take(params["embed"]["tokens"], m["calib"], axis=0)
    x, _ = JL.fake_quant_act(x, amax["embed_out"], jcfg.quant.a_bits, jcfg.quant.quantize_wa)
    s = x.shape[1]
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), x.shape[:2])
    walk = []
    apply_slot = jax.jit(lambda mixer, ffn, *args: JT._apply_slot(jcfg, mixer, ffn, *args),
                         static_argnums=(0, 1))
    for r in range(jcfg.n_reps):
        for i, (mixer, ffn) in enumerate(JT.slot_kinds(jcfg)):
            name = f"slot{i}"
            pick = lambda t: t[r]  # noqa: E731
            xo, jobs, _ = apply_slot(mixer, ffn, x, jax.tree.map(pick, params["blocks"][name]),
                                     jax.tree.map(pick, amax["blocks"][name]), pos, None)
            xt, tobs, _ = T._apply_slot(cfg, mixer, ffn, _t(x),
                                        T.tree_index(m["tparams"]["blocks"][name], r),
                                        T.tree_index(tamax["blocks"][name], r),
                                        _t(pos), None)
            assert tobs.keys() == jobs.keys()
            worst = max(abs(float(tobs[k]) / float(jobs[k]) - 1) for k in jobs)
            grid = 127.0 / float(jobs["resid_a" if ffn == "none" else "resid_m"])
            flips = assert_codes(np.round(xt.numpy() * grid), np.round(np.asarray(xo) * grid),
                                 f"{cfg.name} rep {r} slot {i} ({mixer}/{ffn}) output")
            walk.append((r, i, worst, flips))
            x = xo
    return walk


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_obs_allclose_and_fold_equal(models, arch):
    """Slot by slot with the reference's input injected: obs within 1e-5,
    the output's residual codes +-1 on at most ``FLIP_FRACTION``.  The
    whole forward: obs within 1e-5 up to the first slot whose output code
    flipped (past it that flip moves every later activation, and the
    deviation is printed).  The fold from the reference's obs: equal leaf
    for leaf."""
    m = models(arch)
    cfg = m["cfg"]
    walk = _slot_walk(m)
    assert all(worst <= 1e-5 for _, _, worst, _ in walk)
    first_flip = next((k for k, (*_, flips) in enumerate(walk) if flips), len(walk))
    amax = F.params_from_numpy(jax.tree.map(np.asarray, m["amax"]), "cpu")
    logits, obs, _ = T.forward(cfg, m["tparams"], amax, _t(m["calib"]))
    want, got = _flat(jax.tree.map(np.asarray, m["obs"])), _flat(obs)
    assert want.keys() == got.keys()
    kinds = T.slot_kinds(cfg)
    past = {}
    for k in want:
        rel = np.abs(got[k] / want[k] - 1)
        if k.startswith("/blocks/"):
            slot = int(k.split("/")[2][4:])
            for r, v in enumerate(rel):
                if r * len(kinds) + slot > first_flip:
                    past[f"{k}[{r}]"] = float(v)
                else:
                    assert v <= 1e-5, (k, r, v)
        elif first_flip == len(walk):
            assert rel.max() <= 1e-5, k
    print(f"{arch}: first flipped slot output {first_flip} of {len(walk)}; obs past it differ "
          f"by at most {max(past.values(), default=0):.3g} relative ({len(past)} sites)")
    assert logits.shape == (2, 16, cfg.vocab_size) and torch.isfinite(logits).all()
    obs_ref = F.params_from_numpy(jax.tree.map(np.asarray, m["obs"]), "cpu")
    got = _flat(F.fold_params(cfg, m["tparams"], obs_ref))
    want = _flat(jax.tree.map(np.asarray, m["jfolded"]))
    assert got.keys() == want.keys()
    assert any("/mx/" in k and k.endswith("/inv_s_w") for k in want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_params_shapes_dtypes_and_constants_equal_reference():
    """The port's own init at bfloat16 (the published dtype), one
    super-block: every leaf's shape and dtype the reference's, and the
    constant inits equal."""
    for arch in ARCHS:
        jcfg = dataclasses.replace(j_smoke(arch), param_dtype="bfloat16")
        cfg = dataclasses.replace(smoke_config(arch), param_dtype="bfloat16")
        want = _flat(JT.init_params(jcfg, KEY))
        got = _flat_t(T.init_params(cfg, torch.Generator().manual_seed(0)))
        assert want.keys() == got.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
            if k.split("/")[-1] in ("dt_bias", "A_log", "D", "b_ig", "b_fg", "b_f", "conv_b",
                                    "ln_y", "gamma", "b_og"):
                np.testing.assert_array_equal(got[k].float().numpy(),
                                              want[k].astype(np.float32), err_msg=k)


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# --- the integer forward ---------------------------------------------------------------

def _np(tree):
    return T.tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


SLOTS = {"mamba": ("jamba-1.5-large-398b", 0), "slstm": ("xlstm-1.3b", 0),
         "mlstm": ("xlstm-1.3b", 1)}


def _slot(m, i, r=0):
    """Slot ``i`` of rep ``r``: the reference's folded leaves, the port's."""
    return (jax.tree.map(lambda t: t[r], m["jfolded"]["blocks"][f"slot{i}"]),
            S.layer_views(m["tfolded"], m["cfg"].n_reps)[r][f"slot{i}"])


def test_init_cache_matches_reference(models):
    for arch in ARCHS:
        m = models(arch)
        want = _flat(JS.init_cache(m["jcfg"], 3, 40))
        got = _flat(S.init_cache(m["cfg"], 3, 40, device="cpu"))
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            assert not got[k].any(), k


def test_lin_wonly_equals_reference(models):
    """Every weight-only linear of a Mamba, an mLSTM and an sLSTM slot on
    the same float inputs, with and without the float32 weights that
    ``prepare_folded`` caches."""
    rng = np.random.default_rng(1)
    for mixer, (arch, i) in sorted(SLOTS.items()):
        m = models(arch)
        jf, tf = _slot(m, i)
        prepared = S.prepare_folded(m["cfg"], m["tfolded"])["layers"][0][f"slot{i}"]["mx"]
        for name, lin in jf["mx"].items():
            if not isinstance(lin, dict):
                continue
            x = rng.standard_normal((2, 5, np.asarray(lin["w"]).shape[0] * 2)).astype(np.float32)
            want = np.asarray(JS._lin_wonly(jnp.asarray(x), lin))
            for f in (tf["mx"][name], prepared[name]):
                assert_island(S._lin_wonly(_t(x), f).numpy(), want, f"{mixer} {name}")


@pytest.mark.parametrize("mixer", sorted(SLOTS))
def test_recurrent_slot_equals_reference(models, mixer):
    """``_mamba_int`` / ``_xlstm_int`` on the same int8 input: the
    cache-less prefill over (2, 24) rows, then 8 decode steps from a zero
    state, written in place: output codes +-1 on at most
    ``FLIP_FRACTION``, the states within the island tolerance."""
    arch, i = SLOTS[mixer]
    m = models(arch)
    jcfg, cfg = m["jcfg"], m["cfg"]
    jf, tf = _slot(m, i)
    x = np.random.default_rng(2).integers(-127, 128, (2, 24, cfg.d_model)).astype(np.int8)
    jfn = jax.jit((lambda x, st: JS._mamba_int(x, jf, jcfg, st)) if mixer == "mamba" else
                  (lambda x, st: JS._xlstm_int(x, jf, jcfg, st, mixer)))
    tfn = (lambda x, st: S._mamba_int(x, tf, cfg, st)) if mixer == "mamba" else \
        (lambda x, st: S._xlstm_int(x, tf, cfg, mixer, st))
    want, _ = jfn(jnp.asarray(x), None)
    assert_codes(tfn(_t(x), None).numpy(), want, f"{mixer} cache-less prefill")
    jstate = {k: v[0] for k, v in JS.init_cache(jcfg, 2, 32)[f"slot{i}"].items()}
    tcache = S.init_cache(cfg, 2, 32, device="cpu")[f"slot{i}"]
    tstate = {k: v[0] for k, v in tcache.items()}
    got, want = [], []
    for t in range(8):
        w, jstate = jfn(jnp.asarray(x[:, t:t + 1]), jstate)
        want.append(np.asarray(w))
        got.append(tfn(_t(x[:, t:t + 1]), tstate).numpy())
    assert_codes(np.stack(got), np.stack(want), f"{mixer} 8 decode steps")
    for k in jstate:
        assert_island(tcache[k][0].numpy(), jstate[k], f"{mixer} state {k} after 8 steps", 1e-5)


def _reference_islands(jcfg):
    """``_mamba_int`` / ``_xlstm_int`` computed by the reference (jitted, as
    in its scanned forward) on the port's inputs, the state written back in
    place."""
    mamba = jax.jit(lambda x, f, st: JS._mamba_int(x, f, jcfg, st))
    xlstm = {k: jax.jit(lambda x, f, st, k=k: JS._xlstm_int(x, f, jcfg, st, k))
             for k in ("mlstm", "slstm")}

    def island(fn, x_i8, f, state):
        jst = None if state is None else {k: jnp.asarray(v.numpy()) for k, v in state.items()}
        out, new = fn(jnp.asarray(x_i8.numpy()), _j(f), jst)
        if state is not None:
            for k, v in new.items():
                state[k].copy_(_t(v))
        return _t(out)

    return (lambda x_i8, f, _cfg, state=None: island(mamba, x_i8, f, state),
            lambda x_i8, f, _cfg, kind, state=None: island(xlstm[kind], x_i8, f, state))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_forward_equals_reference(models, arch, monkeypatch):
    """The cache-less prefill over (2, 24) and 8 decode steps from an empty
    cache (the reference's greedy tokens fed to both): with the reference's
    islands injected, logits and cache equal bit for bit (the integer
    stages: LN, the residual adds, the rescales, attention, the MoE
    experts and the head; the islands jitted, so the states too); with the
    port's own islands, the differing logits counted and every greedy
    token equal."""
    m = models(arch)
    jcfg, cfg, jfolded, tfolded = m["jcfg"], m["cfg"], m["jfolded"], m["tfolded"]
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = [np.asarray(jax.jit(lambda f, t: JS.serve_forward(jcfg, f, t)[0])(
        jfolded, jnp.asarray(prompt)))]
    jcache = JS.init_cache(jcfg, 2, 32)
    toks, pos = [prompt[:, -1:]], np.zeros(2, np.int32)
    for _ in range(8):
        lg, jcache = m["jdecode"](jfolded, jcache, jnp.asarray(toks[-1]), jnp.asarray(pos))
        want.append(np.asarray(lg))
        toks.append(want[-1][:, -1].argmax(-1).astype(np.int32)[:, None])
        pos = pos + 1
    own = (S._mamba_int, S._xlstm_int)
    flips = {}
    for label, (mamba_fn, xlstm_fn) in (("reference islands", _reference_islands(jcfg)),
                                        ("own islands", own)):
        monkeypatch.setattr(S, "_mamba_int", mamba_fn)
        monkeypatch.setattr(S, "_xlstm_int", xlstm_fn)
        got = [S.serve_forward(cfg, tfolded, _t(prompt))[0].numpy()]
        tcache = S.init_cache(cfg, 2, 32, device="cpu")
        pos = np.zeros(2, np.int32)
        for tok in toks[:-1]:
            lg, tcache = S.serve_forward(cfg, tfolded, _t(tok), cache=tcache,
                                         pos_offset=_t(pos), mode="decode")
            got.append(lg.numpy())
            pos = pos + 1
        if label == "reference islands":
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            w_c, g_c = _flat(jax.tree.map(np.asarray, jcache)), _flat(tcache)
            assert w_c.keys() == g_c.keys()
            for k in w_c:
                np.testing.assert_array_equal(g_c[k], w_c[k], err_msg=k)
        flips[label] = sum(int((g != w).sum()) for g, w in zip(got, want))
        for g, w in zip(got[1:], want[1:]):
            assert (g[:, -1].argmax(-1) == w[:, -1].argmax(-1)).all(), label
    print(f"{arch} cache-less prefill (2, 24) + 8 decode steps: logits differing from the "
          f"reference's {flips} of {sum(w.size for w in want)}")
    assert flips["reference islands"] == 0


# --- the engines --------------------------------------------------------------------

def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(models, arch):
    """``cache_layout="auto"`` resolves to the contiguous layout; every
    prompt prefills through the batch-1 decode loop (``loop_prefill_steps``
    = the prompt tokens, no one-shot prefill), requests queue for the 2
    slots: events, tokens, counters and ``stats()`` equal."""
    m = models(arch)
    lens, max_new = [5, 12, 3, 9], [6, 4, 7, 5]
    runs = []
    for mod, cfg, folded in ((JE, m["jcfg"], m["jfolded"]), (E, m["cfg"], m["tfolded"])):
        eng = mod.Engine(cfg, folded, mod.EngineConfig(batch_slots=2, max_len=48))
        if mod is JE:
            eng._decode = m["jdecode"]
        reqs = [mod.Request(prompt=p, max_new_tokens=n)
                for p, n in zip(_prompts(cfg.vocab_size, lens, 5), max_new)]
        for r in reqs:
            eng.submit(r)
        ticks = []
        while eng.has_work:
            ticks.append([_event(e) for e in eng.poll()])
        runs.append((eng, reqs, ticks))
    (jeng, jreqs, jticks), (teng, treqs, tticks) = runs
    assert teng.layout == jeng.layout == "contiguous"
    assert tticks == jticks
    for j, t in zip(jreqs, treqs):
        assert t.status.value == j.status.value and t.finish_reason == j.finish_reason
        np.testing.assert_array_equal(t.out, j.out)
    assert teng.counters == jeng.counters
    assert teng.stats(check=True) == jeng.stats(check=True)
    c = teng.counters
    assert c["loop_prefill_steps"] == c["prefill_tokens"] == sum(lens)
    assert c["oneshot_prefills"] == 0 and c["completed"] == len(lens)


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_engine_matches_reference(models, arch):
    m = models(arch)
    prompts = _prompts(m["cfg"].vocab_size, [5, 9], 6)
    jeng = JE.LockstepEngine(m["jcfg"], m["jfolded"], JE.EngineConfig(batch_slots=2, max_len=48))
    # its scalar position as the (B,) vector the decode forward broadcasts
    # it to, so the module's compiled decode serves it
    jeng._decode = lambda f, c, t, p: m["jdecode"](f, c, t, jnp.broadcast_to(p, t.shape[:1]))
    jreqs = jeng.generate([JE.Request(prompt=p, max_new_tokens=6) for p in prompts])
    treqs = E.LockstepEngine(m["cfg"], m["tfolded"], E.EngineConfig(
        batch_slots=2, max_len=48)).generate([E.Request(prompt=p, max_new_tokens=6)
                                              for p in prompts])
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.out, j.out)
        assert t.status is E.RequestStatus.FINISHED


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_matches_lockstep(models, arch):
    """The reference's ``test_continuous_matches_lockstep_hybrid_arch`` in
    the port, for both archs: the decode-loop prefill gives each request
    the tokens a batch-1 lockstep run gives it."""
    m = models(arch)
    cfg, folded = m["cfg"], m["tfolded"]
    lens, max_news = [3, 7], [4, 4]
    prompts = _prompts(cfg.vocab_size, lens, 0)
    lock = E.LockstepEngine(cfg, folded, E.EngineConfig(batch_slots=1, max_len=32))
    truth = []
    for p, n in zip(prompts, max_news):
        lock.reset()
        truth.append(lock.generate([E.Request(prompt=p, max_new_tokens=n)])[0].out.tolist())
    eng = E.Engine(cfg, folded, E.EngineConfig(batch_slots=2, max_len=32))
    out = eng.generate([E.Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, max_news)])
    assert [r.out.tolist() for r in out] == truth
    assert eng.counters["oneshot_prefills"] == 0
    assert eng.counters["loop_prefill_steps"] == sum(lens)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_spec_and_chunking_refused_kv4_falls_back(models, arch):
    """As in the reference: the paged pool, speculative decoding and
    chunked prefill raise ``EngineConfigError`` on ``auto``; ``kv_bits=4``
    warns and falls back to 8; the paged pool itself refuses the arch."""
    m = models(arch)
    cfg, folded = m["cfg"], m["tfolded"]
    for kw in (dict(cache_layout="paged"), dict(spec_k=2), dict(max_prefill_chunk=16),
               dict(max_batched_tokens=32)):
        for mod, c, f in ((E, cfg, folded), (JE, m["jcfg"], m["jfolded"])):
            with pytest.raises(mod.EngineConfigError):
                mod.Engine(c, f, mod.EngineConfig(batch_slots=2, max_len=32, **kw))
    with pytest.raises(ValueError, match="recurrent mixer"):
        S.init_paged_cache(cfg, 9, 16, device="cpu")
    with pytest.warns(UserWarning, match="falling back to kv_bits=8"):
        eng = E.make_engine(cfg, folded, E.EngineConfig(batch_slots=2, max_len=32, kv_bits=4))
    assert eng.kv_bits == 8 and eng.layout == "contiguous" and isinstance(eng, E.Engine)


def test_cached_prefill_raises_naming_the_decode_loop(models):
    """A deliberate deviation: the reference's prefill with a cache returns
    a recurrent state unchanged; the port raises."""
    for arch in ARCHS:
        m = models(arch)
        cache = S.init_cache(m["cfg"], 1, 32, device="cpu")
        with pytest.raises(ValueError, match="decode loop"):
            S.serve_forward(m["cfg"], m["tfolded"], torch.zeros((1, 8), dtype=torch.int32),
                            cache=cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompts", "2",
                       "--prompt-len", "6", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "generated 8 tokens" in out and "layout=contiguous" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_writes_the_state_in_place_through_a_slot_view(models, arch):
    """Decode steps through a view of one slot of a 3-slot cache (as the
    engine's decode-loop prefill hands it over) write the recurrent state
    in place: the viewed slot ends equal to a batch-1 cache run alone, the
    other slots stay zero."""
    m = models(arch)
    cfg, folded = m["cfg"], S.prepare_folded(m["cfg"], m["tfolded"])
    cache = S.init_cache(cfg, 3, 32, device="cpu")
    view = {n: {leaf: t[:, 1:2] for leaf, t in c.items()} for n, c in cache.items()}
    alone = S.init_cache(cfg, 1, 32, device="cpu")
    toks = torch.tensor([[5], [77], [300], [9]], dtype=torch.int32)
    for t in range(4):
        for c in (view, alone):
            S.serve_forward(cfg, folded, toks[t:t + 1], cache=c, pos_offset=t, mode="decode")
    for n, c in cache.items():
        for leaf, t in c.items():
            assert torch.equal(t[:, 1:2], alone[n][leaf]), (n, leaf)
            assert not t[:, 0].any() and not t[:, 2].any(), (n, leaf)
    assert all(bool(cache[n][leaf].any()) for n, c in cache.items() for leaf in c
               if leaf not in ("k", "v"))


@pytest.mark.parametrize("e", [64, 512])
def test_key_scale_rounds_as_the_reference_graph(e):
    """The mLSTM's ``/ sqrt(E)`` inside the reference's scanned bodies (the
    QAT form's ``jnp.sqrt(E * 1.0)``, the serving form's ``math.sqrt``)
    is a multiply by the float32 reciprocal: equal to ``key_scale`` at E =
    64 (the smoke width) and 512 (xlstm-1.3b's), where a true division
    differs."""
    k = np.random.default_rng(e).standard_normal((3, 40, e)).astype(np.float32)
    for div in (lambda x: x / jnp.sqrt(x.shape[-1] * 1.0), lambda x: x / math.sqrt(e)):
        _, want = jax.lax.scan(lambda c, x, div=div: (c, div(x)), 0, jnp.asarray(k))
        np.testing.assert_array_equal((_t(k) * Xl.key_scale(e)).numpy(), np.asarray(want))
    assert (e == 64) == np.array_equal((_t(k) / math.sqrt(e)).numpy(), np.asarray(want))
