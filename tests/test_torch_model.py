"""The port's calibration forward, fold and integer serving forward against
the reference package, on the same weights (carried across as numpy)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.flash_qattention import flash_qattention_jax
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_qattention import flash_qattention_torch
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T

KEY = jax.random.PRNGKey(0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def _calibrated(kv_heads=None):
    extra = {} if kv_heads is None else {"n_kv_heads": kv_heads}
    jcfg = j_smoke("yi-6b", **extra)
    params = JT.init_params(jcfg, KEY)
    amax = JT.init_amax(jcfg)
    calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
    _, obs, _ = JT.forward(jcfg, params, amax, calib)
    return jcfg, params, amax, calib, obs


@pytest.fixture(scope="module")
def model():
    jcfg, params, amax, calib, obs = _calibrated()
    return dict(jcfg=jcfg, cfg=smoke_config("yi-6b"), params=params, amax=amax,
                calib=calib, obs=obs, jfolded=JF.fold_params(jcfg, params, obs))


def test_calibration_forward_obs_allclose(model):
    cfg = model["cfg"]
    params = F.params_from_numpy(_np_tree(model["params"]), "cpu")
    amax = F.params_from_numpy(_np_tree(model["amax"]), "cpu")
    logits, obs, _ = T.forward(cfg, params, amax, torch.from_numpy(np.array(model["calib"])))
    want, got = _flat(_np_tree(model["obs"])), _flat(obs)
    assert want.keys() == got.keys()
    # float reductions (norm means, matmul order) differ from XLA's by ulps
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    assert logits.shape == (2, 16, cfg.vocab_size)


def test_fold_gives_equal_integers(model):
    cfg = model["cfg"]
    params = F.params_from_numpy(_np_tree(model["params"]), "cpu")
    obs = F.params_from_numpy(_np_tree(model["obs"]), "cpu")
    got = _flat(F.fold_params(cfg, params, obs))
    want = _flat(_np_tree(model["jfolded"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flash_prefill_attention_flips_counted():
    """The cache-less causal prefill's attention: torch mirror vs the
    reference's flash_qattention_jax; +-1 codes from the fp32 exp island
    only, on at most 0.1 % of codes."""
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (4, 64, 32)).astype(np.int8)
    k = rng.integers(-127, 128, (1, 64, 32)).astype(np.int8)
    v = rng.integers(-127, 128, (1, 64, 32)).astype(np.int8)
    lut = jref.make_exp_lut_q7()
    M, sh, inv, osc = 23170, 19, np.float32(0.0071), np.float32(1.3)
    want = np.asarray(flash_qattention_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           M, sh, jnp.asarray(lut), inv, osc, bkv=16))
    got = flash_qattention_torch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 M, sh, torch.from_numpy(lut), inv, osc, bkv=16).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"flash prefill: {int((diff > 0).sum())} of {diff.size} codes differ")
    assert diff.max() <= 1 and (diff > 0).sum() <= 1e-3 * diff.size


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_cacheless_prefill_logits_argmax(kv_heads):
    jcfg, params, _, _, obs = _calibrated(kv_heads)
    jfolded = JF.fold_params(jcfg, params, obs)
    cfg = smoke_config("yi-6b", **({} if kv_heads is None else {"n_kv_heads": kv_heads}))
    folded = F.folded_from_numpy(_np_tree(jfolded), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 48)).astype(np.int32)
    want, _ = JS.serve_forward(jcfg, jfolded, jnp.asarray(toks))
    got, _ = S.serve_forward(cfg, folded, torch.from_numpy(toks))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    differ = int((got != want).sum())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"cache-less prefill (n_kv_heads={cfg.n_kv_heads}): {differ} of {got.size} "
          f"logits differ; argmax agrees on {agree:.4f} of rows")
    assert agree >= 0.99


def test_paged_prefill_and_decode_equal_on_ref(model):
    """A paged prefill chunk then 3 decode steps on the ref backend: equal
    logits and equal pools (the row-exact q8 datapath has no float carry)."""
    cfg, jcfg, jfolded = model["cfg"], model["jcfg"], model["jfolded"]
    folded = F.folded_from_numpy(_np_tree(jfolded), "cpu")
    psize, n_pages, b, nb = 8, 12, 2, 4
    btab = np.zeros((b, nb), np.int32)
    btab[0, :3] = [3, 7, 1]
    btab[1, :3] = [2, 5, 9]
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
    jcache = JS.init_paged_cache(jcfg, n_pages, psize)
    tcache = S.init_paged_cache(cfg, n_pages, psize, device="cpu")
    jl, jcache = JS.serve_forward(jcfg, jfolded, jnp.asarray(prompt), cache=jcache,
                                  pos_offset=jnp.int32(0), block_tables=jnp.asarray(btab))
    tl, tcache = S.serve_forward(cfg, folded, torch.from_numpy(prompt), cache=tcache,
                                 pos_offset=0, block_tables=torch.from_numpy(btab))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    pos = np.array([16, 16], np.int32)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jcache = JS.serve_forward(jcfg, jfolded, jnp.asarray(tok), cache=jcache,
                                      pos_offset=jnp.asarray(pos), mode="decode",
                                      block_tables=jnp.asarray(btab))
        tl, tcache = S.serve_forward(cfg, folded, torch.from_numpy(tok), cache=tcache,
                                     pos_offset=torch.from_numpy(pos), mode="decode",
                                     block_tables=torch.from_numpy(btab))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    want, got = _flat(_np_tree(jcache)), _flat(tcache)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_plain_int_matmul_is_exact():
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (3, 64, 4096)).astype(np.int8)
    b = rng.integers(-127, 128, (3, 4096, 16)).astype(np.int8)
    want = np.matmul(a.astype(np.int64), b.astype(np.int64))
    np.testing.assert_array_equal(
        tref.int_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
