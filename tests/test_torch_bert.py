"""The port's BERT path against the reference package on the smoke
``bert-base`` (2 layers, d=128, 4 heads, hd 32), under the paper's policy
``POLICY_FQ`` (W4A8) and the Q8BERT point ``POLICY_W8A8``: the float QAT
forward and classifier, the fold, and the integer serving forward, on the
same weights (carried across as numpy) and the same numpy-seeded tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import policy as JP
from repro.models import bert as JB
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.core import policy as TP
from repro_torch.models import bert as B
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T

KEY = jax.random.PRNGKey(0)
POLICIES = ("POLICY_FQ", "POLICY_W8A8")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=POLICIES)
def bert(request):
    """Reference weights, its calibration over (2, 128) tokens, its fold."""
    pol = request.param
    jcfg = dataclasses.replace(j_smoke("bert-base"), quant=getattr(JP, pol))
    cfg = dataclasses.replace(smoke_config("bert-base"), quant=getattr(TP, pol))
    params = JT.init_params(jcfg, KEY)
    amax = JT.init_amax(jcfg)
    calib = _tokens((2, 128), 3, cfg.vocab_size)
    _, obs, _ = JT.forward(jcfg, params, amax, jnp.asarray(calib))
    return dict(pol=pol, jcfg=jcfg, cfg=cfg, params=params, amax=amax, calib=calib,
                obs=obs, jfolded=JF.fold_params(jcfg, params, obs))


def test_bert_classify_and_forward_allclose():
    """The float QAT forward with a padding mask: classifier and MLM logits
    and every observation within float32 reduction-order noise (the
    matmuls, norms and GELU sum in another order than XLA's)."""
    jcfg = j_smoke("bert-base")
    cfg = smoke_config("bert-base")
    params = JB.init_bert_params(jcfg, KEY)
    amax = JB.init_bert_amax(jcfg)
    toks = _tokens((4, 24), 5, cfg.vocab_size)
    mask = np.ones((4, 24), bool)
    mask[:, 20:] = False
    tparams = F.params_from_numpy(_np_tree(params), "cpu")
    tamax = F.params_from_numpy(_np_tree(amax), "cpu")
    tt, tm = torch.from_numpy(toks), torch.from_numpy(mask)

    want, wobs, _ = JB.bert_classify(jcfg, params, amax, jnp.asarray(toks), jnp.asarray(mask))
    got, gobs, _ = B.bert_classify(cfg, tparams, tamax, tt, tm)
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    w, g = _flat(_np_tree(wobs)), _flat(gobs)
    assert w.keys() == g.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0, err_msg=k)

    want, wobs, _ = JB.bert_forward(jcfg, params, amax, jnp.asarray(toks), jnp.asarray(mask))
    got, gobs, _ = B.bert_forward(cfg, tparams, tamax, tt, tm)
    assert got.shape == (4, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    w, g = _flat(_np_tree(wobs)), _flat(gobs)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0, err_msg=k)


def test_init_bert_params_layout():
    cfg = smoke_config("bert-base")
    params = B.init_bert_params(cfg, torch.Generator().manual_seed(0), n_classes=3)
    want = _np_tree(JB.init_bert_params(j_smoke("bert-base"), KEY, n_classes=3))
    got = _flat(params)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in _flat(want).items()}
    assert set(_flat(B.init_bert_amax(cfg, "cpu"))) == set(_flat(JB.init_bert_amax(j_smoke(
        "bert-base"))))


def test_fold_of_reference_obs_equal(bert):
    cfg = bert["cfg"]
    params = F.params_from_numpy(_np_tree(bert["params"]), "cpu")
    obs = F.params_from_numpy(_np_tree(bert["obs"]), "cpu")
    _assert_trees_equal(F.fold_params(cfg, params, obs), _np_tree(bert["jfolded"]))


@pytest.mark.parametrize("impl", ["ref", "gpu"])
def test_serve_forward_on_reference_fold_equal(bert, impl, monkeypatch):
    """The cache-less integer forward on the reference's folded params: equal
    logits on both backends (on CPU tensors the gpu backend's wrappers
    compute the plain versions of quant_softmax and the GEMMs)."""
    monkeypatch.setenv("REPRO_TORCH_KERNELS", impl)
    cfg, jcfg, jfolded = bert["cfg"], bert["jcfg"], bert["jfolded"]
    toks = _tokens((2, 64), 1, cfg.vocab_size)
    want, _ = JS.serve_forward(jcfg, jfolded, jnp.asarray(toks))
    got, _ = S.serve_forward(cfg, F.folded_from_numpy(_np_tree(jfolded), "cpu"),
                             torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_own_calibration_fold_and_serve_equal(bert):
    """The port's own calibrate -> fold -> serve: calibrating over rows of
    128 keys, the QAT softmax simulator reproduces XLA's float32 result
    (ROADMAP §3), so the folded integers and the logits equal the
    reference's; the count of differing logits is printed."""
    cfg = bert["cfg"]
    params = F.params_from_numpy(_np_tree(bert["params"]), "cpu")
    amax = F.params_from_numpy(_np_tree(bert["amax"]), "cpu")
    _, obs, _ = T.forward(cfg, params, amax, torch.from_numpy(bert["calib"]))
    folded = F.fold_params(cfg, params, obs)
    _assert_trees_equal(folded, _np_tree(bert["jfolded"]))
    toks = _tokens((2, 64), 1, cfg.vocab_size)
    want, _ = JS.serve_forward(bert["jcfg"], bert["jfolded"], jnp.asarray(toks))
    got, _ = S.serve_forward(cfg, folded, torch.from_numpy(toks))
    differ = int((got.numpy() != np.asarray(want)).sum())
    print(f"{bert['pol']}: own calibration, {differ} of {got.numel()} logits differ")
    assert differ == 0


def test_lm_head_takes_an_exact_product_past_2_24():
    """w8 codes at d_model=1152: partial sums reach 1152*127*127 > 2^24, so
    float32 would round; the head runs in float64 and equals the int64
    product."""
    cfg = dataclasses.replace(smoke_config("bert-base", d_model=1152),
                              quant=TP.POLICY_W8A8)
    assert S.head_dtype(cfg) == torch.float64
    assert S.head_dtype(dataclasses.replace(cfg, d_model=768)) == torch.float32
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, (1152, 16)).astype(np.int8)
    w[:, 0] = 127
    w[0, 0] = 126                              # an odd sum above 2^24
    folded = {"lm_head": {"w": torch.from_numpy(w), "inv_acc": torch.tensor(1.0)}}
    x = np.full((1, 1152), 127, np.int8)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    hw = S.head_weights(cfg, folded)
    assert hw.dtype == torch.float64
    np.testing.assert_array_equal((torch.from_numpy(x).to(hw.dtype) @ hw).numpy(), exact)
    f32 = torch.from_numpy(x).float() @ hw.float()
    assert (f32.double().numpy() != exact).any()       # float32 would not be exact


def test_entry_points_default_to_the_card(monkeypatch):
    """``calibrated_folded`` defaults to ``cuda`` and raises without a card;
    on ``cpu`` it folds BERT under both policies with w8 codes plain int8."""
    from repro_torch.launch.serve import calibrated_folded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("bert-base", n_layers=1)
    with pytest.raises(RuntimeError, match="cuda"):
        calibrated_folded(cfg, 0)
    for pol, dtype in ((TP.POLICY_FQ, torch.uint8), (TP.POLICY_W8A8, torch.int8)):
        c = dataclasses.replace(cfg, quant=pol)
        folded = calibrated_folded(c, 0, device="cpu")
        assert folded["blocks"]["slot0"]["w1"]["w"].dtype == dtype
        assert folded["lm_head"]["w"].dtype == dtype
        logits, _ = S.serve_forward(c, folded, torch.from_numpy(_tokens((1, 16), 2, 512)))
        assert logits.shape == (1, 16, 512) and bool(torch.isfinite(logits).all())
