"""The port's training path against the reference, at smoke size, on the
same weights and batches (carried across as numpy): the straight-through
fake-quant and its clip's gradient, the LUT softmax's gradient, the QAT
helpers of ``core/``, AdamW (float32 and int8 moments), gradient
compression, one ``make_train_step`` per arch family, gradient
accumulation, the BERT fine-tuning step, the recomputation (remat) levels,
the row-chunked attention and the token-chunked MLP.  The reference's train
step runs jitted without a mesh (its trainer's mesh fails under jax 0.9,
ROADMAP §3), once per case.

Tolerances (stated, every count outside them printed):

* ``fake_quant``'s gradient equals ``jax.grad``'s bit for bit; the LUT
  softmax's is within 1e-6 of its largest element (the port multiplies by
  float32 reciprocals where XLA divides, ROADMAP §3).
* One train step: loss and grad norm at rtol 1e-5.  The gradient of each
  leaf is read as the first moment after the step, (1 - b1) * clip * g,
  and held at 1e-5 of the leaf's largest element.  Three archs cross a
  known float island that flips activation codes (ROADMAP §3): qwen2-vl's
  M-RoPE (torch's cos/sin against XLA's) moves a few q/k codes (the grad
  norm then differs by 1.9e-5), and musicgen's and BERT's LayerNorm/MHA
  forward, whose P.V product XLA sums in an order no torch order matches,
  moves codes from the first layer on (loss 9.3e-5 and 3.4e-4
  apart).  llama3-405b and stablelm-1.6b cross the norms' float island:
  the port's ``rmsnorm`` / ``layernorm`` sum the mean square in torch's
  order and take torch's ``rsqrt``, XLA its own, so some norm outputs
  differ by an ulp, and where the largest one does, a whole site's scale
  moves (llama3: rep 1's norm1; stablelm: rep 0's norm1).  With the
  reference's norm outputs injected every slot equals the reference's bit
  for bit (``test_norms_are_the_first_differing_site``).  Their bounds,
  written before the test first ran: llama3 (1e-4, 2e-2, 2e-2), stablelm
  (5e-5, 2e-2, 2e-2); jamba's are explained in ``test_torch_train_jamba.py``.
  Whether a draw crosses the island is luck: yi-6b holds at 1e-5 with
  params from seeds 0 and 2 and misses it with seeds 1 and 3 (measured
  once, not a test).  The looser bounds are in ``ISLAND`` below.
* The new params: every element within ``PARAM_TOL`` x lr of the
  reference's (an AdamW step moves a param by about lr; where a gradient is
  near 0 its sign, and so the step's, is free).
* The new amax at rtol 1e-5 (the islands: ``ISLAND``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import fixedpoint as jfx
from repro.core import packing as jpk
from repro.core import qlayernorm as jqln
from repro.core import qlinear as jql
from repro.core import qsoftmax as jqs
from repro.core import quant as jq
from repro.core.policy import POLICY_FQ, POLICY_W8A8
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import bert as JB
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import packing as tpk
from repro_torch.core import qlayernorm as tqln
from repro_torch.core import qlinear as tql
from repro_torch.core import qsoftmax as tqs
from repro_torch.core import quant as tq
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import fold as F
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.train import steps as St

KEY = jax.random.PRNGKey(0)
LR = 1e-3
PARAM_TOL = 2.0
SECTIONS = (4, 6, 6)            # qwen2-vl's published (16, 24, 24) at head_dim 32
# arch -> (loss / grad-norm rtol, gradient rel-to-leaf-max, amax rtol[, bound on
# the norm of the gradients' difference over theirs]); that norm stays within
# 1e-5 of theirs (islands 5e-2 unless a fourth entry says otherwise)
EXACT = (1e-5, 1e-5, 1e-5)
ISLAND = {"qwen2-vl-2b": (5e-5, 2e-2, 1e-5),
          "musicgen-medium": (1e-3, 5e-2, 2e-2),
          "bert-base": (5e-3, 5e-1, 2e-2),
          "llama3-405b": (1e-4, 2e-2, 2e-2),
          "stablelm-1.6b": (5e-5, 2e-2, 2e-2),
          "jamba-1.5-large-398b/n_experts=0": (5e-5, 2e-2, 2e-2),
          "jamba-1.5-large-398b": (5e-3, 1.0, 5e-1, 2e-1)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor)
                               else tree, np.float64)}


def _held(what, want, got, rel_to_max, rel_norm=None):
    """Every leaf of ``got`` within ``rel_to_max`` x the leaf's largest
    |element| of ``want``; prints the worst leaf and the elements outside
    1e-5 of it."""
    fw, fg = _flat(want), _flat(got)
    assert fw.keys() == fg.keys()
    rel = (np.sqrt(sum(np.sum((fw[k] - fg[k]) ** 2) for k in fw))
           / np.sqrt(sum(np.sum(fw[k] ** 2) for k in fw)))
    worst, where, outside, total = 0.0, "", 0, 0
    for k in fw:
        scale = max(float(np.max(np.abs(fw[k]))), 1e-30)
        err = np.abs(fw[k] - fg[k]) / scale
        outside += int(np.sum(err > 1e-5))
        total += err.size
        if float(np.max(err)) > worst:
            worst, where = float(np.max(err)), k
    print(f"  {what}: worst {worst:.3g} of the leaf's max at {where}; "
          f"{outside} of {total} elements beyond 1e-5; difference norm {rel:.3g} of the norm")
    assert worst <= rel_to_max, (what, where, worst)
    assert rel <= (rel_norm or (1e-5 if rel_to_max <= 1e-5 else 5e-2)), (what, rel)


def _jinit(jcfg, opt):
    """The reference's initial state, built jitted (a third of the eager
    time)."""
    return jax.jit(lambda k: JSt.init_train_state(jcfg, k, opt))(KEY)


def _torch_state(jstate, opt):
    params = F.params_from_numpy(_np(jstate.params), "cpu")
    return St.TrainState(params=params, opt=A.init_state(params, opt),
                         amax=F.params_from_numpy(_np(jstate.amax), "cpu"),
                         step=torch.zeros((), dtype=torch.int32))


# --- fake-quant and the LUT softmax --------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_gradient_equals_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(0, 1, (64, 48)).astype(np.float32)
    w = rng.normal(0, 1, (64, 48)).astype(np.float32)
    m = np.float32(np.max(np.abs(x)) * 0.7)         # a third of x clipped
    want = np.asarray(jax.grad(lambda a: jnp.sum(jq.fake_quant(a, m, bits) * w))(x))
    xt = _t(x).requires_grad_(True)
    (tq.fake_quant(xt, torch.tensor(m), bits) * _t(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_fake_quant_clip_bound_passes_half_the_gradient():
    """An element on the clip's bound gets half its gradient, as through
    ``jnp.clip``; ``torch.clamp`` would pass all of it."""
    x = np.asarray([-2.0, -1.0, 0.3, 1.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jq.fake_quant(a, 2.0, 8)))(x))
    np.testing.assert_array_equal(want, [0.5, 1, 1, 1, 0.5])
    xt = _t(x).requires_grad_(True)
    tq.fake_quant(xt, torch.tensor(2.0), 8).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_gamma_of_ones_gets_half_its_gradient():
    """A norm gamma starts at ones, all of it on its own MAX: the fake-quant
    passes half of the upstream gradient to every element (``qnorm``)."""
    up = np.arange(6, dtype=np.float32)

    def jf(g):
        return jnp.sum(jq.fake_quant(g, jax.lax.stop_gradient(jq.per_tensor_max(g)), 8) * up)

    want = np.asarray(jax.grad(jf)(jnp.ones(6)))
    np.testing.assert_array_equal(want, up / 2)
    g = torch.ones(6, requires_grad=True)
    (tq.fake_quant(g, tq.per_tensor_max(g.detach()), 8) * _t(up)).sum().backward()
    np.testing.assert_array_equal(g.grad.numpy(), want)


def test_ste_round_is_half_to_even_with_identity_gradient():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], requires_grad=True)
    y = tq.ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(), [-2, -2, -0, 0, 2, 2])
    (y * torch.arange(6.0)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.arange(6.0))


def test_lut_softmax_qat_gradient_matches_reference():
    rng = np.random.default_rng(1)
    lg = rng.normal(0, 2, (2, 3, 16, 40)).astype(np.float32)
    mask = np.tril(np.ones((16, 40), bool), 24)
    lg = np.where(mask, lg, np.float32(-1e9)).astype(np.float32)
    w = rng.normal(0, 1, lg.shape).astype(np.float32)
    s = np.float32(37.3)
    want = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(JL.lut_softmax_qat(a, s, True) * w)))(lg))
    lt = _t(lg).requires_grad_(True)
    (L.lut_softmax_qat(lt, torch.tensor(s), True) * _t(w)).sum().backward()
    err = np.abs(lt.grad.numpy() - want)
    print(f"  LUT softmax gradient: max |diff| {err.max():.3g}, largest |grad| "
          f"{np.abs(want).max():.3g}, {int(np.sum(err > 0))} of {err.size} differ")
    assert err.max() <= 1e-6 * np.abs(want).max()


# --- the QAT helpers of core/ --------------------------------------------------

def test_quant_helpers_equal_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (7, 33)).astype(np.float32)
    xt = _t(x)
    for bits in (4, 8, 12, 20):
        assert np.dtype(jq.storage_dtype(bits)).name == str(tq.storage_dtype(bits))[6:]
        s = jq.compute_scale(jnp.float32(3.1), bits)
        st = tq.compute_scale(torch.tensor(3.1), bits)
        np.testing.assert_array_equal(np.asarray(s), st.numpy())
        codes = jq.quantize(x, s, bits)
        np.testing.assert_array_equal(np.asarray(codes), tq.quantize(xt, st, bits).numpy())
        np.testing.assert_array_equal(np.asarray(jq.dequantize(codes, s)),
                                      tq.dequantize(_t(codes), st).numpy())
    b = rng.normal(0, 0.3, (33,)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jq.quantize_bias(b, 20.5, 7.25)),
                                  tq.quantize_bias(_t(b), 20.5, 7.25).numpy())
    ema = {"a": np.zeros(3, np.float32), "b": {"c": np.float32(2.0)}}
    obs = {"a": np.float32([1.0, -4.0, 2.0]), "b": {"c": np.float32(3.0)}}
    for _ in range(2):
        want = jq.ema_tree_update(ema, obs, 0.9)
        got = tq.ema_tree_update(T.tree_map(_t, ema), T.tree_map(_t, obs), 0.9)
        for k in ("a",):
            np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
        np.testing.assert_array_equal(np.asarray(want["b"]["c"]), got["b"]["c"].numpy())
        ema = _np(want)
    cal, tcal = jq.EMACalibrator(0.95), tq.EMACalibrator(0.95)
    np.testing.assert_array_equal(np.asarray(cal.update(cal.init(), x)),
                                  tcal.update(tcal.init(device="cpu"), xt).numpy())


@pytest.mark.parametrize("policy", [POLICY_FQ, POLICY_W8A8], ids=["w4a8", "w8a8"])
def test_qlinear_equals_reference(policy):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (5, 64)).astype(np.float32)
    w = rng.normal(0, 0.05, (64, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    for a_max in (0.0, 2.5):
        want = np.asarray(jql.qat_linear(x, w, b, jnp.float32(a_max), policy))
        got = tql.qat_linear(_t(x), _t(w), _t(b), torch.tensor(a_max), policy)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jql.observe(x)), tql.observe(_t(x)).numpy())
    jf = jql.fold_linear(w, b, 20.0, 15.0, policy)
    tf = tql.fold_linear(w, b, 20.0, 15.0, policy)
    for k in ("w_packed", "bias_i", "M", "shift"):
        np.testing.assert_array_equal(np.asarray(getattr(jf, k)), getattr(tf, k).numpy())
    xi = rng.integers(-127, 128, (5, 64)).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(jql.integer_linear_ref(xi, jf)),
                                  tql.integer_linear_ref(_t(xi), tf).numpy())


def test_core_fold_and_fixed_point_helpers_equal_reference():
    rng = np.random.default_rng(4)
    g, be = rng.normal(1, 0.3, (64,)), rng.normal(0, 0.2, (64,))
    for beta, sub in ((be, True), (None, False)):
        want, got = jqln.fold_layernorm(g, beta, 11.3, sub), tqln.fold_layernorm(g, beta, 11.3, sub)
        for k in ("gamma_i", "beta_aligned", "M_out", "shift_out"):
            np.testing.assert_array_equal(np.asarray(getattr(want, k)), getattr(got, k).numpy())
        assert want.subtract_mean == got.subtract_mean
    for s in (0.37, 12.5, 1e3):
        assert jqs.index_multiplier(s) == tqs.index_multiplier(s)
    v = rng.integers(1, 2**30, (4096,)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jfx.fixed_rsqrt(v)), tfx.fixed_rsqrt(_t(v)).numpy())
    f = rng.normal(0, 3, (100,)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jfx.to_fixed(f, 7)), tfx.to_fixed(_t(f), 7).numpy())
    np.testing.assert_array_equal(np.asarray(jfx.from_fixed(v, 7)),
                                  tfx.from_fixed(_t(v), 7).numpy())
    c = rng.integers(-8, 8, (6, 10, 4)).astype(np.int8)
    for axis in (0, 1, -1):
        packed = np.asarray(jpk.pack_int4(c, axis=axis))
        np.testing.assert_array_equal(tpk.pack_int4(_t(c), axis=axis).numpy(), packed)
        np.testing.assert_array_equal(tpk.unpack_int4(_t(packed), axis=axis).numpy(),
                                      np.asarray(jpk.unpack_int4(packed, axis=axis)))
        assert tpk.packed_nbytes(c.shape, axis) == jpk.packed_nbytes(c.shape, axis)


# --- AdamW and gradient compression --------------------------------------------

@pytest.mark.parametrize("quantize_moments", [False, True], ids=["f32", "int8"])
def test_apply_updates_matches_reference_over_five_steps(quantize_moments):
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(0, 0.1, (3, 8, 16)).astype(np.float32),
              "b": {"v": rng.normal(0, 0.1, (16,)).astype(np.float32)}}
    grads = [T.tree_map(lambda p, i=i: np.random.default_rng(i).normal(
        0, 0.5, p.shape).astype(np.float32), params) for i in range(5)]
    cfg = JA.AdamWConfig(lr=1e-2, quantize_moments=quantize_moments)
    tcfg = A.AdamWConfig(lr=1e-2, quantize_moments=quantize_moments)
    jp, js = params, JA.init_state(params, cfg)
    tp = T.tree_map(_t, params)
    ts = A.init_state(tp, tcfg)
    for g in grads:
        jp, js = JA.apply_updates(jp, g, js, cfg)
        tp, ts = A.apply_updates(tp, T.tree_map(_t, g), ts, tcfg)
        np.testing.assert_allclose(float(ts.pop("grad_norm")), float(js.pop("grad_norm")),
                                   rtol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp["b"]["v"].numpy(), np.asarray(jp["b"]["v"]), rtol=0, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    jm, tm = js["m"]["w"], ts["m"]["w"]
    if quantize_moments:       # the codes may move by one where a scale rounds apart
        assert isinstance(tm, A.QMoment) and tm.codes.dtype == torch.int8
        assert np.abs(tm.codes.numpy().astype(int) - np.asarray(jm.codes)).max() <= 1
        np.testing.assert_allclose(tm.scale.numpy(), np.asarray(jm.scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-9)


def test_compress_grads_matches_reference():
    rng = np.random.default_rng(6)
    grads = {"a": rng.normal(0, 1e-3, (32, 17)).astype(np.float32),
             "b": {"c": rng.normal(0, 5, (9,)).astype(np.float32)}}
    want = JSt._compress_grads(grads, 8)
    got = St._compress_grads(T.tree_map(_t, grads), 8)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))


# --- one train step per arch family --------------------------------------------

def _batch(arch, cfg, b=2, s=16):
    src = JSyntheticLM(cfg.vocab_size, s, b, seed=0,
                       n_codebooks=cfg.n_codebooks if cfg.frontend == "audio_codebooks" else 0,
                       vlm_patches=8 if cfg.frontend == "vision_stub" else 0,
                       d_model=cfg.d_model)
    return src.batch_at(0)


def _extra(arch):
    return {"mrope_sections": SECTIONS} if arch == "qwen2-vl-2b" else {}


def _compare_step(arch, jstate, jnew, jm, tnew, tm):
    loss_rtol, grad_tol, amax_rtol, *rel_norm = ISLAND.get(arch, EXACT)
    for k in ("loss", "grad_norm"):
        print(f"  {arch} {k}: reference {float(jm[k])!r}, port {float(tm[k])!r}")
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=loss_rtol)
    _held(f"{arch} gradients ((1 - b1) clip g)", _np(jnew.opt["m"]), tnew.opt["m"], grad_tol,
          *rel_norm)
    dp = max(float(np.max(np.abs(_flat(_np(jnew.params))[k] - _flat(tnew.params)[k])))
             for k in _flat(tnew.params))
    print(f"  {arch} new params: max |diff| {dp / LR:.3g} x lr")
    assert dp <= PARAM_TOL * LR
    fa, ta = _flat(_np(jnew.amax)), _flat(tnew.amax)
    worst = max(float(np.max(np.abs(fa[k] - ta[k]) / np.maximum(np.abs(fa[k]), 1e-30)))
                for k in fa)
    print(f"  {arch} new amax: worst relative difference {worst:.3g}")
    assert worst <= amax_rtol
    assert int(tnew.step) == 1 and int(tnew.opt["step"]) == 1


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b", "qwen2-moe-a2.7b", "qwen2-vl-2b",
                                  "musicgen-medium", "llama3-405b", "stablelm-1.6b"])
def test_train_step_matches_reference(arch):
    jcfg, cfg = j_smoke(arch, **_extra(arch)), smoke_config(arch, **_extra(arch))
    opt, topt = JA.AdamWConfig(lr=LR), A.AdamWConfig(lr=LR)
    jstate = _jinit(jcfg, opt)
    batch = _batch(arch, jcfg)
    jnew, jm = jax.jit(JSt.make_train_step(jcfg, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = St.make_train_step(cfg, topt)(_torch_state(jstate, topt),
                                             {k: _t(v) for k, v in batch.items()})
    _compare_step(arch, jstate, jnew, jm, tnew, tm)
    if cfg.n_experts:
        assert float(tm["aux"]) > 0
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)


def test_grad_accumulation_matches_reference():
    jcfg, cfg = j_smoke("yi-6b"), smoke_config("yi-6b")
    opt, topt = JA.AdamWConfig(lr=LR), A.AdamWConfig(lr=LR)
    jstate = _jinit(jcfg, opt)
    batch = _batch("yi-6b", jcfg, b=4)
    jnew, jm = jax.jit(JSt.make_train_step(jcfg, opt, accum_steps=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = St.make_train_step(cfg, topt, accum_steps=2)
    tnew, tm = step(_torch_state(jstate, topt), {k: _t(v) for k, v in batch.items()})
    _compare_step("yi-6b", jstate, jnew, jm, tnew, tm)
    # the same data in one batch: the same loss, near-identical update
    one, m1 = St.make_train_step(cfg, topt)(_torch_state(jstate, topt),
                                            {k: _t(v) for k, v in batch.items()})
    assert abs(float(m1["loss"]) - float(tm["loss"])) < 1e-3


def test_bert_train_step_matches_reference_and_loss_falls():
    jcfg, cfg = j_smoke("bert-base"), smoke_config("bert-base")
    # no clipping (the gradient norm is above 1): the first moments then hold
    # (1 - b1) g, whose norm gives the gradient's (the step's metrics carry
    # none, as the reference's)
    opt, topt = JA.AdamWConfig(lr=3e-3, grad_clip=1e9), A.AdamWConfig(lr=3e-3, grad_clip=1e9)
    params = jax.jit(lambda k: JB.init_bert_params(jcfg, k))(KEY)
    amax = JB.init_bert_amax(jcfg)
    jstate = JSt.TrainState(params, JA.init_state(params, opt), amax, jnp.zeros((), jnp.int32))
    toks = jax.random.randint(KEY, (4, 24), 0, jcfg.vocab_size)
    mask = jnp.ones((4, 24), bool).at[:, 20:].set(False)
    batch = {"tokens": toks, "mask": mask, "labels": jnp.asarray([0, 1, 0, 1])}
    jnew, jm = jax.jit(JSt.make_bert_train_step(jcfg, opt))(jstate, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    state = _torch_state(jstate, topt)
    step = St.make_bert_train_step(cfg, topt)
    losses = []
    for i in range(6):
        state, m = step(state, tbatch)
        losses.append(float(m["loss"]))
        if i == 0:
            loss_rtol, grad_tol, amax_rtol = ISLAND["bert-base"]
            print(f"  bert-base loss: reference {float(jm['loss'])!r}, port {losses[0]!r}")
            np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=loss_rtol)
            np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]))
            _held("bert-base gradients ((1 - b1) clip g)", _np(jnew.opt["m"]), state.opt["m"],
                  grad_tol)
            want, got = (float(A.global_norm(T.tree_map(_t, _np(jnew.opt["m"])))) / 0.1,
                         float(A.global_norm(state.opt["m"])) / 0.1)
            print(f"  bert-base grad norm: reference {want!r}, port {got!r}")
            np.testing.assert_allclose(got, want, rtol=loss_rtol)
    print(f"  bert-base losses {losses}")
    assert losses[-1] < losses[0]
    assert int(state.step) == 6


# --- recomputation, chunking and what is not ported ------------------------------

def test_remat_levels_give_bit_equal_loss_and_gradients():
    cfg0 = smoke_config("yi-6b", n_layers=4, d_model=64, d_ff=64, vocab_size=128)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg0, gen)
    amax = T.init_amax(cfg0, "cpu")
    batch = {k: _t(v) for k, v in SyntheticLM(cfg0.vocab_size, 32, 2).batch_at(0).items()}
    runs = {}
    for remat, groups in ((False, 0), (True, 0), (True, 2), (False, 2)):
        cfg = dataclasses.replace(cfg0, remat=remat, remat_groups=groups)
        loss, _, grads = St.lm_loss_and_grads(cfg, params, amax, batch)
        runs[(remat, groups)] = (loss, grads)
    loss0, g0 = runs[(False, 0)]
    for key, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), key
        for a, b in zip(T.tree_leaves(grads), T.tree_leaves(g0), strict=True):
            assert torch.equal(a, b), key


def test_remat_around_row_chunks_gives_bit_equal_gradients():
    """At S = 1,024 the attention's row chunks are recomputed inside each
    recomputed layer (nested non-reentrant checkpoints): the loss and the
    gradients equal the run without either."""
    cfg0 = smoke_config("yi-6b", n_layers=1, d_model=32, n_heads=1, n_kv_heads=1, head_dim=32,
                        d_ff=32, vocab_size=128)
    params = T.init_params(cfg0, torch.Generator().manual_seed(0))
    amax = T.init_amax(cfg0, "cpu")
    batch = {k: _t(v) for k, v in SyntheticLM(cfg0.vocab_size, 1024, 1).batch_at(0).items()}
    loss0, _, g0 = St.lm_loss_and_grads(cfg0, params, amax, batch)
    cfg = dataclasses.replace(cfg0, remat=True)
    loss, _, grads = St.lm_loss_and_grads(cfg, params, amax, batch)
    assert torch.equal(loss, loss0)
    for a, b in zip(T.tree_leaves(grads), T.tree_leaves(g0), strict=True):
        assert torch.equal(a, b)


def test_row_chunked_attention_matches_reference():
    """At S = 1,024 (two chunks of 512 rows, each recomputed in the
    backward) the attention and its input gradient against the reference's
    row-chunked scan."""
    jcfg = j_smoke("yi-6b", d_model=64, n_heads=2, n_kv_heads=1, head_dim=32)
    cfg = smoke_config("yi-6b", d_model=64, n_heads=2, n_kv_heads=1, head_dim=32)
    p = _np(jax.jit(lambda k: JT.init_params(jcfg, k))(KEY)["blocks"]["slot0"]["attn"])
    p = {k: v[0] for k, v in p.items()}
    amax = {s: np.float32(0.0) for s in JT.ATTN_SITES}
    x = np.random.default_rng(7).normal(0, 1, (1, 1024, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1024, dtype=np.int32), (1, 1024))
    w = np.random.default_rng(8).normal(0, 1, (1, 1024, 64)).astype(np.float32)

    def jf(a):
        out, _ = JL.attention_qat(a, p, amax, jcfg.quant, jcfg, pos)
        return jnp.sum(out * w), out

    (_, want), gwant = jax.jit(jax.value_and_grad(jf, has_aux=True))(x)
    xt = _t(x).requires_grad_(True)
    out, _ = L.attention_qat(xt, T.tree_map(_t, p), T.tree_map(_t, amax), cfg.quant, cfg,
                             _t(pos))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    err = np.abs(xt.grad.numpy() - np.asarray(gwant))
    print(f"  attention at S=1024: input gradient max |diff| {err.max():.3g} of "
          f"{np.abs(np.asarray(gwant)).max():.3g}")
    assert err.max() <= 1e-4 * np.abs(np.asarray(gwant)).max()


def test_token_chunked_mlp_matches_reference():
    jcfg = j_smoke("yi-6b", d_model=16, d_ff=32)
    p = {k: v[0] for k, v in _np(jax.jit(lambda k: JT.init_params(jcfg, k))(KEY)[
        "blocks"]["slot0"]["mlp"]).items()}
    amax = {s: np.float32(0.0) for s in JT.MLP_SITES_SWIGLU}
    x = np.random.default_rng(9).normal(0, 1, (2, 5120, 16)).astype(np.float32)
    want, wobs = JT._chunked_mlp(x, p, amax, jcfg.quant, "swiglu")
    tp, ta = T.tree_map(_t, p), T.tree_map(_t, amax)
    got, gobs = T._chunked_mlp(_t(x), tp, ta, jcfg.quant, "swiglu")
    for k in wobs:               # the max over the chunks of each site
        np.testing.assert_allclose(gobs[k].numpy(), np.asarray(wobs[k]), rtol=1e-6)
    # each chunk is the plain MLP on its rows (its own batch statistics)
    for i in (0, 4608):
        y, _ = L.mlp_qat(_t(x)[:, i:i + 512], tp, ta, jcfg.quant, "swiglu")
        assert torch.equal(got[:, i:i + 512], y)
    # against the reference: SiLU's and the products' float islands move a
    # few h codes (one h_in step each), counted
    want = np.asarray(want)
    far = np.abs(got.numpy() - want) > 1e-5 * np.abs(want).max()
    print(f"  chunked MLP: {int(far.sum())} of {far.size} outputs beyond 1e-5 of the max")
    assert far.mean() < 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.1 * np.abs(want).max())


@pytest.mark.parametrize("arch", ["llama3-405b", "stablelm-1.6b"])
def test_norms_are_the_first_differing_site(arch):
    """Slot by slot, with the reference's slot input: the port's own norms
    move at least one norm output's largest element by an ulp in this draw
    (the island the step test crosses), and with the reference's norm
    outputs injected (taken from the same jitted slot) the port's slot
    output equals the reference's bit for bit."""
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jparams = jax.jit(lambda k: JT.init_params(jcfg, k))(KEY)
    jamax = JT.init_amax(jcfg)
    tparams = F.params_from_numpy(_np(jparams), "cpu")
    tamax = F.params_from_numpy(_np(jamax), "cpu")
    x = jnp.take(jparams["embed"]["tokens"], jnp.asarray(_batch(arch, jcfg)["tokens"]), axis=0)
    x, _ = JL.fake_quant_act(x, jamax["embed_out"], jcfg.quant.a_bits, True)
    pos = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32), x.shape[:2])
    moved = []
    for r in range(jcfg.n_reps):
        for i, (mixer, ffn) in enumerate(JT.slot_kinds(jcfg)):
            pj = jax.tree.map(lambda t, r=r: t[r], jparams["blocks"][f"slot{i}"])
            aj = jax.tree.map(lambda t, r=r: t[r], jamax["blocks"][f"slot{i}"])
            norms, inner = [], JL.qnorm

            def jslot(x, pj, aj, mixer=mixer, ffn=ffn, norms=norms, inner=inner):
                def recorded(*a, **k):
                    norms.append(inner(*a, **k))
                    return norms[-1]
                JL.qnorm = recorded
                try:
                    out = JT._apply_slot(jcfg, mixer, ffn, x, pj, aj, pos, None)
                finally:
                    JL.qnorm = inner
                return out[0], list(norms)

            want, jn = jax.jit(jslot)(x, pj, aj)
            jn = [_t(v) for v in jn]
            args = (T.tree_index(tparams["blocks"][f"slot{i}"], r),
                    T.tree_index(tamax["blocks"][f"slot{i}"], r), _t(pos), None)
            own, tinner = [], L.qnorm
            for inject in (False, True):
                it = iter(jn)
                L.qnorm = ((lambda *a, **k: next(it)) if inject
                           else (lambda *a, **k: own.append(tinner(*a, **k)) or own[-1]))
                try:
                    with torch.no_grad():
                        got, _, _ = T._apply_slot(cfg, mixer, ffn, _t(x), *args)
                finally:
                    L.qnorm = tinner
                differ = int((got.numpy() != np.asarray(want)).sum())
                print(f"  {arch} rep {r} slot {i}, {'reference' if inject else 'own'} norms: "
                      f"{differ} of {got.numel()} outputs differ")
                if inject:
                    assert differ == 0, (arch, r, i)
            moved += [bool(a.abs().max() != b.abs().max()) for a, b in zip(own, jn)]
            x = want
    print(f"  {arch}: {sum(moved)} of {len(moved)} norm outputs' largest element moved")
    assert any(moved)


def test_launcher_trains_on_the_cpu_and_refuses_the_mesh(capsys, tmp_path):
    launch_train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out
    assert (tmp_path / "step_000002" / "manifest.json").exists()
    # the production meshes need 256 and 512 devices; the CPU is one
    for flags, need in ((["--production-mesh"], 256), (["--production-mesh", "--multi-pod"], 512)):
        with pytest.raises(ValueError, match=f"needs {need} devices, found 1"):
            launch_train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", *flags])
