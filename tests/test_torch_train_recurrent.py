"""Training the recurrent mixers (xlstm-1.3b's mLSTM and sLSTM, jamba's
Mamba) against the reference, at smoke size, on the same weights and
inputs (carried across as numpy): the gate functions' gradient rules, the
tie rules, the chunked selective scan, the causal conv, the parallel mLSTM
across its 512-row chunks, the sLSTM loop, xlstm's ``make_train_step``,
recomputation on recurrent slots, and the launcher.

Tolerances (stated, every count outside them printed):

* ``softplus`` and ``sigmoid``: the port's backward applied to the
  reference's forward output equals ``jax.grad`` bit for bit (the rules are
  JAX's); ``softplus``'s with XLA's ``exp`` injected, since torch's ``exp``
  differs from XLA's on some inputs (the recurrent cores' float island,
  ROADMAP §3).  ``silu`` = ``x * sigmoid(x)`` through that rule: within
  1e-6 of its largest gradient (XLA fuses the product rule's two terms in an
  order no torch order tried matched; the count is printed).
* Ties: ``jabs``, ``torch.amax`` and ``torch.maximum`` give ``jnp.abs``'s,
  ``jnp.max``'s and ``jnp.maximum``'s gradients exactly.
* ``ssm_chunked`` (3 chunks, the last ragged), ``causal_conv``,
  ``mlstm_parallel`` at S = 1,024 (two chunks) and the sLSTM block over 64
  steps: every gradient leaf within 1e-5 of the leaf's largest element of
  ``jax.grad`` of the reference.
* One train step: xlstm-1.3b at ``EXACT`` (rtol 1e-5 for loss and grad norm,
  1e-5 of each gradient leaf's maximum, amax at rtol 1e-5); jamba's step is
  in ``test_torch_train_jamba.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.policy import POLICY_FP32
from repro.models import mamba as JMb
from repro.models import transformer as JT
from repro.models import xlstm as JXl
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba as Mb
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as Xl
from repro_torch.optim import adamw as A
from repro_torch.train import steps as St
from test_torch_train import (
    LR,
    _batch,
    _compare_step,
    _jinit,
    _np,
    _t,
    _torch_state,
)

KEY = jax.random.PRNGKey(0)


def _grads_held(what, want, got, rel=1e-5):
    """Each gradient within ``rel`` of its leaf's largest |element|;
    prints the worst leaf and the elements beyond 1e-5."""
    worst, where, outside = 0.0, "", 0
    for name, w, g in zip(want.keys(), want.values(), got):
        w = np.asarray(w, np.float64)
        err = np.abs(g.numpy().astype(np.float64) - w) / max(float(np.abs(w).max()), 1e-30)
        outside += int(np.sum(err > 1e-5))
        if float(err.max()) >= worst:
            worst, where = float(err.max()), name
    print(f"  {what}: worst {worst:.3g} of the leaf's max at {where}; {outside} elements "
          "beyond 1e-5")
    assert worst <= rel, (what, where, worst)


def _torch_grads(fn, inputs, w):
    ts = [_t(a).requires_grad_(True) for a in inputs]
    (fn(*ts) * _t(w)).sum().backward()
    return [t.grad for t in ts]


# --- the gate functions' gradient rules and the ties ----------------------------

def _xla_exp(v: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.jit(jnp.exp)(v.numpy())))


def test_softplus_gradient_is_jaxs_rule():
    """``logaddexp``'s rule, ``g * exp(x - out)``: 0.5 at 0 (autograd
    through the forward's clamp and abs gives 1), equal to ``jax.grad`` bit
    for bit from the reference's forward output with XLA's exp."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 3, 1 << 18), [0.0, -0.0, np.inf, -np.inf, 90.0, -90.0]])
    x = x.astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    out_j, vjp = jax.vjp(jax.jit(jax.nn.softplus), x)
    want = np.asarray(jax.jit(vjp)(g)[0])
    got = Mb.softplus_grad(_t(x), _t(np.asarray(out_j)), _t(g), exp=_xla_exp).numpy()
    np.testing.assert_array_equal(got, want)
    xt = _t(x).requires_grad_(True)
    out = Mb.softplus(xt)
    (out * _t(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  Mb.softplus_grad(_t(x), out.detach(), _t(g)).numpy())
    z = torch.zeros(3, requires_grad=True)
    Mb.softplus(z).sum().backward()
    assert z.grad.tolist() == [0.5] * 3 == [float(jax.grad(jax.nn.softplus)(0.0))] * 3
    plain = _t(x).requires_grad_(True)
    (torch.clamp(plain, min=0) + torch.log1p(torch.exp(-torch.abs(plain)))).backward(_t(g))
    print(f"  softplus: {int(np.sum(xt.grad.numpy() != want))} of {x.size} gradients differ "
          "from jax.grad (torch's exp/log1p island); autograd through the formula: "
          f"{int(np.sum(plain.grad.numpy() != want))}")
    # log_sigmoid, the xLSTM forget gates': -softplus(-x), 0.5 at 0
    z = torch.zeros(2, requires_grad=True)
    Xl.log_sigmoid(z).sum().backward()
    assert z.grad.tolist() == [0.5, 0.5] == [float(jax.grad(jax.nn.log_sigmoid)(0.0))] * 2


def test_sigmoid_and_silu_gradients_are_jaxs_rules():
    """``lax.logistic``'s rule ``g * (y * (1 - y))``: from the reference's
    forward output, ``jax.grad`` bit for bit (torch's autograd multiplies
    in another order); ``silu`` = ``x * sigmoid(x)`` within 1e-6 of its
    largest gradient."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, 1 << 18).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(jax.jit(jax.nn.sigmoid), x)
    want = np.asarray(jax.jit(vjp)(g)[0])
    np.testing.assert_array_equal(Mb.sigmoid_grad(_t(np.asarray(y_j)), _t(g)).numpy(), want)
    xt = _t(x).requires_grad_(True)
    y = Mb.sigmoid(xt)
    y.backward(_t(g))
    torch_rule = _t(x).requires_grad_(True)
    torch.sigmoid(torch_rule).backward(_t(g))
    print(f"  sigmoid: {int(np.sum(xt.grad.numpy() != want))} of {x.size} gradients differ "
          f"from jax.grad (forward island), {int(np.sum(torch_rule.grad.numpy() != want))} "
          "with torch's rule")
    same = y.detach().numpy() == np.asarray(y_j)
    _, svjp = jax.vjp(jax.jit(jax.nn.silu), x)
    swant = np.asarray(jax.jit(svjp)(g)[0])
    sx = _t(x).requires_grad_(True)
    Mb.silu(sx).backward(_t(g))
    err = np.abs(sx.grad.numpy() - swant)
    print(f"  silu: the two sigmoids differ on {int((~same).sum())} inputs; the gradients on "
          f"{int((err > 0).sum())}, at most {err.max() / np.abs(swant).max():.3g} of the largest")
    assert err.max() <= 1e-6 * np.abs(swant).max()


def test_tie_rules_match_jax():
    """``jabs`` passes the gradient whole at 0 and -0 (``jnp.abs``);
    ``torch.amax`` and ``torch.maximum`` split a tie evenly, as ``jnp.max``
    and ``jnp.maximum`` (the mLSTM's stabilizer and normalizer)."""
    x = np.asarray([-1.5, -0.0, 0.0, 2.0], np.float32)
    xt = _t(x).requires_grad_(True)
    (Xl.jabs(xt) * torch.arange(1.0, 5.0)).sum().backward()
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.abs(a) * jnp.arange(1.0, 5.0)))(x))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(want, [-1, 2, 3, 4])
    t = np.asarray([[1.0, 3.0, 3.0, -np.inf], [2.0, 2.0, 2.0, 0.0]], np.float32)
    tt = _t(t).requires_grad_(True)
    torch.amax(tt, dim=1).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(),
                                  np.asarray(jax.grad(lambda a: jnp.sum(jnp.max(a, 1)))(t)))
    a, b = np.float32([1.0, 2.0, 0.5]), np.float32([1.0, 1.0, 0.5])
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    torch.maximum(at, bt).sum().backward()
    ja, jb = jax.grad(lambda u, v: jnp.sum(jnp.maximum(u, v)), (0, 1))(a, b)
    np.testing.assert_array_equal(at.grad.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(jb))


# --- the cores' gradients against jax.grad ---------------------------------------

def test_ssm_chunked_and_causal_conv_gradients_match_reference():
    """S = 300: three chunks of 128, the last ragged (zero-padded), the
    state carried between them; every input's gradient."""
    rng = np.random.default_rng(2)
    bt, s, d_in, n = 2, 300, 16, 8
    x = rng.normal(0, 1, (bt, s, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-3, 1, (bt, s, d_in)))).astype(np.float32)
    B, C = (rng.normal(0, 1, (bt, s, n)).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.normal(0, 1, (d_in, n))).astype(np.float32)
    D = rng.normal(0, 1, (d_in,)).astype(np.float32)
    w = rng.normal(0, 1, (bt, s, d_in)).astype(np.float32)
    inputs = (x, dt, B, C, A, D)
    names = ("x", "dt", "B", "C", "A", "D")
    want = jax.jit(jax.grad(lambda *a: jnp.sum(JMb._ssm_chunked(*a) * w),
                            argnums=tuple(range(6))))(*inputs)
    got = _torch_grads(Mb.ssm_chunked, inputs, w)
    _grads_held("ssm_chunked at S=300", dict(zip(names, want)), got)
    kw = rng.normal(0, 0.5, (4, d_in)).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, k: jnp.sum(JMb._causal_conv(a, k)[0] * w),
                            argnums=(0, 1)))(x, kw)
    got = _torch_grads(lambda a, k: Mb.causal_conv(a, k)[0], (x, kw), w)
    _grads_held("causal_conv", {"x": want[0], "w": want[1]}, got)


def test_mlstm_parallel_gradient_matches_reference_across_chunks(monkeypatch):
    """S = 1,024: two 512-row chunks, each recomputed in the backward (one
    ``remat`` per chunk, as the reference's ``jax.checkpoint``); every
    input's gradient, ``logf``'s through ``cumsum``'s autograd backward."""
    rng = np.random.default_rng(3)
    b, s, h, e = 1, 1024, 2, 16
    q, k, v = (rng.normal(0, 1, (b, s, h, e)).astype(np.float32) for _ in range(3))
    gi = rng.normal(0, 1, (b, s, h)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(rng.normal(2, 1, (b, s, h)).astype(np.float32)))
    w = rng.normal(0, 1, (b, s, h, e)).astype(np.float32)
    inputs = (q, k, v, gi, logf)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(JXl.mlstm_parallel(*a) * w),
                            argnums=tuple(range(5))))(*inputs)
    chunks = []
    inner = Xl.remat

    def counted(fn, *a):
        chunks.append(a[2])
        return inner(fn, *a)

    monkeypatch.setattr(Xl, "remat", counted)
    got = _torch_grads(Xl.mlstm_parallel, inputs, w)
    assert chunks == [0, 512]
    _grads_held("mlstm_parallel at S=1024", dict(zip(("q", "k", "v", "gi", "logf"), want)), got)


def test_slstm_block_gradient_matches_reference_over_64_steps():
    """The sLSTM block (its loop over 64 steps) without fake-quant
    (``POLICY_FP32``), on the smoke xlstm's slot-0 weights: the input's and
    every weight's gradient."""
    jcfg = j_smoke("xlstm-1.3b")
    p = {k: v[0] for k, v in _np(jax.jit(lambda key: JT.init_params(jcfg, key))(KEY)[
        "blocks"]["slot0"]["mixer"]).items()}
    amax = {site: np.float32(0.0) for site in JXl.SLSTM_SITES}
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 64, jcfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    names = sorted(p)

    def jf(a, *ps):
        out, _, _ = JXl.slstm_qat(a, dict(zip(names, ps)), amax, POLICY_FP32, jcfg)
        return jnp.sum(out * w)

    want = jax.jit(jax.grad(jf, argnums=tuple(range(len(names) + 1))))(x, *[p[k] for k in names])
    cfg = smoke_config("xlstm-1.3b")
    tamax = {k: _t(v) for k, v in amax.items()}
    got = _torch_grads(lambda a, *ps: Xl.slstm_qat(a, dict(zip(names, ps)), tamax, POLICY_FP32,
                                                   cfg)[0], (x, *[p[k] for k in names]), w)
    _grads_held("sLSTM block over 64 steps", dict(zip(["x", *names], want)), got)


# --- one train step per recurrent arch ---------------------------------------------

@pytest.fixture(scope="module")
def reference_step():
    """The reference's initial state and its jitted step on one batch."""
    jcfg = j_smoke("xlstm-1.3b")
    opt = JA.AdamWConfig(lr=LR)
    jstate = _jinit(jcfg, opt)
    batch = _batch("xlstm-1.3b", jcfg)
    jnew, jm = jax.jit(JSt.make_train_step(jcfg, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return jstate, batch, jnew, jm


def test_train_step_matches_reference(reference_step):
    jstate, batch, jnew, jm = reference_step
    topt = A.AdamWConfig(lr=LR)
    tnew, tm = St.make_train_step(smoke_config("xlstm-1.3b"), topt)(
        _torch_state(jstate, topt), {k: _t(v) for k, v in batch.items()})
    _compare_step("xlstm-1.3b", jstate, jnew, jm, tnew, tm)


@pytest.mark.parametrize("arch,pattern,s", [("xlstm-1.3b", ("s", "x"), 64),
                                            ("xlstm-1.3b", ("x",), 1024),
                                            ("jamba-1.5-large-398b", None, 160)],
                         ids=["xlstm-sx-64", "xlstm-x-1024", "jamba-160"])
def test_remat_levels_give_bit_equal_loss_and_gradients_on_recurrent_slots(arch, pattern, s):
    """``cfg.remat`` recomputes every slot of a super-block, the recurrent
    ones included, and ``remat_groups`` each group of super-blocks: loss and
    gradients equal the run without recomputation.  xlstm's sLSTM and
    mLSTM slots, and its mLSTM at S = 1,024 (the parallel form's 512-row
    chunks recomputed inside each recomputed super-block); jamba across two
    Mamba chunks."""
    base = smoke_config(arch)
    pattern = pattern or base.pattern
    cfg0 = smoke_config(arch, n_layers=2 * len(pattern), block_pattern=pattern, d_model=32,
                        n_heads=2, n_kv_heads=2, head_dim=16, d_ff=base.d_ff and 32,
                        vocab_size=64, **({"n_experts": 2} if base.n_experts else {}))
    params = T.init_params(cfg0, torch.Generator().manual_seed(0))
    amax = T.init_amax(cfg0, "cpu")
    batch = {k: _t(v) for k, v in SyntheticLM(cfg0.vocab_size, s, 1).batch_at(0).items()}
    runs = {}
    for remat, groups in ((False, 0), (True, 0), (True, 2)):
        cfg = dataclasses.replace(cfg0, remat=remat, remat_groups=groups)
        loss, _, grads = St.lm_loss_and_grads(cfg, params, amax, batch)
        runs[(remat, groups)] = (loss, grads)
    loss0, g0 = runs[(False, 0)]
    assert torch.isfinite(loss0)
    for key, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), key
        for a, b in zip(T.tree_leaves(grads), T.tree_leaves(g0), strict=True):
            assert torch.equal(a, b), key


def test_launcher_trains_xlstm_on_the_cpu(capsys, tmp_path):
    launch_train.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out
    assert (tmp_path / "step_000002" / "manifest.json").exists()
