"""BERT's training path against the reference, piece by piece, at smoke size:
the LayerNorm ``qnorm`` with its fake-quantized gamma and beta, the
learned-position embedding, the pooler -> tanh -> classifier head and
``bert_loss``, each outside the attention's float island (XLA sums the P.V
product in its own order, so a whole BERT step is held only at
``ISLAND["bert-base"]`` in ``test_torch_train.py``); then a 20-step loss
trajectory of the smoke BERT against the reference's jitted step.

Tolerances (stated before the tests first ran, every count printed):

* ``qnorm(..., "layernorm")``: the gradients of x, gamma and beta within 1e-5
  of each leaf's largest element of ``jax.grad`` of the reference (jitted).
* The embedding, the final LayerNorm, the head and the loss: one
  ``make_bert_train_step`` with every block replaced by the identity on both
  sides (the same patch), at ``EXACT``: loss and accuracy at rtol 1e-5, every
  gradient leaf within 1e-5 of its maximum, the new amax at rtol 1e-5.
* The trajectory: 20 steps of each side's own step from the same state on
  the same batches (synthetic SST-2); each step's loss within 2e-2 of the
  reference's, relative (a BERT step's loss crosses the P.V island: 3.4e-4
  apart on ``test_bert_train_step_matches_reference_and_loss_falls``'s
  batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.policy import POLICY_FQ
from repro.models import bert as JB
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.train import steps as St
from test_torch_train import KEY, _held, _np, _t, _torch_state


@pytest.mark.parametrize("shape,affine", [((4, 24, 32), False), ((4, 24, 32), True),
                                          ((2, 16, 128), True)])
def test_qnorm_layernorm_gradients_match_reference(shape, affine):
    rng = np.random.default_rng(shape[-1] + affine)
    x = rng.normal(0, 2, shape).astype(np.float32)
    d = shape[-1]
    p = ({"gamma": rng.normal(1, 0.2, d).astype(np.float32),
          "beta": rng.normal(0, 0.3, d).astype(np.float32)} if affine else
         {"gamma": np.ones(d, np.float32), "beta": np.zeros(d, np.float32)})
    w = rng.normal(0, 1, shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, q: jnp.sum(JL.qnorm(a, q, POLICY_FQ, "layernorm") * w),
                            argnums=(0, 1)))(x, p)
    xt = _t(x).requires_grad_(True)
    pt = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    (L.qnorm(xt, pt, POLICY_FQ, "layernorm") * _t(w)).sum().backward()
    _held(f"qnorm layernorm {shape} {'random' if affine else 'ones/zeros'} affine",
          {"x": np.asarray(want[0]), **_np(want[1])},
          {"x": xt.grad, **{k: v.grad for k, v in pt.items()}}, 1e-5)


def _identity_slots(monkeypatch):
    """Every block the identity, on both sides: its sites observe 0."""
    def jslot(cfg_, mixer, ffn, x, p, amax, pos, mask):
        return x, {s: jnp.zeros((), jnp.float32) for s in amax}, jnp.zeros((), jnp.float32)

    def tslot(cfg_, mixer, ffn, x, p, amax, pos, mask):
        zero = torch.zeros((), dtype=torch.float32)
        return x, {s: zero for s in amax}, zero

    monkeypatch.setattr(JT, "_apply_slot", jslot)
    monkeypatch.setattr(T, "_apply_slot", tslot)


def _bert_batch(b=4, s=24, vocab=512, step=0):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    toks[:, 1:5] = rng.integers(0, 32, (b, 4))
    labels = ((toks < 16).sum(1) > ((toks >= 16) & (toks < 32)).sum(1)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[:, s - 4:] = False
    return {"tokens": toks, "mask": mask, "labels": labels}


def _bert_states(jcfg, opt, topt):
    params = jax.jit(lambda k: JB.init_bert_params(jcfg, k))(KEY)
    amax = JB.init_bert_amax(jcfg)
    jstate = JSt.TrainState(params, JA.init_state(params, opt), amax, jnp.zeros((), jnp.int32))
    return jstate, _torch_state(jstate, topt)


def test_embed_final_norm_head_and_loss_match_reference(monkeypatch):
    """The learned-position embedding and its fake-quant, the final
    LayerNorm, the pooler -> tanh -> classifier head and ``bert_loss`` (NLL
    + aux, accuracy) of one BERT step, the blocks the identity on both
    sides: EXACT."""
    jcfg, cfg = j_smoke("bert-base"), smoke_config("bert-base")
    assert cfg.learned_pos and cfg.norm_type == "layernorm"
    _identity_slots(monkeypatch)
    opt, topt = JA.AdamWConfig(lr=3e-3, grad_clip=1e9), A.AdamWConfig(lr=3e-3, grad_clip=1e9)
    jstate, tstate = _bert_states(jcfg, opt, topt)
    batch = _bert_batch()
    jnew, jm = jax.jit(JSt.make_bert_train_step(jcfg, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = St.make_bert_train_step(cfg, topt)(tstate, {k: _t(v) for k, v in batch.items()})
    print(f"  loss: reference {float(jm['loss'])!r}, port {float(tm['loss'])!r}")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]), rtol=1e-5)
    grads = _np(jnew.opt["m"])
    for leaf in (grads["backbone"]["embed"]["pos"], grads["backbone"]["final_norm"]["beta"],
                 grads["pooler"]["w"], grads["classifier"]["w"]):
        assert np.abs(leaf).max() > 0          # the pieces under test get a gradient
    _held("embed, final norm, head, loss: gradients ((1 - b1) g)", grads, tnew.opt["m"], 1e-5)
    fa = {k: np.asarray(v) for k, v in _np(jnew.amax).items() if k != "blocks"}
    for k, v in fa.items():
        np.testing.assert_allclose(tnew.amax[k].numpy(), v, rtol=1e-5, err_msg=k)


def test_bert_loss_trajectory_matches_reference_over_20_steps():
    """20 steps of the smoke BERT on each side from the same state, each on
    its own trajectory, on the same synthetic SST-2 batches: every step's
    loss within 2e-2 of the reference's (relative); the gaps printed."""
    jcfg, cfg = j_smoke("bert-base"), smoke_config("bert-base")
    opt, topt = JA.AdamWConfig(lr=1e-3), A.AdamWConfig(lr=1e-3)
    jstate, tstate = _bert_states(jcfg, opt, topt)
    jstep = jax.jit(JSt.make_bert_train_step(jcfg, opt))
    tstep = St.make_bert_train_step(cfg, topt)
    gaps, want, got = [], [], []
    for i in range(20):
        batch = _bert_batch(step=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
        gaps.append(abs(got[-1] - want[-1]) / abs(want[-1]))
    print("  step gaps (relative): " + ", ".join(f"{g:.2g}" for g in gaps))
    print(f"  losses: reference {want[0]:.4f} -> {want[-1]:.4f}, port {got[0]:.4f} -> "
          f"{got[-1]:.4f}")
    assert max(gaps) <= 2e-2
    assert int(tstate.step) == 20
