"""Loss and train-step builders, as the reference ``train/steps.py``.

``train_step``: QAT loss -> gradients (autograd through the straight-through
fake-quant) -> optional int8 gradient compression -> AdamW (optionally int8
moments) -> EMA update of the activation-calibration tree (paper Eq. 3).

A step is a function of (state, batch) that returns a new ``TrainState``;
it modifies no tensor of the state it is given.  The reference's
``jit_train_step`` (its shardings and donation) waits for the mesh, ROADMAP
Open items §1, item 8.  Every config trains here: attention, dense, MoE and
recurrent (Mamba, mLSTM, sLSTM) archs, the frontends and BERT.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import ema_tree_update, rdiv
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt: Any
    amax: Any
    step: torch.Tensor


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     opt_cfg: adamw.AdamWConfig) -> TrainState:
    """Random params from ``gen``, zero moments and amax, on ``gen.device``."""
    params = T.init_params(cfg, gen)
    return TrainState(params=params, opt=adamw.init_state(params, opt_cfg),
                      amax=T.init_amax(cfg, gen.device),
                      step=torch.zeros((), dtype=torch.int32, device=gen.device))


def init_bert_train_state(cfg: ModelConfig, gen: torch.Generator,
                          opt_cfg: adamw.AdamWConfig) -> TrainState:
    from repro_torch.models import bert as B

    params = B.init_bert_params(cfg, gen)
    return TrainState(params=params, opt=adamw.init_state(params, opt_cfg),
                      amax=B.init_bert_amax(cfg, gen.device),
                      step=torch.zeros((), dtype=torch.int32, device=gen.device))


def _sharded_ce(lg: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32: logsumexp minus the target's logit.
    The reference picks the target by a one-hot einsum (it keeps a
    vocab-sharded axis sharded); every other term of that sum is 0, so a
    gather picks the same float32 value without the (..., V) one-hot."""
    lg = lg.to(torch.float32)
    lse = torch.logsumexp(lg, -1)
    picked = torch.gather(lg, -1, tgt.long()[..., None])[..., 0]
    return torch.mean(lse - picked)


def lm_loss(cfg: ModelConfig, params, amax, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE + ``AUX_WEIGHT`` x the MoE aux loss.  batch: {'tokens':
    (B, S) or (B, K, S), 'extra_embeds'?, 'pos3'?}.  Audio archs score each
    codebook; the vision stub's image rows are not scored."""
    tokens = batch["tokens"]
    logits, obs, aux = T.forward(cfg, params, amax, tokens,
                                 extra_embeds=batch.get("extra_embeds"),
                                 pos3=batch.get("pos3"))
    if cfg.frontend == "audio_codebooks":
        tgt, lg = tokens[:, :, 1:], logits[:, :, :-1]
    else:
        tgt, lg = tokens[:, 1:], logits[:, :-1]
        if batch.get("extra_embeds") is not None:
            lg = lg[:, batch["extra_embeds"].shape[1]:]
    loss = _sharded_ce(lg, tgt)
    return loss + AUX_WEIGHT * aux, {"obs": obs, "ce": loss.detach(), "aux": aux.detach()}


def value_and_grad(fn, params):
    """(value, aux, grads) of ``fn(params) -> (scalar, aux)``: each gradient
    in its param's dtype, zeros for a param the loss does not reach (as
    ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in T.tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = fn(T.tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads, strict=True)]
    return loss.detach(), aux, T.tree_unflatten(params, grads)


def lm_loss_and_grads(cfg: ModelConfig, params, amax, batch):
    """(loss, aux, grads) of ``lm_loss`` for one (micro)batch."""
    return value_and_grad(lambda p: lm_loss(cfg, p, amax, batch), params)


def _compress_grads(grads, bits: int):
    """int8 gradient compression (per-tensor symmetric quantize-dequantize),
    which the reference applies before the data-parallel reduction."""
    def qdq(g):
        g32 = g.to(torch.float32)
        amax = torch.amax(torch.abs(g32))
        s = rdiv(2.0 ** (bits - 1) - 1, torch.clamp(amax, min=1e-12))
        return torch.round(g32 * s) / s
    return T.tree_map(qdq, grads)


def _tree_max(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_max([t[k] for t in trees]) for k in trees[0]}
    out = trees[0]
    for t in trees[1:]:
        out = torch.maximum(out, t)
    return out


def _finish(cfg, opt_cfg, ema_decay, state: TrainState, grads, obs):
    """Compression, AdamW and the EMA: the new state and the grad norm."""
    if cfg.quant.grad_compress_bits:
        grads = _compress_grads(grads, cfg.quant.grad_compress_bits)
    new_params, new_opt = adamw.apply_updates(state.params, grads, state.opt, opt_cfg)
    gn = new_opt.pop("grad_norm")
    return TrainState(params=new_params, opt=new_opt,
                      amax=ema_tree_update(state.amax, obs, ema_decay),
                      step=state.step + 1), gn


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    ema_decay: float = 0.99, accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics)`` with metrics loss,
    ce, aux and grad_norm (0-d tensors).  ``accum_steps`` > 1 splits the
    batch into that many microbatches along axis 0 and sums their float32
    gradients; the observations are the max over the microbatches."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if accum_steps == 1:
            loss, aux, grads = lm_loss_and_grads(cfg, state.params, state.amax, batch)
            obs, ce, aux_l = aux["obs"], aux["ce"], aux["aux"]
        else:
            gsum, loss_sum, obs_all = None, 0.0, []
            for i in range(accum_steps):
                mb = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, aux, grads = lm_loss_and_grads(cfg, state.params, state.amax, mb)
                grads = T.tree_map(lambda g: g.to(torch.float32), grads)
                gsum = grads if gsum is None else _tree_add(gsum, grads)
                loss_sum = loss_sum + loss
                obs_all.append(aux["obs"])
            grads = T.tree_map(lambda g: g / accum_steps, gsum)
            loss = loss_sum / accum_steps
            obs, ce = _tree_max(obs_all), loss
            aux_l = torch.zeros((), dtype=torch.float32, device=loss.device)
        new_state, gn = _finish(cfg, opt_cfg, ema_decay, state, grads, obs)
        return new_state, {"loss": loss, "ce": ce, "aux": aux_l, "grad_norm": gn}

    return train_step


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return a + b


def bert_loss(cfg: ModelConfig, params, amax, batch):
    """Classification NLL + ``AUX_WEIGHT`` x aux, and (obs, accuracy)."""
    from repro_torch.models import bert as B

    logits, obs, aux = B.bert_classify(cfg, params, amax, batch["tokens"], batch.get("mask"))
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, 1, batch["labels"].long()[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == batch["labels"]).to(torch.float32))
    return torch.mean(nll) + AUX_WEIGHT * aux, {"obs": obs, "acc": acc}


def make_bert_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, ema_decay: float = 0.99):
    """Classification fine-tuning step (the paper's SST-2 setting): batch
    {'tokens', 'mask'?, 'labels'}; metrics loss and acc."""

    def train_step(state: TrainState, batch):
        loss, aux, grads = value_and_grad(lambda p: bert_loss(cfg, p, state.amax, batch),
                                          state.params)
        new_state, _ = _finish(cfg, opt_cfg, ema_decay, state, grads, aux["obs"])
        return new_state, {"loss": loss, "acc": aux["acc"]}

    return train_step
