"""AdamW with optional int8-quantized moments, as the reference
``optim/adamw.py``: functional over nested dicts of tensors.

Moment quantization is the paper's symmetric-linear scheme with one scale
per last-axis vector (the second moment in the sqrt domain).  The update
runs in float32 whatever the parameter dtype, and casts back (bf16 params:
float32 moments).  A stacked (L, ...) leaf of three or more axes is updated
one layer slice at a time: the update is elementwise and the moment scales
are per last-axis vector, so the result is the same, and the float32
temporaries of the update stay the size of one layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.quant import rdiv
from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    quantize_moments: bool = False   # int8 m/v (paper-style symmetric)


class QMoment(NamedTuple):
    codes: torch.Tensor   # int8
    scale: torch.Tensor   # per-last-axis-vector fp32 scales


def _q(x: torch.Tensor) -> QMoment:
    """Per-last-axis-vector symmetric int8 quantization (first moment)."""
    if x.ndim == 0:
        s = rdiv(127.0, torch.clamp(torch.abs(x), min=1e-12))
        return QMoment(torch.round(x * s).to(torch.int8), s)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s = rdiv(127.0, torch.clamp(amax, min=1e-12))
    return QMoment(torch.clamp(torch.round(x * s), -127, 127).to(torch.int8), s)


def _dq(m: QMoment) -> torch.Tensor:
    return m.codes.to(F32) / m.scale


def _q_v(x: torch.Tensor) -> QMoment:
    """Second moment in the sqrt domain: int8 codes of sqrt(v), which halves
    the dynamic range the 8 bits must cover (the update takes sqrt(v))."""
    r = torch.sqrt(torch.clamp(x, min=0.0))
    if x.ndim == 0:
        s = rdiv(127.0, torch.clamp(r, min=1e-12))
        return QMoment(torch.round(r * s).to(torch.int8), s)
    amax = torch.amax(r, dim=-1, keepdim=True)
    s = rdiv(127.0, torch.clamp(amax, min=1e-12))
    return QMoment(torch.clamp(torch.round(r * s), 0, 127).to(torch.int8), s)


def _dq_v(m: QMoment) -> torch.Tensor:
    r = m.codes.to(F32) / m.scale
    return r * r


def _q_zeros(shape, device) -> QMoment:
    """``_q`` (and ``_q_v``) of zeros of ``shape``: zero codes and the
    scale of an all-zero vector, 127 / 1e-12, in every vector's place."""
    s = rdiv(127.0, torch.clamp(torch.zeros((), dtype=F32, device=device), min=1e-12))
    scale = s if not shape else s.expand((*shape[:-1], 1)).contiguous()
    return QMoment(torch.zeros(shape, dtype=torch.int8, device=device), scale)


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    def zero_like(p):
        if cfg.quantize_moments:
            return _q_zeros(tuple(p.shape), p.device)
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zero_like, params), "v": tree_map(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(F32)))
    return torch.sqrt(total)


def update_scalars(step: torch.Tensor, gn: torch.Tensor, cfg: AdamWConfig,
                   lr_scale: float = 1.0) -> Tuple:
    """(clip, b1c, b2c, lr) of the step numbered ``step`` (1 for the first)
    at the gradients' global norm ``gn``: what every leaf's update shares."""
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    step_f = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=step.device), step_f)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=step.device), step_f)
    return clip, b1c, b2c, cfg.lr * lr_scale


def _upd(p, g, m, v, scalars, cfg: AdamWConfig):
    clip, b1c, b2c, lr = scalars
    qm = cfg.quantize_moments
    g = g.to(F32) * clip
    m_f = _dq(m) if qm else m
    v_f = _dq_v(v) if qm else v
    m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
    v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
    u = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
    u = u + cfg.weight_decay * p.to(F32)
    p_new = (p.to(F32) - lr * u).to(p.dtype)
    if qm:
        return p_new, _q(m_f), _q_v(v_f)
    return p_new, m_f, v_f


def update_leaf(p, g, m, v, scalars, cfg: AdamWConfig):
    """(new p, new m, new v) of one leaf: elementwise, with int8 moments'
    scales per last-axis vector of the whole leaf.  A stacked leaf of three
    or more axes is updated one layer slice at a time, each slice's results
    written into the stacked outputs."""
    qm = cfg.quantize_moments
    if p.ndim < 3:
        return _upd(p, g, m, v, scalars, cfg)

    def layer(mo, i):
        return QMoment(mo.codes[i], mo.scale[i]) if qm else mo[i]

    bufs = None
    for i in range(p.shape[0]):
        parts = [t for o in _upd(p[i], g[i], layer(m, i), layer(v, i), scalars, cfg)
                 for t in (o if isinstance(o, QMoment) else (o,))]
        if bufs is None:
            bufs = [torch.empty((p.shape[0], *t.shape), dtype=t.dtype, device=t.device)
                    for t in parts]
        for buf, t in zip(bufs, parts, strict=True):
            buf[i] = t
    if qm:
        return bufs[0], QMoment(*bufs[1:3]), QMoment(*bufs[3:5])
    return tuple(bufs)


def apply_updates(params, grads, state, cfg: AdamWConfig,
                  lr_scale: float = 1.0) -> Tuple[Any, Dict]:
    """One AdamW step.  Returns (new params, {"m", "v", "step",
    "grad_norm"}), the norm taken before clipping."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scalars = update_scalars(step, gn, cfg, lr_scale)
    out = [update_leaf(p, g, m, v, scalars, cfg)
           for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                 tree_leaves(state["m"]), tree_leaves(state["v"]), strict=True)]
    return (tree_unflatten(params, [o[0] for o in out]),
            {"m": tree_unflatten(state["m"], [o[1] for o in out]),
             "v": tree_unflatten(state["v"], [o[2] for o in out]),
             "step": step, "grad_norm": gn})
