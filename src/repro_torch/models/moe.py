"""Mixture-of-Experts layer (GShard-style capacity dispatch) for the QAT
forward (calibration and training), and the routing the integer forward
shares; its load-balancing loss reaches the training loss (``train.steps.
lm_loss``).

A copy in torch of the reference ``models/moe.py``.  Router logits stay
float32; each token's top-k experts take it in the order the tokens come,
up to ``capacity`` rows an expert, and a token an expert has no room for is
dropped (its ``dest`` is the sentinel row ``E * cap``).  Dispatch and
combine are indexed writes and gathers: ``dest`` is unique apart from the
sentinel row, so an indexed write equals the reference's scatter-add.

The float steps follow the reference's float32 order where it is known:
the softmax's row sum in XLA's order (``layers.xla_row_sum``), the gate
renormalization summed over the k choices in order, the combine a
separate multiply and add per choice.  Its ``exp`` and the router product
are torch's (a counted float island, ROADMAP §3).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.layers import Obs, fake_quant_act, xla_row_sum

CAPACITY_FACTOR = 1.25
MOE_SITES = ("exp_in", "exp_g", "exp_u", "exp_h")
MOE_SHARED_SITES = ("shr_in", "shr_g", "shr_u", "shr_h")


def capacity(tokens: int, n_experts: int, top_k: int, factor=CAPACITY_FACTOR) -> int:
    """Rows each expert takes in a forward of ``tokens`` rows (every row of
    the forward, padding and idle slots included)."""
    c = int(math.ceil(tokens * top_k * factor / n_experts))
    return max(c, top_k, 4)


def router_softmax(gate_logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the experts in float32: exp of the gap to the
    row max, over the row sum in XLA's order."""
    lg = gate_logits.to(torch.float32)
    e = torch.exp(lg - torch.amax(lg, -1, keepdim=True))
    return e / xla_row_sum(e)[..., None]


def topk_routing(gate_logits: torch.Tensor, top_k: int, cap: int):
    """Routing plan of (T, E) router logits: per choice, the flat
    destination row in [0, E*cap] (``E*cap``: dropped) and the
    renormalized combine weight, (k, T) each, and the load-balancing loss."""
    t, e = gate_logits.shape
    dev = gate_logits.device
    probs = router_softmax(gate_logits)
    remaining = probs
    fill = torch.zeros((e,), dtype=torch.int32, device=dev)
    load = torch.zeros((e,), dtype=torch.float32, device=dev)
    dests, gates = [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, -1)                                    # (T,)
        onehot = torch.nn.functional.one_hot(idx, e).to(torch.float32)
        gate = torch.gather(probs, 1, idx[:, None])[:, 0]
        pos = fill[None, :] + torch.cumsum(onehot, 0).to(torch.int32) - 1
        pos_tok = torch.gather(pos, 1, idx[:, None])[:, 0]
        keep = (pos_tok < cap) & (pos_tok >= 0)
        dests.append(torch.where(keep, idx.to(torch.int32) * cap + pos_tok,
                                 torch.full_like(pos_tok, e * cap)))
        gates.append(torch.where(keep, gate, torch.zeros_like(gate)))
        taken = torch.sum(onehot * keep[:, None], 0)
        load = load + taken
        fill = fill + taken.to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    me = torch.mean(probs, 0)
    aux = e * torch.sum(me * (load / t)) / max(top_k, 1)
    denom = gates[0]
    for g in gates[1:]:
        denom = denom + g
    denom = torch.clamp(denom, min=1e-9)
    return torch.stack(dests), torch.stack([g / denom for g in gates]), aux


def scatter_dispatch(x: torch.Tensor, dest: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """x (T, d), dest (k, T) -> xe (E*cap, d), zero where no token landed."""
    xe = torch.zeros((e * cap + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(dest.shape[0]):
        xe[dest[i].long()] = x
    return xe[:-1]


def gather_combine(ye_flat: torch.Tensor, dest: torch.Tensor, gates: torch.Tensor,
                   dtype) -> torch.Tensor:
    """ye_flat (E*cap, d), dest/gates (k, T) -> y (T, d): per choice in
    order, a multiply and then an add (a dropped choice reads a zero row)."""
    yp = torch.cat([ye_flat, torch.zeros_like(ye_flat[:1])], 0)
    y = None
    for i in range(dest.shape[0]):
        term = gates[i][:, None] * yp[dest[i].long()]
        y = term if y is None else y + term
    return y.to(dtype)


def _expert_ffn_qat(xe, p, amax, policy: QuantPolicy, prefix: str):
    """xe (E, C, d); stacked expert weights (E, d, f) / (E, f, d), fake
    quantized under one maximum over the whole stack."""
    obs: Obs = {}

    def fq_w(w):
        if not policy.quantize_wa:
            return w
        return q.fake_quant(w, q.per_tensor_max(w.detach()).to(w.dtype), policy.w_bits)

    def fq(x, site):
        return fake_quant_act(x, amax[f"{prefix}_{site}"], policy.a_bits, policy.quantize_wa)

    xq, obs[f"{prefix}_in"] = fq(xe, "in")
    g = torch.einsum("ecd,edf->ecf", xq, fq_w(p["wg"]))
    u = torch.einsum("ecd,edf->ecf", xq, fq_w(p["wu"]))
    g, obs[f"{prefix}_g"] = fq(torch.nn.functional.silu(g), "g")
    u, obs[f"{prefix}_u"] = fq(u, "u")
    h, obs[f"{prefix}_h"] = fq(g * u, "h")
    return torch.einsum("ecf,efd->ecd", h, fq_w(p["wd"])), obs


def moe_qat(x: torch.Tensor, p: Dict, amax: Dict, policy: QuantPolicy,
            cfg) -> Tuple[torch.Tensor, Obs, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), obs, aux loss)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    obs: Obs = {}
    gate_logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    cap = capacity(t, cfg.n_experts, cfg.top_k)
    dest, gates, aux = topk_routing(gate_logits, cfg.top_k, cap)
    xe = scatter_dispatch(xt, dest, cfg.n_experts, cap).reshape(cfg.n_experts, cap, d)
    ye, o = _expert_ffn_qat(xe, p["experts"], amax, policy, "exp")
    obs.update(o)
    yt = gather_combine(ye.reshape(cfg.n_experts * cap, d), dest, gates, x.dtype)
    if cfg.n_shared_experts:
        xs = xt[None].expand(cfg.n_shared_experts, t, d)
        ys, o = _expert_ffn_qat(xs, p["shared"], amax, policy, "shr")
        obs.update(o)
        yt = yt + torch.sum(ys, 0)
    return yt.reshape(b, s, d), obs, aux
