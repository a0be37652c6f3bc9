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

Routing spans the data ranks of a sharded train step as the reference's
global step does.  A token's choices depend on its own probabilities only
(``topk_choices``), so a rank needs nothing of the others' rows but their
(k, E) choice counts: ``route`` gathers every rank's
(``collectives.all_gather_counts``), and ``plan`` places this rank's
choices after the kept rows of the forward's earlier choices and the ranks
ahead of it, with the capacity of every rank's rows and the aux loss
against the whole forward's kept load.  Outside a data rank the counts are
this forward's own, and ``plan`` is ``topk_routing``.  Each rank's dispatch
buffer is the global capacity's: the rows of the other ranks' tokens stay 0.

The float steps follow the reference's float32 order where it is known:
the softmax's row sum in XLA's order (``layers.xla_row_sum``), the gate
renormalization summed over the k choices in order, the combine a
separate multiply and add per choice, SiLU as ``x * sigmoid(x)`` with
``lax.logistic``'s gradient (``layers.silu``).  Its ``exp`` and the router
product are torch's (a counted float island, ROADMAP §3).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core import quant as q
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.layers import (Obs, _group, _parts, fake_quant_act, fake_quant_parts,
                                       silu, xla_row_sum)
from repro_torch.sharding import collectives as C

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


def topk_choices(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """(k, T) int64: each token's experts in choice order, the argmax of its
    probabilities with the experts of its earlier choices masked out.  A
    choice depends on its token's probabilities alone, not on whether an
    earlier one was kept."""
    remaining, idx = probs, []
    for _ in range(top_k):
        i = torch.argmax(remaining, -1)
        idx.append(i)
        remaining = remaining * (1.0 - torch.nn.functional.one_hot(i, probs.shape[1])
                                 .to(torch.float32))
    return torch.stack(idx)


def choice_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(k, E) int32: the tokens choosing each expert at each choice."""
    return torch.nn.functional.one_hot(idx, n_experts).sum(1).to(torch.int32)


def plan(probs: torch.Tensor, idx: torch.Tensor, cap: int, before: torch.Tensor,
         totals: torch.Tensor, tokens: int):
    """Routing plan of these rows' choices within a forward of ``tokens``
    rows: ``before`` (k, E) counts the forward's rows ahead of these (other
    data ranks'), ``totals`` (k, E) all of its rows'.  Choice i of a token
    takes the next row of its expert after the rows kept by the forward's
    choices < i and its rows ahead at choice i; it is kept below ``cap``.
    Returns (dest (k, T) in [0, E*cap], E*cap where dropped; combine weights
    (k, T); the load-balancing loss of these rows' mean probabilities against
    the forward's kept load)."""
    e = probs.shape[1]
    fill = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    load = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    dests, gates = [], []
    for i in range(idx.shape[0]):
        onehot = torch.nn.functional.one_hot(idx[i], e).to(torch.float32)
        gate = torch.gather(probs, 1, idx[i][:, None])[:, 0]
        pos = (fill + before[i])[None, :] + torch.cumsum(onehot, 0).to(torch.int32) - 1
        pos_tok = torch.gather(pos, 1, idx[i][:, None])[:, 0]
        keep = (pos_tok < cap) & (pos_tok >= 0)
        dests.append(torch.where(keep, idx[i].to(torch.int32) * cap + pos_tok,
                                 torch.full_like(pos_tok, e * cap)))
        gates.append(torch.where(keep, gate, torch.zeros_like(gate)))
        taken = torch.minimum(totals[i], cap - fill)
        load = load + taken.to(torch.float32)
        fill = fill + taken
    me = torch.mean(probs, 0)
    aux = e * torch.sum(me * (load / tokens)) / max(idx.shape[0], 1)
    denom = gates[0]
    for g in gates[1:]:
        denom = denom + g
    denom = torch.clamp(denom, min=1e-9)
    return torch.stack(dests), torch.stack([g / denom for g in gates]), aux


def topk_routing(gate_logits: torch.Tensor, top_k: int, cap: int):
    """Routing plan of (T, E) router logits, every row of the forward here:
    per choice, the flat destination row in [0, E*cap] (``E*cap``: dropped)
    and the renormalized combine weight, (k, T) each, and the load-balancing
    loss."""
    probs = router_softmax(gate_logits)
    idx = topk_choices(probs, top_k)
    counts = choice_counts(idx, probs.shape[1])
    return plan(probs, idx, cap, torch.zeros_like(counts), counts, probs.shape[0])


def route(gate_logits: torch.Tensor, n_experts: int, top_k: int):
    """``topk_routing`` over the whole (micro)batch of a data-parallel step:
    this rank's rows are its block of it, in rank order.  Outside a data
    rank (``sharding.collectives.data_rank``) the rows are the whole
    forward.  Inside one, every rank's (k, E) counts are gathered (one
    ``all_gather_counts`` a layer): capacity counts every rank's rows, a
    choice's row follows the kept rows of the forward's earlier choices and
    the ranks ahead of this one, and the aux loss weighs this rank's mean
    probabilities against the forward's kept load, so the ranks' mean aux is
    the whole batch's.  Returns (cap, dest, gates, aux)."""
    probs = router_softmax(gate_logits)
    t = probs.shape[0]
    idx = topk_choices(probs, top_k)
    counts = choice_counts(idx, n_experts)
    met = C.all_gather_counts(counts)
    if met is None:
        before, totals, tokens = torch.zeros_like(counts), counts, t
    else:
        table, rank = met
        before, totals, tokens = table[:rank].sum(0), table.sum(0), t * table.shape[0]
        before, totals = before.to(torch.int32), totals.to(torch.int32)
    cap = capacity(tokens, n_experts, top_k)
    return (cap, *plan(probs, idx, cap, before, totals, tokens))


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


def _expert_ffn_qat(xs, p, amax, policy: QuantPolicy, prefix: str, group):
    """xs: the (E, C, d) input for each of this process's model ranks;
    stacked expert weights (E, d, f) / (E, f, d), or their model blocks
    (``moe_qat``), fake quantized under one maximum over the whole stack
    (``collectives.model_max`` of the ranks' blocks' maxima).  Returns each
    rank's (E, C, d) partial (the whole product when ``group`` is None) and
    the obs."""
    obs: Obs = {}

    def fq_w(w):
        ws = _parts(w)
        if not policy.quantize_wa:
            return ws
        m = C.model_max(group, [q.per_tensor_max(v.detach()) for v in ws])
        return [q.fake_quant(v, m.to(v.dtype), policy.w_bits) for v in ws]

    def fq(x, site):
        return fake_quant_parts(x, amax[f"{prefix}_{site}"], policy.a_bits, policy.quantize_wa,
                                group)

    quantized = [fake_quant_act(x, amax[f"{prefix}_in"], policy.a_bits, policy.quantize_wa)
                 for x in xs]
    xq, obs[f"{prefix}_in"] = [x for x, _ in quantized], quantized[0][1]
    g = [torch.einsum("ecd,edf->ecf", x, w) for x, w in zip(xq, fq_w(p["wg"]), strict=True)]
    u = [torch.einsum("ecd,edf->ecf", x, w) for x, w in zip(xq, fq_w(p["wu"]), strict=True)]
    g, obs[f"{prefix}_g"] = fq([silu(t) for t in g], "g")
    u, obs[f"{prefix}_u"] = fq(u, "u")
    h, obs[f"{prefix}_h"] = fq([a * b for a, b in zip(g, u, strict=True)], "h")
    return [torch.einsum("ecf,efd->ecd", a, w) for a, w in zip(h, fq_w(p["wd"]), strict=True)], \
        obs


def moe_qat(x: torch.Tensor, p: Dict, amax: Dict, policy: QuantPolicy,
            cfg) -> Tuple[torch.Tensor, Obs, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), obs, aux loss).

    With model-split expert weights (``{"<model rank>": block}``, their
    ``moe_d_ff`` split: ``train/steps.py``'s "split") each model rank runs
    its d_ff columns of every expert's gate and up products and its rows of
    the down product, in the context's model group.  The router, the
    routing, the dispatch and the combine weights are the replicated
    computation of every rank.  The token rows reach the ranks through one
    ``collectives.copy_to_model`` (the routed experts' dispatch and the
    shared experts' input), and so do the combine weights: each rank's
    combine consumes them, so their gradients, and through them the
    router's, sum every rank's.  A rank's row-parallel partial is combined
    first (float32, its dropped choices reading a zero row) and the ranks'
    combined partials are summed after (``reduce_from_model``): (T, d) a
    layer, not the (E x cap, d) of a sum right after the down product (the
    reference partitioner's place), top_k x 1.25 fewer rows; the shared
    experts' sum over their stack is taken a rank before its sum over the
    ranks, likewise."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    obs: Obs = {}
    group = _group(p["experts"]["wg"])
    gate_logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    cap, dest, gates, aux = route(gate_logits, cfg.n_experts, cfg.top_k)
    xts = C.copy_to_model(group, xt)
    xe = [scatter_dispatch(v, dest, cfg.n_experts, cap).reshape(cfg.n_experts, cap, d)
          for v in xts]
    ye, o = _expert_ffn_qat(xe, p["experts"], amax, policy, "exp", group)
    obs.update(o)
    combined = [gather_combine(y.reshape(cfg.n_experts * cap, d), dest, g, torch.float32)
                for y, g in zip(ye, C.copy_to_model(group, gates), strict=True)]
    yt = C.reduce_from_model(group, combined).to(x.dtype)
    if cfg.n_shared_experts:
        xs = [v[None].expand(cfg.n_shared_experts, t, d) for v in xts]
        ys, o = _expert_ffn_qat(xs, p["shared"], amax, policy, "shr", group)
        obs.update(o)
        yt = yt + C.reduce_from_model(group, [torch.sum(y, 0) for y in ys])
    return yt.reshape(b, s, d), obs, aux
