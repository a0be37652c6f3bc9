"""Loss and train-step builders, as the reference ``train/steps.py``.

``train_step``: QAT loss -> gradients (autograd through the straight-through
fake-quant) -> optional int8 gradient compression -> AdamW (optionally int8
moments) -> EMA update of the activation-calibration tree (paper Eq. 3).

A step is a function of (state, batch) that returns a new ``TrainState``;
it modifies no tensor of the state it is given.  ``jit_train_step`` builds
the step over a device mesh (``launch/mesh.py``): the state split over the
ranks per ``sharding/partition.py``'s rules, the batch over the data ranks,
the reference's global math (GSPMD: sharding moves data, not results).
One process drives every rank of a ``Mesh``; each rank of a
``ProcessMesh`` is a process of its own, and the two give the same bits.
Every config trains here, on one data rank or more: attention, dense, MoE
and recurrent (Mamba, mLSTM, sLSTM) archs, the frontends and BERT.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import ema_tree_update, rdiv
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import layers as L
from repro_torch.models import mamba as Mb
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt

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


def _vocab_parallel_ce(blocks: Dict[str, torch.Tensor], tgt: torch.Tensor) -> torch.Tensor:
    """``_sharded_ce`` of logits split over the model ranks' vocab blocks
    (``{"<model rank>": (..., V / m) float32 block}``, ``transformer.
    forward``'s under "split"), in the reference's form, with no rank
    holding the whole logits: the row max over every rank's block
    (``collectives.model_max``, under stop-gradient, as ``jax.nn.
    logsumexp``'s), lse = max + log of the ranks' sums of exp(logit - max),
    added in rank order (``reduce_from_model``), and the target's logit
    from the rank whose block holds it, 0 on the others, summed over the
    ranks (exact: one term is nonzero)."""
    group = L._group(blocks)
    m = C.model_max(group, [torch.amax(lg.detach(), -1) for lg in blocks.values()])
    sums, picks = [], []
    for key, lg in blocks.items():
        sums.append(torch.sum(torch.exp(lg - m[..., None]), -1))
        t = tgt.long() - int(key) * lg.shape[-1]
        inside = (t >= 0) & (t < lg.shape[-1])
        v = torch.gather(lg, -1, torch.where(inside, t, 0)[..., None])[..., 0]
        picks.append(torch.where(inside, v, torch.zeros((), dtype=v.dtype, device=v.device)))
    lse = m + torch.log(C.reduce_from_model(group, sums))
    return torch.mean(lse - C.reduce_from_model(group, picks))


def lm_loss(cfg: ModelConfig, params, amax, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE + ``AUX_WEIGHT`` x the MoE aux loss.  batch: {'tokens':
    (B, S) or (B, K, S), 'extra_embeds'?, 'pos3'?}.  Audio archs score each
    codebook, in one mean over (B, K, S - 1); the vision stub's image rows
    are not scored.  Logits split over the model ranks' vocab blocks take
    ``_vocab_parallel_ce`` on the same rows."""
    tokens = batch["tokens"]
    logits, obs, aux = T.forward(cfg, params, amax, tokens,
                                 extra_embeds=batch.get("extra_embeds"),
                                 pos3=batch.get("pos3"))
    n_img = 0 if batch.get("extra_embeds") is None else batch["extra_embeds"].shape[1]

    def scored(lg):
        """The logits that predict a next token: every codebook's, or the
        text rows' (the image rows are not scored)."""
        if cfg.frontend == "audio_codebooks":
            return lg[:, :, :-1]
        return lg[:, :-1][:, n_img:]

    tgt = tokens[:, :, 1:] if cfg.frontend == "audio_codebooks" else tokens[:, 1:]
    if isinstance(logits, dict):
        loss = _vocab_parallel_ce({k: scored(v) for k, v in logits.items()}, tgt)
    else:
        loss = _sharded_ce(scored(logits), tgt)
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
            obs, ce = C.tree_max(obs_all), loss    # the microbatches' max
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


# --- the step over a device mesh ---------------------------------------------------

class _MetaGen(torch.Generator):
    """A CPU generator that names the meta device: an init drawn with it
    builds every leaf on ``meta``, allocating nothing."""

    @property
    def device(self):
        return torch.device("meta")


def state_shape(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, bert: bool = False) -> TrainState:
    """The initial ``TrainState`` with every leaf on the ``meta`` device:
    shapes and dtypes only (the reference's ``jax.eval_shape`` of the init)."""
    return (init_bert_train_state if bert else init_train_state)(cfg, _MetaGen(), opt_cfg)


def state_shardings(mesh, shape: TrainState, fsdp: bool = True) -> TrainState:
    """The reference's state shardings: params, m and v (an int8 moment's
    codes) per ``make_param_shardings``; amax, the steps and the moments'
    scales replicated."""
    return TrainState(
        params=Pt.make_param_shardings(mesh, shape.params, fsdp=fsdp),
        opt={"m": Pt.make_param_shardings(mesh, shape.opt["m"], fsdp=fsdp),
             "v": Pt.make_param_shardings(mesh, shape.opt["v"], fsdp=fsdp),
             "step": Pt.replicated(mesh)},
        amax=T.tree_map(lambda _: Pt.replicated(mesh), shape.amax),
        step=Pt.replicated(mesh))


def data_ranks(mesh, shapes: Dict[str, Tuple[int, ...]]):
    """The data ranks of a batch of these shapes: (rows, device) of each
    block of the batch axis under ``batch_sharding`` (the device of the first
    rank that holds it).  One entry when the batch does not split."""
    counts = set()
    for shape in shapes.values():
        sh = Pt.batch_sharding(mesh, len(shape), shape)
        counts.add(Pt.block_index(sh, 0, 1)[0][1])
    if len(counts) != 1:
        raise ValueError(f"the batch's leaves split into {sorted(counts)} blocks: {shapes}")
    n = counts.pop()
    b = next(iter(shapes.values()))[0]
    devs = {}
    for r in range(mesh.size):
        devs.setdefault(Pt.block_index(sh, r, 1)[0][0], mesh.devices[r])
    return [(slice(k * b // n, (k + 1) * b // n), devs[k]) for k in range(n)]


def _by_path(tree) -> Dict[str, Any]:
    """{path: leaf} of nested dicts, in their order (an int8 moment is one
    leaf)."""
    paths = [p for p, _ in Pt.tree_paths(T.tree_map(lambda _: None, tree))]
    return dict(zip(paths, T.tree_leaves(tree), strict=True))


def _at(tree, path: str):
    """The node of nested dicts at ``path`` (a model-split leaf's dict of
    model blocks, or a tensor)."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def check_split(cfg: ModelConfig, mesh, bert: bool = False):
    """Raises ``ValueError`` where ``model_compute="split"`` cannot run
    ``cfg`` on ``mesh``, naming the width: a width the model axis does not
    divide would leave its leaf whole (the reference's ``_fit_spec``) under
    a split computation, and a rank takes whole heads (the reference's
    ``_fit_spec`` would split inside a head, ROADMAP §3): the heads (an
    xLSTM mixer's too), d_ff, the experts' d_ff, Mamba's d_in, and an LM's
    vocab, each codebook's and each head's (BERT's embedding may stay
    whole: its lookup is then replicated); and an xLSTM's ``ln_y`` sums its
    row in 32-wide windows that must not cross a rank's columns, so d_model
    / m must be a multiple of 32."""
    m = mesh.shape.get("model", 1)
    widths = [("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff)]
    if cfg.n_experts:
        widths.append(("moe_d_ff", cfg.moe_d_ff or cfg.d_ff))
    if "m" in cfg.pattern:
        widths.append(("Mamba's d_in", Mb.mamba_dims(cfg)[0]))
    if not bert:
        widths.append(("vocab_size", cfg.vocab_size))
    for name, n in widths:
        if n % m:
            raise ValueError(f"model_compute='split' needs {name} = {n} to divide by the model "
                             f"axis of {m}")
    if "x" in cfg.pattern and m > 1 and (cfg.d_model % m or cfg.d_model // m % 32):
        raise ValueError(f"model_compute='split' needs d_model / {m} (d_model = {cfg.d_model}) "
                         "to be a multiple of 32: the mLSTM's ln_y sums its row in 32-wide "
                         "windows, each within one rank's columns")


def _any_zero(tree) -> bool:
    return any(bool((t == 0).any()) for t in T.tree_leaves(tree))


def _gather_moment(blocks, sharding, device):
    if isinstance(sharding, adamw.QMoment):
        return adamw.QMoment(*(C.all_gather([b[i] for b in blocks], sharding[i], device)
                               for i in range(2)))
    return C.all_gather(blocks, sharding, device)


def _scatter_moment(full, sharding, out):
    if isinstance(sharding, adamw.QMoment):
        parts = [C.scatter(full[i], sharding[i], None if out is None else [o[i] for o in out])
                 for i in range(2)]
        return [adamw.QMoment(c, s) for c, s in zip(*parts, strict=True)]
    return C.scatter(full, sharding, out)


def _copies(t: torch.Tensor, mesh) -> list:
    """A replicated leaf's value for each rank: its own tensor on its device."""
    return [t if r == 0 and t.device == d else t.to(d, copy=True)
            for r, d in enumerate(mesh.devices)]


def _meeting(passes):
    """Runs each data rank's pass (``passes[r]()``) in a thread of its own
    as rank r of one ``collectives.DataRanks``, at the caller's grad mode
    and torch thread count (a new thread starts at torch's), and yields
    their results in rank order as they finish.  A rank that raises stops
    the others at their next exchange; the first rank's own error is
    raised."""
    group = C.DataRanks(len(passes))
    results, errors = [None] * len(passes), [None] * len(passes)
    grad, n_threads = torch.is_grad_enabled(), torch.get_num_threads()

    def run(r):
        torch.set_num_threads(n_threads)
        try:
            with torch.set_grad_enabled(grad), C.data_rank(group, r):
                results[r] = passes[r]()
        except BaseException as e:  # noqa: BLE001 -- raised on the caller's thread
            errors[r] = e
            group.abort()

    threads = [threading.Thread(target=run, args=(r,), name=f"data rank {r}", daemon=True)
               for r in range(len(passes))]
    for t in threads:
        t.start()
    try:
        for r, t in enumerate(threads):
            t.join()
            if errors[r] is not None:
                break
            yield results[r]
            results[r] = None
    finally:
        group.abort()
        for t in threads:
            t.join()
    first = next((e for e in errors if e is not None and not isinstance(e, C.PeerFailed)),
                 None)
    if first is not None:
        raise first


def init_rank_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, shardings: TrainState,
                    mesh: ProcessMesh, seed: int, bert: bool = False) -> TrainState:
    """This rank's block of the initial state drawn from ``seed`` on its
    device: ``rank_tree`` of ``init_(bert_)train_state``'s, bit for bit.
    The params are drawn whole and cut, and float moments are the zeros of
    the block's shapes, so the whole moments never exist; int8 moments'
    scales span whole vectors, so with them the whole state is cut."""
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(seed)
    if opt_cfg.quantize_moments:
        whole = (init_bert_train_state if bert else init_train_state)(cfg, gen, opt_cfg)
        return Pt.rank_tree(whole, shardings, mesh.rank)
    if bert:
        from repro_torch.models import bert as B

        params, amax = B.init_bert_params(cfg, gen), B.init_bert_amax(cfg, mesh.device)
    else:
        params, amax = T.init_params(cfg, gen), T.init_amax(cfg, mesh.device)
    mine = Pt.rank_tree(params, shardings.params, mesh.rank)
    del params
    return TrainState(params=mine, opt=adamw.init_state(mine, opt_cfg), amax=amax,
                      step=torch.zeros((), dtype=torch.int32, device=mesh.device))


def _loss_and_grads(cfg, bert, params, amax, rows, model=None):
    with Pt.model_split(model):
        if bert:
            return value_and_grad(lambda p: bert_loss(cfg, p, amax, rows), params)
        return lm_loss_and_grads(cfg, params, amax, rows)


def _observed(cfg, bert, params, amax, rows, model=None):
    with torch.no_grad(), Pt.model_split(model):
        _, aux = (bert_loss if bert else lm_loss)(cfg, params, amax, rows)
    return aux["obs"]


def _filled(amax, obs):
    """``amax`` with its zero sites set to ``obs``'s."""
    a, o = Pt.tree_paths(amax, sort_keys=True), Pt.tree_paths(obs, sort_keys=True)
    return Pt.tree_rebuild(amax, [torch.where(x > 0, x, y.to(x.device))
                                  for (_, x), (_, y) in zip(a, o, strict=True)], sort_keys=True)


_SCALARS = {True: ("acc",), False: ("ce", "aux")}       # by ``bert``


def _mesh_metrics(per_micro, n_ranks: int, accum: int, bert: bool, dev):
    """The step's metrics but the grad norm, from each microbatch's data
    ranks' (loss, {metric: value}) in rank order: the losses summed in rank
    order over the ranks, then over the microbatches, and the other metrics
    averaged over every (microbatch, rank) in that order."""
    losses, extras = [], []
    for ranks in per_micro:
        loss_i = None
        for loss, aux in ranks:
            loss_i = loss.to(dev) if loss_i is None else loss_i + loss.to(dev)
            extras.append(aux)
        losses.append(loss_i / n_ranks if n_ranks > 1 else loss_i)
    loss = losses[0] if accum == 1 else sum(losses, 0.0) / accum

    def mean(k):
        return extras[0][k] if len(extras) == 1 else \
            sum(e[k].to(dev) for e in extras) / len(extras)

    if bert:
        return {"loss": loss, "acc": mean("acc")}
    if accum == 1:
        return {"loss": loss, "ce": mean("ce"), "aux": mean("aux")}
    return {"loss": loss, "ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=dev)}


def jit_train_step(cfg: ModelConfig, mesh, opt_cfg: adamw.AdamWConfig, batch_example, *,
                   fsdp: bool = True, donate: bool = True, bert: bool = False,
                   accum_steps: int = 1, model_compute: str = "gather"):
    """The train step over ``mesh``: returns (step, state_shardings,
    batch_shardings) as the reference's.  On a ``Mesh`` (one process drives
    every rank), ``step(shards, batch) -> (shards, metrics)`` takes the
    ranks' states (a list in rank order, as ``partition.split_tree(state,
    state_shardings)`` cuts them); on a ``ProcessMesh`` (this process is one
    rank), ``step(shard, batch) -> (shard, metrics)`` takes this rank's
    state (``partition.rank_tree(state, state_shardings, mesh.rank)``) and
    every rank calls it together, each getting the same metrics.  The batch
    is the global batch (a dict of tensors on any device; ``batch_example``
    gives its leaves' shapes, tensors on ``meta`` will do).  The step runs
    eagerly, as every port step does (capturing it is ROADMAP item 13).

    It keeps the reference's global math.  Each data rank (a block of the
    batch axis) gathers the params onto its device once a step and runs the
    loss and its backward on its rows of each microbatch: microbatch i is
    rows [i B/a, (i+1) B/a) of the global batch, split over the data ranks.
    At sites whose amax is 0 the reference quantizes with the global
    (micro)batch's observed max, so while any amax is 0 one no-grad forward
    over the global microbatch first fills those sites with it (its MoE
    layers route the whole microbatch at once, so it exchanges nothing).
    A MoE arch's capacity and aux loss count the global microbatch too: over
    more than one data rank each rank runs its loss and backward under
    ``collectives.data_rank`` (on a ``Mesh`` in a thread of its own), and at
    every MoE layer the ranks gather each other's (k, E) routing counts
    (``collectives.all_gather_counts``, ``moe.route``), a recomputed layer
    replaying what its forward received; on a ``Mesh`` any other arch runs
    the ranks one after another.  The ranks' gradients are summed in
    float32 in rank order into the owners' shards and divided by the data
    ranks and microbatches; the compression and the global norm
    (``adamw.global_norm``'s order) take each leaf whole, and so does the
    AdamW update on a ``Mesh`` and wherever moments are int8 (a scale spans
    its whole last-axis vector); on a ``ProcessMesh`` a float-moment leaf is
    updated on this rank's block alone (elementwise: the same bits).
    ``donate=True`` writes the new values into the given shards;
    ``donate=False`` leaves every given tensor as it was.  ``bert=True``
    builds ``make_bert_train_step``'s step (no accumulation, as the
    reference's).

    ``model_compute`` says what the model axis does.  "gather" (the
    default): a split leaf is gathered whole and the model ranks of a data
    rank compute the same pass, which is the unsharded step's (bit for bit
    on one data rank).  "split": the reference's model axis, Megatron's
    tensor parallelism (``models/layers.py``): a model-split leaf is
    gathered over the data axes only, for its FSDP dim, into its model
    blocks, never over the model axis; each model rank computes its own
    heads (attention, mLSTM and sLSTM), MLP and experts' d_ff columns,
    Mamba channels and vocab blocks (``models/moe.py``, ``models/mamba.py``,
    ``models/xlstm.py``; a codebook table's and several heads' per codebook
    and head), the cross-entropy stays
    vocab-parallel (``_vocab_parallel_ce``), and the ranks meet in the
    activations' collectives (``collectives.model_sum``, ``model_max``,
    ``model_exchange``, ``model_gather``).  A model-split leaf's gradient
    is its model block's, summed over the data ranks of its model
    coordinate; a replicated leaf's is the same bits on every model rank
    (each holds the same ``model_sum``, or the ranks' blocks assembled by
    ``collectives.model_blocks``), so one contribution a data rank counts,
    as under "gather".  On a ``Mesh`` each data rank's pass runs every
    model rank's part in one process (``collectives.ModelRanks``), the
    process step's bit oracle; on a model axis of 1 "split" gives
    "gather"'s bits.  It covers every arch and BERT wherever the model axis
    divides their widths (``check_split``): the attention, MoE, Mamba and
    xLSTM mixers (``models/xlstm.py``), the audio codebooks and several LM
    heads, and the vision stub's prepended rows.
    """
    if model_compute not in ("gather", "split"):
        raise ValueError(f"model_compute must be 'gather' or 'split' (got {model_compute!r})")
    if model_compute == "split":
        check_split(cfg, mesh, bert)
    shape = state_shape(cfg, opt_cfg, bert)
    state_sh = state_shardings(mesh, shape, fsdp)
    example = {k: tuple(v.shape) for k, v in batch_example.items()}
    batch_sh = {k: Pt.batch_sharding(mesh, len(v), v) for k, v in example.items()}
    accum = 1 if bert else accum_steps
    b = next(iter(example.values()))[0]
    if b % accum:
        raise ValueError(f"accum_steps={accum} does not divide the batch of {b}")
    ranks = data_ranks(mesh, {k: (v[0] // accum, *v[1:]) for k, v in example.items()})
    meet = bool(cfg.n_experts) and not bert and len(ranks) > 1
    p_sh, m_sh, v_sh = (_by_path(t) for t in (state_sh.params, state_sh.opt["m"],
                                              state_sh.opt["v"]))
    # the params that "split" holds as model blocks
    split = {p for p, sh in p_sh.items()
             if model_compute == "split" and Pt.model_dim(sh) is not None}
    if isinstance(mesh, ProcessMesh):
        step = _process_step(cfg, mesh, opt_cfg, example, ranks, meet, (p_sh, m_sh, v_sh),
                             split, donate=donate, bert=bert, accum=accum)
        return step, state_sh, batch_sh
    model = C.ModelRanks(mesh.shape.get("model", 1)) if model_compute == "split" else None
    dev0 = mesh.devices[0]
    # the whole reduced gradient of a leaf takes the room its owners' blocks
    # took when every rank is on one device, so the norm's pass keeps it for
    # the update's; across devices it is gathered again, not held on one
    keep_whole = len(set(mesh.devices)) == 1

    def step(shards, batch):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} rank states for a {mesh.size}-rank mesh")
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        if shapes != example:
            raise ValueError(f"a batch of {shapes} for a step built for {example}")
        r0 = shards[0]
        paths = list(_by_path(r0.params))
        params = [_by_path(s.params) for s in shards]
        gathered = {}

        def leaf_on(p, dev):
            blocks = [pr[p] for pr in params]
            if p in split:
                return {str(m): C.gather_model_block(blocks, p_sh[p], m, dev)
                        for m in model.ranks}
            return C.all_gather(blocks, p_sh[p], dev)

        def params_on(dev):
            if dev not in gathered:
                gathered[dev] = T.tree_unflatten(r0.params, [leaf_on(p, dev) for p in paths])
            return gathered[dev]

        n = len(ranks) * accum
        acc, per_micro = {}, []
        obs_by_rank = [[] for _ in ranks]
        fill = len(ranks) > 1 and _any_zero(r0.amax)
        bm = b // accum
        for i in range(accum):
            mb = batch if accum == 1 else {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
            amax = r0.amax
            if fill:
                dev = ranks[0][1]
                amax = _filled(amax, _observed(cfg, bert, params_on(dev),
                                               T.tree_map(lambda t, d=dev: t.to(d), amax),
                                               {k: v.to(dev) for k, v in mb.items()}, model))
            passes = [functools.partial(
                _loss_and_grads, cfg, bert, params_on(dev),
                T.tree_map(lambda t, d=dev: t.to(d), amax),
                {k: v[rows].to(dev) for k, v in mb.items()}, model) for rows, dev in ranks]
            per_micro.append([])
            for g_i, (loss, aux, grads) in enumerate(
                    _meeting(passes) if meet else (f() for f in passes)):
                per_micro[-1].append((loss, {k: aux[k] for k in _SCALARS[bert]}))
                obs_by_rank[g_i].append(aux["obs"])
                g = {p: _at(grads, p) for p in paths}
                del grads, aux
                for p in paths:
                    if p in split:      # the model blocks' gradients: the leaf's, placed
                        g[p] = torch.cat(list(g[p].values()), Pt.model_dim(p_sh[p]))
                    acc[p] = C.reduce_scatter_add(acc.get(p), g.pop(p), p_sh[p], sole=n == 1)
        gathered.clear()
        if n > 1:
            for blocks in acc.values():
                for t in blocks:
                    t.div_(n)
        metrics = _mesh_metrics(per_micro, len(ranks), accum, bert, dev0)
        obs = C.max_over_ranks([C.tree_max(o) for o in obs_by_rank])

        bits = cfg.quant.grad_compress_bits

        def grad_of(p):
            g = acc[p]
            if isinstance(g, list):         # the owners' blocks
                g = C.all_gather(g, p_sh[p], dev0)
                g = _compress_grads(g, bits) if bits else g
                if keep_whole:
                    acc[p] = g
            return g

        total = 0
        for p in paths:                     # adamw.global_norm's order
            total = total + torch.sum(torch.square(grad_of(p).to(torch.float32)))
        gn = torch.sqrt(total)
        opt_step = r0.opt["step"] + 1
        scalars = adamw.update_scalars(opt_step, gn, opt_cfg)
        ms, vs = [_by_path(s.opt["m"]) for s in shards], [_by_path(s.opt["v"]) for s in shards]
        new_p, new_m, new_v = ({} for _ in range(3))
        for p in paths:
            pn, mn, vn = adamw.update_leaf(
                C.all_gather([pr[p] for pr in params], p_sh[p], dev0), grad_of(p),
                _gather_moment([m[p] for m in ms], m_sh[p], dev0),
                _gather_moment([v[p] for v in vs], v_sh[p], dev0), scalars, opt_cfg)
            del acc[p]
            new_p[p] = C.scatter(pn, p_sh[p], [pr[p] for pr in params] if donate else None)
            new_m[p] = _scatter_moment(mn, m_sh[p], [m[p] for m in ms] if donate else None)
            new_v[p] = _scatter_moment(vn, v_sh[p], [v[p] for v in vs] if donate else None)
        amax_new = ema_tree_update(r0.amax, T.tree_map(lambda t: t.to(dev0), obs), 0.99)
        amaxes = T.tree_map(lambda t: _copies(t, mesh), amax_new)
        steps, opt_steps = _copies(r0.step + 1, mesh), _copies(opt_step, mesh)
        out = []
        for r, s in enumerate(shards):
            def rank_tree(tree, new, r=r):
                return T.tree_unflatten(tree, [new[p][r] for p in _by_path(tree)])

            out.append(TrainState(
                params=rank_tree(s.params, new_p),
                opt={"m": rank_tree(s.opt["m"], new_m), "v": rank_tree(s.opt["v"], new_v),
                     "step": opt_steps[r]},
                amax=T.tree_map(lambda c, r=r: c[r], amaxes),
                step=steps[r]))
        return out, {**metrics, "grad_norm": gn}

    return step, state_sh, batch_sh


def _process_step(cfg, mesh, opt_cfg, example, ranks, meet, shardings, split, *, donate, bert,
                  accum):
    """``jit_train_step``'s step for this rank of a ``ProcessMesh``: the same
    float operations in the same order as the one-process step, each on
    this rank's part (``collectives.Process``).  Under "split" (``split``:
    the model-split params), where the caller sets ``step.replicas`` to a
    list, each step appends the ``launch.ranks.digest`` of this rank's
    gradient of each replicated leaf (its last microbatch's), which every
    model rank must share."""
    from repro_torch.launch.ranks import digest

    P = C.Process(mesh)
    model = P.model if split else None
    if len(ranks) != P.n:
        raise ValueError(f"a step on a process mesh needs each microbatch to split over its "
                         f"{P.n} data ranks (it splits into {len(ranks)})")
    p_sh, m_sh, v_sh = shardings
    me, dev = mesh.rank, mesh.device
    mine = ranks[P.block[me]][0]
    b = next(iter(example.values()))[0]
    bm, n = b // accum, len(ranks) * accum
    qm, bits = opt_cfg.quantize_moments, cfg.quant.grad_compress_bits
    names = _SCALARS[bert]

    def moment_whole(mo, sh):
        if isinstance(sh, adamw.QMoment):
            return adamw.QMoment(*(P.all_gather(mo[i], sh[i]) for i in range(2)))
        return P.all_gather(mo, sh)

    def moment_block(mo, sh):
        if isinstance(sh, adamw.QMoment):
            return adamw.QMoment(*(Pt.block_of(mo[i], sh[i], me) for i in range(2)))
        return Pt.block_of(mo, sh, me)

    def into(old, new):
        """``new`` written into ``old`` (donated), or ``new``."""
        if not donate:
            return new
        if isinstance(old, adamw.QMoment):
            return adamw.QMoment(*(o.copy_(x) for o, x in zip(old, new, strict=True)))
        return old.copy_(new)

    def step(shard, batch):
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        if shapes != example:
            raise ValueError(f"a batch of {shapes} for a step built for {example}")
        own = _by_path(shard.params)
        paths = list(own)
        key = str(P.model.rank)
        params = T.tree_unflatten(shard.params, [
            {key: P.all_gather_data(own[p], p_sh[p])} if p in split
            else P.all_gather(own[p], p_sh[p]) for p in paths])
        fill = len(ranks) > 1 and _any_zero(shard.amax)
        acc, table, obs_micro = {}, [], []
        for i in range(accum):
            mb = batch if accum == 1 else {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
            amax = shard.amax
            if fill:        # every rank fills from the global microbatch's forward
                amax = _filled(amax, _observed(cfg, bert, params, amax,
                                               {k: v.to(dev) for k, v in mb.items()}, model))
            rows = {k: v[mine].to(dev) for k, v in mb.items()}
            with C.data_rank(P, P.block[me]) if meet else contextlib.nullcontext():
                loss, aux, grads = _loss_and_grads(cfg, bert, params, amax, rows, model)
            vals = [loss, *(aux[k] for k in names)]
            if any(t.dtype != torch.float32 for t in vals):
                raise TypeError(f"the step's metrics are {[t.dtype for t in vals]}, not float32")
            table.append(torch.stack(vals))
            obs_micro.append(aux["obs"])
            g = {p: _at(grads, p) for p in paths}
            del grads, aux
            if i == accum - 1:
                del params
                if split and step.replicas is not None:
                    step.replicas.append(digest({p: g[p] for p in paths if p not in split}))
            for p in paths:
                if p in split:
                    acc[p] = P.reduce_scatter_data(acc.get(p), g.pop(p)[key], p_sh[p],
                                                   sole=n == 1)
                else:
                    acc[p] = P.reduce_scatter_add(acc.get(p), g.pop(p), p_sh[p], sole=n == 1)
        if n > 1:
            for t in acc.values():
                t.div_(n)
        blocks = P.gather_blocks(torch.stack(table))
        metrics = _mesh_metrics([[(t[i, 0], dict(zip(names, t[i, 1:]))) for t in blocks]
                                 for i in range(accum)], len(ranks), accum, bert, dev)
        obs = P.max_over_ranks(C.tree_max(obs_micro))

        total, grads = 0, {}
        for p in paths:                     # adamw.global_norm's order, every rank
            g = acc.pop(p)
            whole = P.all_gather(g, p_sh[p])
            if bits:
                whole = _compress_grads(whole, bits)
            total = total + torch.sum(torch.square(whole.to(torch.float32)))
            grads[p] = whole if qm else Pt.block_of(whole, p_sh[p], me) if bits else g
            del g, whole
        gn = torch.sqrt(total)
        opt_step = shard.opt["step"] + 1
        scalars = adamw.update_scalars(opt_step, gn, opt_cfg)
        ms, vs = _by_path(shard.opt["m"]), _by_path(shard.opt["v"])
        new_p, new_m, new_v = ({} for _ in range(3))
        for p in paths:
            if qm:      # an int8 moment's scales span whole last-axis vectors
                pn, mn, vn = adamw.update_leaf(
                    P.all_gather(own[p], p_sh[p]), grads.pop(p), moment_whole(ms[p], m_sh[p]),
                    moment_whole(vs[p], v_sh[p]), scalars, opt_cfg)
                pn, mn, vn = (Pt.block_of(pn, p_sh[p], me), moment_block(mn, m_sh[p]),
                              moment_block(vn, v_sh[p]))
            else:
                pn, mn, vn = adamw.update_leaf(own[p], grads.pop(p), ms[p], vs[p], scalars,
                                               opt_cfg)
            new_p[p], new_m[p], new_v[p] = into(own[p], pn), into(ms[p], mn), into(vs[p], vn)

        def tree(t, new):
            return T.tree_unflatten(t, [new[p] for p in _by_path(t)])

        return TrainState(params=tree(shard.params, new_p),
                          opt={"m": tree(shard.opt["m"], new_m), "v": tree(shard.opt["v"], new_v),
                               "step": opt_step},
                          amax=ema_tree_update(shard.amax, obs, 0.99),
                          step=shard.step + 1), {**metrics, "grad_norm": gn}

    step.replicas = None
    return step
