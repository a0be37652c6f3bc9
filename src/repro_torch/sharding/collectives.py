"""The sharded train step's collectives, behind one seam: gather a leaf from
its shards, reduce the data ranks' gradients into the owners' shards, take
the max over ranks, gather every data rank's MoE routing counts, and, when
the step splits its compute over the model axis (``model_compute="split"``,
Megatron's tensor parallelism), the model group's activation collectives.
Two backends do the same things and give the same bits.

The ``local`` backend (the module's functions) serves a ``Mesh`` that one
process drives: the first three are loops over the ranks' tensors with
copies between their devices.  The fourth is where the data ranks meet: a
MoE layer's routing counts the whole (micro)batch (``models/moe.py``), so
each data rank runs its forward and backward in a thread of its own
(``train/steps.py``), posts its (k, E) int32 table of per-(choice, expert)
counts at each MoE layer, and blocks in ``all_gather_counts`` until every
data rank of its ``DataRanks`` group has posted.  Its model group,
``ModelRanks``, holds every model rank's part in one process: a split op is
a loop over the ranks' parts in rank order, and a model collective a sum or
max over that loop's results; no threads, no meeting.

The ``process`` backend (``Process``) serves a ``launch.mesh.ProcessMesh``,
one OS process per rank over a ``torch.distributed`` process group: each
call is this rank's part of one collective that every rank makes in the
same order.  It gathers with ``all_gather``; it reduces with an all-to-all
of the gradient's blocks (each data block's first rank sends block r to
rank r), after which each owner sums what it received in float32 in data
rank order, the local loop's order (neither gloo's nor NCCL's reduce-scatter
sums in rank order); it takes the max with ``all_reduce(MAX)``; and, as the
MoE data ranks' group, it all-gathers the counts over the batch axes'
subgroup.  Under "split" a model-split leaf is gathered, and its gradient
reduced, over the data subgroup of the rank's model coordinate only
(``all_gather_data``, ``reduce_scatter_data``), and ``Process.model`` is the
rank's model group over the model axis's subgroup.  ``ROUTES`` names the op
each collective makes and how it moves a CUDA tensor under each backend.

The model group's collectives (``model_sum``, ``model_max``, the autograd
pair ``copy_to_model`` / ``reduce_from_model``, Megatron's *f* and *g*, and
``model_exchange``, the all-to-all that re-blocks a column-split tensor of
several segments, Mamba's ``[x | z]``; ``model_gather``, the ranks' parts
concatenated in rank order, and ``model_blocks``, a replicated leaf's
per-rank blocks whose gradient it assembles) take a group, or None for a
tensor held whole.  ``model_sum`` all-gathers the ranks' float32 partials and
every rank sums them in rank order from rank 0's, so each holds the same
bits (no library all-reduce sums in rank order).

Under either backend a recomputed (remat) forward replays the MoE tables
its first forward received, in order, and never meets again:
``recompute_contexts`` is the ``context_fn`` of ``layers.remat``'s
checkpoint, so the replay reaches the thread that recomputes (on a CUDA
card, autograd's own, where the counts' thread meeting would deadlock).  A
recomputed split region instead runs in its model group again and makes
its model collectives again: they are process-group collectives that
every rank makes in the same order (the backward's ``model_sum`` too, on
the same thread), which the CPU's gloo and four processes on one card
meet without a deadlock.  On ``meta`` tensors (the dry run's traced rank)
the counts' gather waits for no one and returns a ``meta`` table.

``tally()`` counts the collectives called while it is open, per kind and
per function, and the bytes of each call's result on one rank, as the
reference's dry run sums the result shapes of XLA's collectives: a gathered
leaf whole (a model block: ``all_gather_data``), a reduce-scatter's own
float32 block (an all-reduce when no rank splits the leaf), each maxed leaf,
the (n, k, E) counts table, each ``model_sum``'s and ``model_max``'s result
(an all-reduce), one rank's block out of ``model_exchange`` (an all-to-all,
its backward's too), each ``model_gather``'s concatenated result.  A call of
the process backend counts as the local backend counts one rank's part of
it: one data rank's contribution, one gathered leaf, one rank's table, one
model collective.
``host_ms()`` sums the host time of the process backend's calls (and the
model group's, under either backend), per kind and function.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import partition as Pt

_tallies: List[Dict[Tuple[str, str], List[int]]] = []
_tally_lock = threading.Lock()
_clocks: List[Dict[Tuple[str, str], float]] = []


@contextlib.contextmanager
def tally():
    """Yields {(kind, function): [calls, bytes]}, filled while open."""
    t: Dict[Tuple[str, str], List[int]] = {}
    _tallies.append(t)
    try:
        yield t
    finally:
        _tallies.remove(t)


def _count(kind: str, fn: str, nbytes: int):
    with _tally_lock:           # the data ranks' threads count into one tally
        for t in _tallies:
            c = t.setdefault((kind, fn), [0, 0])
            c[0] += 1
            c[1] += int(nbytes)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _whole(sharding: Pt.NamedSharding, ndim: int) -> bool:
    return all(n == 1 for _, n in Pt.block_index(sharding, 0, ndim))


def all_gather(blocks: Sequence[torch.Tensor], sharding: Pt.NamedSharding,
               device=None) -> torch.Tensor:
    """The leaf on ``device`` (default rank 0's).  A leaf no rank splits
    comes back as rank 0's own tensor when that is on ``device``."""
    dev = torch.device(device) if device is not None else sharding.mesh.devices[0]
    whole = _whole(sharding, blocks[0].dim())
    if whole and blocks[0].device == dev:
        return blocks[0]
    out = Pt.gather_leaf(blocks, sharding, dev)
    if not whole:
        _count("all-gather", "all_gather", _nbytes(out.shape, out.dtype))
    return out


def scatter(full: torch.Tensor, sharding: Pt.NamedSharding,
            out: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Each rank's block of ``full`` (a leaf computed on one rank), written
    into ``out``'s tensors (the ranks' old shards) when given."""
    mesh = sharding.mesh
    if _whole(sharding, full.dim()) and mesh.size == 1 and full.device == mesh.devices[0] \
            and full.is_contiguous():
        blocks = [full]
    else:
        blocks = Pt.split_leaf(full, sharding)
    if out is None:
        return blocks
    for old, new in zip(out, blocks, strict=True):
        old.copy_(new)
    return list(out)


def reduce_scatter_add(owners: Optional[List[torch.Tensor]], contribution: torch.Tensor,
                       sharding: Pt.NamedSharding, *, sole: bool = False) -> List[torch.Tensor]:
    """Add one data rank's gradient of a leaf, in float32, into each rank's
    running sum of its own block (``owners``; None starts the sums with this
    contribution).  Called once per data rank, in rank order.  ``sole``: the
    only contribution (one data rank, one microbatch), so there is no sum to
    take: each rank gets its block as it is, in its own dtype, uncopied where
    it already lies on the rank's device."""
    mesh = sharding.mesh
    blocks = []
    for r, dev in enumerate(mesh.devices):
        sl = Pt._slices(contribution.shape, Pt.block_index(sharding, r, contribution.dim()))
        blocks.append(contribution[sl])
    if sole:
        return [b.to(dev) for b, dev in zip(blocks, mesh.devices, strict=True)]
    _count("all-reduce" if _whole(sharding, contribution.dim()) else "reduce-scatter",
           "reduce_scatter_add", _nbytes(blocks[0].shape, torch.float32))
    if owners is None:
        return [b.to(dev, torch.float32, copy=True, memory_format=torch.contiguous_format)
                for b, dev in zip(blocks, mesh.devices, strict=True)]
    for acc, b in zip(owners, blocks, strict=True):
        acc.add_(b.to(acc.device, torch.float32))
    return owners


def tree_max(trees: Sequence):
    """The elementwise max of trees (nested dicts of tensors), on the first
    tree's devices: a rank's own reduction, no collective."""
    if isinstance(trees[0], dict):
        return {k: tree_max([t[k] for t in trees]) for k in trees[0]}
    out = trees[0]
    for t in trees[1:]:
        out = torch.maximum(out, t.to(out.device))
    return out


def max_over_ranks(trees: Sequence):
    """``tree_max`` of the data ranks' trees (one per data rank in rank
    order): an all-reduce of each leaf."""
    out = tree_max(trees)
    for _, t in Pt.tree_paths(out):
        _count("all-reduce", "max_over_ranks", _nbytes(t.shape, t.dtype))
    return out


# --- the MoE routing counts' exchange ------------------------------------------------

class PeerFailed(RuntimeError):
    """Another data rank of the group failed before the exchange met."""


class DataRanks:
    """The ``n`` data ranks of one (micro)batch, one thread each, that meet
    at every MoE layer of their forward.  Their i-th calls of
    ``all_gather_counts`` meet each other."""

    def __init__(self, n: int):
        self.n = n
        self._cond = threading.Condition()
        self._posted: Dict[int, List[Optional[torch.Tensor]]] = {}
        self._read: Dict[int, int] = {}
        self._failed = False

    def abort(self):
        """A rank failed: every rank waiting, or about to, raises."""
        with self._cond:
            self._failed = True
            self._cond.notify_all()

    def gather(self, rank: int, call: int, counts: torch.Tensor) -> List[torch.Tensor]:
        with self._cond:
            slot = self._posted.setdefault(call, [None] * self.n)
            slot[rank] = counts
            self._cond.notify_all()
            while not self._failed and any(c is None for c in slot):
                self._cond.wait()
            if self._failed:
                raise PeerFailed("a data rank failed before the MoE counts exchange met")
            self._read[call] = self._read.get(call, 0) + 1
            if self._read[call] == self.n:
                del self._posted[call], self._read[call]
            return list(slot)


class _Rank:
    """What a data rank's thread runs under: its group, its index, its next
    exchange, and the replay source and record sinks of the remat regions
    around it."""

    def __init__(self, group: DataRanks, rank: int, source=None):
        self.group, self.rank = group, rank
        self.calls = 0
        self.source = source          # an iterator over recorded tables, or None (live)
        self.sinks: List[list] = []   # the tapes of the open remat regions' forwards


_local = threading.local()


def _current() -> Optional[_Rank]:
    return getattr(_local, "rank", None)


@contextlib.contextmanager
def _as(rank: Optional[_Rank]):
    old = _current()
    _local.rank = rank
    try:
        yield rank
    finally:
        _local.rank = old


def data_rank(group: DataRanks, rank: int):
    """The calling thread's MoE layers route as data rank ``rank`` of
    ``group`` while open."""
    return _as(_Rank(group, rank))


def all_gather_counts(counts: torch.Tensor) -> Optional[Tuple[torch.Tensor, int]]:
    """Every data rank's (k, E) int32 routing counts of this MoE layer,
    stacked in rank order as (n, k, E) on ``counts``'s device, and the
    caller's rank; None outside a data rank (one rank routes alone)."""
    me = _current()
    if me is None:
        return None
    n = me.group.n
    if me.source is not None:
        table = next(me.source, None)
        if table is None:
            raise RuntimeError("a recomputed forward made more MoE exchanges than its first")
    elif counts.device.type == "meta":
        table = torch.empty((n, *counts.shape), dtype=counts.dtype, device="meta")
    else:
        posted = me.group.gather(me.rank, me.calls, counts)
        me.calls += 1
        table = torch.stack([c.to(counts.device) for c in posted])
    if me.source is None:
        _count("all-gather", "all_gather_counts", _nbytes(table.shape, table.dtype))
    for tape in me.sinks:
        tape.append(table)
    return table, me.rank


class _Recording:
    def __init__(self, rank: _Rank, tape: list):
        self.rank, self.tape = rank, tape

    def __enter__(self):
        self.rank.sinks.append(self.tape)

    def __exit__(self, *exc):
        # by identity: two tapes of equal tables compare equal
        del self.rank.sinks[next(i for i, t in enumerate(self.rank.sinks) if t is self.tape)]


class _Replaying:
    def __init__(self, rank: _Rank, tape: list, model=None):
        self.rank, self.tape, self.model = rank, tape, model

    def __enter__(self):
        self._cm = contextlib.ExitStack()
        self._cm.enter_context(_as(_Rank(self.rank.group, self.rank.rank,
                                         source=iter(self.tape))))
        self._cm.enter_context(Pt.model_split(self.model))

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: inside a data rank, the
    region's forward records the counts tables it receives and its
    recomputation replays them, on whichever thread recomputes it; inside a
    model group (``partition.model_split``) the recomputation runs in it
    too, and makes its model collectives again (every rank recomputes the
    same regions in the same order, so they meet); otherwise nothing."""
    me, model = _current(), Pt.model_group()
    if me is None and model is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    tape: list = []
    if me is None:
        return contextlib.nullcontext(), Pt.model_split(model)
    return _Recording(me, tape), _Replaying(me, tape, model)


# --- the model axis: Megatron's split compute --------------------------------------

class ModelRanks:
    """The local model group: one process holds every one of ``size`` model
    ranks' parts, so a split op is a loop over them in rank order and a
    model collective is a sum or max over the loop's parts (no threads, no
    meeting).  The one-process oracle of the process backend's bits."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = tuple(range(size))

    def every(self, parts: Sequence[torch.Tensor], fn: str) -> List[torch.Tensor]:
        """Every model rank's part, in rank order, from this process's
        (for collective ``fn``)."""
        return list(parts)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def move(self, chunks: Dict, routes) -> Dict:
        """``model_exchange``'s moves: {(rank, slot): chunk} of this
        process's ranks after each route ``(src, dst)`` carried ``chunks[src]``
        to ``dst``."""
        return {dst: chunks[src] for src, dst in routes}


class TracedModelRank(ModelRanks):
    """Model rank ``rank`` of ``size`` alone, its peers absent: the dry
    run's traced model coordinate on ``meta`` tensors, whose collectives
    return results of the right shapes (a peer's part is taken to be this
    rank's) and move nothing."""

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = size, rank
        self.ranks = (rank,)

    def every(self, parts: Sequence[torch.Tensor], fn: str) -> List[torch.Tensor]:
        return [parts[0]] * self.size

    def move(self, chunks: Dict, routes) -> Dict:
        like = next(iter(chunks.values()))
        return {dst: like for _, dst in routes if dst[0] == self.rank}


def _model_count(group, kind: str, fn: str, t: torch.Tensor):
    if group.size > 1:
        _count(kind, fn, _nbytes(t.shape, t.dtype))


def model_max(group, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The elementwise max of a statistic over every model rank (this
    process's ``parts``, in rank order): ``all_reduce(MAX)`` over the model
    subgroup.  Exact.  ``group`` None: the one part, whole."""
    out = parts[0]
    for t in parts[1:]:
        out = torch.maximum(out, t)
    if group is None:
        return out
    _model_count(group, "all-reduce", "model_max", out)
    with _clocked("all-reduce", "model_max"):
        return group.max(out)


def model_sum(group, partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The row-parallel all-reduce: every model rank's partial in float32,
    summed in model-rank order from rank 0's, in the partials' dtype.  The
    process backend all-gathers the partials (neither gloo's nor NCCL's
    all-reduce sums in rank order), so every rank holds the same bits; they
    travel in their own dtype and are widened on arrival (the same float32
    values as widening first, in half the bytes for bf16)."""
    dtype = partials[0].dtype
    with _clocked("all-reduce", "model_sum"):
        every = [t.to(torch.float32) for t in group.every(partials, "model_sum")]
        out = every[0]
        for t in every[1:]:
            out = out + t
        out = out.to(dtype)
    _model_count(group, "all-reduce", "model_sum", out)
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: the replicated input of a column-parallel product,
    one view a model rank; the backward sums the ranks' gradients
    (``model_sum``)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return tuple(x.view_as(x) for _ in group.ranks)

    @staticmethod
    def backward(ctx, *grads):
        return None, model_sum(ctx.group, grads)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the sum of the row-parallel partials (``model_sum``);
    the backward hands each rank the gradient as it is."""

    @staticmethod
    def forward(ctx, group, *partials):
        ctx.n = len(partials)
        return model_sum(group, partials)

    @staticmethod
    def backward(ctx, g):
        return (None, *([g] * ctx.n))


def model_gather(group, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Every model rank's part (this process's ``parts``, in rank order; one
    shape and dtype on every rank) concatenated along ``dim`` in rank order:
    an all-gather over the model subgroup.  Exact; no gradient."""
    with _clocked("all-gather", "model_gather"):
        out = torch.cat(group.every(parts, "model_gather"), dim)
    _model_count(group, "all-gather", "model_gather", out)
    return out


class _ModelBlocks(torch.autograd.Function):
    """This process's model ranks' blocks of a replicated leaf along a dim;
    the backward assembles the ranks' disjoint gradient blocks in rank
    order (``model_gather``), so every rank holds the leaf's whole gradient,
    the same bits (a sum of zero-padded copies would turn -0.0 into +0.0)."""

    @staticmethod
    def forward(ctx, group, dim, w):
        ctx.group, ctx.dim = group, dim
        n = w.shape[dim] // group.size
        return tuple(w.narrow(dim, r * n, n) for r in group.ranks)

    @staticmethod
    def backward(ctx, *grads):
        return None, None, model_gather(ctx.group, grads, ctx.dim)


def model_blocks(group, w: torch.Tensor, dim: int) -> List[torch.Tensor]:
    """Each of this process's model ranks' block of the replicated ``w``
    along ``dim`` (rank r's: the r-th of ``group.size`` equal blocks), for a
    split computation that reads only its own columns of a leaf every rank
    holds whole (xLSTM's gate weights, ``ln_y`` and the sLSTM's recurrent
    heads); its gradient is the ranks' blocks assembled.  ``group`` None:
    ``[w]``."""
    return [w] if group is None else list(_ModelBlocks.apply(group, dim % w.dim(), w))


def _exchange_routes(size: int, segments: int, inverse: bool = False):
    """``model_exchange``'s ((src rank, slot), (dst rank, slot)) of every
    chunk c, in chunk order: the whole tensor's ``size * segments`` chunks,
    rank r holding chunks [r segments, (r + 1) segments) before and chunks
    c = s size + r (block r of segment s) after."""
    routes = [((c // segments, c % segments), (c % size, c // size))
              for c in range(size * segments)]
    return [(d, s) for s, d in routes] if inverse else routes


def _exchange(group, parts, segments: int, inverse: bool):
    chunks = {(r, j): c for r, part in zip(group.ranks, parts, strict=True)
              for j, c in enumerate(part.chunk(segments, -1))}
    with _clocked("all-to-all", "model_exchange"):
        moved = group.move(chunks, _exchange_routes(group.size, segments, inverse))
        out = [torch.cat([moved[(r, j)] for j in range(segments)], -1) for r in group.ranks]
    _model_count(group, "all-to-all", "model_exchange", out[0])
    return out


class _ModelExchange(torch.autograd.Function):
    """``model_exchange``; the backward moves each rank's gradient back by
    the inverse routes."""

    @staticmethod
    def forward(ctx, group, segments, *parts):
        ctx.group, ctx.segments = group, segments
        return tuple(_exchange(group, parts, segments, inverse=False))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_exchange(ctx.group, grads, ctx.segments, inverse=True))


def copy_to_model(group, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` for each of this process's model ranks (``[x]`` when ``group``
    is None); its gradient is the sum of theirs, in rank order."""
    return [x] if group is None else list(_CopyToModel.apply(group, x))


def reduce_from_model(group, partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """``model_sum`` of the ranks' partials, each rank's gradient the sum's
    (the one partial when ``group`` is None)."""
    return partials[0] if group is None else _ReduceFromModel.apply(group, *partials)


def model_exchange(group, parts: Sequence[torch.Tensor], segments: int) -> List[torch.Tensor]:
    """Each rank's block of every segment of a tensor that the ranks'
    ``parts`` split into column blocks: the tensor is ``segments`` segments
    along its last axis (Mamba's ``[x | z]``, 2), and rank r's result is
    block r of segment 0, then of segment 1, ...  An all-to-all over the
    model ranks (the reshard the reference's partitioner inserts between
    a column-parallel product and a split of its output); exact, its
    backward the inverse exchange.  ``group`` None, or one rank: ``parts``
    as they are."""
    if group is None or group.size == 1:
        return list(parts)
    return list(_ModelExchange.apply(group, segments, *parts))


def gather_model_block(blocks: Sequence[torch.Tensor], sharding: Pt.NamedSharding, model: int,
                       device=None) -> torch.Tensor:
    """Model block ``model`` of a leaf from every rank's ``blocks`` (rank
    order): the blocks of that model coordinate's ranks gathered over the
    data axes only.  A block no data rank splits is its rank's own tensor."""
    ranks = Pt.model_ranks(sharding.mesh, model)
    sub = Pt.data_sharding(sharding)
    dev = torch.device(device) if device is not None else sharding.mesh.devices[ranks[0]]
    mine = [blocks[r] for r in ranks]
    if _whole(sub, mine[0].dim()):
        return mine[0] if mine[0].device == dev else mine[0].to(dev)
    out = Pt.gather_leaf(mine, sub, dev, ranks=ranks)
    _count("all-gather", "all_gather_data", _nbytes(out.shape, out.dtype))
    return out


# --- the process backend: one OS process per rank ------------------------------------

# Each collective of the process backend: the ``torch.distributed`` op it
# makes, and how that op moves a CUDA tensor under each backend ("device":
# the tensor goes to the process group where it lies).  A probe of the
# card's torch (2.11, gloo, two ranks on cuda:0) ran all_gather,
# all_to_all_single and all_reduce(MAX) on CUDA tensors; gloo lacks only
# all_to_all's list form there, which this backend does not use, so no op
# needs a host buffer.  A collective missing here raises for a CUDA tensor.
DIST_OPS = {"all_gather": "all_gather", "reduce_scatter_add": "all_to_all_single",
            "max_over_ranks": "all_reduce", "gather_blocks": "all_gather",
            "all_gather_counts": "all_gather", "all_gather_data": "all_gather",
            "model_sum": "all_gather", "model_max": "all_reduce",
            "model_exchange": "all_to_all_single", "model_gather": "all_gather"}
ROUTES = {(backend, fn): (op, "device") for backend in ("gloo", "nccl")
          for fn, op in DIST_OPS.items()}


@contextlib.contextmanager
def host_ms():
    """Yields {(kind, function): host ms} of the process backend's calls,
    filled while open."""
    t: Dict[Tuple[str, str], float] = {}
    _clocks.append(t)
    try:
        yield t
    finally:
        _clocks.remove(t)


@contextlib.contextmanager
def _clocked(kind: str, fn: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        for t in _clocks:
            t[(kind, fn)] = t.get((kind, fn), 0.0) + ms


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (a copy where ``t`` is not
    contiguous): the process group moves bytes, whatever the dtype."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.view(like.dtype).reshape(like.shape)


def _add_in_order(owner: Optional[torch.Tensor], parts, like: torch.Tensor) -> torch.Tensor:
    """``owner`` (None starts it) plus each of ``parts`` (the bytes of
    tensors shaped as ``like``) in float32, in order."""
    for part in parts:
        part = _from_bytes(part, like)
        if owner is None:
            owner = part.to(torch.float32, copy=True, memory_format=torch.contiguous_format)
        else:
            owner.add_(part.to(torch.float32))
    return owner


class Process:
    """The process backend over ``mesh`` (a ``launch.mesh.ProcessMesh``):
    this rank's part of each collective.  Every (micro)batch must split over
    every rank of the batch axes.  It is also the MoE data ranks' group
    (``data_rank(process, block)``): ``n`` data ranks, ``gather`` of the
    counts over the batch axes' subgroup."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh, self.dist = mesh, dist
        self.device = mesh.device
        axes = Pt.batch_axes(mesh)
        self.batch_group = mesh.groups[axes]
        sh = Pt.NamedSharding(mesh, (axes,))
        self.block = [Pt.block_index(sh, r, 1)[0][0] for r in range(mesh.size)]
        self.n = math.prod(mesh.shape[a] for a in axes)
        # each data block's first rank: the one whose gradient counts
        self.reps = [self.block.index(k) for k in range(self.n)]
        self.model = _ProcessModel(self)

    def _op(self, fn: str, t: torch.Tensor):
        """The ``torch.distributed`` op that collective ``fn`` makes on ``t``."""
        op, route = ROUTES.get((self.mesh.backend, fn), (None, None))
        if op is None or (t.is_cuda and route != "device"):
            raise NotImplementedError(f"{fn} has no route for CUDA tensors under "
                                      f"{self.mesh.backend} (collectives.ROUTES)")
        return getattr(self.dist, op)

    def _all_gather(self, fn: str, t: torch.Tensor, group=None, n: Optional[int] = None):
        """Every rank's ``t`` (one shape and dtype on every rank), in rank
        order, for collective ``fn``."""
        n = self.mesh.size if n is None else n
        if n == 1:
            return [t]
        b = _bytes(t)
        out = [torch.empty_like(b) for _ in range(n)]
        self._op(fn, b)(out, b, group=group)
        return [_from_bytes(o, t) for o in out]

    def all_gather(self, block: torch.Tensor, sharding: Pt.NamedSharding) -> torch.Tensor:
        """The leaf whole on this rank's device, from every rank's
        ``block``; a leaf no rank splits is its own block."""
        if _whole(sharding, block.dim()):
            return block
        with _clocked("all-gather", "all_gather"):
            out = Pt.gather_leaf(self._all_gather("all_gather", block), sharding, self.device)
        _count("all-gather", "all_gather", _nbytes(out.shape, out.dtype))
        return out

    def reduce_scatter_add(self, owner: Optional[torch.Tensor], contribution: torch.Tensor,
                           sharding: Pt.NamedSharding, *, sole: bool = False) -> torch.Tensor:
        """Add every data rank's ``contribution`` (here, this rank's data
        block's gradient of a leaf) into this rank's running float32 sum of
        its own block (``owner``; None starts it), in data rank order.
        Every rank calls it once a microbatch.  ``sole`` (one data rank, one
        microbatch): this rank's block as it is, in its own dtype, nothing
        moved."""
        me, size = self.mesh.rank, self.mesh.size

        def block(r):
            return contribution[Pt._slices(contribution.shape,
                                           Pt.block_index(sharding, r, contribution.dim()))]

        mine = block(me)
        if sole:
            return mine
        kind = "all-reduce" if _whole(sharding, contribution.dim()) else "reduce-scatter"
        _count(kind, "reduce_scatter_add", _nbytes(mine.shape, torch.float32))
        nb = mine.numel() * mine.element_size()
        with _clocked(kind, "reduce_scatter_add"):
            # a model rank's contribution repeats its data block's first rank's
            send = [_bytes(block(r)) for r in range(size)] if me in self.reps else []
            src = torch.cat(send) if send else mine.new_empty(0, dtype=torch.uint8)
            del send
            out = torch.empty(nb * self.n, dtype=torch.uint8, device=contribution.device)
            self._op("reduce_scatter_add", out)(
                out, src, [nb if r in self.reps else 0 for r in range(size)],
                [nb] * size if me in self.reps else [0] * size)
            del src
            owner = _add_in_order(owner, out.split(nb), mine)   # one per data block, in order
        return owner

    def all_gather_data(self, block: torch.Tensor, sharding: Pt.NamedSharding) -> torch.Tensor:
        """This rank's model block of the leaf, from its data subgroup's
        ``block`` (``gather_model_block``'s process part): gathered over the
        data axes only, never over the model axis."""
        ranks = Pt.model_ranks(self.mesh, self.model.rank)
        sub = Pt.data_sharding(sharding)
        if _whole(sub, block.dim()):
            return block
        with _clocked("all-gather", "all_gather_data"):
            every = self._all_gather("all_gather_data", block, self.batch_group, self.n)
            out = Pt.gather_leaf(every, sub, self.device, ranks=ranks)
        _count("all-gather", "all_gather_data", _nbytes(out.shape, out.dtype))
        return out

    def reduce_scatter_data(self, owner: Optional[torch.Tensor], contribution: torch.Tensor,
                            sharding: Pt.NamedSharding, *, sole: bool = False) -> torch.Tensor:
        """``reduce_scatter_add`` of a model-split leaf: ``contribution`` is
        this rank's gradient of its model block, summed in float32 in data
        rank order over the data subgroup of its model coordinate into this
        rank's running sum of its own block (``owner``)."""
        ranks = Pt.model_ranks(self.mesh, self.model.rank)
        sub = Pt.data_sharding(sharding)

        def block(r):
            return contribution[Pt._slices(contribution.shape,
                                           Pt.block_index(sub, r, contribution.dim()))]

        mine = block(self.mesh.rank)
        if sole:
            return mine
        _count("reduce-scatter", "reduce_scatter_add", _nbytes(mine.shape, torch.float32))
        nb = mine.numel() * mine.element_size()
        with _clocked("reduce-scatter", "reduce_scatter_add"):
            if self.n == 1:
                return _add_in_order(owner, [_bytes(mine)], mine)
            src = torch.cat([_bytes(block(r)) for r in ranks])
            out = torch.empty(nb * self.n, dtype=torch.uint8, device=contribution.device)
            self._op("reduce_scatter_add", out)(out, src, group=self.batch_group)
            del src
            return _add_in_order(owner, out.split(nb), mine)    # one per data rank, in order

    def max_over_ranks(self, tree):
        """The elementwise max of every rank's ``tree`` (nested dicts of
        tensors): an all-reduce of each leaf."""
        leaves = []
        for _, t in Pt.tree_paths(tree):
            out = t.clone(memory_format=torch.contiguous_format)
            with _clocked("all-reduce", "max_over_ranks"):
                self._op("max_over_ranks", out)(out, op=self.dist.ReduceOp.MAX)
            _count("all-reduce", "max_over_ranks", _nbytes(t.shape, t.dtype))
            leaves.append(out)
        return Pt.tree_rebuild(tree, leaves)

    def gather_blocks(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Each data block's ``t`` (a table of one shape on every rank), in
        block order, from the block's first rank: the step's metrics."""
        every = self._all_gather("gather_blocks", t)
        return [every[r] for r in self.reps]

    def gather(self, rank: int, call: int, counts: torch.Tensor) -> List[torch.Tensor]:
        """``DataRanks.gather`` across processes: every data rank's (k, E)
        counts of this MoE layer, in block order (the batch axes'
        subgroup's rank order)."""
        del rank, call              # the group's calls meet in the order made
        with _clocked("all-gather", "all_gather_counts"):
            return self._all_gather("all_gather_counts", counts, self.batch_group, self.n)

    def barrier(self):
        if self.mesh.backend == "nccl":
            self.dist.barrier(device_ids=[self.device.index])
        else:
            self.dist.barrier()


class _ProcessModel:
    """A ``Process``'s model group: this rank's model coordinate alone
    (``ranks``), its peers over the model axis's subgroup."""

    def __init__(self, proc: Process):
        mesh = proc.mesh
        self.proc = proc
        self.size = mesh.shape.get("model", 1)
        self.rank = mesh.coords(mesh.rank).get("model", 0)
        self.ranks = (self.rank,)
        self.group = mesh.groups.get(("model",))

    def every(self, parts: Sequence[torch.Tensor], fn: str) -> List[torch.Tensor]:
        (t,) = parts
        return self.proc._all_gather(fn, t, self.group, self.size)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return t
        out = t.clone(memory_format=torch.contiguous_format)
        self.proc._op("model_max", out)(out, op=self.proc.dist.ReduceOp.MAX, group=self.group)
        return out

    def move(self, chunks: Dict, routes) -> Dict:
        """``ModelRanks.move`` across the model subgroup: one
        ``all_to_all_single`` of the chunks' bytes (every chunk one shape
        and dtype), each pair of ranks' chunks in chunk order."""
        me = self.rank
        like = next(iter(chunks.values()))
        nb = like.numel() * like.element_size()
        sends = [[src for src, dst in routes if src[0] == me and dst[0] == d]
                 for d in range(self.size)]
        recvs = [[dst for src, dst in routes if src[0] == s and dst[0] == me]
                 for s in range(self.size)]
        src = torch.cat([_bytes(chunks[k]) for row in sends for k in row])
        out = torch.empty(nb * sum(map(len, recvs)), dtype=torch.uint8, device=like.device)
        self.proc._op("model_exchange", out)(out, src, [nb * len(r) for r in recvs],
                                             [nb * len(r) for r in sends], group=self.group)
        got = iter(out.split(nb))
        return {k: _from_bytes(next(got), like) for row in recvs for k in row}
