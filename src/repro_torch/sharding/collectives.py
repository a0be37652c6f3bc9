"""The sharded train step's collectives, behind one seam: gather a leaf from
its shards, reduce the data ranks' gradients into the owners' shards, take
the max over ranks, and gather every data rank's MoE routing counts.  Two
backends do the same four things and give the same bits.

The ``local`` backend (the module's functions) serves a ``Mesh`` that one
process drives: the first three are loops over the ranks' tensors with
copies between their devices.  The fourth is where the data ranks meet: a
MoE layer's routing counts the whole (micro)batch (``models/moe.py``), so
each data rank runs its forward and backward in a thread of its own
(``train/steps.py``), posts its (k, E) int32 table of per-(choice, expert)
counts at each MoE layer, and blocks in ``all_gather_counts`` until every
data rank of its ``DataRanks`` group has posted.

The ``process`` backend (``Process``) serves a ``launch.mesh.ProcessMesh``,
one OS process per rank over a ``torch.distributed`` process group: each
call is this rank's part of one collective that every rank makes in the
same order.  It gathers with ``all_gather``; it reduces with an all-to-all
of the gradient's blocks (each data block's first rank sends block r to
rank r), after which each owner sums what it received in float32 in data
rank order, the local loop's order (neither gloo's nor NCCL's reduce-scatter
sums in rank order); it takes the max with ``all_reduce(MAX)``; and, as the
MoE data ranks' group, it all-gathers the counts over the batch axes'
subgroup.  ``ROUTES`` names how each op it uses moves a CUDA tensor under
each backend.

Under either backend a recomputed (remat) forward replays the tables its
first forward received, in order, and never meets again:
``recompute_contexts`` is the ``context_fn`` of ``layers.remat``'s
checkpoint, so the replay reaches the thread that recomputes (on a CUDA
card, autograd's own, where a collective would deadlock).  On ``meta``
tensors (the dry run's traced rank) the gather waits for no one and returns
a ``meta`` table.

``tally()`` counts the collectives called while it is open, per kind and
per function, and the bytes of each call's result on one rank, as the
reference's dry run sums the result shapes of XLA's collectives: a gathered
leaf whole, a reduce-scatter's own float32 block (an all-reduce when no rank
splits the leaf), each maxed leaf, the (n, k, E) counts table.  A call of
the process backend counts as the local backend counts one rank's part of
it: one data rank's contribution, one gathered leaf, one rank's table.
``host_ms()`` sums the host time of the process backend's calls, per kind
and function.
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
    def __init__(self, rank: _Rank, tape: list):
        self.rank, self.tape = rank, tape

    def __enter__(self):
        self._cm = _as(_Rank(self.rank.group, self.rank.rank, source=iter(self.tape)))
        self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: inside a data rank, the
    region's forward records the counts tables it receives and its
    recomputation replays them, on whichever thread recomputes it; outside
    one, nothing."""
    me = _current()
    if me is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    tape: list = []
    return _Recording(me, tape), _Replaying(me, tape)


# --- the process backend: one OS process per rank ------------------------------------

# How each op of the process backend moves a CUDA tensor under each backend:
# "device" hands the tensor to the process group where it lies.  A probe of
# the card's torch (2.11, gloo, two ranks on cuda:0) ran all_gather,
# all_to_all_single and all_reduce(MAX) on CUDA tensors; gloo lacks
# only all_to_all's list form there, which this backend does not use, so no
# op needs a host buffer.  An op missing here raises for a CUDA tensor.
ROUTES = {(backend, op): "device" for backend in ("gloo", "nccl")
          for op in ("all_gather", "all_to_all_single", "all_reduce")}


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

    def _op(self, op: str, t: torch.Tensor):
        if t.is_cuda and ROUTES.get((self.mesh.backend, op)) != "device":
            raise NotImplementedError(f"{op} has no route for CUDA tensors under "
                                      f"{self.mesh.backend} (collectives.ROUTES)")
        return getattr(self.dist, op)

    def _all_gather(self, t: torch.Tensor, group=None, n: Optional[int] = None):
        """Every rank's ``t`` (one shape and dtype on every rank), in rank
        order."""
        n = self.mesh.size if n is None else n
        if n == 1:
            return [t]
        b = _bytes(t)
        out = [torch.empty_like(b) for _ in range(n)]
        self._op("all_gather", b)(out, b, group=group)
        return [_from_bytes(o, t) for o in out]

    def all_gather(self, block: torch.Tensor, sharding: Pt.NamedSharding) -> torch.Tensor:
        """The leaf whole on this rank's device, from every rank's
        ``block``; a leaf no rank splits is its own block."""
        if _whole(sharding, block.dim()):
            return block
        with _clocked("all-gather", "all_gather"):
            out = Pt.gather_leaf(self._all_gather(block), sharding, self.device)
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
            self._op("all_to_all_single", out)(
                out, src, [nb if r in self.reps else 0 for r in range(size)],
                [nb] * size if me in self.reps else [0] * size)
            del src
            for part in out.split(nb):          # one per data block, in block order
                part = _from_bytes(part, mine)
                if owner is None:
                    owner = part.to(torch.float32, copy=True, memory_format=torch.contiguous_format)
                else:
                    owner.add_(part.to(torch.float32))
        return owner

    def max_over_ranks(self, tree):
        """The elementwise max of every rank's ``tree`` (nested dicts of
        tensors): an all-reduce of each leaf."""
        leaves = []
        for _, t in Pt.tree_paths(tree):
            out = t.clone(memory_format=torch.contiguous_format)
            with _clocked("all-reduce", "max_over_ranks"):
                self._op("all_reduce", out)(out, op=self.dist.ReduceOp.MAX)
            _count("all-reduce", "max_over_ranks", _nbytes(t.shape, t.dtype))
            leaves.append(out)
        return Pt.tree_rebuild(tree, leaves)

    def gather_blocks(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Each data block's ``t`` (a table of one shape on every rank), in
        block order, from the block's first rank: the step's metrics."""
        every = self._all_gather(t)
        return [every[r] for r in self.reps]

    def gather(self, rank: int, call: int, counts: torch.Tensor) -> List[torch.Tensor]:
        """``DataRanks.gather`` across processes: every data rank's (k, E)
        counts of this MoE layer, in block order (the batch axes'
        subgroup's rank order)."""
        del rank, call              # the group's calls meet in the order made
        with _clocked("all-gather", "all_gather_counts"):
            return self._all_gather(counts, self.batch_group, self.n)

    def barrier(self):
        if self.mesh.backend == "nccl":
            self.dist.barrier(device_ids=[self.device.index])
        else:
            self.dist.barrier()
