"""The sharded train step's collectives, behind one seam: gather a leaf from
its shards, reduce the data ranks' gradients into the owners' shards, take
the max over ranks, and gather every data rank's MoE routing counts.

One process drives every rank, so the first three are loops over the ranks'
tensors with copies between their devices.  The fourth is where the data
ranks meet: a MoE layer's routing counts the whole (micro)batch
(``models/moe.py``), so each data rank runs its forward and backward in a
thread of its own (``train/steps.py``), posts its (k, E) int32 table of
per-(choice, expert) counts at each MoE layer, and blocks in
``all_gather_counts`` until every data rank of its ``DataRanks`` group has
posted.  A recomputed (remat) forward replays the tables its first forward
received, in order, and never meets again: ``recompute_contexts`` is the
``context_fn`` of ``layers.remat``'s checkpoint, so the replay reaches the
thread that recomputes (on a CUDA card, autograd's own).  On ``meta``
tensors (the dry run's traced rank) the gather waits for no one and returns
a ``meta`` table.

A process-group backend (``all_gather``, ``reduce_scatter``,
``all_reduce(MAX)`` and an ``all_gather`` of the counts across cards) would
replace these functions and nothing else (ROADMAP Open items §1, item 5).

``tally()`` counts the collectives called while it is open, per kind and
per function, and the bytes of each call's result on one rank, as the
reference's dry run sums the result shapes of XLA's collectives: a gathered
leaf whole, a reduce-scatter's own float32 block (an all-reduce when no rank
splits the leaf), each maxed leaf, the (n, k, E) counts table.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import partition as Pt

_tallies: List[Dict[Tuple[str, str], List[int]]] = []
_tally_lock = threading.Lock()


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
