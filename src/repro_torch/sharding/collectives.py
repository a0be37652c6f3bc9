"""The sharded train step's three collectives, behind one seam: gather a
leaf from its shards, reduce the data ranks' gradients into the owners'
shards, and take the max over ranks.

One process drives every rank, in rank order, so each collective is a loop
over the ranks' tensors with copies between their devices.  A process-group
backend (``all_gather``, ``reduce_scatter``, ``all_reduce(MAX)`` across
cards) would replace these functions and nothing else (ROADMAP Open items
§1).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.sharding import partition as Pt


def _whole(sharding: Pt.NamedSharding, ndim: int) -> bool:
    return all(n == 1 for _, n in Pt.block_index(sharding, 0, ndim))


def all_gather(blocks: Sequence[torch.Tensor], sharding: Pt.NamedSharding,
               device=None) -> torch.Tensor:
    """The leaf on ``device`` (default rank 0's).  A leaf no rank splits
    comes back as rank 0's own tensor when that is on ``device``."""
    dev = torch.device(device) if device is not None else sharding.mesh.devices[0]
    if _whole(sharding, blocks[0].dim()) and blocks[0].device == dev:
        return blocks[0]
    return Pt.gather_leaf(blocks, sharding, dev)


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
    if owners is None:
        return [b.to(dev, torch.float32, copy=True, memory_format=torch.contiguous_format)
                for b, dev in zip(blocks, mesh.devices, strict=True)]
    for acc, b in zip(owners, blocks, strict=True):
        acc.add_(b.to(acc.device, torch.float32))
    return owners


def max_over_ranks(trees: Sequence):
    """The elementwise max of the ranks' trees (nested dicts of tensors, one
    per data rank in rank order), on the first tree's devices."""
    if isinstance(trees[0], dict):
        return {k: max_over_ranks([t[k] for t in trees]) for k in trees[0]}
    out = trees[0]
    for t in trees[1:]:
        out = torch.maximum(out, t.to(out.device))
    return out
