"""The serving half of the reference's ``sharding/partition.py``: the
partition specs of the tensor-parallel paged KV pool, and the split of a
pool into per-rank shards and back.

A spec is a tuple with one entry per axis: ``None`` (not split) or the mesh
axis ``"model"`` (split into ``mesh.size`` contiguous blocks, block r on
rank r).  The pool's K/V leaves are (n_reps, n_pages, P, Hkv, hd) and split
only over Hkv: every rank holds its heads' slice of EVERY page, so page ids
stay global and one host-side block table and allocator address all ranks.
A shard is its own contiguous tensor on its rank's device (a strided view
of the Hkv axis would break the paged kernels' 16-byte and stride
assumptions); kv4's 2-D (n_reps, n_pages) scale leaves are replicated, one
copy per rank.  The QAT and serving parameter rules, the batch shardings and
the mesh context are not ported (ROADMAP Open items §1, item 8b).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.launch.mesh import TPMesh

Spec = Tuple


class NamedSharding(NamedTuple):
    mesh: TPMesh
    spec: Spec


def _fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop the mesh axes that do not divide their dim, and trim the spec to
    the rank of ``shape``."""
    if shape is None:
        return tuple(spec)
    parts = []
    for i, ax in enumerate(tuple(spec)[:len(shape)]):
        if ax is None:
            parts.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        keep, rem = [], shape[i]
        for a in axes:
            n = mesh.shape[a]
            if rem % n == 0:
                keep.append(a)
                rem //= n
        parts.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(parts)


def kv_pool_pspec() -> Spec:
    """The spec of one paged-pool K/V leaf (n_reps, n_pages, P, Hkv, hd):
    the KV heads split over the model axis, the page axis never."""
    return (None, None, None, "model", None)


def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _rebuild(tree, values):
    """``tree``'s nested dicts with their leaves replaced, in order."""
    it = iter(values)

    def go(t):
        return {k: go(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return go(tree)


def paged_pool_shardings(mesh: TPMesh, tree) -> Dict:
    """A ``NamedSharding`` per leaf of a paged pool: ``kv_pool_pspec``
    fitted to the leaf (an indivisible Hkv, or a 2-D scale leaf, comes out
    unsplit; the engine refuses Hkv % tp != 0 itself)."""
    return _rebuild(tree, [NamedSharding(mesh, _fit_spec(kv_pool_pspec(), tuple(v.shape), mesh))
                           for _, v in _leaves(tree)])


def kv_pool_specs(tree, mesh: TPMesh) -> Dict:
    """The spec of each leaf of a paged pool: the 5-D payload leaves take
    ``kv_pool_pspec``; lower-rank leaves (kv4's per-page scales, computed
    from full-head codes) are replicated."""
    return _rebuild(tree, [_fit_spec(kv_pool_pspec(), tuple(v.shape), mesh) if v.dim() == 5
                           else (None,) * v.dim() for _, v in _leaves(tree)])


def _split_axis(v: torch.Tensor):
    """The axis a pool leaf splits over (the payload's Hkv), or None."""
    return kv_pool_pspec().index("model") if v.dim() == 5 else None


def split_pool(pool: Dict, mesh: TPMesh) -> List[Dict]:
    """One pool per rank: each payload leaf's r-th block of Hkv and a copy
    of each scale leaf, as fresh contiguous tensors on rank r's device."""
    leaves = [v for _, v in _leaves(pool)]
    for v in leaves:
        ax = _split_axis(v)
        if ax is not None and v.shape[ax] % mesh.size:
            raise ValueError(f"TP={mesh.size} does not divide the pool's {v.shape[ax]} KV heads")
    return [_rebuild(pool, [(v if _split_axis(v) is None else
                             v.chunk(mesh.size, dim=_split_axis(v))[r])
                            .to(dev, copy=True, memory_format=torch.contiguous_format)
                            for v in leaves])
            for r, dev in enumerate(mesh.devices)]


def gather_pool(shards: Sequence[Dict], mesh: TPMesh) -> Dict:
    """The pool the shards split, on rank 0's device: payload leaves
    concatenated over Hkv in rank order, scale leaves taken from rank 0."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a {mesh.size}-rank mesh")
    dev = mesh.devices[0]
    per_rank = list(zip(*[[v for _, v in _leaves(s)] for s in shards], strict=True))
    return _rebuild(shards[0], [
        parts[0].to(dev, copy=True) if _split_axis(parts[0]) is None
        else torch.cat([p.to(dev) for p in parts], dim=_split_axis(parts[0]))
        for parts in per_rank])
