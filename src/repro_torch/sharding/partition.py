"""Name-based parameter -> partition-spec rules (Megatron TP + FSDP over
DP), the batch and cache specs, the mesh context, and the placement of a
tree's leaves on a mesh's ranks: the reference's ``sharding/partition.py``.

Axes: ``data`` (+ ``pod`` composed in front on multi-pod meshes) carry the
batch and the FSDP shard of weights; ``model`` carries the weights' tensor-
parallel split: column-parallel on QKV/gate/up (output dim), row-parallel on
O/down (contraction dim), vocab-parallel embeddings and LM head, expert-FFN
dims for MoE, state dims for Mamba.  FSDP: the non-'model' weight dim is
also split over the DP axes.  Serving never uses FSDP.

A spec is a tuple with one entry per leading dim: ``None`` (not split), a
mesh axis, or a tuple of axes (split over their product; block i on the
rank whose coordinates on those axes flatten to i, row-major in the tuple's
order).  A leaf split over some axes is replicated over the others.  A
shard is its own contiguous tensor on its rank's device: ``split_tree``
cuts a tree into one tree per rank (rank order, ``mesh.coords``) and
``gather_tree`` puts it back together.  The paged KV pool of the serving
engine splits over its KV heads only (``kv_pool_pspec``).

A split leaf's "model" blocks are storage, not Megatron compute (each data
rank gathers a leaf before using it, whether one process drives every rank
or each rank is a process of its own), so ``constrain`` places nothing.
"""
from __future__ import annotations

import dataclasses
import math
import re
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

Spec = Tuple


class NamedSharding(NamedTuple):
    mesh: object          # launch.mesh.Mesh or TPMesh
    spec: Spec


# --- rule tables ----------------------------------------------------------------
# (regex on 'path/like/this', spec given the FSDP axes) -- the reference's,
# entry for entry.  Paths are relative; a leading 'blocks/slotN/' has a
# stacked (n_reps) dim 0, which is never split.

def _qat_rules(_dp, fs):
    return [
        (r"embed/tokens$",      ("model", fs)),
        (r"embed/pos$",         (None, None)),
        (r"embed/codebooks$",   (None, "model", fs)),
        (r"attn/wq$",           (None, fs, "model")),
        (r"attn/wk$",           (None, fs, "model")),
        (r"attn/wv$",           (None, fs, "model")),
        (r"attn/wo$",           (None, "model", fs)),
        (r"attn/b[qkv]$",       (None, "model")),
        (r"attn/bo$",           (None, None)),
        (r"attn/[qk]n$",        (None, None)),
        (r"mlp/wg$",            (None, fs, "model")),
        (r"mlp/wu$",            (None, fs, "model")),
        (r"mlp/wd$",            (None, "model", fs)),
        (r"mlp/w1$",            (None, fs, "model")),
        (r"mlp/w2$",            (None, "model", fs)),
        (r"mlp/b1$",            (None, "model")),
        (r"mlp/b2$",            (None, None)),
        (r"moe/router$",        (None, None, None)),
        (r"moe/(experts|shared)/wg$", (None, None, fs, "model")),
        (r"moe/(experts|shared)/wu$", (None, None, fs, "model")),
        (r"moe/(experts|shared)/wd$", (None, None, "model", fs)),
        # mamba: d_in dims split over model (elementwise-parallel scan)
        (r"mixer/w_in$",        (None, fs, "model")),
        (r"mixer/conv_w$",      (None, None, "model")),
        (r"mixer/conv_b$",      (None, "model")),
        (r"mixer/w_x$",         (None, "model", None)),
        (r"mixer/w_dt$",        (None, None, "model")),
        (r"mixer/dt_bias$",     (None, "model")),
        (r"mixer/A_log$",       (None, "model", None)),
        (r"mixer/D$",           (None, "model")),
        (r"mixer/w_out$",       (None, "model", fs)),
        # xlstm: project onto model over the wide dim
        (r"mixer/w[qkv]$",      (None, fs, "model")),
        (r"mixer/wo$",          (None, "model", fs)),
        (r"mixer/w_[io]g$",     (None, None, None)),
        (r"mixer/w_fg$",        (None, None, None)),
        (r"mixer/w_[zifo]$",    (None, fs, "model")),
        (r"mixer/b_[zifo]g?$",  (None, "model")),
        (r"mixer/r$",           (None, None, None, None)),
        (r"mixer/ln_y$",        (None, None)),
        (r"lm_head$",           (fs, "model")),           # (d, V) or (K, d, V)
        (r"(norm1|norm2|final_norm)/(gamma|beta)$", (None,)),
        (r"pooler/w$",          (None, None)),
        (r"classifier/w$",      (None, None)),
    ]


def _serve_rules(_dp):
    """Folded-int serving: no FSDP; packed dim0 = K//2 follows K's spec."""
    return [
        (r"embed/tokens_i8$",    ("model", None)),
        (r"embed/pos_i8$",       (None, None)),
        (r"embed/codebooks_i8$", (None, "model", None)),
        (r"w[qkv]/(w|b)$",       (None, None, "model")),
        (r"wo/w$",               (None, "model", None)),
        (r"wo/b$",               (None, None)),
        (r"(wg|wu|w1)/(w|b)$",   (None, None, "model")),
        (r"(wd|w2)/w$",          (None, "model", None)),
        (r"(wd|w2)/b$",          (None, None)),
        (r"experts/w[gu1]/(w|b)$", (None, None, None, "model")),
        (r"experts/wd/w$",       (None, None, "model", None)),
        (r"shared/w[gu1]/(w|b)$", (None, None, None, "model")),
        (r"shared/wd/w$",        (None, None, "model", None)),
        (r"mx/w_in/w$",          (None, None, "model")),
        (r"mx/w_x/w$",           (None, "model", None)),
        (r"mx/w_out/w$",         (None, "model", None)),
        (r"mx/conv_w$",          (None, None, "model")),
        (r"mx/conv_b$",          (None, "model")),
        (r"mx/w_dt$",            (None, None, "model")),
        (r"mx/(dt_bias|D)$",     (None, "model")),
        (r"mx/A_log$",           (None, "model", None)),
        (r"mx/w[qkv]/w$",        (None, None, "model")),
        (r"mx/wo/w$",            (None, "model", None)),
        (r"mx/w_[zifo]/w$",      (None, None, "model")),
        (r"lm_head/w$",          (None, "model")),
        (r"lm_head/w$",          (None, "model")),
    ]


def _spec_for(path: str, rules, ndim: int) -> Spec:
    for rx, spec in rules:
        if re.search(rx, path):
            parts = list(spec)
            # pad/trim to rank (stacked multi-head lm_head etc.)
            while len(parts) < ndim:
                parts.insert(0, None)
            return tuple(parts[:ndim])
    return ()  # replicate


def _fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop the mesh axes that do not divide their dim (batch 1 at
    long_500k, 4-head gate tensors against a 16-way model axis), and trim
    the spec to the rank of ``shape``."""
    if shape is None:
        return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax for ax in spec)
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


# --- trees ------------------------------------------------------------------------

def _children(tree, sort_keys: bool):
    """(name, child) pairs of a tree node, or None for a leaf: a dict's
    items (sorted by key when ``sort_keys``, as JAX flattens them), a
    dataclass's or a NamedTuple's fields by name, a tuple's or a list's
    items by index.  A ``NamedSharding`` is a leaf."""
    if isinstance(tree, NamedSharding):
        return None
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else list(tree)
        return [(str(k), tree[k]) for k in keys]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_paths(tree, sort_keys: bool = False, prefix=()) -> List[Tuple[str, object]]:
    """(path, leaf) of every leaf, the path's parts joined by "/" as the
    reference joins JAX's key paths (``…/codes`` and ``…/scale`` of an int8
    moment)."""
    kids = _children(tree, sort_keys)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [pl for name, child in kids for pl in tree_paths(child, sort_keys, prefix + (name,))]


def tree_rebuild(tree, leaves, sort_keys: bool = False):
    """``tree``'s structure holding ``leaves`` (in ``tree_paths`` order)."""
    it = iter(leaves)

    def go(t):
        kids = _children(t, sort_keys)
        if kids is None:
            return next(it)
        vals = {name: go(child) for name, child in kids}
        if isinstance(t, dict):
            return {k: vals[str(k)] for k in t}
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **vals)
        if hasattr(t, "_fields"):
            return type(t)(**vals)
        return type(t)(vals[str(i)] for i in range(len(t)))

    return go(tree)


def _tree_paths_specs(tree):
    return tree_paths(tree)


def _shape(v):
    return tuple(v.shape) if hasattr(v, "shape") else None


# --- shardings ----------------------------------------------------------------------

def make_param_shardings(mesh, tree, *, mode: str = "qat", fsdp: bool = True):
    """A ``NamedSharding`` per leaf of ``tree`` (tensors, ``meta`` ones
    included).  An int8 moment's ``…/codes`` take its param's spec and its
    per-vector ``…/scale`` are replicated."""
    dp = "data"
    fs = ("pod", "data") if ("pod" in mesh.axis_names and fsdp) else ("data" if fsdp else None)
    rules = _qat_rules(dp, fs) if mode == "qat" else _serve_rules(dp)
    specs = []
    for p, v in _tree_paths_specs(tree):
        if p.endswith("/scale") or p.endswith("/1"):
            specs.append(())
            continue
        if p.endswith("/codes"):
            p = p[: -len("/codes")]
        elif p.endswith("/0"):
            p = p[:-2]
        sp = _spec_for(p, rules, getattr(v, "ndim", 0))
        specs.append(_fit_spec(sp, _shape(v), mesh))
    return tree_rebuild(tree, [NamedSharding(mesh, s) for s in specs])


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_sharding(mesh, ndim: int, shape=None) -> NamedSharding:
    spec = (batch_axes(mesh), *([None] * (ndim - 1)))
    return NamedSharding(mesh, _fit_spec(spec, shape, mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def cache_sharding(mesh, tree):
    """The decode cache: (n_reps, B, ...) leaves split over the DP axes on
    B; int8 K/V also over model on head_dim."""
    dp = batch_axes(mesh)

    def spec(path, v):
        nd = v.ndim
        if path.endswith("/k") or path.endswith("/v"):
            sp = (None, dp, None, None, "model")     # (L, B, S, Hkv, hd)
        elif nd >= 2:
            sp = (None, dp, *([None] * (nd - 2)))
        else:
            sp = ()
        return _fit_spec(sp, _shape(v), mesh)

    return tree_rebuild(tree, [NamedSharding(mesh, spec(p, v))
                               for p, v in _tree_paths_specs(tree)])


# --- placement ---------------------------------------------------------------------

def block_index(sharding: NamedSharding, rank: int, ndim: int) -> Tuple[Tuple[int, int], ...]:
    """(block, blocks) along each of ``ndim`` dims for ``rank``."""
    mesh, coords = sharding.mesh, sharding.mesh.coords(rank)
    out = []
    for i in range(ndim):
        ax = sharding.spec[i] if i < len(sharding.spec) else None
        idx, n = 0, 1
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            idx, n = idx * mesh.shape[a] + coords[a], n * mesh.shape[a]
        out.append((idx, n))
    return tuple(out)


def shard_shape(shape, sharding: NamedSharding) -> Tuple[int, ...]:
    """A rank's block shape of a leaf of ``shape``."""
    return tuple(d // n for d, (_, n) in zip(shape, block_index(sharding, 0, len(shape))))


def shard_nbytes(v, sharding: NamedSharding) -> int:
    """A rank's bytes of leaf ``v`` (every rank holds as many)."""
    return math.prod(shard_shape(tuple(v.shape), sharding)) * v.element_size()


def _slices(shape, index):
    for d, (i, n) in zip(shape, index):
        if d % n:
            raise ValueError(f"a dim of {d} does not split into {n} blocks")
    return tuple(slice(i * (d // n), (i + 1) * (d // n)) for d, (i, n) in zip(shape, index))


def block_of(v: torch.Tensor, sharding: NamedSharding, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``v``, a fresh contiguous tensor on its
    device."""
    return v[_slices(v.shape, block_index(sharding, rank, v.dim()))].to(
        sharding.mesh.devices[rank], copy=True, memory_format=torch.contiguous_format)


def split_leaf(v: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """Rank r's block of ``v``, a fresh contiguous tensor on its device, for
    each rank."""
    return [block_of(v, sharding, r) for r in range(sharding.mesh.size)]


def gather_leaf(blocks: Sequence[torch.Tensor], sharding: NamedSharding,
                device=None) -> torch.Tensor:
    """The leaf the ranks' ``blocks`` split, on ``device`` (default rank 0's):
    each distinct block taken from the first rank that holds it."""
    mesh = sharding.mesh
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} shards for a {mesh.size}-rank mesh")
    dev = torch.device(device) if device is not None else mesh.devices[0]
    b0 = blocks[0]
    index = [block_index(sharding, r, b0.dim()) for r in range(mesh.size)]
    full = tuple(d * n for d, (_, n) in zip(b0.shape, index[0]))
    out = torch.empty(full, dtype=b0.dtype, device=dev)
    seen = set()
    for r, idx in enumerate(index):
        if idx not in seen:
            seen.add(idx)
            out[_slices(full, idx)] = blocks[r].to(dev)
    return out


def split_tree(tree, shardings) -> List:
    """One tree per rank (rank order): each leaf's block per its sharding in
    ``shardings`` (a tree of ``NamedSharding`` shaped as ``tree``), as fresh
    contiguous tensors on the rank's device."""
    leaves, shs = tree_paths(tree, sort_keys=True), tree_paths(shardings, sort_keys=True)
    if [p for p, _ in leaves] != [p for p, _ in shs]:
        raise ValueError("the tree and its shardings differ in their paths")
    per_leaf = [split_leaf(v, s) for (_, v), (_, s) in zip(leaves, shs)]
    return [tree_rebuild(tree, [blocks[r] for blocks in per_leaf], sort_keys=True)
            for r in range(shs[0][1].mesh.size if shs else 1)]


def rank_tree(tree, shardings, rank: int):
    """Rank ``rank``'s tree of ``split_tree(tree, shardings)`` alone (a
    process of a ``ProcessMesh`` holds its own)."""
    leaves, shs = tree_paths(tree, sort_keys=True), tree_paths(shardings, sort_keys=True)
    if [p for p, _ in leaves] != [p for p, _ in shs]:
        raise ValueError("the tree and its shardings differ in their paths")
    return tree_rebuild(tree, [block_of(v, s, rank) for (_, v), (_, s) in zip(leaves, shs)],
                        sort_keys=True)


def gather_tree(shards: Sequence, shardings, device=None):
    """The tree ``split_tree`` cut into ``shards``, on ``device`` (default
    rank 0's)."""
    shs = [s for _, s in tree_paths(shardings, sort_keys=True)]
    per_rank = [[v for _, v in tree_paths(s, sort_keys=True)] for s in shards]
    return tree_rebuild(shards[0], [
        gather_leaf([leaves[i] for leaves in per_rank], sh, device)
        for i, sh in enumerate(shs)], sort_keys=True)


# --- the tensor-parallel paged KV pool --------------------------------------------

def kv_pool_pspec() -> Spec:
    """The spec of one paged-pool K/V leaf (n_reps, n_pages, P, Hkv, hd):
    the KV heads split over the model axis, the page axis never, so page ids
    stay global and one host-side block table and allocator address every
    rank."""
    return (None, None, None, "model", None)


def paged_pool_shardings(mesh, tree) -> Dict:
    """A ``NamedSharding`` per leaf of a paged pool: ``kv_pool_pspec``
    fitted to the leaf (an indivisible Hkv, or a 2-D scale leaf, comes out
    unsplit; the engine refuses Hkv % tp != 0 itself)."""
    return tree_rebuild(tree, [NamedSharding(mesh, _fit_spec(kv_pool_pspec(), tuple(v.shape),
                                                             mesh))
                               for _, v in tree_paths(tree)])


def kv_pool_specs(tree, mesh) -> Dict:
    """The spec of each leaf of a paged pool: the 5-D payload leaves take
    ``kv_pool_pspec``; lower-rank leaves (kv4's per-page scales, computed
    from full-head codes) are replicated."""
    return tree_rebuild(tree, [_fit_spec(kv_pool_pspec(), tuple(v.shape), mesh) if v.dim() == 5
                               else (None,) * v.dim() for _, v in tree_paths(tree)])


def _pool_shardings(pool: Dict, mesh) -> Dict:
    """The pool's payload leaves split over Hkv (unfitted), the rest
    replicated."""
    return tree_rebuild(pool, [NamedSharding(mesh, kv_pool_pspec() if v.dim() == 5 else ())
                               for _, v in tree_paths(pool)])


def split_pool(pool: Dict, mesh) -> List[Dict]:
    """One pool per rank: each payload leaf's r-th block of Hkv and a copy
    of each scale leaf, as fresh contiguous tensors on rank r's device."""
    for _, v in tree_paths(pool):
        if v.dim() == 5 and v.shape[3] % mesh.size:
            raise ValueError(f"TP={mesh.size} does not divide the pool's {v.shape[3]} KV heads")
    return split_tree(pool, _pool_shardings(pool, mesh))


def gather_pool(shards: Sequence[Dict], mesh) -> Dict:
    """The pool the shards split, on rank 0's device: payload leaves
    concatenated over Hkv in rank order, scale leaves taken from rank 0."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a {mesh.size}-rank mesh")
    return gather_tree(shards, _pool_shardings(shards[0], mesh))


# --- the mesh context -----------------------------------------------------------------

_CTX = threading.local()


def set_mesh_ctx(mesh):
    _CTX.mesh = mesh


def get_mesh_ctx():
    return getattr(_CTX, "mesh", None)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` itself: the reference's sharding constraint places activations,
    which one process driving every rank does not split.  The spec is still
    fitted to ``x`` on the context's mesh, so a spec naming an axis the mesh
    lacks fails here as there."""
    mesh = get_mesh_ctx()
    if mesh is not None:
        _fit_spec(spec, tuple(x.shape), mesh)
    return x


def dp_axes_or_none() -> Optional[Tuple[str, ...]]:
    mesh = get_mesh_ctx()
    return None if mesh is None else batch_axes(mesh)


def model_axis_size() -> int:
    mesh = get_mesh_ctx()
    if mesh is None or "model" not in mesh.axis_names:
        return 0
    return mesh.shape["model"]
