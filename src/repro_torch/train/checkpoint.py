"""Atomic checkpoints in the reference's on-disk layout (``train/
checkpoint.py``), so a float32 state restores across the two packages:

    <dir>/step_000120.tmp-<nonce>/   <- written first
        manifest.json                 (leaf paths, keys, shapes, dtypes, crc32, meta)
        shard_00000.npz               (one array per leaf, ``leaf_00000`` ...)
    <dir>/step_000120/               <- atomic rename after fsync

Leaves are in the reference's flatten order, with its paths: a dict's keys
sorted, a dataclass's (``TrainState``) and a NamedTuple's (``QMoment``)
fields by name, joined by "/".  numpy has no bfloat16, so a bf16 leaf is
written and read as its raw 2-byte words (uint16), its manifest dtype
"bfloat16", its crc32 over those bytes.

Fault-tolerance contract (as the reference's):
  * a crash mid-write leaves only .tmp dirs; ``latest_step`` ignores them
    and ``gc_old`` collects them; a restart resumes from the last complete
    checkpoint (exactly-once data through the data step in ``meta``);
  * integrity: the crc32 of every leaf is checked on load.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import uuid
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

_LEAF_KEY = "leaf_{:05d}"


def _children(tree):
    """(name, child) pairs in the reference's flatten order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return None


def _paths(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [pl for name, child in kids for pl in _paths(child, prefix + (name,))]


def _rebuild(tree, it):
    """``tree``'s structure holding the next leaves of ``it`` (flatten order)."""
    kids = _children(tree)
    if kids is None:
        return next(it)
    vals = {name: _rebuild(child, it) for name, child in kids}
    if isinstance(tree, dict):
        return {k: vals[str(k)] for k in tree}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **vals)
    return type(tree)(**vals)


def _to_numpy(v):
    """A leaf -> (numpy array, dtype name); bf16 as its uint16 words."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(v)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir, step: int, tree, meta: Optional[Dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:06d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir()
    manifest = {"step": step, "meta": meta or {}, "leaves": []}
    arrays = {}
    for i, (path, v) in enumerate(_paths(tree)):
        arr, dtype = _to_numpy(v)
        key = _LEAF_KEY.format(i)
        arrays[key] = arr
        manifest["leaves"].append({"path": path, "key": key, "shape": list(arr.shape),
                                   "dtype": dtype, "crc32": zlib.crc32(arr.tobytes())})
    np.savez(tmp / "shard_00000.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # fsync the directory contents before the atomic publish
    for f in tmp.iterdir():
        fd = os.open(f, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    final = ckpt_dir / f"step_{step:06d}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, target_tree, device=None, *, strict_crc: bool = True):
    """Load into the structure of ``target_tree``, whose tensor leaves give
    each leaf's dtype and (unless ``device`` is given) its device.  Returns
    (tree, meta)."""
    d = Path(ckpt_dir) / f"step_{step:06d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {}
    with np.load(d / "shard_00000.npz") as data:
        for leaf in manifest["leaves"]:
            arr = data[leaf["key"]]
            if strict_crc and zlib.crc32(arr.tobytes()) != leaf["crc32"]:
                raise IOError(f"checkpoint corruption at {leaf['path']}")
            by_path[leaf["path"]] = _from_numpy(arr, leaf["dtype"])
    out = []
    for path, v in _paths(target_tree):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        out.append(by_path[path].to(dtype=v.dtype, device=device or v.device))
    return _rebuild(target_tree, iter(out)), manifest["meta"]


def gc_old(ckpt_dir, keep: int = 3):
    """Delete all but the newest ``keep`` complete checkpoints, and tmp litter."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    done = sorted(p for p in ckpt_dir.iterdir() if re.fullmatch(r"step_\d+", p.name))
    for p in done[:-keep] if keep else done:
        shutil.rmtree(p)
    for p in ckpt_dir.iterdir():
        if ".tmp-" in p.name:
            shutil.rmtree(p)
