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
  * ``save`` of a sharded state (the ranks' trees and their shardings)
    writes the full leaves, and ``restore(..., shardings=)`` splits each
    leaf onto the target mesh's ranks: a run may resume on a mesh of
    another shape (elastic resize).  On a ``ProcessMesh`` every rank calls
    both with its own tree: ``save`` gathers the leaves whole, rank 0
    writes them and the others wait at a barrier; ``restore`` has each rank
    read the file and cut its own block, so the processes may number
    otherwise than the writer's;
  * integrity: the crc32 of every leaf is checked on load.
"""
from __future__ import annotations

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

from repro_torch.launch.mesh import ProcessMesh
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt

_LEAF_KEY = "leaf_{:05d}"


def _paths(tree):
    """(path, leaf) in the reference's flatten order (dict keys sorted)."""
    return Pt.tree_paths(tree, sort_keys=True)


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


def save(ckpt_dir, step: int, tree, meta: Optional[Dict] = None, *, shardings=None) -> Path:
    """Write ``tree`` as checkpoint ``step``.  With ``shardings``, ``tree``
    is the ranks' trees (``partition.split_tree``'s list) and their leaves
    are gathered whole first; on a ``ProcessMesh`` it is this rank's tree,
    every rank calls ``save``, rank 0 writes and the others wait for it."""
    mesh = _process_mesh(shardings)
    if mesh is not None:
        proc = C.Process(mesh)
        shs = dict(_paths(shardings))
        whole = []
        for path, v in _paths(tree):
            w = proc.all_gather(v, shs[path])
            whole.append(w.cpu() if mesh.rank == 0 else None)
            del w
        final = Path(ckpt_dir) / f"step_{step:06d}"
        if mesh.rank == 0:
            save(ckpt_dir, step, Pt.tree_rebuild(tree, whole, sort_keys=True), meta)
        proc.barrier()
        return final
    if shardings is not None:
        tree = Pt.gather_tree(tree, shardings, device="cpu")
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


def _process_mesh(shardings) -> Optional[ProcessMesh]:
    if shardings is None:
        return None
    mesh = _paths(shardings)[0][1].mesh
    return mesh if isinstance(mesh, ProcessMesh) else None


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, target_tree, device=None, *, shardings=None,
            strict_crc: bool = True):
    """Load into the structure of ``target_tree``, whose tensor leaves give
    each leaf's dtype and (unless ``device`` is given) its device.  Returns
    (tree, meta).  With ``shardings`` (a tree of ``NamedSharding`` shaped as
    ``target_tree``, whose leaves may then lie on ``meta``), the tree comes
    back split onto their mesh: the ranks' trees, as
    ``partition.split_tree`` cuts them (on a ``ProcessMesh``, this rank's
    tree alone), whatever mesh wrote the checkpoint."""
    if shardings is not None:
        full, meta = restore(ckpt_dir, step, target_tree, "cpu", strict_crc=strict_crc)
        mesh = _process_mesh(shardings)
        if mesh is not None:
            return Pt.rank_tree(full, shardings, mesh.rank), meta
        return Pt.split_tree(full, shardings), meta
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
    return Pt.tree_rebuild(target_tree, out, sort_keys=True), manifest["meta"]


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
