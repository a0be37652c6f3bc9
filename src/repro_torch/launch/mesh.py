"""Device meshes: the training mesh (``Mesh``, ``make_host_mesh``,
``make_production_mesh``) and the serving engine's tensor-parallel mesh
(``TPMesh``, ``make_tp_mesh``), the counterparts of the reference's
``launch/mesh.py``.

A rank is a place that holds one shard of each split tensor; the host
drives every rank from one process, in rank order.  A mesh may name one
device several times: ``Mesh(np.array([cuda0] * 4).reshape(4, 1), ("data",
"model"))`` runs four data ranks on one card, and the same over
``torch.device("cpu")`` four on the CPU, as the reference simulates devices
with ``--xla_force_host_platform_device_count``.  ``meta`` devices stand in
for a mesh that is not there (the dry run's 256 or 512 ranks).

Single pod: 16 x 16 = 256 ranks, axes (data, model).  Multi-pod: 2 x 16 x 16
= 512 ranks, axes (pod, data, model); 'pod' composes with 'data' for the
batch split and the gradient reduction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def _visible(device_type: str) -> Tuple[torch.device, ...]:
    if device_type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if device_type == "cpu":
        return (torch.device("cpu"),)
    raise ValueError(f"device_type must be cuda or cpu (got {device_type!r})")


class Mesh:
    """An N-D grid of ranks with named axes.  ``devices`` is array-like of
    devices whose shape is the mesh's; rank r is the r-th cell in row-major
    order (``coords(r)`` its coordinates), on ``devices[r]`` of the flat
    tuple ``self.devices``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a mesh of axes {axis_names} needs a non-empty device array of "
                             f"that rank (got shape {grid.shape})")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.axis_names = axis_names
        self.devices = tuple(_device(d) for d in grid.flat)
        self.device_grid = np.asarray(self.devices, dtype=object).reshape(grid.shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_grid.shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(rank, self.device_grid.shape))))

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices)))})"


def make_production_mesh(multi_pod: bool = False, devices=None, device_type: str = "cuda") -> Mesh:
    """(16, 16) over axes (data, model), or (2, 16, 16) over (pod, data,
    model), on the first 256 or 512 of ``devices`` (default: every visible
    ``device_type`` device).  Raises on fewer, naming the count found."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = tuple(devices) if devices is not None else _visible(device_type)
    need = math.prod(shape)
    if len(devs) < need:
        raise ValueError(f"the production mesh {shape} over {axes} needs {need} devices, "
                         f"found {len(devs)}")
    return Mesh(np.asarray(devs[:need], dtype=object).reshape(shape), axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> Mesh:
    """(n // model, model) over axes (data, model) and the n visible
    ``device_type`` devices (the CPU is one)."""
    devs = _visible(device_type)
    if not devs or len(devs) % model:
        raise ValueError(f"a host mesh with model={model} needs a multiple of {model} "
                         f"{device_type} devices, found {len(devs)}")
    return Mesh(np.asarray(devs, dtype=object).reshape(len(devs) // model, model),
                ("data", "model"))


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """The serving engine's tensor-parallel mesh: one axis, ``"model"``;
    rank r's device is ``devices[r]``; rank order is head order."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a TPMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_device(d) for d in self.devices))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("model",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> Dict[str, int]:
        return {"model": rank}


def make_tp_mesh(model: int = 1, device_type: str = "cuda") -> TPMesh:
    """A ``model``-rank mesh over the first ``model`` devices of
    ``device_type`` ("cuda", or "cpu", which has one).  Raises when there
    are fewer; an explicit ``TPMesh`` that names a device several times runs
    several ranks on it."""
    devs = _visible(device_type)
    if not 1 <= model <= len(devs):
        raise ValueError(f"TP={model} needs {model} {device_type} devices, found {len(devs)} "
                         "(an explicit TPMesh may name one device several times)")
    return TPMesh(devs[:model])
