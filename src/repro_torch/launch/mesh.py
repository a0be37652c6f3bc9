"""Device meshes: the training mesh (``Mesh``, ``make_host_mesh``,
``make_production_mesh``, and ``ProcessMesh``, ``make_process_mesh``) and
the serving engine's tensor-parallel mesh (``TPMesh``, ``make_tp_mesh``),
the counterparts of the reference's ``launch/mesh.py``.

A rank is a place that holds one shard of each split tensor.  A ``Mesh`` is
driven from one process, rank after rank.  A mesh may name one device
several times: ``Mesh(np.array([cuda0] * 4).reshape(4, 1), ("data",
"model"))`` runs four data ranks on one card, and the same over
``torch.device("cpu")`` four on the CPU, as the reference simulates devices
with ``--xla_force_host_platform_device_count``.  ``meta`` devices stand in
for a mesh that is not there (the dry run's 256 or 512 ranks).

A ``ProcessMesh`` is the same grid run one OS process per rank, joined by a
``torch.distributed`` process group (``launch/ranks.py`` starts them):
each process holds its own rank's shards only, and
``sharding/collectives.py``'s process backend moves blocks between the
processes as XLA moves them between a mesh's devices.

Single pod: 16 x 16 = 256 ranks, axes (data, model).  Multi-pod: 2 x 16 x 16
= 512 ranks, axes (pod, data, model); 'pod' composes with 'data' for the
batch split and the gradient reduction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

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


def process_devices(n: int, backend: str, device_type: str) -> Tuple[torch.device, ...]:
    """Each of ``n`` ranks' device under ``backend``: ``cuda:<rank>`` when
    the machine has a card per rank; ``cuda:0`` for every rank when it has
    fewer and the backend is gloo (the ranks share one card); the CPU only
    when ``device_type`` asks for it.  NCCL raises unless every rank has a
    card of its own: nothing falls back to gloo or to the CPU."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl (got {backend!r})")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs between CUDA cards; ranks on the CPU take gloo")
        return (torch.device("cpu"),) * n
    if device_type != "cuda":
        raise ValueError(f"device_type must be cuda or cpu (got {device_type!r})")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA card is visible; pass device_type='cpu' to run the ranks on "
                           "the CPU")
    if cards >= n:
        return tuple(torch.device("cuda", r) for r in range(n))
    if backend == "nccl":
        raise ValueError(f"NCCL needs a card for each rank: {n} ranks, {cards} card(s) visible "
                         "(gloo runs the ranks on one shared card)")
    return (torch.device("cuda", 0),) * n


class ProcessMesh(Mesh):
    """A ``Mesh`` run one OS process per rank over an initialised
    ``torch.distributed`` process group: ``devices`` are every rank's
    devices, ``rank`` and ``device`` this process's, ``backend`` the
    group's, and ``groups[(axis,)]`` this rank's subgroup over each axis
    (the ranks that differ from it on that axis alone, in rank order, which
    is their block order on it; None for a subgroup of one)."""

    def __init__(self, devices, axis_names: Sequence[str], rank: int, backend: str,
                 groups: Dict[Tuple[str, ...], Optional[object]]):
        super().__init__(devices, axis_names)
        self.rank, self.backend, self.groups = rank, backend, groups

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def __repr__(self):
        return f"ProcessMesh({self.shape}, rank {self.rank} of {self.size} on {self.device}, " \
               f"{self.backend})"


def _subgroups(dist, shape, rank) -> Dict[Tuple[str, ...], Optional[object]]:
    """This rank's subgroup over each axis of a (data, model) mesh.  Every
    rank creates every group, in the same order, as
    ``torch.distributed.new_group`` asks."""
    grid = np.arange(math.prod(shape)).reshape(shape)
    out = {}
    for axis, rows in (("data", grid.T), ("model", grid)):
        for row in rows.tolist():
            group = dist.new_group(row) if len(row) > 1 else None
            if rank in row:
                out[(axis,)] = group
    return out


def make_process_mesh(shape: Optional[Sequence[int]] = None,
                      device_type: str = "cuda") -> ProcessMesh:
    """This process's view of a (data, model) mesh of ``shape`` (default
    ``(world, 1)``), one process per rank: call it in every rank of an
    initialised process group (``launch/ranks.py::run``), whose world size
    must be the mesh's size.  Each rank's device is ``process_devices``'."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh runs inside a rank of an initialised process group "
                           "(launch/ranks.py::run starts them)")
    world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    shape = tuple(shape) if shape is not None else (world, 1)
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks, the process "
                         f"group has {world}")
    devs = process_devices(world, backend, device_type)
    return ProcessMesh(np.asarray(devs, dtype=object).reshape(shape), ("data", "model"), rank,
                       backend, _subgroups(dist, shape, rank))


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
