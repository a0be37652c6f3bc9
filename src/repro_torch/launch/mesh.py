"""The serving engine's tensor-parallel mesh: an ordered tuple of devices,
one per rank, on one axis named ``"model"``.

The counterpart of the reference's ``make_tp_mesh`` (``launch/mesh.py``).
A rank is a place where the engine keeps one shard of the paged KV pool and
launches its attention kernel; the host drives every rank from one process,
in rank order.  An explicit ``TPMesh`` may name one device several times:
``TPMesh((torch.device("cuda:0"),) * 4)`` runs four ranks on one card, and
``TPMesh((torch.device("cpu"),) * 4)`` four on the CPU, as the reference
simulates devices with ``--xla_force_host_platform_device_count``.  The
training meshes (``make_production_mesh``, ``make_host_mesh``) are not
ported (ROADMAP Open items §1, item 8b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """Rank r's device is ``devices[r]``; rank order is head order."""
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


def make_tp_mesh(model: int = 1, device_type: str = "cuda") -> TPMesh:
    """A ``model``-rank mesh over the first ``model`` devices of
    ``device_type`` ("cuda", or "cpu", which has one).  Raises when there
    are fewer; an explicit ``TPMesh`` that names a device several times runs
    several ranks on it."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
    elif device_type == "cpu":
        n = 1
    else:
        raise ValueError(f"device_type must be cuda or cpu (got {device_type!r})")
    if not 1 <= model <= n:
        raise ValueError(f"TP={model} needs {model} {device_type} devices, found {n} (an "
                         "explicit TPMesh may name one device several times)")
    if device_type == "cpu":
        return TPMesh((torch.device("cpu"),))
    return TPMesh(tuple(torch.device("cuda", i) for i in range(model)))
