"""Bytes by dtype and op counts of a recorded hot step.

The port's counterpart of ``hbm_bytes_by_dtype`` in the reference's
``analysis/hlo_cost.py``, on a ``graph_audit`` recording in place of
post-fusion HLO: every recorded op reads its operands once and writes its
results once.  An ``exact_int_product`` or a kernel launch counts as one op
(its interior is the kernel's, as a fusion's interior is in HLO), so the
ops recorded inside a ``kernel_launch`` scope (the plain version's, on the
CPU) are not counted again, and a view or an allocation (``empty``) moves
no bytes.  A uint8 element is an int4 code pair of the packed pool or a
packed weight, counted at 0.5 byte as the reference counts packed u8
payloads.  It is a traffic model of eager ops, not a measurement: the
loop-aware HLO parser has no eager counterpart.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.graph_audit import Op

BYTES = {"bool": 1, "uint8": 0.5, "int8": 1, "int16": 2, "float16": 2, "bfloat16": 2,
         "int32": 4, "float32": 4, "int64": 8, "float64": 8}
ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty"})


def _counted(ops: Iterable[Op]) -> Iterable[Op]:
    return (op for op in ops
            if not op.in_launch and not op.view and op.name not in ALLOCATIONS)


def _op_bytes(op: Op) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for dt, shape in op.inputs + op.outputs:
        n = 1
        for d in shape:
            n *= d
        out[dt] = out.get(dt, 0.0) + n * BYTES.get(dt, 0)
    return out


def bytes_by_dtype(ops: Iterable[Op]) -> Dict[str, float]:
    """dtype -> bytes the step's ops read and write."""
    out: Dict[str, float] = {}
    for op in _counted(ops):
        for dt, b in _op_bytes(op).items():
            out[dt] = out.get(dt, 0.0) + b
    return out


def top_ops(ops: Iterable[Op], n: int = 3) -> List[Tuple[str, float]]:
    """The ``n`` op names that move the most bytes, with their bytes."""
    by: Dict[str, float] = {}
    for op in _counted(ops):
        by[op.name] = by.get(op.name, 0.0) + sum(_op_bytes(op).values())
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def op_counts(ops: Iterable[Op]) -> Dict[str, int]:
    """op kind ("aten", "exact", "launch") -> ops counted."""
    out: Dict[str, int] = {}
    for op in _counted(ops):
        out[op.kind] = out.get(op.kind, 0) + 1
    return out
