"""Named scopes for the integer-datapath auditor (``graph_audit``).

The port has no jaxpr: ``graph_audit.record`` runs a hot step eagerly under
a ``TorchDispatchMode`` and records every aten op together with the scopes
open around it.  A scope stands where the reference has a named ``pjit``
eqn.  Three kinds:

* ``kernel_boundary`` — the reference's kind: a kernel-equivalent interior,
  the plain whole-pool (or gathered-chain) dequant of the int4 pool, which
  the CUDA kernels do page by page in shared memory.  Its name is
  registered here and its interior is walked with POOL-FLOAT-CAST off and
  every other rule on.
* ``exact_int_product`` — an integer product carried in a float matmul
  (torch's int8 matmul wraps and CUDA has no int32 one): the port's
  counterpart of an integer ``dot_general`` with int32 accumulation.
  Recorded as one op named after the scope with an int32 result; its
  interior is opaque.  While recording, the auditor checks that both
  operands hold integers and that the carrier sums them exactly for any
  operands of their static range: an integer operand's dtype range, or the
  range the scope declares for codes carried in a float.
* ``kernel_launch`` — a wrapper that launches a CUDA kernel through ctypes,
  a call the dispatcher cannot see (as a Pallas body is opaque in a
  jaxpr): recorded as one op named after the wrapper, with the launches
  its own ``launches`` counter took in the call.  On a CPU tensor the
  wrapper runs its plain version, walked with every rule on.

With no recorder active a scope costs one list test and leaves every
result as it was.  This module stays import-light: kernel and model modules
import it, it imports none of them.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

# kernel_boundary name -> why its interior may dequantize a pool
REGISTRY: Dict[str, str] = {}
# exact_int_product name -> why the carrier is exact
EXACT: Dict[str, str] = {}

# the active recorders (graph_audit.Recorder), innermost last
_recorders: List = []


def active():
    """The innermost active recorder, or None."""
    return _recorders[-1] if _recorders else None


def register(name: str, why: str) -> None:
    REGISTRY[name] = why


def _scoped(kind: str, name: str, fn: Callable, **info) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _recorders:
            return fn(*args, **kwargs)
        return _recorders[-1].call(kind, name, fn, args, kwargs, wrapper=wrapper, **info)
    return wrapper


@contextlib.contextmanager
def scope(name: str):
    """A named scope around a block; the auditor treats it as a kernel
    boundary when ``name`` is among its boundaries."""
    rec = active()
    if rec is None:
        yield
        return
    rec.push(name, "named")
    try:
        yield
    finally:
        rec.pop()


def kernel_boundary(*, why: str) -> Callable:
    """Decorator: mark ``fn`` as a kernel-equivalent scope named after it,
    and register the name."""
    def deco(fn):
        register(fn.__name__, why)
        return _scoped("named", fn.__name__, fn)
    return deco


def exact_int_product(*, why: str, carrier: Optional[torch.dtype] = None,
                      ranges: Optional[Callable[..., Tuple[Optional[int], Optional[int]]]]
                      = None) -> Callable:
    """Decorator: ``fn(a, b, ...)`` is the integer product of ``a`` and
    ``b`` carried in ``carrier`` (default: the float type among the
    operands), contracted over ``a``'s last axis.  ``ranges(*args,
    **kwargs)`` gives the largest magnitude each operand may hold (None:
    its integer dtype's range); an operand carried in a float needs one."""
    def deco(fn):
        EXACT[fn.__name__] = why
        return _scoped("exact", fn.__name__, fn, carrier=carrier, ranges=ranges)
    return deco


def kernel_launch(fn: Callable) -> Callable:
    """Decorator for a kernel wrapper: one op named after it per call.  The
    wrapper counts its launches on itself (``wrapper.launches``)."""
    return _scoped("launch", fn.__name__, fn)
