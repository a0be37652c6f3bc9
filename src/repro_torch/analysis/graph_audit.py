"""Integer-datapath auditor: record a hot step's aten ops and enforce the
serving engine's declared invariants as machine-checked rules.

The port's counterpart of the reference's ``analysis/jaxpr_audit.py``.  The
port has no jaxpr, so ``record`` runs the step once, eagerly, under a
``TorchDispatchMode`` that sees every aten op: its name, the dtypes and
shapes of its tensor operands and results, the scopes open around it
(``boundary``) and whether it writes into an operand.  The rules, with the
reference's ids:

``INT-DOT-FLOAT``
    No matmul-family op (``MATMUL_OPS``) with a float result or operand
    reachable from quantized data, outside an ``exact_int_product`` scope.
    Taint starts at every narrow-int (int8/uint8: int8 codes and packed
    int4 codes) tensor and flows from any tainted operand to every result
    and into the operand an in-place op writes.  Float elementwise islands
    (RoPE, the fp32 carry, the logits exit) are allowed; float products are
    not.  An ``exact_int_product`` whose operand is not integer-valued is
    float work too.

``INT-DOT-ACC``
    An integer matmul must accumulate at >= 32 bits, and an
    ``exact_int_product`` must keep ``K * A * B`` below 2^24 (float32
    carrier) or 2^53 (float64), so every partial sum is exact for any
    operands it may be given.  ``A`` and ``B`` are the operands' static
    ranges: an integer dtype's (128 for int8), or the range the scope
    declares for codes carried in a float (``boundary.exact_int_product``'s
    ``ranges``); a float operand with none declared fails.  The same ratio
    over the operands this run held is printed, not gated.

``LATTICE-MIXED``
    Arithmetic ops (``ARITH_OPS``) must see tensor operands of one kind, all
    integer or all float (0-dim tensors included; Python scalars exempt).
    Implicit type promotion makes this reachable in torch.

``POOL-FLOAT-CAST``
    No pool-scale cast from a narrow int to a float outside a
    ``kernel_boundary`` or ``exact_int_product`` scope.  The threshold is
    half the smallest KV pool payload leaf (``pool_threshold_elems``).

``DONATION``
    The eager form of donation: the step writes every cache leaf in place.
    It returns the same leaf objects, no leaf's storage moves, and no op
    outside a kernel boundary allocates a fresh tensor of a pool leaf's
    dtype and shape, whole or one layer's (a copied pool doubles its
    memory).

``DONATION-ALIAS``
    No two live cache leaves share storage, across every rank's pool.

``audit_graph`` runs the rules on one ``(fn, args)`` hot graph;
``audit_engine`` runs every hot graph of a live ``Engine`` plus the
aliasing check.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis import boundary as boundary_mod

NARROW_INT = ("int8", "uint8")
FLOAT_KINDS = ("float16", "bfloat16", "float32", "float64")
WIDE_INT = ("int32", "int64")
INT_KINDS = NARROW_INT + ("int16",) + WIDE_INT

MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "linear", "dot", "mv",
                        "_int_mm"})
# the reference's ARITH_PRIMS under their aten names (in-place forms too)
ARITH_OPS = frozenset({"add", "sub", "mul", "div", "remainder", "pow", "maximum", "minimum",
                       "atan2", "nextafter"})
CAST_OPS = frozenset({"_to_copy", "to", "copy_"})

# the largest integer each float carrier holds exactly, with every smaller one
EXACT_LIMIT = {"float16": 2.0 ** 11, "bfloat16": 2.0 ** 8, "float32": 2.0 ** 24,
               "float64": 2.0 ** 53}


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _kind(t: torch.Tensor) -> Optional[str]:
    dt = dtype_name(t.dtype)
    if dt in FLOAT_KINDS:
        return "float"
    if dt in INT_KINDS:
        return "int"
    return None    # bool, etc. — not lattice-checked


@dataclasses.dataclass
class Violation:
    rule: str
    graph: str
    scope: str       # nested scope path, e.g. "/_dequant_paged_view"
    detail: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Op:
    """One recorded op: an aten op, or one ``exact`` product or kernel
    ``launch`` standing for its whole scope."""
    name: str
    scope: str
    kind: str                                   # "aten" | "exact" | "launch"
    inputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    outputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    view: bool              # every result aliases an operand and nothing is written
    in_launch: bool         # inside a kernel_launch scope (the plain version's interior)
    launched: int = 0       # a launch op: the launches its wrapper's own counter took


@dataclasses.dataclass
class AuditResult:
    graph: str
    n_eqns: int = 0
    violations: List[Violation] = dataclasses.field(default_factory=list)
    # output dtype -> op name -> count (by first result's dtype)
    op_histogram: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    float_prims: Set[str] = dataclasses.field(default_factory=set)
    ops: List[Op] = dataclasses.field(default_factory=list)
    # the largest K * A * B of an exact_int_product over its carrier's
    # limit, A and B the operands' static ranges (gated below 1; 0 when the
    # step ran none), and the same over the magnitudes this run held
    exact_ratio: float = 0.0
    exact_ratio_seen: float = 0.0

    @property
    def float_eqns(self) -> int:
        return sum(n for dt, prims in self.op_histogram.items()
                   if dt in FLOAT_KINDS for n in prims.values())

    @property
    def launched(self) -> Dict[str, int]:
        """Kernel wrapper -> the launches its ``launches`` counter took in
        the step (one a wrapper call that launched its CUDA kernel)."""
        out: Dict[str, int] = {}
        for op in self.ops:
            if op.launched:
                out[op.name] = out.get(op.name, 0) + op.launched
        return out


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _sig(ts: Sequence[torch.Tensor]) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    return tuple((dtype_name(t.dtype), tuple(t.shape)) for t in ts)


def _integral(t: torch.Tensor) -> bool:
    if not t.dtype.is_floating_point:
        return True
    return bool(torch.equal(t, t.trunc()))


def _absmax(t: torch.Tensor) -> float:
    return float(t.to(torch.float64).abs().amax()) if t.numel() else 0.0


def _static_max(t: torch.Tensor, declared: Optional[int]) -> Optional[float]:
    """The largest magnitude ``t`` may hold: ``declared``, else its integer
    dtype's range; None for a float operand with no declared range."""
    if declared is not None:
        return float(declared)
    if t.dtype.is_floating_point:
        return None
    info = torch.iinfo(t.dtype)
    return float(max(-info.min, info.max))


class Recorder(TorchDispatchMode):
    """Records one step's ops and applies the op-level rules as it goes."""

    def __init__(self, *, graph: str, pool_threshold: int,
                 boundaries: Optional[Dict[str, str]] = None,
                 pool: Optional[Set[Tuple[torch.dtype, Tuple[int, ...]]]] = None):
        super().__init__()
        self.res = AuditResult(graph=graph)
        self.pool_threshold = pool_threshold
        self.boundaries = dict(boundary_mod.REGISTRY) if boundaries is None else boundaries
        self.pool = pool          # _pool_spec of the cache, or None
        self.taint = WeakIdKeyDictionary()
        self._scopes: List[Tuple[str, str]] = []
        self._quiet = 0

    # --- scopes (boundary.py calls these) --------------------------------

    def push(self, name: str, kind: str):
        self._scopes.append((name, kind))

    def pop(self):
        self._scopes.pop()

    def call(self, kind: str, name: str, fn, args, kwargs, *, wrapper=None, carrier=None,
             ranges=None):
        if kind == "exact":
            return self._exact(name, fn, args, kwargs, carrier, ranges)
        n0 = getattr(wrapper, "launches", 0)
        self.push(name, kind)
        try:
            out = fn(*args, **kwargs)
        finally:
            self.pop()
        if kind == "launch":
            ins = _tensors((args, kwargs))
            self._add(Op(name, self.scope, "launch", _sig(ins), _sig(_tensors(out)), False,
                         self._in_launch, launched=getattr(wrapper, "launches", 0) - n0),
                      ins, _tensors(out))
        return out

    @property
    def scope(self) -> str:
        return "".join(f"/{n}" for n, _ in self._scopes)

    @property
    def _in_boundary(self) -> bool:
        return any(n in self.boundaries for n, k in self._scopes if k == "named")

    @property
    def _in_launch(self) -> bool:
        return any(k == "launch" for _, k in self._scopes)

    def __enter__(self):
        boundary_mod._recorders.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        boundary_mod._recorders.remove(self)
        return super().__exit__(*exc)

    # --- taint ----------------------------------------------------------

    def tainted(self, t: torch.Tensor) -> bool:
        hit = self.taint.get(t)
        return dtype_name(t.dtype) in NARROW_INT if hit is None else hit

    def _violate(self, rule: str, detail: str):
        self.res.violations.append(Violation(rule, self.res.graph, self.scope, detail))

    def _add(self, op: Op, ins: List[torch.Tensor], outs: List[torch.Tensor],
             written: Sequence[torch.Tensor] = ()):
        res = self.res
        res.ops.append(op)
        res.n_eqns += 1
        if op.outputs:
            dt = op.outputs[0][0]
            hist = res.op_histogram.setdefault(dt, {})
            hist[op.name] = hist.get(op.name, 0) + 1
            if dt in FLOAT_KINDS:
                res.float_prims.add(op.name)
        in_taint = any(self.tainted(t) for t in ins)
        for t in outs:
            self.taint[t] = in_taint
        if in_taint:
            for t in written:
                self.taint[t] = True
        return in_taint

    # --- the dispatch hook ----------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        schema = func._schema
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written.extend(_tensors(v))
        view = not written and bool(schema.returns) and all(
            r.alias_info is not None for r in schema.returns)
        in_taint = self._add(Op(name, self.scope, "aten", _sig(ins), _sig(outs), view,
                                self._in_launch), ins, outs, written)
        self._rules(name, ins, outs, written, view, in_taint)
        return out

    def _rules(self, name, ins, outs, written, view, in_taint):
        base = name[:-1] if name.endswith("_") and name != "copy_" else name
        out_dt = dtype_name(outs[0].dtype) if outs else None
        if base in MATMUL_OPS:
            kinds = {_kind(t) for t in ins}
            if (out_dt in FLOAT_KINDS or "float" in kinds) and in_taint:
                self._violate("INT-DOT-FLOAT", f"{name} with float dtype ({out_dt}) reachable "
                                               "from quantized operands")
            if kinds == {"int"} and out_dt not in WIDE_INT:
                self._violate("INT-DOT-ACC", f"integer {name} accumulates in {out_dt}; "
                                             "accumulate in int32")
        elif base in ARITH_OPS:
            kinds = {_kind(t) for t in ins} - {None}
            if len(kinds) > 1:
                self._violate("LATTICE-MIXED", f"{name} mixes operand kinds {sorted(kinds)}: "
                                               f"{[dtype_name(t.dtype) for t in ins]}")
        if name in CAST_OPS and not self._in_boundary and ins:
            src = ins[-1] if name == "copy_" else ins[0]
            dst = ins[0] if name == "copy_" else (outs[0] if outs else None)
            if dst is not None and dtype_name(src.dtype) in NARROW_INT \
                    and dtype_name(dst.dtype) in FLOAT_KINDS \
                    and src.numel() >= self.pool_threshold:
                self._violate("POOL-FLOAT-CAST",
                              f"pool-scale cast {dtype_name(src.dtype)}->"
                              f"{dtype_name(dst.dtype)} of {src.numel()} elems (threshold "
                              f"{self.pool_threshold}) outside a registered kernel boundary")
        if self.pool and not view and not written and not self._in_boundary:
            for t in outs:
                if (t.dtype, tuple(t.shape)) in self.pool:
                    self._violate("DONATION", f"{name} allocates a fresh {dtype_name(t.dtype)} "
                                              f"{tuple(t.shape)}, a pool leaf's (or one "
                                              "layer's) shape: the pool is copied, not "
                                              "written in place")

    # --- exact integer products -------------------------------------------

    def _exact(self, name, fn, args, kwargs, carrier, ranges):
        self._quiet += 1
        try:
            out = fn(*args, **kwargs)
            a, b = _tensors(args)[:2]
            integral = _integral(a) and _integral(b)
            if carrier is None:
                carrier = next((t.dtype for t in (a, b) if t.dtype.is_floating_point),
                               torch.float64)
            limit = EXACT_LIMIT[dtype_name(carrier)]
            k = a.shape[-1]
            seen = k * _absmax(a) * _absmax(b) / limit
            declared = ranges(*args, **kwargs) if ranges is not None else (None, None)
            amax, bmax = (_static_max(t, r) for t, r in zip((a, b), declared))
        finally:
            self._quiet -= 1
        shape = tuple(out.shape)
        op = Op(name, self.scope, "exact", _sig((a, b)), (("int32", shape),), False,
                self._in_launch)
        in_taint = self._add(op, [a, b], [out])
        self.res.exact_ratio_seen = max(self.res.exact_ratio_seen, seen)
        if not integral and in_taint:
            self._violate("INT-DOT-FLOAT", f"{name}: an operand is not integer-valued, so the "
                                           f"{dtype_name(carrier)} product is float work on "
                                           "quantized data")
        if amax is None or bmax is None:
            self._violate("INT-DOT-ACC", f"{name}: an operand carried in a float has no "
                                         "declared range, so no K bounds its partial sums "
                                         f"in the {dtype_name(carrier)} carrier")
            return out
        ratio = k * amax * bmax / limit
        self.res.exact_ratio = max(self.res.exact_ratio, ratio)
        if ratio >= 1.0:
            self._violate("INT-DOT-ACC", f"{name}: K * A * B = {k} * {amax:.0f} * {bmax:.0f} "
                                         f"is {ratio:.3g} x the {dtype_name(carrier)} "
                                         f"carrier's exact range ({limit:.0f}): partial sums "
                                         f"of operands in range round (this run's held "
                                         f"{seen:.3g} x)")
        return out


# --- cache helpers ---------------------------------------------------------------

def cache_leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a cache: nested dicts, and a list of
    per-rank pools under tensor parallelism."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from cache_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from cache_leaves(v, f"{path}[{i}]")


def pool_threshold_elems(cache) -> int:
    """Half the smallest KV pool payload leaf's element count: activations
    sit far below, any whole-pool (or gathered whole-chain) dequant above.
    Payload leaves are the >=4-D pool tensors; 2-D kv4 scale leaves and
    non-paged layouts fall back to the largest leaf.  Under tensor
    parallelism the leaves are each rank's, so one rank dequantizing its
    whole shard is caught."""
    leaves = [t for _, t in cache_leaves(cache)]
    pools = [t.numel() for t in leaves if t.dim() >= 4]
    if not pools:
        pools = [max((t.numel() for t in leaves), default=2)]
    return max(min(pools) // 2, 1)


def _pool_spec(cache) -> Set[Tuple[torch.dtype, Tuple[int, ...]]]:
    """(dtype, shape) of every cache leaf and of one layer's slice of it:
    what a copy of the pool, whole or a layer at a time, allocates."""
    return {(t.dtype, tuple(t.shape[i:])) for _, t in cache_leaves(cache) for i in (0, 1)
            if t.dim() > i}


def record(fn, args, *, graph: str = "graph", pool_threshold: int = 1 << 62,
           boundaries: Optional[Dict[str, str]] = None, pool=None):
    """Run ``fn(*args)`` once under a ``Recorder``; returns (result, the
    recorder's ``AuditResult``: ops, histogram and op-level violations)."""
    rec = Recorder(graph=graph, pool_threshold=pool_threshold, boundaries=boundaries,
                   pool=pool)
    with rec:
        out = fn(*args)
    return out, rec.res


def audit_graph(fn, args, *, graph: str, pool_threshold: int,
                boundaries: Optional[Dict[str, str]] = None,
                check_donation: bool = True) -> AuditResult:
    """Record ``fn(*args)`` and run every rule.  ``pool_threshold`` is the
    element count above which a narrow-int -> float cast counts as
    pool-scale.  A hot step takes its cache as ``args[1]`` and returns
    ``(logits, cache)``; with ``check_donation`` every cache leaf must be
    written in place."""
    before = [(p, t, t.untyped_storage().data_ptr()) for p, t in cache_leaves(args[1])] \
        if check_donation else []
    pool = _pool_spec(args[1]) if check_donation else None
    out, res = record(fn, args, graph=graph, pool_threshold=pool_threshold,
                      boundaries=boundaries, pool=pool)
    after = dict(cache_leaves(out[1])) if isinstance(out, tuple) and len(out) == 2 else {}
    for path, t, ptr in before:
        if after.get(path) is not t:
            res.violations.append(Violation(
                "DONATION", graph, "",
                f"cache leaf {path} is not returned as the same tensor: the step rebinds "
                "the pool instead of writing it in place"))
        elif t.untyped_storage().data_ptr() != ptr:
            res.violations.append(Violation(
                "DONATION", graph, "", f"cache leaf {path} moved to new storage"))
    return res


def audit_cache_aliasing(cache, *, graph: str = "cache") -> List[Violation]:
    """No two cache leaves may share storage: on one device (every TP rank
    on ``(cuda:0,) * 4`` included) a shared buffer means one rank's or one
    leaf's writes land in another's."""
    out: List[Violation] = []
    seen: List[Tuple[torch.device, int, int, str]] = []
    for path, t in cache_leaves(cache):
        st = t.untyped_storage()
        lo, hi = st.data_ptr(), st.data_ptr() + st.nbytes()
        for dev, lo2, hi2, other in seen:
            if dev == t.device and lo < hi2 and lo2 < hi:
                out.append(Violation("DONATION-ALIAS", graph, path,
                                     f"leaf shares storage with {other}: writes to one land "
                                     "in the other"))
                break
        seen.append((t.device, lo, hi, path))
    return out


def audit_engine(engine, *, graphs=None) -> Dict[str, AuditResult]:
    """Run every rule over each hot graph of a live Engine, plus the
    live-storage aliasing check (attached to the first graph)."""
    hot = engine.hot_graphs()
    if graphs is not None:
        hot = {k: v for k, v in hot.items() if k in graphs}
    thr = pool_threshold_elems(engine.cache)
    results: Dict[str, AuditResult] = {}
    for name, (fn, args) in hot.items():
        results[name] = audit_graph(fn, args, graph=name, pool_threshold=thr)
    if results:
        next(iter(results.values())).violations.extend(audit_cache_aliasing(engine.cache))
    return results


__all__ = [
    "AuditResult", "Violation", "Op", "Recorder", "record", "audit_graph",
    "audit_cache_aliasing", "audit_engine", "pool_threshold_elems", "cache_leaves",
    "NARROW_INT", "FLOAT_KINDS",
]
