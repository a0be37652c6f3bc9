"""Intentionally-broken fixtures that prove the analysis subsystem works.

A static checker that never fires is indistinguishable from one that
can't.  Each fixture plants exactly one of the bugs the auditor and the
kernel lint exist to catch — the reference's (a seeded float matmul on the
int path, an int8 product that accumulates narrow, a whole-pool float cast
outside a kernel boundary, a step that replaces its pool, aliased pool
leaves, an out-of-range, an unclamped and a trash-page read of the paged
decode) and the port's own (a mixed-kind ``mul``, an exact product over a
carrier too narrow, and one too narrow for its operands' range although
this run's values are small, a paged decode that writes past its pool, a
ptxas log over the shared-memory budget, a swapped argument pair, a paged
``.cu`` with a body of its own) — and
``run_self_test`` asserts the expected rule id is raised, and that the two
negative controls stay clean.  ``analyze --self-test`` runs it before a
zero-violation report is trusted.  Every fixture runs on CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from repro_torch.analysis import boundary, graph_audit, kernel_lint
from repro_torch.analysis.graph_audit import (audit_cache_aliasing, audit_graph,
                                              pool_threshold_elems)
from repro_torch.kernels import ref


class Fixture(NamedTuple):
    expected_rule: str    # "" for a negative control (must stay clean)
    run: Callable[[], List[graph_audit.Violation]]


def _cache():
    # miniature paged pool: two >=4-D int8 payload leaves, 1024 elems each
    # (pool threshold = 512, far above the fixtures' activations)
    return {"k": torch.zeros((1, 4, 16, 2, 8), dtype=torch.int8),
            "v": torch.ones((1, 4, 16, 2, 8), dtype=torch.int8)}


def _args():
    return {"w": torch.ones((8, 8), dtype=torch.int8)}, _cache(), torch.ones((2, 8))


def _audit(fn, boundaries=None) -> List[graph_audit.Violation]:
    args = _args()
    return audit_graph(fn, args, graph=f"fixture:{fn.__name__}",
                       pool_threshold=pool_threshold_elems(args[1]),
                       boundaries=boundaries).violations


def _quantize(x):
    return torch.clamp(torch.round(x * 16.0), -127, 127).to(torch.int8)


# --- graph-rule fixtures --------------------------------------------------------------

def _bad_fdot(params, cache, x):
    # launders the int8 weight into a float matmul: INT-DOT-FLOAT
    wf = params["w"].to(torch.float32) / 127.0
    return x @ wf, cache


def _bad_acc(params, cache, x):
    # int8 x int8 matmul with an int8 result: INT-DOT-ACC
    return torch.mm(_quantize(x), params["w"]), cache


@boundary.exact_int_product(why="fixture: a float32 carrier too narrow for its K",
                            carrier=torch.float32)
def _f32_product(a, b):
    return a.to(torch.float32) @ b.to(torch.float32)


def _bad_carrier(params, cache, x):
    # K * 127 * 127 >= 2^24: the float32 carrier's partial sums round: INT-DOT-ACC
    a = torch.full((2, 1100), 127, dtype=torch.int8)
    return _f32_product(a, torch.full((1100, 8), 127, dtype=torch.int8)), cache


@boundary.exact_int_product(why="fixture: float32-carried codes of a w8 head",
                            carrier=torch.float32, ranges=lambda a, w, qmax: (None, qmax))
def _f32_head(a, w, qmax):
    return a.to(w.dtype) @ w


def _bad_carrier_range(params, cache, x):
    # this run's values are 0 and 1, far inside float32, but int8 activations
    # times w8 codes over K = 1100 may reach 1100 * 128 * 127 >= 2^24: INT-DOT-ACC
    a = (_quantize(x).repeat(1, 138)[:, :1100] > 0).to(torch.int8)
    return _f32_head(a, torch.ones((1100, 8)), 127), cache


def _bad_mixed(params, cache, x):
    # int8 codes times a 0-dim float tensor, promoted implicitly: LATTICE-MIXED
    return _quantize(x) * torch.tensor(0.5), cache


def _bad_pool_cast(_params, cache, x):
    # dequantizes the whole pool in open code: POOL-FLOAT-CAST
    return x + cache["k"].to(torch.float32).sum(), cache


def _bad_donation(params, cache, x):
    # returns a copy of the pool in place of the pool: DONATION
    return _clean(params, cache, x)[0], {k: v.clone() for k, v in cache.items()}


def _clean(params, cache, x):
    # the shape of a correct hot graph: an exact integer product with a
    # wide result, activation-scale casts only
    y = ref.int_matmul(_quantize(x), params["w"])
    return y.to(torch.float32) / 256.0, cache


def _blessed_pool_cast(_params, cache, x):
    # the whole-pool cast of _bad_pool_cast inside a boundary scope: clean
    with boundary.scope("_blessed_dequant"):
        kf = cache["k"].to(torch.float32)
    return x + kf.sum(), cache


def _run_aliased() -> List[graph_audit.Violation]:
    # one tensor reused for two pool leaves
    shared = torch.zeros((1, 4, 16, 2, 8), dtype=torch.int8)
    return audit_cache_aliasing({"k": shared, "v": shared}, graph="fixture:aliased")


# --- index-bound fixtures: paged decode "kernels" with planted index bugs ---------------

def _reach(pool: torch.Tensor, pages: int) -> torch.Tensor:
    """``pages`` pages from the pool's first, read through its buffer (a
    kernel's raw pointer walks past a view's end the same way)."""
    return pool.as_strided((pages, *pool.shape[1:]), pool.stride(), pool.storage_offset())


def _one_more_block(btab, lens, psize, page=None):
    """Lengths one block longer (the first dead block read as live), its
    table column set to ``page`` where given."""
    longer = torch.clamp(lens + psize, max=btab.shape[1] * psize)
    if page is None:
        return btab, longer
    bt = btab.clone()
    live = (lens.long() + psize - 1) // psize
    rows = torch.nonzero(live < bt.shape[1])[:, 0]
    bt[rows, live[rows]] = page
    return bt, longer


def _oob_decode(q, k, v, btab, lens, *scalars):
    # the first dead block's page is read one past the pool's end
    n, psize = k.shape[0], k.shape[1]
    bt, longer = _one_more_block(btab, lens, psize, page=n)
    return ref.paged_decode_qattention_ref(q, _reach(k, n + 1), _reach(v, n + 1), bt, longer,
                                           *scalars)


def _dead_unclamped_decode(q, k, v, btab, lens, *scalars):
    # the first dead block's table column is read as live
    bt, longer = _one_more_block(btab, lens, k.shape[1])
    return ref.paged_decode_qattention_ref(q, k, v, bt, longer, *scalars)


def _trash_decode(q, k, v, btab, lens, *scalars):
    # the first dead block reads the trash page
    bt, longer = _one_more_block(btab, lens, k.shape[1], page=0)
    return ref.paged_decode_qattention_ref(q, k, v, bt, longer, *scalars)


def _writes_past_decode(q, k, v, btab, lens, *scalars):
    # a correct read, then a store into the page after the pool's last
    n = k.shape[0]
    _reach(k, n + 1)[n] = 1
    return ref.paged_decode_qattention_ref(q, k, v, btab, lens, *scalars)


def _battery(fake) -> Callable[[], List[graph_audit.Violation]]:
    return lambda: kernel_lint.check_index_bounds("cpu", {
        f"fixture:{fake.__name__}":
            lambda dev: kernel_lint.paged_decode_cases(dev, False, fn=fake)})


# --- kernel-lint text fixtures -----------------------------------------------------------

OVER_BUDGET_LOG = """\
ptxas info    : Compiling entry function '_Z14fixture_kernelPKaPa' for 'sm_90a'
ptxas info    : Function properties for _Z14fixture_kernelPKaPa
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 239616 bytes smem, 400 bytes cmem[0]
"""


def _run_smem() -> List[graph_audit.Violation]:
    return kernel_lint.check_smem({"fixture_kernel": OVER_BUDGET_LOG})[1]


def _run_swapped() -> List[graph_audit.Violation]:
    # the paged decode wrapper passes the lengths before the block table
    text = (kernel_lint.SRC / "kernels" / "decode_attention.py").read_text()
    good = "btab.data_ptr(), lens.data_ptr(),\n        lut.data_ptr()"
    if good not in text:
        raise RuntimeError("the paged decode wrapper's call changed; update this fixture")
    return kernel_lint.check_arg_order(
        {"decode_attention": text.replace(good, "lens.data_ptr(), btab.data_ptr(),\n"
                                                "        lut.data_ptr()")})


def _run_body_copy() -> List[graph_audit.Violation]:
    # a paged .cu with its own kernel body in place of the shared header's
    name = "paged_decode_attention.cu"
    text = (kernel_lint.SRC / "csrc" / name).read_text()
    text = text.replace('#include "paged_decode.cuh"',
                        '#include "common.cuh"\n__global__ void local_decode_body() {}')
    return kernel_lint.check_shared_body({name: text})


FIXTURES: Dict[str, Fixture] = {
    "seeded_f32_matmul": Fixture("INT-DOT-FLOAT", lambda: _audit(_bad_fdot)),
    "narrow_accumulate": Fixture("INT-DOT-ACC", lambda: _audit(_bad_acc)),
    "narrow_carrier": Fixture("INT-DOT-ACC", lambda: _audit(_bad_carrier)),
    "narrow_carrier_small_values": Fixture("INT-DOT-ACC", lambda: _audit(_bad_carrier_range)),
    "mixed_kind_mul": Fixture("LATTICE-MIXED", lambda: _audit(_bad_mixed)),
    "open_pool_dequant": Fixture("POOL-FLOAT-CAST", lambda: _audit(_bad_pool_cast)),
    "clobbered_donation": Fixture("DONATION", lambda: _audit(_bad_donation)),
    "aliased_pool_leaves": Fixture("DONATION-ALIAS", _run_aliased),
    "idxmap_out_of_range": Fixture("IDXMAP-RANGE", _battery(_oob_decode)),
    "idxmap_dead_unclamped": Fixture("IDXMAP-CLAMP", _battery(_dead_unclamped_decode)),
    "idxmap_paged_trash": Fixture("IDXMAP-RANGE", _battery(_trash_decode)),
    "idxmap_write_past_pool": Fixture("IDXMAP-RANGE", _battery(_writes_past_decode)),
    "smem_over_budget": Fixture("SMEM-BUDGET", _run_smem),
    "swapped_arg_pair": Fixture("ARG-ORDER", _run_swapped),
    "paged_body_copy": Fixture("SHARED-BODY", _run_body_copy),
    # negative controls: a correct graph and a boundary-blessed pool cast
    "clean_int_graph": Fixture("", lambda: _audit(_clean)),
    "blessed_pool_cast": Fixture("", lambda: _audit(
        _blessed_pool_cast, boundaries={"_blessed_dequant": "fixture boundary"})),
}


def run_self_test() -> Dict:
    """Run every fixture; each broken one must raise its expected rule id,
    each negative control must stay clean.  Returns a JSON-able summary
    with an overall ``ok`` flag."""
    results = {}
    for name, fx in FIXTURES.items():
        viols = fx.run()
        rules = sorted({v.rule for v in viols})
        ok = fx.expected_rule in rules if fx.expected_rule else not rules
        results[name] = {
            "expected_rule": fx.expected_rule,
            "flagged_rules": rules,
            "ok": ok,
            "violations": [v.to_dict() for v in viols],
        }
    return {"ok": all(r["ok"] for r in results.values()), "fixtures": results}
