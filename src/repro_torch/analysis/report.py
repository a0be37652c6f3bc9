"""Frozen, versioned schema for the static-analysis report (ANALYSIS.json).

The port's copy of the reference's ``analysis/report.py``, key for key
except two top-level keys: ``jax_version`` is ``torch_version`` and
``pallas_lint`` is ``kernel_lint``.  The key sets below are the single
source of truth, payloads carry the version under ``schema_version``, and
consumers (the ``analyze`` CLI, tests) validate exact key sets instead of
guessing from shape.  :data:`ANALYSIS_SCHEMA_VERSION` bumps whenever a key is added,
removed, or changes meaning.  Version 1 is the first frozen schema.

Baseline policy — what is gated vs merely recorded:

* ``violations`` — gated at zero on any FRESH report, no baseline needed
  (the committed baseline is exempt only in the sense that it never has
  any: a baseline with violations should never have been committed).
* per-graph ``float_prims`` — the SET of primitive names that produce a
  float output in each audited graph.  Gated as a one-way ratchet vs the
  committed baseline: a new float primitive appearing in a hot graph is
  exactly the "integer pipeline regresses to float one op at a time"
  failure the subsystem exists to catch.  Sets, not counts: op counts
  shift with torch versions and kernel backends; the set of float op
  *kinds* on the serve path is the stable contract.
* ``op_histogram`` / ``hbm_bytes_by_dtype`` / ``n_eqns`` — recorded for
  the trajectory, deliberately not gated (version-noisy).
"""
from __future__ import annotations

from typing import Dict, List, Mapping

ANALYSIS_SCHEMA_VERSION = 1

REPORT_KIND = "analysis_report"

# --- top-level report keys ----------------------------------------------
REPORT_KEYS: Dict[str, str] = {
    "kind": f"artifact discriminator: always {REPORT_KIND!r}",
    "schema_version": "analysis schema version (this module)",
    "torch_version": "torch the steps were recorded under (informational)",
    "presets": "preset name -> per-preset audit payload",
    "skipped": "list of {preset, reason} for presets this host cannot run",
    "kernel_lint": "kernel lint payload: {checks, violations}",
    "violations_total": "total violations across presets + kernel lint",
}

PRESET_KEYS: Dict[str, str] = {
    "config": "engine knobs: {kv_bits, tp, spec_k}",
    "graphs": "hot-graph name -> per-graph audit payload",
}

GRAPH_KEYS: Dict[str, str] = {
    "n_eqns": "ops recorded (all nesting levels)",
    "violations": "list of {rule, graph, scope, detail}",
    "op_histogram": "output dtype -> op name -> op count",
    "float_prims": "sorted op names with a float output (GATED set)",
    "hbm_bytes_by_dtype": "bytes per dtype from analysis.cost ({} if not recorded)",
}

VIOLATION_KEYS: Dict[str, str] = {
    "rule": "stable rule id (INT-DOT-FLOAT, DONATION, IDXMAP-RANGE, ...)",
    "graph": "hot graph / kernel the violation was found in",
    "scope": "nested scope path inside the graph ('' for graph-level)",
    "detail": "human-readable location + why",
}

LINT_KEYS: Dict[str, str] = {
    "checks": "list of {check, kernel, ok, detail} per lint group",
    "violations": "list of {rule, graph, scope, detail}",
}

_REPORT = frozenset(REPORT_KEYS)
_PRESET = frozenset(PRESET_KEYS)
_GRAPH = frozenset(GRAPH_KEYS)
_VIOLATION = frozenset(VIOLATION_KEYS)
_LINT = frozenset(LINT_KEYS)


class AnalysisSchemaError(ValueError):
    """An ANALYSIS.json payload does not match the frozen schema."""


def _check_keys(got, expected, what: str):
    missing = sorted(expected - got)
    unknown = sorted(got - expected)
    if missing or unknown:
        raise AnalysisSchemaError(
            f"{what} does not match analysis schema "
            f"v{ANALYSIS_SCHEMA_VERSION}: missing={missing} "
            f"unknown={unknown}")


def _check_violations(viols, what: str):
    for i, v in enumerate(viols):
        _check_keys(set(v), _VIOLATION, f"{what}[{i}]")


def validate_report(doc: Mapping, *, what: str = "ANALYSIS.json") -> Mapping:
    """Exact-match a report against the frozen schema, all levels deep."""
    if doc.get("kind") != REPORT_KIND:
        raise AnalysisSchemaError(
            f"{what} carries kind={doc.get('kind')!r}, expected "
            f"{REPORT_KIND!r}")
    if doc.get("schema_version") != ANALYSIS_SCHEMA_VERSION:
        raise AnalysisSchemaError(
            f"{what} carries schema_version={doc.get('schema_version')!r}, "
            f"this build understands {ANALYSIS_SCHEMA_VERSION}")
    _check_keys(set(doc), _REPORT, what)
    for pname, preset in doc["presets"].items():
        pwhat = f"{what}['presets'][{pname!r}]"
        _check_keys(set(preset), _PRESET, pwhat)
        for gname, graph in preset["graphs"].items():
            gwhat = f"{pwhat}['graphs'][{gname!r}]"
            _check_keys(set(graph), _GRAPH, gwhat)
            _check_violations(graph["violations"], f"{gwhat}['violations']")
    _check_keys(set(doc["kernel_lint"]), _LINT, f"{what}['kernel_lint']")
    _check_violations(doc["kernel_lint"]["violations"],
                      f"{what}['kernel_lint']['violations']")
    for i, sk in enumerate(doc["skipped"]):
        _check_keys(set(sk), {"preset", "reason"}, f"{what}['skipped'][{i}]")
    return doc


def count_violations(doc: Mapping) -> int:
    n = sum(len(g["violations"]) for p in doc["presets"].values()
            for g in p["graphs"].values())
    return n + len(doc["kernel_lint"]["violations"])


def build_report(*, presets: Mapping, skipped: List[Dict],
                 kernel_lint: Mapping, torch_version: str) -> Dict:
    """Assemble + validate a report from ``audit_engine`` results.

    ``presets`` maps preset name -> (config dict, {graph: AuditResult},
    {graph: hbm_bytes_by_dtype dict})."""
    doc: Dict = {
        "kind": REPORT_KIND,
        "schema_version": ANALYSIS_SCHEMA_VERSION,
        "torch_version": torch_version,
        "presets": {},
        "skipped": list(skipped),
        "kernel_lint": {"checks": list(kernel_lint["checks"]),
                        "violations": list(kernel_lint["violations"])},
        "violations_total": 0,
    }
    for name, (config, results, hbm) in presets.items():
        graphs = {}
        for gname, res in results.items():
            graphs[gname] = {
                "n_eqns": res.n_eqns,
                "violations": [v.to_dict() for v in res.violations],
                "op_histogram": res.op_histogram,
                "float_prims": sorted(res.float_prims),
                "hbm_bytes_by_dtype": dict(hbm.get(gname, {})),
            }
        doc["presets"][name] = {"config": dict(config), "graphs": graphs}
    doc["violations_total"] = count_violations(doc)
    return validate_report(doc)


def compare_to_baseline(cur: Mapping, base: Mapping) -> List[str]:
    """One-way float-primitive ratchet vs the committed baseline.

    Returns failure strings for (a) any float primitive newly producing
    output in a graph both reports audited, and (b) any baseline
    preset/graph that vanished from the current report without being
    recorded as skipped.  Presets only the current report has (new
    hardware, new knobs) are fine — they become gated once committed."""
    failures: List[str] = []
    validate_report(cur, what="current report")
    validate_report(base, what="baseline report")
    skipped_now = {s["preset"] for s in cur["skipped"]}
    for pname, bpreset in base["presets"].items():
        if pname not in cur["presets"]:
            if pname not in skipped_now:
                failures.append(
                    f"preset {pname!r} is in the baseline but the current "
                    "report neither audited nor skipped it")
            continue
        cgraphs = cur["presets"][pname]["graphs"]
        for gname, bgraph in bpreset["graphs"].items():
            if gname not in cgraphs:
                failures.append(
                    f"graph {pname}/{gname} is in the baseline but missing "
                    "from the current report")
                continue
            new = sorted(set(cgraphs[gname]["float_prims"])
                         - set(bgraph["float_prims"]))
            if new:
                failures.append(
                    f"graph {pname}/{gname} grew new float primitives "
                    f"{new} — the integer datapath regressed toward float "
                    "(update the baseline ONLY if this is intentional)")
    return failures
