"""Static-analysis CLI: ``python -m repro_torch.analysis.analyze``.

Builds one folded smoke yi-6b, then for every ``EngineConfig`` preset on
the audit matrix (kv_bits 8/4 x tp 1/4 x spec_k 0/3, minus the
combinations ``EngineConfig.validate`` rejects) boots a live paged engine,
records and audits every hot step (decode, prefill chunk, verify) with
``graph_audit``, runs the kernel lint, and emits one versioned ANALYSIS.json
(``report`` schema).  A tensor-parallel preset's ranks run on the one
device named ``tp`` times, so every preset runs on every host and
``skipped`` stays empty.

Exit is non-zero on ANY violation, on a float-op ratchet failure vs
``--baseline``, or — under ``--self-test`` — if any intentionally broken
fixture fails to raise its expected rule id.  ``--device`` defaults to
``cuda`` and raises without a card; the CPU audits the plain versions.

    python -m repro_torch.analysis.analyze --device cpu --out ANALYSIS.json
    python -m repro_torch.analysis.analyze --device cpu \\
        --baseline src/repro_torch/analysis/baseline_cpu.json
    python -m repro_torch.analysis.analyze --device cpu --self-test
    python -m repro_torch.analysis.analyze --hlo      # + bytes by dtype (analysis.cost)
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# (kv_bits, tp, spec_k) — every combination EngineConfig accepts
PRESETS: Tuple[Tuple[int, int, int], ...] = (
    (8, 1, 0), (8, 1, 3), (8, 4, 0), (8, 4, 3), (4, 1, 0), (4, 4, 0),
)
BASELINE = Path(__file__).with_name("baseline_cpu.json")


def preset_name(kv_bits: int, tp: int, spec_k: int) -> str:
    return f"kv{kv_bits}_tp{tp}_spec{spec_k}"


def _device(device: str):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("analyze --device cuda needs a CUDA card (pass --device cpu to "
                           "audit the plain versions)")
    return dev


def run_audits(*, device: str = "cuda", with_bytes: bool = False, cfg=None, folded=None,
               engine_kw: Optional[Dict] = None) -> Tuple[Dict, List[Dict]]:
    """(presets payload for ``report.build_report``, skipped list) over
    every preset of ``PRESETS``.  The
    smoke yi-6b's folded weights come from ``calibrated_folded`` at seed 0
    unless ``cfg`` and ``folded`` are given; ``engine_kw`` overrides the
    engines' knobs (batch_slots=4, max_len=64, page_size=8)."""
    from repro_torch.analysis import cost, graph_audit
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.serve.engine import Engine, EngineConfig

    dev = _device(device)
    if folded is None:
        from repro_torch.configs import smoke_config
        from repro_torch.launch.serve import calibrated_folded

        cfg = smoke_config("yi-6b")
        folded = calibrated_folded(cfg, 0, device=dev)
    kw = {"batch_slots": 4, "max_len": 64, "page_size": 8, **(engine_kw or {})}
    out: Dict = {}
    for kv_bits, tp, spec_k in PRESETS:
        name = preset_name(kv_bits, tp, spec_k)
        mesh = TPMesh((dev,) * tp) if tp > 1 else None
        eng = Engine(cfg, folded, EngineConfig(cache_layout="paged", kv_bits=kv_bits,
                                               spec_k=spec_k, mesh=mesh, **kw))
        results = graph_audit.audit_engine(eng)
        hbm = {g: cost.bytes_by_dtype(r.ops) for g, r in results.items()} if with_bytes else {}
        nv = sum(len(r.violations) for r in results.values())
        print(f"[analyze] {name}: {len(results)} graph(s), "
              f"{sum(r.n_eqns for r in results.values())} ops, {nv} violation(s)")
        out[name] = ({"kv_bits": kv_bits, "tp": tp, "spec_k": spec_k}, results, hbm)
        del eng
    return out, []


def self_test() -> int:
    from repro_torch.analysis import fixtures
    res = fixtures.run_self_test()
    for name, fr in res["fixtures"].items():
        want = fr["expected_rule"] or "(clean)"
        status = "ok" if fr["ok"] else "FAILED"
        print(f"[self-test] {name}: expected {want}, "
              f"flagged {fr['flagged_rules']} [{status}]")
    if not res["ok"]:
        print("[self-test] FAILED: a broken fixture was not flagged with "
              "its rule id (or a negative control was) — the analyzers "
              "cannot be trusted", file=sys.stderr)
        return 1
    print(f"[self-test] all {len(res['fixtures'])} fixtures behaved")
    return 0


def gate(doc: Dict, baseline: Optional[Path]) -> int:
    """Print every violation, every lint check that is not ok and the
    ratchet's verdict; 1 on any failure (a memcheck whose tool cannot run
    on the machine is printed, not gated)."""
    from repro_torch.analysis import kernel_lint, report

    rc = 0
    for c in doc["kernel_lint"]["checks"]:
        if not c["ok"]:
            print(f"[analyze] lint check {c['check']} ({c['kernel']}) not ok: {c['detail']}",
                  file=sys.stderr)
    if kernel_lint.failed_checks(doc["kernel_lint"]):
        rc = 1
    total = doc["violations_total"]
    if total:
        print(f"\nANALYSIS FAILED: {total} violation(s):", file=sys.stderr)
        for p in doc["presets"].values():
            for g in p["graphs"].values():
                for v in g["violations"]:
                    print(f"  - [{v['rule']}] {v['graph']}{v['scope']}: "
                          f"{v['detail']}", file=sys.stderr)
        for v in doc["kernel_lint"]["violations"]:
            print(f"  - [{v['rule']}] {v['graph']}: {v['detail']}",
                  file=sys.stderr)
        rc = 1
    else:
        n_graphs = sum(len(p["graphs"]) for p in doc["presets"].values())
        print(f"[analyze] zero violations across {len(doc['presets'])} "
              f"preset(s) / {n_graphs} graph(s) + kernel lint")
    if baseline:
        if not baseline.exists():
            print(f"[analyze] baseline {baseline} missing — commit one "
                  "(run with --out and check it in)", file=sys.stderr)
            return 1
        failures = report.compare_to_baseline(doc, json.loads(baseline.read_text()))
        for f in failures:
            print(f"[baseline] {f}", file=sys.stderr)
        if failures:
            rc = 1
        else:
            print(f"[analyze] float-op ratchet vs {baseline} holds")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.analyze",
        description="integer-datapath audit of the engine's hot steps + CUDA kernel lint")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the versioned JSON report here")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="committed report to ratchet float ops against")
    ap.add_argument("--hlo", action="store_true",
                    help="also record each hot step's bytes by dtype (analysis.cost)")
    ap.add_argument("--self-test", action="store_true",
                    help="run the intentionally-broken fixtures instead of "
                         "auditing the tree")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (the kernels; the default) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)

    _device(args.device)
    if args.self_test:
        return self_test()

    import torch

    from repro_torch.analysis import kernel_lint, report

    presets, skipped = run_audits(device=args.device, with_bytes=args.hlo)
    doc = report.build_report(presets=presets, skipped=skipped,
                              kernel_lint=kernel_lint.run_all(torch.device(args.device).type),
                              torch_version=torch.__version__)
    if args.out:
        args.out.write_text(json.dumps(doc, indent=1, sort_keys=True))
        print(f"[analyze] wrote {args.out}")
    return gate(doc, args.baseline)


if __name__ == "__main__":
    raise SystemExit(main())
