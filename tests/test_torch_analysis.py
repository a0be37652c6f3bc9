"""The port's static analysis (``repro_torch.analysis``) against the
reference's ``repro.analysis``, and over the port's own tree.

Parity: the report schema, its rejections and the float-op ratchet equal
the reference's ``report.py`` on the same payloads (two top-level keys
renamed); the presets, the hot graphs' names, the fixtures' rule ids and
the kernel boundaries cover the reference's.  The tree: every preset's hot
steps audit clean on the smoke yi-6b (the reference's folded weights,
carried across), the committed CPU baseline holds the ratchet, and every
planted fixture fires its rule while the two negative controls stay
clean.  The scopes change no result, and auditing an engine leaves it
serving as before.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.analysis import analyze as j_analyze
from repro.analysis import fixtures as j_fixtures
from repro.analysis import jaxpr_audit as j_audit
from repro.analysis import report as j_report
from repro.configs import smoke_config as j_smoke
from repro.models import fold as JF
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.analysis import (analyze, boundary, cost, fixtures, graph_audit, kernel_lint,
                                  report)
from repro_torch.configs import smoke_config
from repro_torch.models import fold as F
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
PAGED = dict(batch_slots=4, max_len=64, cache_layout="paged", page_size=8)
RENAMED = {"jax_version": "torch_version", "pallas_lint": "kernel_lint"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folded():
    jcfg = j_smoke("yi-6b")
    params = JT.init_params(jcfg, KEY)
    calib = jax.random.randint(KEY, (2, 16), 0, jcfg.vocab_size)
    _, obs, _ = JT.forward(jcfg, params, JT.init_amax(jcfg), calib)
    # jitted: 1 s against 5 s eager; the audit needs folded weights, not
    # the eager fold's bits
    jfolded = jax.jit(JF.fold_params, static_argnums=0)(jcfg, params, obs)
    tfolded = F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu")
    return jcfg, jfolded, smoke_config("yi-6b"), tfolded


@pytest.fixture(scope="module")
def audited(folded):
    """The six presets audited on the CPU and the report built from them."""
    _, _, cfg, tfolded = folded
    presets, skipped = analyze.run_audits(device="cpu", with_bytes=True, cfg=cfg,
                                          folded=tfolded)
    doc = report.build_report(presets=presets, skipped=skipped,
                              kernel_lint=kernel_lint.run_all("cpu"),
                              torch_version=torch.__version__)
    return presets, doc


# --- parity with the reference --------------------------------------------------------

def _payload(make_result, float_prims=("exp",), preset="kv8_tp1_spec0", viols=()):
    res = make_result(graph="decode", n_eqns=3)
    res.float_prims = set(float_prims)
    res.op_histogram = {"float32": {p: 1 for p in float_prims}}
    res.violations = list(viols)
    return {preset: ({"kv_bits": 8, "tp": 1, "spec_k": 0}, {"decode": res},
                     {"decode": {"int8": 64.0}})}


def _both(float_prims=("exp",), preset="kv8_tp1_spec0", skipped=(), viol=False):
    """The same payload through the reference's build_report and the port's;
    the reference's document with its two keys renamed, and the port's."""
    lint = {"checks": [{"check": "c", "kernel": "*", "ok": True, "detail": ""}],
            "violations": []}
    jv = [j_audit.Violation("INT-DOT-FLOAT", "decode", "/s", "d")] if viol else []
    tv = [graph_audit.Violation("INT-DOT-FLOAT", "decode", "/s", "d")] if viol else []
    jdoc = j_report.build_report(presets=_payload(j_audit.AuditResult, float_prims, preset, jv),
                                 skipped=list(skipped), pallas=lint, jax_version="v")
    tdoc = report.build_report(presets=_payload(graph_audit.AuditResult, float_prims, preset,
                                                tv),
                               skipped=list(skipped), kernel_lint=lint, torch_version="v")
    return {RENAMED.get(k, k): v for k, v in jdoc.items()}, tdoc


def _to_ref(doc):
    back = {v: k for k, v in RENAMED.items()}
    return {back.get(k, k): v for k, v in doc.items()}


def test_report_build_equals_reference():
    for kw in ({}, {"viol": True}, {"float_prims": ()},
               {"skipped": [{"preset": "x", "reason": "r"}]}):
        jdoc, tdoc = _both(**kw)
        assert tdoc == jdoc
        assert report.count_violations(tdoc) == j_report.count_violations(_to_ref(tdoc))
    assert report.ANALYSIS_SCHEMA_VERSION == j_report.ANALYSIS_SCHEMA_VERSION
    assert report.REPORT_KIND == j_report.REPORT_KIND
    assert set(report.REPORT_KEYS) == {RENAMED.get(k, k) for k in j_report.REPORT_KEYS}
    for mine, theirs in ((report.PRESET_KEYS, j_report.PRESET_KEYS),
                         (report.GRAPH_KEYS, j_report.GRAPH_KEYS),
                         (report.VIOLATION_KEYS, j_report.VIOLATION_KEYS),
                         (report.LINT_KEYS, j_report.PALLAS_KEYS)):
        assert set(mine) == set(theirs)


def _broken(doc):
    yield dict(doc, schema_version=report.ANALYSIS_SCHEMA_VERSION + 1)
    yield dict(doc, kind="bench")
    yield {k: v for k, v in doc.items() if k != "kernel_lint"}
    yield dict(doc, surprise=1)
    yield dict(doc, skipped=[{"preset": "x"}])
    bad_graph = json.loads(json.dumps(doc))
    del bad_graph["presets"]["kv8_tp1_spec0"]["graphs"]["decode"]["n_eqns"]
    yield bad_graph
    bad_viol = json.loads(json.dumps(doc))
    bad_viol["presets"]["kv8_tp1_spec0"]["graphs"]["decode"]["violations"] = [
        dict(rule="r", graph="g", scope="")]
    yield bad_viol


def test_report_rejections_equal_reference():
    _, tdoc = _both()
    n = 0
    for bad in _broken(tdoc):
        with pytest.raises(report.AnalysisSchemaError) as mine:
            report.validate_report(bad)
        with pytest.raises(j_report.AnalysisSchemaError) as theirs:
            j_report.validate_report(_to_ref(bad))
        msg = str(theirs.value)
        for old, new in RENAMED.items():
            msg = msg.replace(old, new)
        assert str(mine.value) == msg
        n += 1
    assert n == 7


def test_ratchet_equals_reference():
    base_j, base_t = _both(("exp",))
    for kw in ({"float_prims": ("exp",)}, {"float_prims": ()},
               {"float_prims": ("exp", "mm")}, {"preset": "other"},
               {"preset": "other", "skipped": [{"preset": "kv8_tp1_spec0", "reason": "r"}]}):
        cur_j, cur_t = _both(**kw)
        assert report.compare_to_baseline(cur_t, base_t) == \
            j_report.compare_to_baseline(_to_ref(cur_j), _to_ref(base_j))
    assert report.compare_to_baseline(_both(("exp", "mm"))[1], base_t)


def test_presets_equal_reference():
    assert analyze.PRESETS == j_analyze.PRESETS
    assert [analyze.preset_name(*p) for p in analyze.PRESETS] == \
        [j_analyze.preset_name(*p) for p in j_analyze.PRESETS]


@pytest.mark.parametrize("kw", [dict(PAGED, spec_k=3), dict(PAGED, kv_bits=4),
                                dict(batch_slots=4, max_len=64, cache_layout="contiguous")],
                         ids=["paged_spec3", "paged_kv4", "contiguous"])
def test_hot_graph_names_equal_reference(folded, kw):
    jcfg, jfolded, cfg, tfolded = folded
    jnames = list(JE.Engine(jcfg, jfolded, JE.EngineConfig(**kw)).hot_graphs())
    assert list(E.Engine(cfg, tfolded, E.EngineConfig(**kw)).hot_graphs()) == jnames


def test_fixture_rules_and_boundaries_cover_reference():
    mine = {fx.expected_rule for fx in fixtures.FIXTURES.values()}
    assert {fx.expected_rule for fx in j_fixtures.FIXTURES.values()} <= mine
    assert set(j_fixtures.FIXTURES) <= set(fixtures.FIXTURES)
    assert {"dequantize_kv_pool", "_dequant_paged_view"} <= set(boundary.REGISTRY)
    assert {"int_matmul", "_head_product"} <= set(boundary.EXACT)


# --- the port's tree --------------------------------------------------------------

def test_presets_audit_clean(audited):
    presets, doc = audited
    assert set(doc["presets"]) == {analyze.preset_name(*p) for p in analyze.PRESETS}
    assert doc["skipped"] == []
    assert doc["violations_total"] == 0, [
        v for p in doc["presets"].values() for g in p["graphs"].values()
        for v in g["violations"]] + doc["kernel_lint"]["violations"]
    for pname, (config, results, hbm) in presets.items():
        assert set(results) == ({"decode", "prefill_chunk", "verify"} if config["spec_k"]
                                else {"decode", "prefill_chunk"})
        for gname, res in results.items():
            assert res.n_eqns > 100, (pname, gname)
            assert not res.float_prims & graph_audit.MATMUL_OPS, (pname, gname)
            # every integer product of the plain path is an exact one, far inside its
            # carrier for any operands of its static range, and this run's inside that
            assert 0 < res.exact_ratio_seen <= res.exact_ratio < 0.01
            assert res.launched == {}            # the CPU runs the plain versions
            assert hbm[gname]["int8"] > 0 and hbm[gname]["uint8"] > 0


def test_committed_baseline_holds(audited):
    _, doc = audited
    base = json.loads(analyze.BASELINE.read_text())
    report.validate_report(base)
    assert report.count_violations(base) == 0
    assert set(base["presets"]) == set(doc["presets"])
    assert report.compare_to_baseline(doc, base) == []


def test_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "ANALYSIS.json"
    assert analyze.main(["--device", "cpu", "--out", str(out),
                         "--baseline", str(analyze.BASELINE)]) == 0
    doc = report.validate_report(json.loads(out.read_text()))
    assert doc["violations_total"] == 0 and len(doc["presets"]) == 6
    assert "ratchet" in capsys.readouterr().out
    assert analyze.main(["--device", "cpu", "--self-test"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            analyze.main(["--self-test"])


@pytest.mark.parametrize("name", list(fixtures.FIXTURES))
def test_fixture_fires_its_rule(name):
    fx = fixtures.FIXTURES[name]
    rules = {v.rule for v in fx.run()}
    if fx.expected_rule:
        assert fx.expected_rule in rules
    else:
        assert rules == set()


def test_cost_counts_top_level_ops():
    @boundary.kernel_launch
    def fake_kernel(x):
        return (x.to(torch.int32) * 2).to(torch.int8)

    @boundary.kernel_launch
    def launching_kernel(x):
        # a wrapper counts its launches on itself; the recorder reads the count
        launching_kernel.launches += 2
        return x

    fake_kernel.launches = 0
    launching_kernel.launches = 0

    def step(x, w):
        from repro_torch.kernels import ref
        return fake_kernel(x), ref.int_matmul(x, w), w[0]

    x = torch.ones((4, 8), dtype=torch.int8)
    w = torch.ones((8, 2), dtype=torch.uint8)
    _, res = graph_audit.record(step, (x, w))
    assert cost.op_counts(res.ops) == {"launch": 1, "exact": 1}   # the view moves nothing
    assert cost.bytes_by_dtype(res.ops) == {"int8": 2 * 32 + 32, "uint8": 0.5 * 16,
                                            "int32": 4 * 8}
    assert [op.name for op in res.ops if op.in_launch] == ["_to_copy", "mul", "_to_copy"]
    # the launches each wrapper's own counter took: none where it ran its plain version
    assert res.launched == {}
    _, res = graph_audit.record(launching_kernel, (x,))
    assert res.launched == {"launching_kernel": 2}


def test_kernel_lint_reads_the_tree():
    assert kernel_lint.check_arg_order() == []
    assert kernel_lint.check_shared_body() == []
    entries = kernel_lint.parse_ptxas(fixtures.OVER_BUDGET_LOG)
    assert entries == [{"entry": "_Z14fixture_kernelPKaPa", "registers": 96, "smem": 239616,
                        "spill_stores": 0, "spill_loads": 0}]
    if not torch.cuda.is_available():
        # the lint's entry points run the kernels unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA card"):
            kernel_lint.run_all()
        with pytest.raises(RuntimeError, match="CUDA card"):
            kernel_lint.check_index_bounds()
    ok = {"check": "arg_order", "kernel": "*", "ok": True, "detail": ""}
    refused = {"check": "memcheck", "kernel": "*", "ok": False,
               "detail": kernel_lint.UNAVAILABLE + "the tool refuses the device"}
    found = {"check": "memcheck", "kernel": "*", "ok": False, "detail": "1 violation(s)"}
    assert kernel_lint.failed_checks({"checks": [ok, refused]}) == []
    assert kernel_lint.failed_checks({"checks": [ok, refused, found]}) == [found]


# --- the scopes change nothing ------------------------------------------------------------

def _clone(tree):
    return [_clone(t) for t in tree] if isinstance(tree, list) else \
        {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_recording_is_transparent(folded, kv_bits):
    """One served engine's decode step, from the same cache, with the
    recorder on and off: bit-equal logits and cache."""
    _, _, cfg, tfolded = folded
    eng = E.Engine(cfg, tfolded, E.EngineConfig(**PAGED, kv_bits=kv_bits))
    rng = np.random.default_rng(0)
    for n in (9, 20):
        eng.submit(E.Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                             max_new_tokens=4))
    for _ in range(3):
        eng.poll()
    fn, (fd, cache, _, pos, btab) = eng.hot_graphs()["decode"]
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32))
    plain_logits, plain_cache = fn(fd, _clone(cache), tok, pos, btab)
    (logits, rec_cache), res = graph_audit.record(fn, (fd, _clone(cache), tok, pos, btab))
    assert res.n_eqns > 100
    assert torch.equal(logits, plain_logits)
    for (p, a), (_, b) in zip(graph_audit.cache_leaves(rec_cache),
                              graph_audit.cache_leaves(plain_cache)):
        assert torch.equal(a, b), p


def test_auditing_leaves_the_engine_serving(folded):
    """An engine audited mid-run serves the same tokens as one never
    audited, and the audit writes nothing into its pool."""
    _, _, cfg, tfolded = folded
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 30)]

    def run(audit):
        eng = E.Engine(cfg, tfolded, E.EngineConfig(**PAGED, spec_k=3))
        reqs = [E.Request(prompt=p, max_new_tokens=6) for p in prompts]
        for r in reqs:
            eng.submit(r)
        for tick in range(200):
            if not eng.has_work:
                break
            if audit and tick == 2:
                before = _clone(eng.cache)
                results = graph_audit.audit_engine(eng)
                assert all(not r.violations for r in results.values())
                for (p, a), (_, b) in zip(graph_audit.cache_leaves(eng.cache),
                                          graph_audit.cache_leaves(before)):
                    assert torch.equal(a, b), p
            eng.poll()
        return [r.out.tolist() for r in reqs]

    assert run(True) == run(False)
