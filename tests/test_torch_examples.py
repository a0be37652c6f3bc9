"""The port's two example modules against the reference's example scripts:
``launch/train_bert_sst2.py`` (the paper's Table I experiment: its synthetic
SST-2 batches, its held-out accuracies under FQ and fp32 execution, its
command line) and ``launch/serve_quantized.py`` (its request stream through
``make_engine``).

The reference examples are scripts whose top level trains or serves, so
their code is read with ``ast``, never imported: ``make_batch`` is taken
out of ``examples/train_bert_sst2.py`` and run alone, and the held-out
evaluation and the request stream are the scripts' lines.
"""
import ast
import dataclasses
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.policy import POLICY_FP32 as J_FP32
from repro.launch.serve import calibrated_folded as j_calibrated_folded
from repro.models import bert as JB
from repro.serve import engine as JE
from repro_torch.launch import serve_quantized as SQ
from repro_torch.launch import train_bert_sst2 as SST
from repro_torch.models import fold as F

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_make_batch(vocab):
    """``make_batch`` of ``examples/train_bert_sst2.py``, compiled alone
    with the globals it reads (``np``, ``jnp``, ``cfg.vocab_size``)."""
    tree = ast.parse((EXAMPLES / "train_bert_sst2.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_batch")
    scope = {"np": np, "jnp": jnp, "cfg": types.SimpleNamespace(vocab_size=vocab)}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "train_bert_sst2.py", "exec"), scope)
    return scope["make_batch"]


@pytest.mark.parametrize("vocab", [512, 30522])
def test_make_batch_equals_reference(vocab):
    want = _reference_make_batch(vocab)
    for step in [0, 1, 149, *range(1000, 1010)]:
        got, ref = SST.make_batch(vocab, step), want(step)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    assert SST.make_batch(vocab, 3, 32, 128)["tokens"].shape == (32, 128)


def test_held_out_accuracies_equal_reference():
    """The reference's init weights, calibrated by one classify forward,
    carried across: each held-out batch's FQ and fp32 accuracy equals the
    reference's ``bert_classify``'s (the evaluation lines of the script)."""
    jcfg = j_smoke("bert-base", d_model=128, n_layers=2)
    cfg = SST.sst2_config()
    assert (cfg.d_model, cfg.n_layers, cfg.vocab_size) == (jcfg.d_model, jcfg.n_layers,
                                                          jcfg.vocab_size)
    params = JB.init_bert_params(jcfg, KEY)
    # a classifier wide enough that the predictions follow the inputs
    params["classifier"]["w"] = jnp.asarray(
        np.random.default_rng(0).normal(0, 4, params["classifier"]["w"].shape), jnp.float32)
    calib = SST.make_batch(jcfg.vocab_size, 0)
    _, obs, _ = JB.bert_classify(jcfg, params, JB.init_bert_amax(jcfg),
                                 jnp.asarray(calib["tokens"]), jnp.asarray(calib["mask"]))
    amax = obs
    jcfg_fp = dataclasses.replace(jcfg, quant=J_FP32)
    classify = {name: jax.jit(lambda p, a, t, m, c=c: JB.bert_classify(c, p, a, t, m)[0])
                for name, c in (("fq", jcfg), ("fp32", jcfg_fp))}
    want = {"fq": [], "fp32": []}
    for step in SST.HELD_OUT:
        b = SST.make_batch(jcfg.vocab_size, step)
        for name, fn in classify.items():
            lg = fn(params, amax, jnp.asarray(b["tokens"]), jnp.asarray(b["mask"]))
            want[name].append(float((lg.argmax(-1) == b["labels"]).mean()))
    got = SST.held_out(cfg, F.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                       F.params_from_numpy(jax.tree.map(np.asarray, amax), "cpu"), "cpu")
    print(f"held-out FQ {got['fq']:.4f} fp32 {got['fp32']:.4f}")
    assert got == {k: float(np.mean(v)) for k, v in want.items()}
    assert 0.2 < got["fq"] < 0.8 and 0.2 < got["fp32"] < 0.8


def test_train_bert_sst2_main_prints_the_reference_lines(capsys):
    """Two steps on the CPU: the script's step lines (step 0 and the last)
    and its held-out line, in the reference's formats."""
    state, history, accs = SST.main(["--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and len(history) == 2 and int(state.step) == 2
    for line, step in zip(lines, (0, 1)):
        assert re.fullmatch(rf"step {step:4d} loss \d+\.\d{{4}} acc [01]\.\d{{3}}", line), line
    assert re.fullmatch(r"held-out acc  FQ\(QAT\)=[01]\.\d{3}  fp32-exec=[01]\.\d{3}  "
                        r"drop=-?[01]\.\d{3} \(paper: 0\.8% on SST-2\)", lines[2]), lines[2]
    assert all(np.isfinite(loss) for loss, _ in history) and set(accs) == {"fq", "fp32"}


def _reference_requests(cfg, n, max_new):
    """The request stream of ``examples/serve_quantized.py`` (its list
    comprehension, read out of the script)."""
    src = (EXAMPLES / "serve_quantized.py").read_text()
    expr = re.search(r"reqs = (\[Request\(.*?for _ in range\(args\.requests\)\])", src,
                     re.S).group(1)
    scope = {"np": np, "Request": JE.Request, "cfg": cfg,
             "args": types.SimpleNamespace(requests=n, max_new=max_new),
             "rng": np.random.default_rng(0)}
    return eval(expr, scope)


def test_serve_quantized_equals_reference_engine(capsys):
    """The example's requests (3 slots, 6 requests, 8 new tokens) on the
    reference's folded smoke yi-6b, carried across: the port's outputs equal
    the reference engine's ``generate``; then the module's command line."""
    jcfg = j_smoke("yi-6b")
    jfolded = j_calibrated_folded(jcfg, KEY, jax.random.randint(KEY, (2, 32), 0,
                                                                 jcfg.vocab_size))
    jreqs = _reference_requests(jcfg, 6, 8)
    JE.make_engine(jcfg, jfolded, JE.EngineConfig(batch_slots=3, max_len=128)).generate(jreqs)
    cfg = SQ.smoke_config("yi-6b")
    eng, reqs = SQ.serve(cfg, F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu"),
                         3, 6, 8)
    assert [r.prompt.tolist() for r in reqs] == [r.prompt.tolist() for r in jreqs]
    assert [r.out.tolist() for r in reqs] == [r.out.tolist() for r in jreqs]
    assert eng.counters["decode_steps"] > 0
    out = SQ.main(["--device", "cpu", "--slots", "2", "--requests", "3", "--max-new", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and len(lines) == 4
    assert lines[0].startswith(f"req0: prompt[{len(out[0].prompt)}]=") and \
        lines[0].endswith(f"-> {out[0].out.tolist()}")
    assert lines[3].startswith("engine stats: {")
    assert torch.device(eng.device).type == "cpu"
