"""The training compute split over the model axis for xLSTM, the audio
codebooks and LM heads, and the vision stub (``jit_train_step(...,
model_compute="split")``, the reference's model rules for xlstm-1.3b,
musicgen-medium and qwen2-vl-2b), against the reference at smoke size:
xlstm-1.3b cut to its sLSTM slot and one mLSTM slot (2 layers, d_model 128,
``n_heads=4`` on both packages, so a model axis of 4 runs one head a rank),
musicgen-medium (2 layers, 4 codebooks of 512, 4 heads), qwen2-vl-2b (2
layers, 2 KV heads, M-RoPE sections (4, 6, 6), 8 image rows before 16 text
tokens), on batches of 4 rows of 16 tokens.

Bounds, stated before these tests first ran (the step comparisons were
measured with a throwaway script first):

* The split mLSTM and sLSTM on a local model group of 2 and 4 against the
  whole functions, zero amax: every column part bit for bit (q/k/v, the
  four sLSTM gates), the observed maxima equal, ``ln_y``'s mean square of
  each row bit for bit the whole row's (``xla_row_sum``'s order) on the
  rows the split normalizes, the row-parallel ``wo`` / ``w_out`` output
  within ``ROW_ULPS`` float32 ulps of its largest element.  Found when
  these tests first ran: with one head a rank (m = 4) the mLSTM's gate
  pre-activations are not the whole forward's bits (``x @ w_ig`` with one
  column of ``w_ig`` a rank takes the CPU's matrix-vector product, another
  order; two columns a rank are bit-equal), and so neither are the rows
  ``ln_y`` normalizes (49 of 80 rows' mean squares apart); the mean square
  is therefore held on the split's own rows.
* ``layers.xla_row_sum_parts`` equal to ``xla_row_sum`` of the whole row
  bit for bit, and ``collectives.model_blocks``' gradient the ranks'
  blocks assembled bit for bit (a -0.0 stays -0.0).
* The codebook lookup over vocab blocks equal to the whole table's bit for
  bit.
* The vocab-parallel cross-entropy of 4 heads' (B, K, S, V) logits on 2
  and 4 vocab blocks against ``_sharded_ce``: the target's logit bit for
  bit, the loss and every element of its gradient within ``ROW_ULPS`` ulps
  of the loss / the gradient's largest element.
* qwen2-vl's image rows: no image row's logit reaches the split loss.
* The one-process "split" step on (1, 2), (2, 2) and, where the heads
  allow, (1, 4), 2 steps from the reference's initial state (zero amax: on
  (2, 2) the fill runs): the first step's loss, grad norm, gradient (the
  first moment), amax and params (within 2 x lr), the second step's loss
  and grad norm within the trainer's drift bounds (``DRIFT``, or the
  arch's own loss bound where it is wider), against the reference's jitted
  step and the port's unsharded step, at ``NORM_ISLAND`` or the arch's own
  ``ISLAND`` where it is wider (musicgen's P.V), entry by entry.  Measured
  first: musicgen and qwen2-vl within 1.2e-5 of both in loss and grad
  norm and 1.8e-4 of a leaf's largest gradient element; xlstm's first step
  within 3.2e-5 of the reference (its gradient 5.3e-3 of a leaf's largest
  element), but its second loss 2.46e-4 from the reference on (1, 2) and
  (2, 2), where it equals the unsharded port's step, and 2.46e-4 from the
  unsharded port on (1, 4), where it lands on the reference's side (1.5e-7
  from it): the port's own xLSTM island, which its unsharded step crosses
  against the reference (2.46e-4 at the second step) and the split crosses
  or not with the rows the row sums add.  So xlstm's second-step loss
  bound is ``XLSTM_SECOND`` (5e-4 and 2e-2), not ``DRIFT``'s 2e-4.
* A model axis of 1: "split" equals "gather" bit for bit.
* The process step (gloo, one process a rank) on every case's mesh: every
  rank's every leaf and every metric equal to the one-process "split"
  step's, bit for bit; every replicated leaf's gradient (xLSTM's
  ``w_ig``, ``w_fg``, ``w_og``, ``ln_y`` and ``r`` among them) the same
  digest on the model ranks of a data rank; each rank's tally of
  collectives equal to the reckoning from the specs and the config
  (``test_torch_megatron_moe.reckon_split_collectives``: the window sums'
  and the replicated blocks' gathers, a lookup a codebook, the scored rows
  only).
"""
import functools
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.launch import ranks as R
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as Xl
from repro_torch.optim import adamw as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt
from repro_torch.train import steps as St
from test_torch_megatron import ROW_ULPS, _leaves_equal
from test_torch_megatron_moe import _against, _blocks, _recording, _run, _ulps, \
    reckon_split_collectives
from test_torch_mesh_train import NORM_ISLAND, _mesh, _tb
from test_torch_train import ISLAND, LR, _flat, _jinit, _np, _t, _torch_state

XLSTM, MUSICGEN, VL = "xlstm-1.3b", "musicgen-medium", "qwen2-vl-2b"
ARCHS = [XLSTM, MUSICGEN, VL]
SHAPE = (4, 16)
N_IMG = 8                   # the vision stub's image rows before each row's tokens
OVER = {XLSTM: dict(n_heads=4, n_kv_heads=4, head_dim=32, n_layers=2, block_pattern=("s", "x")),
        MUSICGEN: {}, VL: dict(mrope_sections=(4, 6, 6))}
TOL = {a: tuple(max(x, y) for x, y in zip(NORM_ISLAND, ISLAND.get(a, NORM_ISLAND)))
       for a in ARCHS}
XLSTM_SECOND = (5e-4, 2e-2)  # xlstm's second-step loss and grad norm (module docstring)
TIMEOUT_S = 120.0
EPS = float(torch.finfo(torch.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under
    pytest-xdist's workers every worker's threads contend for the same
    cores; the worker's own count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- (a) the split xLSTM mixers, ln_y's row sum, the replicated blocks ---------------

MIXER_SPLIT = {"mlstm": {"wq": -1, "wk": -1, "wv": -1, "wo": 0, "b_ig": 0, "b_fg": 0, "b_og": 0},
               "slstm": {"w_z": -1, "w_i": -1, "w_f": -1, "w_o": -1, "b_z": 0, "b_i": 0,
                         "b_f": 0, "b_o": 0, "w_out": 0}}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_split_xlstm_mixer_equals_the_whole(mixer, m, monkeypatch):
    cfg = smoke_config(XLSTM, **OVER[XLSTM])
    gen = torch.Generator()
    gen.manual_seed(m)
    p = T.init_slot_params(cfg, mixer, "none", gen)["mixer"]
    split = {k: _blocks(v, MIXER_SPLIT[mixer][k], m) if k in MIXER_SPLIT[mixer] else v
             for k, v in p.items()}
    x = _t(np.random.default_rng(m).normal(0, 1, (2, 40, cfg.d_model)).astype(np.float32))
    amax = {s: torch.tensor(0.0) for s in (Xl.MLSTM_SITES if mixer == "mlstm"
                                           else Xl.SLSTM_SITES)}
    fn = Xl.mlstm_qat if mixer == "mlstm" else Xl.slstm_qat
    seen = {"whole": {"cols": [], "sums": []}, "split": {"cols": [], "sums": []}}
    monkeypatch.setattr(Xl, "qdense_column", _recording(Xl, "qdense_column",
                                                        seen["whole"]["cols"]))
    monkeypatch.setattr(L, "xla_row_sum", _recording(L, "xla_row_sum", seen["whole"]["sums"]))
    y, obs, _ = fn(x, p, amax, cfg.quant, cfg)
    monkeypatch.undo()
    monkeypatch.setattr(Xl, "qdense_column", _recording(Xl, "qdense_column",
                                                        seen["split"]["cols"]))
    monkeypatch.setattr(L, "xla_row_sum_parts", _recording(L, "xla_row_sum_parts",
                                                           seen["split"]["sums"]))
    with Pt.model_split(C.ModelRanks(m)):
        ys, obs_s, _ = fn(x, split, amax, cfg.quant, cfg)
    cols_w, cols_s = seen["whole"]["cols"], seen["split"]["cols"]
    assert len(cols_w) == len(cols_s) == (3 if mixer == "mlstm" else 4)
    for (_, (yw, _)), (_, (parts, _)) in zip(cols_w, cols_s, strict=True):
        assert len(parts) == m and torch.equal(torch.cat(parts, -1), yw[0])
    assert {k: float(v) for k, v in obs_s.items()} == {k: float(v) for k, v in obs.items()}
    differ = ""
    if mixer == "mlstm":      # ln_y's mean square of the rows the split normalizes
        (_, whole_ms), = seen["whole"]["sums"]
        ((squares, _), split_ms), = seen["split"]["sums"]
        assert len(split_ms) == m
        assert all(torch.equal(t, L._row_sum_ordered(torch.cat(squares, -1), 32))
                   for t in split_ms)
        differ = f"; the mean square {int((split_ms[0] != whole_ms).sum())} of " \
                 f"{whole_ms.numel()} rows apart from the whole forward's"
    print(f"  {mixer} m={m}: the output {_ulps(ys, y):.3g} ulps of its largest from the "
          f"whole ({int((ys != y).sum())} of {y.numel()} differ){differ}")
    assert _ulps(ys, y) <= ROW_ULPS


@pytest.mark.parametrize("m", [2, 4])
def test_split_row_sum_and_replicated_blocks_are_exact(m):
    rng = np.random.default_rng(10 + m)
    d = 32 * m * 3
    x = _t(rng.normal(0, 1, (3, 5, d)).astype(np.float32)).requires_grad_(True)
    parts = list(x.chunk(m, -1))
    sums = L.xla_row_sum_parts(parts, C.ModelRanks(m))
    whole = L.xla_row_sum(x.detach())
    assert all(torch.equal(s, whole) for s in sums)
    gs = [_t(rng.normal(0, 1, (3, 5)).astype(np.float32)) for _ in range(m)]
    (g,) = torch.autograd.grad(sums, x, gs)
    total = gs[0]
    for t in gs[1:]:
        total = total + t
    assert torch.equal(g, total[..., None].expand(x.shape))
    w = _t(rng.normal(0, 1, (6, 4 * m)).astype(np.float32)).requires_grad_(True)
    blocks = C.model_blocks(C.ModelRanks(m), w, -1)
    assert torch.equal(torch.cat(blocks, -1), w.detach())
    gb = [torch.full((6, 4), -0.0) if r == 0 else torch.full((6, 4), float(r)) for r in range(m)]
    (gw,) = torch.autograd.grad(blocks, w, gb)
    assert torch.equal(gw, torch.cat(gb, -1)) and bool(torch.signbit(gw[:, :4]).all())


# --- (b) the codebooks, the K heads' cross-entropy, the image rows ----------------------

@pytest.mark.parametrize("m", [2, 4])
def test_codebook_lookup_over_vocab_blocks_is_the_whole_lookup(m):
    cfg = smoke_config(MUSICGEN)
    gen = torch.Generator()
    gen.manual_seed(m)
    params = T.init_params(cfg, gen)
    codes = _t(np.random.default_rng(m).integers(0, cfg.vocab_size, (3, cfg.n_codebooks, 20))
               .astype(np.int32))
    whole = T.embed(cfg, params, codes)
    split = {"embed": {"codebooks": _blocks(params["embed"]["codebooks"], 1, m)}}
    with Pt.model_split(C.ModelRanks(m)), C.tally() as tally:
        got = T.embed(cfg, split, codes)
    assert torch.equal(got, whole)
    assert tally[("all-reduce", "model_sum")][0] == cfg.n_codebooks


@pytest.mark.parametrize("m", [2, 4])
def test_k_head_vocab_parallel_ce_equals_the_whole_ce(m):
    rng = np.random.default_rng(20 + m)
    lg = _t(rng.normal(0, 3, (3, 4, 15, 512)).astype(np.float32))
    tgt = _t(rng.integers(0, 512, (3, 4, 15)).astype(np.int32))
    whole = lg.clone().requires_grad_(True)
    loss = St._sharded_ce(whole, tgt)
    (g,) = torch.autograd.grad(loss, whole)
    parts = [c.clone().requires_grad_(True) for c in lg.chunk(m, -1)]
    picked, inner = [], C.reduce_from_model

    def rec(group, partials):
        out = inner(group, partials)
        picked.append(out)
        return out

    C.reduce_from_model = rec
    try:
        with Pt.model_split(C.ModelRanks(m)):
            loss_s = St._vocab_parallel_ce({str(r): t for r, t in enumerate(parts)}, tgt)
    finally:
        C.reduce_from_model = inner
    g_s = torch.cat(torch.autograd.grad(loss_s, parts), -1)
    assert torch.equal(picked[1], torch.gather(lg, -1, tgt.long()[..., None])[..., 0])
    off = abs(float(loss_s.detach()) - float(loss)) / (EPS * abs(float(loss)))
    print(f"  m={m}: the loss {off:.3g} ulps from the whole CE's, its gradient "
          f"{_ulps(g_s, g):.3g} ulps of the largest")
    assert off <= ROW_ULPS and _ulps(g_s, g) <= ROW_ULPS


def test_image_rows_are_not_scored(monkeypatch):
    """qwen2-vl's vocab-parallel loss takes the text rows alone: image rows'
    logits set to anything leave it as it was, and it equals the whole
    cross-entropy of the text rows."""
    cfg = smoke_config(VL, **OVER[VL])
    rng = np.random.default_rng(3)
    b, s, v = 2, 12, cfg.vocab_size
    lg = _t(rng.normal(0, 3, (b, N_IMG + s, v)).astype(np.float32))
    tokens = _t(rng.integers(0, v, (b, s)).astype(np.int32))
    batch = {"tokens": tokens, "extra_embeds": torch.zeros((b, N_IMG, cfg.d_model))}
    obs, aux = {}, torch.zeros(())
    losses = []
    for fill in (None, float("nan"), 1e4):
        full = lg.clone()
        if fill is not None:
            full[:, :N_IMG] = fill
        monkeypatch.setattr(T, "forward", lambda *a, full=full, **k: (
            {str(r): c for r, c in enumerate(full.chunk(2, -1))}, obs, aux))
        with Pt.model_split(C.ModelRanks(2)):
            losses.append(float(St.lm_loss(cfg, {}, {}, batch)[0]))
    want = float(St._sharded_ce(lg[:, :-1][:, N_IMG:], tokens[:, 1:]))
    print(f"  the split loss {losses}, the whole CE of the text rows {want}")
    assert losses[0] == losses[1] == losses[2]
    assert abs(losses[0] - want) <= ROW_ULPS * EPS * abs(want)


# --- (c) the one-process "split" step --------------------------------------------------

def _batches(cfg):
    audio = cfg.frontend == "audio_codebooks"
    src = JSyntheticLM(cfg.vocab_size, SHAPE[1], SHAPE[0], seed=0,
                       n_codebooks=cfg.n_codebooks if audio else 0,
                       vlm_patches=N_IMG if cfg.frontend == "vision_stub" else 0,
                       d_model=cfg.d_model)
    return [src.batch_at(i) for i in range(2)]


@pytest.fixture(scope="module")
def references():
    """Each arch's reference initial state and its jitted step's states and
    metrics on two batches, built once."""
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch, **OVER[arch])
        opt = JA.AdamWConfig(lr=LR)
        jstate = _jinit(jcfg, opt)
        step, s, states, ms = jax.jit(JSt.make_train_step(jcfg, opt)), jstate, [], []
        for b in _batches(jcfg):
            s, m = step(s, b)
            states.append(s)
            ms.append({k: float(v) for k, v in m.items()})
        out[arch] = (smoke_config(arch, **OVER[arch]), jstate, states, ms)
    return out


CASES = {f"{a}-{d}x{m}": (a, (d, m)) for a in ARCHS for d, m in ((1, 2), (2, 2), (1, 4))
         if not (a == VL and m == 4)}


@pytest.fixture(scope="module")
def split_runs(references):
    """Each case's one-process "split" run and each arch's unsharded port
    run: {name: (first, metrics, shards)}, {arch: ...}."""
    opt = A.AdamWConfig(lr=LR)
    out, unsharded = {}, {}
    for name, (arch, shape) in CASES.items():
        cfg, jstate, _, _ = references[arch]
        batches = _batches(cfg)
        out[name] = _run(cfg, shape, 1, _torch_state(jstate, opt), batches)
        if arch not in unsharded:
            unsharded[arch] = _run(cfg, (1, 1), 1, _torch_state(jstate, opt), batches,
                                   "gather")
    return out, unsharded


@pytest.mark.parametrize("name", list(CASES))
def test_one_process_split_step_matches_reference(references, split_runs, name):
    arch, _ = CASES[name]
    _, _, states, jms = references[arch]
    first, ms, _ = split_runs[0][name]
    second = XLSTM_SECOND if arch == XLSTM else None
    _against(f"{name} vs the reference", TOL[arch],
             {"m": _np(states[0].opt["m"]), "params": _flat(_np(states[0].params)),
              "amax": _flat(_np(states[0].amax))}, jms, first, ms, second)
    ufirst, ums, _ = split_runs[1][arch]
    _against(f"{name} vs the port unsharded", TOL[arch],
             {"m": ufirst.opt["m"], "params": _flat(ufirst.params), "amax": _flat(ufirst.amax)},
             ums, first, ms, second)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_on_a_model_axis_of_one_equals_gather(references, arch):
    cfg, jstate, _, _ = references[arch]
    opt = A.AdamWConfig(lr=LR)
    batches = _batches(cfg)
    got, ms, shards = _run(cfg, (2, 1), 1, _torch_state(jstate, opt), batches)
    want, wms, wshards = _run(cfg, (2, 1), 1, _torch_state(jstate, opt), batches, "gather")
    assert ms == wms
    assert not _leaves_equal(got, want)
    for a, b in zip(shards, wshards, strict=True):
        assert not _leaves_equal(a, b)


# --- (d) the process step ----------------------------------------------------------------

REPLICATED = {XLSTM: ("mixer/w_ig", "mixer/w_fg", "mixer/w_og", "mixer/ln_y", "mixer/r"),
              MUSICGEN: ("embed/pos", "attn/bo", "mlp/b2"), VL: ("norm1/gamma", "final_norm/gamma")}


@pytest.fixture(scope="module")
def process_runs(references, tmp_path_factory):
    """Every case's per-rank results: one start of 4 processes, one of 2."""
    d = tmp_path_factory.mktemp("megatron_xlstm")
    opt = A.AdamWConfig(lr=LR)
    paths = {}
    for arch in ARCHS:
        paths[arch] = str(d / f"{arch}.pt")
        torch.save(_torch_state(references[arch][1], opt), paths[arch])
    calls = {4: {}, 2: {}}
    for name, (arch, shape) in CASES.items():
        cfg = references[arch][0]
        calls[shape[0] * shape[1]][name] = functools.partial(
            R.train_steps, cfg, opt, _batches(cfg), mesh_shape=shape, device_type="cpu",
            state=paths[arch], model_compute="split")
    out = {}
    for n in (4, 2):
        t0 = time.perf_counter()
        res = R.run(R.in_turn, n, backend="gloo", device_type="cpu",
                    args=(list(calls[n].values()),), timeout_s=TIMEOUT_S)
        print(f"  the {n}-process start took {time.perf_counter() - t0:.1f} s")
        for i, name in enumerate(calls[n]):
            out[name] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_process_split_step_equals_the_one_process_split_step(split_runs, process_runs, name):
    arch, shape = CASES[name]
    _, metrics, shards = split_runs[0][name]
    got = process_runs[name]
    mesh = _mesh(*shape)
    assert len(got) == len(shards)
    for r, res in enumerate(got):
        assert res["metrics"] == metrics, (r, res["metrics"], metrics)
        differ = _leaves_equal(res["state"], shards[r])
        assert not differ, (r, differ[:5])
    replicated = got[0]["replicas"][0]
    assert all(any(p.endswith(w) for p in replicated) for w in REPLICATED[arch]), \
        (REPLICATED[arch], sorted(replicated))
    for r, res in enumerate(got):
        peer = [q for q in range(mesh.size) if mesh.coords(q)["data"] == mesh.coords(r)["data"]][0]
        assert res["replicas"] == got[peer]["replicas"], (r, peer)
    print(f"  {name}: {len(got)} ranks x 2 steps equal the one-process split step's; "
          f"{len(replicated)} replicated leaves' gradients equal on every model rank of a data "
          "rank")


@pytest.mark.parametrize("name", list(CASES))
def test_process_tally_equals_the_reckoning(references, process_runs, name):
    arch, shape = CASES[name]
    cfg = references[arch][0]
    rows = (SHAPE[0] // shape[0], SHAPE[1])
    n_img = N_IMG if cfg.frontend == "vision_stub" else 0
    opt = A.AdamWConfig(lr=LR)
    for step, fill in enumerate((shape[0] > 1, False)):
        want = reckon_split_collectives(cfg, opt, shape, rows, 1, fill, n_img)
        for r, res in enumerate(process_runs[name]):
            got = {k: list(v) for k, v in res["tally"][step].items()}
            assert got == want, (name, r, step, {k: (got.get(k), want.get(k))
                                                 for k in got.keys() | want.keys()
                                                 if got.get(k) != want.get(k)})
    t = process_runs[name][0]["tally"][1]
    print(f"  {name}: a rank's second step {t}")
    if arch == XLSTM:
        assert t[("all-gather", "model_gather")][0] > 0
