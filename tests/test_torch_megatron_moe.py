"""The training compute split over the model axis for the MoE expert FFN and
the Mamba mixer, and the vocab-parallel cross-entropy (``jit_train_step(...,
model_compute="split")``), against the reference at smoke size:
qwen2-moe-a2.7b and mixtral-8x22b (2 layers, d_model 128, 4 experts top-2,
qwen2-moe's 2 shared), jamba-1.5-large (4 slots of its super-block, every
kind of slot it has: Mamba with a dense MLP, Mamba with the 4 smoke
experts, attention with a dense MLP, Mamba with experts), on (4, 16)
batches.

Bounds, stated before these tests first ran (the step comparisons were
measured with a throwaway script first, and the bounds below name where
that measurement crossed an arch's own bound):

* The split expert FFN (qwen2-moe's routed and shared experts) and the split
  Mamba mixer on a local model group of 2 and 4 against the whole
  functions, zero amax: every column part bit for bit (the ``exp_g``,
  ``exp_u``, ``exp_h`` and ``shr_*`` sites' inputs, the ``mamba_conv``
  site's input), the observed maxima equal (the Mamba's ``mamba_in`` and
  ``mamba_conv``); the row sums (the experts' combined outputs, Mamba's
  ``w_x`` output and its mixer's output) within ``ROW_ULPS`` float32 ulps of
  the tensor's largest element; the chunked scan on a block of channels
  equal to that block of the whole scan bit for bit; ``model_exchange`` of
  the column blocks of a whole ``xz`` equal to slicing its x and z halves,
  its backward the inverse.
* The vocab-parallel cross-entropy on 2 and 4 vocab blocks against
  ``_sharded_ce`` of the whole logits: the target's logit bit for bit, the
  loss and every element of its gradient within ``ROW_ULPS`` ulps of the
  loss / the gradient's largest element (the float island of its order,
  printed).
* The one-process "split" step on (1, 2) and (2, 2), 2 steps from the
  reference's initial state (zero amax: on (2, 2) the fill runs), and
  qwen2-moe's (2, 2) step with 2 microbatches: the first step's loss, grad
  norm, gradient (the first moment), amax and params (within 2 x lr), the
  second step's loss and grad norm within the trainer's drift bounds
  (``DRIFT``, or the arch's own loss bound where it is wider), against the
  reference's jitted step and the port's unsharded step.  qwen2-moe and
  mixtral: ``NORM_ISLAND`` against both (``test_torch_moe_mesh.py``'s bound
  against the reference with one microbatch, and ``test_torch_megatron.
  py``'s for the split yi-6b step).  Measured first: with one microbatch
  both archs' split steps land within 7.2e-7 of the reference, and the
  port's unsharded step within 7.5e-4 (qwen2-moe) and 1.9e-3 (mixtral) of
  its leaf's largest gradient element, so ``EXACT`` against the unsharded
  port, ``test_torch_moe_mesh.py``'s bound for its data meshes, misses:
  the split's island (ROADMAP §3, the first differing site layer 0's
  residual sum after the row-parallel ``wo``) lands on the reference's
  side of the norms' island this draw crosses.  With 2 microbatches
  (2-row microbatches, 12 of 20 sites' codes moved) qwen2-moe's grad norm
  sits 9.6e-5 and its gradient 1.25e-2 from both.  jamba: ``ISLAND
  ["jamba-1.5-large-398b"]`` against both.  0 (token, choice) pairs may
  differ in routing between the first split step's forwards and the
  unsharded step's (a data rank's, its rows of them).  Found when these
  tests first ran: the check first took both steps (against the "gather"
  step on the same mesh), and jamba's second step rerouted 215 pairs on
  (1, 2) (32 to 80 a MoE layer), from a state that its first step's island
  had already moved (its forwards of the first step route alike); the
  second step's states differ, so its routing is not compared.
* The process step (gloo, one process a rank) on (1, 2) and (2, 2): every
  rank's every leaf and every metric equal to the one-process "split"
  step's, bit for bit; the router's and every replicated leaf's gradient
  the same digest on the model ranks of a data rank; each rank's tally of
  collectives equal to the reckoning from the specs and the config
  (``reckon_split_collectives``).
* ``check_split`` accepts the three archs on a model axis of 2 and 4, and
  item 5d's (xlstm-1.3b, musicgen-medium, qwen2-vl-2b) wherever the axis
  divides their widths; at full size on the dry run's 16-way model axis it
  raises for each naming its heads, and for an xLSTM whose d_model / m is
  not a whole number of ``ln_y``'s 32-wide windows.
"""
import functools
import math
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro.train import steps as JSt
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import ranks as R
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding import partition as Pt
from repro_torch.train import steps as St
from test_torch_megatron import DRIFT, ROW_ULPS, _leaves_equal, _reckon_gathers
from test_torch_mesh_train import NORM_ISLAND, _mesh, _tb
from test_torch_train import ISLAND, LR, _flat, _held, _jinit, _np, _t, _torch_state

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b", "jamba-1.5-large-398b"]
JAMBA = "jamba-1.5-large-398b"
SHAPE = (4, 16)
TOL = {"qwen2-moe-a2.7b": NORM_ISLAND, "mixtral-8x22b": NORM_ISLAND, JAMBA: ISLAND[JAMBA]}
ACCUM2 = "qwen2-moe-a2.7b"          # the arch of the case with 2 microbatches
# jamba's cut: its reference's jitted step compiles in ~38 s at 8 slots
CUT = {JAMBA: dict(n_layers=4, block_pattern=("m", "m", "a", "m"))}
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


def _blocks(t, dim, m):
    return {str(r): c.contiguous() for r, c in enumerate(t.chunk(m, dim))}


def _ulps(got, want):
    return float((got - want).abs().max()) / (EPS * float(want.abs().max()))


def _recording(module, name, store):
    """``module.name`` wrapped to append (args, result) of each call."""
    inner = getattr(module, name)

    def rec(*a, **k):
        out = inner(*a, **k)
        store.append((a, out))
        return out
    return rec


# --- (a) the split expert FFN and Mamba mixer against the whole ---------------------

@pytest.mark.parametrize("m", [2, 4])
def test_split_expert_ffn_equals_the_whole(m, monkeypatch):
    cfg = smoke_config("qwen2-moe-a2.7b")
    gen = torch.Generator()
    gen.manual_seed(m)
    p = T.init_slot_params(cfg, "attn", "moe", gen)["moe"]
    split = {"router": p["router"],
             **{g: {k: _blocks(w, 1 if k == "wd" else 2, m) for k, w in p[g].items()}
                for g in ("experts", "shared")}}
    x = _t(np.random.default_rng(m).normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32))
    amax = {s: torch.tensor(0.0) for s in M.MOE_SITES + M.MOE_SHARED_SITES}
    sites = {"whole": [], "split": []}
    monkeypatch.setattr(M, "fake_quant_parts", _recording(M, "fake_quant_parts", sites["whole"]))
    y, obs, aux = M.moe_qat(x, p, amax, cfg.quant, cfg)
    monkeypatch.undo()
    monkeypatch.setattr(M, "fake_quant_parts", _recording(M, "fake_quant_parts", sites["split"]))
    with Pt.model_split(C.ModelRanks(m)):
        ys, obs_s, aux_s = M.moe_qat(x, split, amax, cfg.quant, cfg)
    assert len(sites["whole"]) == len(sites["split"]) == 6
    for (aw, _), (as_, _) in zip(sites["whole"], sites["split"], strict=True):
        assert len(as_[0]) == m and torch.equal(torch.cat(as_[0], -1), aw[0][0])
    assert {k: float(v) for k, v in obs_s.items()} == {k: float(v) for k, v in obs.items()}
    assert float(aux_s) == float(aux)
    print(f"  m={m}: the experts' output {_ulps(ys, y):.3g} ulps of its largest from the whole "
          f"({int((ys != y).sum())} of {y.numel()} differ)")
    assert _ulps(ys, y) <= ROW_ULPS


def _mamba(m):
    cfg = smoke_config(JAMBA)
    gen = torch.Generator()
    gen.manual_seed(m)
    p = T.init_slot_params(cfg, "mamba", "none", gen)["mixer"]
    dims = {"w_in": -1, "conv_w": -1, "conv_b": 0, "w_x": 0, "w_dt": -1, "dt_bias": 0,
            "A_log": 0, "D": 0, "w_out": 0}
    return cfg, p, {k: _blocks(v, dims[k], m) for k, v in p.items()}


@pytest.mark.parametrize("m", [2, 4])
def test_split_mamba_mixer_equals_the_whole(m, monkeypatch):
    cfg, p, split = _mamba(m)
    x = _t(np.random.default_rng(m).normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32))
    amax = {s: torch.tensor(0.0) for s in Mb.MAMBA_SITES}
    rows = {"whole": [], "split": []}
    monkeypatch.setattr(Mb, "qdense_row", _recording(Mb, "qdense_row", rows["whole"]))
    y, obs, _ = Mb.mamba_qat(x, p, amax, cfg.quant, cfg)
    monkeypatch.undo()
    monkeypatch.setattr(Mb, "qdense_row", _recording(Mb, "qdense_row", rows["split"]))
    with Pt.model_split(C.ModelRanks(m)):
        ys, obs_s, _ = Mb.mamba_qat(x, split, amax, cfg.quant, cfg)
    (xc, (prm, _)), (xcs, (prm_s, _)) = rows["whole"][0], rows["split"][0]
    # w_x's input: the conv's channels (the column-parallel w_in, the exchange)
    assert torch.equal(torch.cat(xcs[0], -1), xc[0][0])
    for site in ("mamba_in", "mamba_conv"):
        assert float(obs_s[site]) == float(obs[site]), site
    print(f"  m={m}: w_x's row sum {_ulps(prm_s, prm):.3g} ulps of its largest, the mixer's "
          f"output {_ulps(ys, y):.3g}; observed maxima split {[float(obs_s[s]) for s in obs]}, "
          f"whole {[float(obs[s]) for s in obs]}")
    assert _ulps(prm_s, prm) <= ROW_ULPS and _ulps(ys, y) <= ROW_ULPS


@pytest.mark.parametrize("m", [2, 4])
def test_scan_and_exchange_are_exact_per_channel_block(m):
    cfg, p, _ = _mamba(m)
    d_in, _ = Mb.mamba_dims(cfg)
    rng = np.random.default_rng(m)
    bt, s, n = 2, 40, cfg.mamba_d_state        # S crosses no chunk; a ragged one below
    x, dt = (_t(rng.normal(0, 1, (bt, s, d_in)).astype(np.float32)) for _ in range(2))
    dt = torch.nn.functional.softplus(dt)
    B, C_ = (_t(rng.normal(0, 1, (bt, s, n)).astype(np.float32)) for _ in range(2))
    A_ = -torch.exp(p["A_log"])
    for steps in (s, 2 * Mb.CHUNK + 8):
        xx, dd = x.repeat(1, math.ceil(steps / s), 1)[:, :steps], \
            dt.repeat(1, math.ceil(steps / s), 1)[:, :steps]
        bb, cc = (t.repeat(1, math.ceil(steps / s), 1)[:, :steps] for t in (B, C_))
        whole = Mb.ssm_chunked(xx, dd, bb, cc, A_, p["D"])
        w = d_in // m
        for r in range(m):
            c = slice(r * w, (r + 1) * w)
            assert torch.equal(Mb.ssm_chunked(xx[..., c], dd[..., c], bb, cc, A_[c], p["D"][c]),
                               whole[..., c]), (steps, r)
    xz = _t(rng.normal(0, 1, (bt, s, 2 * d_in)).astype(np.float32)).requires_grad_(True)
    parts = list(xz.chunk(m, -1))
    out = C.model_exchange(C.ModelRanks(m), parts, 2)
    xi, z = xz.chunk(2, -1)
    for r, o in enumerate(out):
        want = torch.cat([xi.chunk(m, -1)[r], z.chunk(m, -1)[r]], -1)
        assert torch.equal(o, want), r
    gs = [torch.full_like(o, float(r + 1)) * o.detach() for r, o in enumerate(out)]
    (g,) = torch.autograd.grad(out, xz, gs)
    want = torch.cat([torch.cat([gs[r].chunk(2, -1)[h] for r in range(m)], -1) for h in range(2)],
                     -1)
    assert torch.equal(g, want)


# --- (b) the vocab-parallel cross-entropy --------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_ce_equals_the_whole_ce(m):
    rng = np.random.default_rng(m)
    lg = _t(rng.normal(0, 3, (4, 15, 512)).astype(np.float32))
    tgt = _t(rng.integers(0, 512, (4, 15)).astype(np.int32))
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
    off = abs(float(loss_s) - float(loss)) / (EPS * abs(float(loss)))
    print(f"  m={m}: the loss {off:.3g} ulps from the whole CE's, its gradient "
          f"{_ulps(g_s, g):.3g} ulps of the largest ({int((g_s != g).sum())} of {g.numel()} "
          f"elements differ)")
    assert off <= ROW_ULPS and _ulps(g_s, g) <= ROW_ULPS


# --- (c) the one-process "split" step ------------------------------------------------

def _batches(vocab):
    src = JSyntheticLM(vocab, SHAPE[1], SHAPE[0], seed=0)
    return [src.batch_at(i) for i in range(2)]


@pytest.fixture(scope="module")
def references():
    """Each arch's reference initial state and its jitted steps on two
    batches ({accum: (states, metrics)}; 2 microbatches for ``ACCUM2``
    only), built once."""
    out = {}
    for arch in ARCHS:
        jcfg = j_smoke(arch, **CUT.get(arch, {}))
        opt = JA.AdamWConfig(lr=LR)
        jstate = _jinit(jcfg, opt)
        runs = {}
        for accum in (1, 2) if arch == ACCUM2 else (1,):
            step, s, states, ms = jax.jit(JSt.make_train_step(jcfg, opt, accum_steps=accum)), \
                jstate, [], []
            for b in _batches(jcfg.vocab_size):
                s, m = step(s, b)
                states.append(s)
                ms.append({k: float(v) for k, v in m.items()})
            runs[accum] = (states, ms)
        out[arch] = (smoke_config(arch, **CUT.get(arch, {})), jstate, runs)
    return out


CASES = {f"{a}-{d}x2": (a, (d, 2), 1) for a in ARCHS for d in (1, 2)}
CASES[f"{ACCUM2}-2x2-accum2"] = (ACCUM2, (2, 2), 2)


def _routing(fn):
    """``fn()``'s routing at every MoE layer: {data rank or None: [dest,
    ...] in call order}, and ``fn()``'s result."""
    seen, inner = {}, M.plan

    def recorded(probs, idx, cap, *a):
        res = inner(probs, idx, cap, *a)
        me = C._current()
        seen.setdefault(None if me is None else me.rank, []).append(res[0].clone())
        return res

    M.plan = recorded
    try:
        out = fn()
    finally:
        M.plan = inner
    return out, seen


def _run(cfg, shape, accum, state, batches, model_compute="split"):
    """``jit_train_step``'s steps on the one-process ``shape`` mesh: (the
    state whole after the first step, metrics per step, the ranks' final
    states)."""
    step, sh, _ = St.jit_train_step(cfg, _mesh(*shape), A.AdamWConfig(lr=LR), _tb(batches[0]),
                                    accum_steps=accum, model_compute=model_compute,
                                    donate=False)
    shards, metrics, first = Pt.split_tree(state, sh), [], None
    for b in batches:
        shards, m = step(shards, _tb(b))
        metrics.append({k: float(v) for k, v in m.items()})
        first = Pt.gather_tree(shards, sh) if first is None else first
    return first, metrics, shards


@pytest.fixture(scope="module")
def split_runs(references):
    """Each case's one-process "split" run and its routing, and the port's
    unsharded steps and their routing: {name: ...}, built once for (c) and
    (d)."""
    out, unsharded = {}, {}
    opt = A.AdamWConfig(lr=LR)
    for name, (arch, shape, accum) in CASES.items():
        cfg, jstate, _ = references[arch]
        batches = _batches(cfg.vocab_size)
        run, routes = _routing(lambda: _run(cfg, shape, accum, _torch_state(jstate, opt),
                                            batches))
        if (arch, accum) not in unsharded:
            unsharded[(arch, accum)] = _routing(lambda: _run(
                cfg, (1, 1), accum, _torch_state(jstate, opt), batches, "gather"))
        out[name] = {"run": run, "routes": routes, "unsharded": unsharded[(arch, accum)][0],
                     "unsharded_routes": unsharded[(arch, accum)][1][None]}
    return out


def _against(what, tol, jfirst, jms, first, ms, second=None):
    """A split run against a reference: the first step's metrics,
    gradient, amax and params, the second step's loss and grad norm (within
    ``second``, by default the drift bounds or ``tol``'s loss bound)."""
    second = second or (max(DRIFT[0], tol[0]), max(DRIFT[1], tol[0]))
    for i, k in enumerate(("loss", "grad_norm")):
        rel = [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(ms, jms, strict=True)]
        print(f"  {what} {k}: {[a[k] for a in ms]} against {[b[k] for b in jms]}, relative "
              f"{[f'{r:.3g}' for r in rel]}")
        assert rel[0] <= tol[0] and rel[1] <= second[i], (k, rel)
    _held(f"{what} first step's gradient", jfirst["m"], first.opt["m"], tol[1], *tol[3:])
    jp, tp = jfirst["params"], _flat(first.params)
    assert max(float(np.max(np.abs(jp[k] - tp[k]))) for k in jp) <= 2 * LR
    ja, ta = jfirst["amax"], _flat(first.amax)
    worst = max(float(np.max(np.abs(ja[k] - ta[k]) / np.maximum(np.abs(ja[k]), 1e-30)))
                for k in ja)
    assert worst <= tol[2], (what, worst)


@pytest.mark.parametrize("name", list(CASES))
def test_one_process_split_step_matches_reference(references, split_runs, name):
    arch, shape, accum = CASES[name]
    _, _, ref = references[arch]
    run = split_runs[name]
    first, ms, _ = run["run"]
    states, jms = ref[accum]
    tol = TOL[arch]
    _against(f"{name} vs the reference", tol,
             {"m": _np(states[0].opt["m"]), "params": _flat(_np(states[0].params)),
              "amax": _flat(_np(states[0].amax))}, jms, first, ms)
    ufirst, ums, _ = run["unsharded"]
    _against(f"{name} vs the port unsharded", tol,
             {"m": ufirst.opt["m"], "params": _flat(ufirst.params), "amax": _flat(ufirst.amax)},
             ums, first, ms)
    # the first step's forwards (the unsharded step's first n_moe x accum):
    # the fill's, whole, and each data rank's, its rows of the unsharded
    cfg = references[arch][0]
    n_moe = accum * cfg.n_reps * sum(f == "moe" for _, f in T.slot_kinds(cfg))
    want, got = run["unsharded_routes"][:n_moe], run["routes"]
    pairs = list(zip(got[None][:n_moe], want, strict=True)) if shape[0] > 1 else []
    t = want[0].shape[1] // shape[0]
    for r in range(shape[0]):
        mine = got[r if shape[0] > 1 else None][:n_moe]
        pairs += [(a, b[:, r * t:(r + 1) * t]) for a, b in zip(mine, want, strict=True)]
    differ = sum(int((a != b).sum()) for a, b in pairs)
    print(f"  {name}: {len(pairs)} routings of the first step, {differ} (token, choice) pairs "
          f"differ from the unsharded step's")
    assert differ == 0


# --- (d) the process step ------------------------------------------------------------

def model_group_collectives(cfg, m: int, n_data: int, rows, grad: bool, add, n_img: int = 0):
    """``add(key, bytes, times)`` for each of one data rank's model-group
    collectives (and its MoE counts exchanges) in a "split" forward, and its
    backward when ``grad``, on a model axis of ``m``: ``rows`` (B, S) its
    token rows, ``n_img`` image rows prepended (the activations run over
    n_img + S).  A forward: the vocab-parallel lookup's sum (one a codebook
    for an audio arch); per attention layer the ``wo`` sum, 8 site maxima
    (float32) and 4 weight maxima (the weights' dtype); per Mamba layer
    ``w_x``'s and ``w_out``'s sums, 3 site and 3 weight maxima and one
    exchange; per mLSTM layer the ``wo`` sum, the gather of ``ln_y``'s
    float32 window sums, 2 site and 4 weight maxima; per sLSTM layer the
    ``w_out`` sum, 2 and 5 maxima; per dense MLP the down sum, 4 and 3
    maxima (SwiGLU) or 3 and 2 (GELU); per MoE layer the routed experts'
    combined float32 (T, d) sum and the shared experts' sum, 3 and 3 maxima
    per expert group (and, over more than one data rank, the counts exchange
    of a pass with a backward); the cross-entropy's row max and its two
    float32 sums over the scored rows.  A backward adds one sum per
    replicated input of column-parallel products (the attention's, the
    MLP's, the Mamba's and its (dt_r, B, C), an xLSTM mixer's, the MoE's
    tokens and combine weights, qk-norm's gammas, the LM head's), one
    exchange per Mamba layer, the sum of ``ln_y``'s row-sum gradient and
    the gathers of the replicated xLSTM leaves' gradient blocks (``w_ig``,
    ``w_fg``, ``w_og``, ``ln_y``; the sLSTM's ``r``); with remat a layer's
    forward runs twice."""
    b, s = rows
    es = torch.empty((), dtype=cfg.dtype).element_size()
    d = cfg.d_model
    d_in, dt_rank = Mb.mamba_dims(cfg)
    audio = cfg.frontend == "audio_codebooks"
    act, t = b * (n_img + s) * d * es, b * (n_img + s)
    fwd = 2 if grad and cfg.remat else 1
    add(("all-reduce", "model_sum"), b * s * d * es, cfg.n_codebooks if audio else 1)
    for mixer, ffn in T.slot_kinds(cfg) * cfg.n_reps:
        if mixer == "attn":
            add(("all-reduce", "model_sum"), act, fwd + grad)
            add(("all-reduce", "model_sum"), cfg.hd * es, 2 * grad * cfg.qk_norm)
            add(("all-reduce", "model_max"), 4, 8 * fwd)
            add(("all-reduce", "model_max"), es, 4 * fwd)
        elif mixer == "mamba":
            prm = t * (dt_rank + 2 * cfg.mamba_d_state) * es
            add(("all-reduce", "model_sum"), prm, fwd + grad)
            add(("all-reduce", "model_sum"), act, fwd + grad)
            add(("all-to-all", "model_exchange"), t * 2 * d_in // m * es, fwd + grad)
            add(("all-reduce", "model_max"), 4, 3 * fwd)
            add(("all-reduce", "model_max"), es, 3 * fwd)
        elif mixer == "mlstm":
            add(("all-reduce", "model_sum"), act, fwd + grad)
            add(("all-reduce", "model_sum"), t * 4, grad)
            add(("all-gather", "model_gather"), t * d // 32 * 4, fwd)
            add(("all-gather", "model_gather"), d * cfg.n_heads * es, 2 * grad)
            add(("all-gather", "model_gather"), d * d * es, grad)
            add(("all-gather", "model_gather"), d * es, grad)
            add(("all-reduce", "model_max"), 4, 2 * fwd)
            add(("all-reduce", "model_max"), es, 4 * fwd)
        else:                                                       # slstm
            add(("all-reduce", "model_sum"), act, fwd + grad)
            add(("all-gather", "model_gather"), d * 4 * d // cfg.n_heads * es, grad)
            add(("all-reduce", "model_max"), 4, 2 * fwd)
            add(("all-reduce", "model_max"), es, 5 * fwd)
        if ffn == "dense":
            swiglu = cfg.act == "swiglu"
            add(("all-reduce", "model_sum"), act, fwd + grad)
            add(("all-reduce", "model_max"), 4, (4 if swiglu else 3) * fwd)
            add(("all-reduce", "model_max"), es, (3 if swiglu else 2) * fwd)
        elif ffn == "moe":
            groups = 1 + bool(cfg.n_shared_experts)
            add(("all-reduce", "model_sum"), t * cfg.d_model * 4, fwd)
            add(("all-reduce", "model_sum"), act, fwd * bool(cfg.n_shared_experts))
            add(("all-reduce", "model_sum"), act, grad)
            add(("all-reduce", "model_sum"), cfg.top_k * t * 4, grad)
            add(("all-reduce", "model_max"), 4, 3 * groups * fwd)
            add(("all-reduce", "model_max"), es, 3 * groups * fwd)
            add(("all-gather", "all_gather_counts"), n_data * cfg.top_k * cfg.n_experts * 4,
                grad * (n_data > 1))
    scored = b * (cfg.n_codebooks if audio else 1) * (s - 1) * 4
    add(("all-reduce", "model_sum"), act, grad)                     # the head's input
    add(("all-reduce", "model_max"), scored, 1)
    add(("all-reduce", "model_sum"), scored, 2)


def reckon_split_collectives(cfg, opt, shape, rows, accum: int, fill: bool, n_img: int = 0):
    """One rank's collectives in one "split" step on a process mesh of
    ``shape``, per the specs and the config: {(kind, function): [calls,
    bytes]}.  ``rows``: (B, S) of a data rank's microbatch; ``fill``: the
    step's zero-amax forward over the global microbatch, per microbatch.
    The data axes: each param gathered for the forward (whole, or into its
    model block over the data axes), each split leaf's reduced gradient
    gathered whole for the norm, each gradient leaf reduced a microbatch
    (none on one data rank and one microbatch), each amax leaf maxed; the
    model group's (``model_group_collectives``; ``n_img`` image rows
    before each row's tokens) a microbatch."""
    n_data, m = shape
    sole = n_data * accum == 1
    st = St.state_shape(cfg, opt)
    sh = St.state_shardings(_mesh(*shape), st)
    out = {k: list(v) for k, v in _reckon_gathers(cfg, opt, shape, False, sole).items()}

    def add(key, nbytes, times=1):
        if times:
            c = out.setdefault(key, [0, 0])
            c[0] += times
            c[1] += nbytes * times

    for (_, v), (_, s) in zip(Pt.tree_paths(st.params, sort_keys=True),
                              Pt.tree_paths(sh.params, sort_keys=True), strict=True):
        if not sole:
            split = any(n > 1 for _, n in Pt.block_index(s, 0, v.dim()))
            add(("reduce-scatter" if split else "all-reduce", "reduce_scatter_add"),
                math.prod(Pt.shard_shape(tuple(v.shape), s)) * 4, accum)
    for _, a in Pt.tree_paths(st.amax):
        add(("all-reduce", "max_over_ranks"), a.numel() * a.element_size())
    b, s = rows
    for _ in range(accum):
        if fill:
            model_group_collectives(cfg, m, n_data, (b * n_data, s), False, add, n_img)
        model_group_collectives(cfg, m, n_data, rows, True, add, n_img)
    return out


@pytest.fixture(scope="module")
def process_runs(references, tmp_path_factory):
    """Every case's per-rank results: one start of 4 processes, one of 2."""
    d = tmp_path_factory.mktemp("megatron_moe")
    opt = A.AdamWConfig(lr=LR)
    paths = {}
    for arch in ARCHS:
        paths[arch] = str(d / f"{arch}.pt")
        torch.save(_torch_state(references[arch][1], opt), paths[arch])
    calls = {4: {}, 2: {}}
    for name, (arch, shape, accum) in CASES.items():
        cfg = references[arch][0]
        calls[shape[0] * shape[1]][name] = functools.partial(
            R.train_steps, cfg, opt, _batches(cfg.vocab_size), mesh_shape=shape,
            device_type="cpu", state=paths[arch], accum_steps=accum, model_compute="split")
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
    arch, shape, _ = CASES[name]
    _, metrics, shards = split_runs[name]["run"]
    got = process_runs[name]
    mesh = _mesh(*shape)
    assert len(got) == len(shards)
    for r, res in enumerate(got):
        assert res["metrics"] == metrics, (r, res["metrics"], metrics)
        differ = _leaves_equal(res["state"], shards[r])
        assert not differ, (r, differ[:5])
    router = [p for p in got[0]["replicas"][0] if p.endswith("moe/router")]
    assert router, name
    for r, res in enumerate(got):
        peer = [q for q in range(mesh.size) if mesh.coords(q)["data"] == mesh.coords(r)["data"]][0]
        assert res["replicas"] == got[peer]["replicas"], (r, peer)
    print(f"  {name}: {len(got)} ranks x 2 steps equal the one-process split step's; "
          f"{len(got[0]['replicas'][0])} replicated leaves' gradients ({len(router)} routers) "
          f"equal on every model rank of a data rank")


@pytest.mark.parametrize("name", list(CASES))
def test_process_tally_equals_the_reckoning(references, process_runs, name):
    arch, shape, accum = CASES[name]
    cfg = references[arch][0]
    rows = (SHAPE[0] // shape[0] // accum, SHAPE[1])
    opt = A.AdamWConfig(lr=LR)
    for step, fill in enumerate((shape[0] > 1, False)):
        want = reckon_split_collectives(cfg, opt, shape, rows, accum, fill)
        for r, res in enumerate(process_runs[name]):
            got = {k: list(v) for k, v in res["tally"][step].items()}
            assert got == want, (name, r, step, {k: (got.get(k), want.get(k))
                                                 for k in got.keys() | want.keys()
                                                 if got.get(k) != want.get(k)})
    t = process_runs[name][0]["tally"][1]
    print(f"  {name}: a rank's second step {t}")
    if arch == JAMBA:
        assert t[("all-to-all", "model_exchange")][0] > 0


# --- (e) what "split" covers ---------------------------------------------------------

def test_check_split_covers_moe_and_mamba_and_names_item_5d():
    opt = A.AdamWConfig(lr=LR)
    batch = {"tokens": torch.zeros((4, 16), dtype=torch.int32)}
    for arch in ARCHS:
        for m in (2, 4):
            St.check_split(smoke_config(arch), _mesh(1, m))
    # item 5d's archs split too where the model axis divides their widths
    # (tests/test_torch_megatron_xlstm.py); at full size the dry run's 16-way
    # axis divides none of their heads, and the refusal names the width
    for arch, over in (("xlstm-1.3b", {}), ("xlstm-1.3b", dict(n_heads=4, n_kv_heads=4)),
                       ("musicgen-medium", {}), ("qwen2-vl-2b", {})):
        for m in (2, 4) if over or arch == "musicgen-medium" else (2,):
            St.check_split(smoke_config(arch, **over), _mesh(1, m))
    St.jit_train_step(smoke_config("musicgen-medium"), _mesh(1, 4), opt,
                      {"tokens": torch.zeros((4, 4, 16), dtype=torch.int32)},
                      model_compute="split")
    for arch, heads in (("xlstm-1.3b", 4), ("musicgen-medium", 24), ("qwen2-vl-2b", 12)):
        with pytest.raises(ValueError, match=f"n_heads = {heads} to divide by the model axis "
                                             "of 16"):
            St.check_split(get_config(arch), _mesh(1, 16))
    with pytest.raises(ValueError, match=r"d_model / 2 \(d_model = 96\) to be a multiple of 32"):
        St.check_split(smoke_config("xlstm-1.3b", d_model=96, n_heads=4, n_kv_heads=4),
                       _mesh(1, 2))
    for over, what in ((dict(moe_d_ff=90), "moe_d_ff = 90"), (dict(vocab_size=510),
                                                               "vocab_size = 510")):
        with pytest.raises(ValueError, match=f"{what} to divide by the model axis of 4"):
            St.check_split(smoke_config("qwen2-moe-a2.7b", **over), _mesh(1, 4))
    with pytest.raises(ValueError, match="Mamba's d_in = 130 to divide"):
        St.check_split(smoke_config(JAMBA, d_model=65), _mesh(1, 4))
