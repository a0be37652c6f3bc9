"""Speculative decoding in the port against the reference, on the smoke
yi-6b with the reference's folded weights carried across as numpy.

* The engine: the port's ``ref`` engine with ``spec_k > 0`` against the
  reference's ``ref`` engine on the cases of ``tests/test_spec_decode.py``
  (prompt lookup, no proposals, the oracle across page boundaries, full
  rejection, preemption mid-verify, a sampled slot riding along, the
  budget clamp at ``spec_k=8``): the per-tick event stream, ``out``,
  ``counters`` and ``stats(check=True)`` equal.  The reference's runs are
  made once per module.
* The layer: ``serve_forward(mode="verify")`` against the reference's call
  on the same inputs, equal logits and pool, a slot one row from
  ``max_len`` included (its padding columns lie past the block table).
* Row 3 at the verify shape: the plain paged prefill at S = 4 and a ragged,
  unaligned ``pos0`` against the reference's oracle and its Pallas kernel
  in interpret mode, and row for row equal to the plain paged decode
  (row 4) at each row's length: the identity the ``gpu`` engine leans on.
* The ``gpu`` backend's control flow (the plain kernel versions on CPU
  tensors): speculative tokens equal plain-decode tokens.
* The draft sources, the per-slot mask and the config checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.prefill_attention import paged_prefill_qattention as j_prefill
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro.serve import draft as JD
from repro.serve import engine as JE
from repro_torch.configs import smoke_config
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import qsoftmax as tqs
from repro_torch.kernels import ref as tref
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.serve import draft as D
from repro_torch.serve import engine as E

KEY = jax.random.PRNGKey(0)
FLIP_FRACTION = 1e-3
BASE = dict(batch_slots=2, max_len=64, prefill_bucket=4, cache_layout="paged", page_size=4)
LENS = [3, 11, 6, 17, 5]
MAX_NEWS = [6, 8, 5, 4, 7]


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
    jfolded = JF.fold_params(jcfg, params, obs)
    tfolded = F.folded_from_numpy(jax.tree.map(np.asarray, jfolded), "cpu")
    return jcfg, jfolded, smoke_config("yi-6b"), tfolded


def _cycle(vocab, lens, max_news, seed=7, period=3, sampled=()):
    """(prompt, max_new, temperature) of prompt-lookup-friendly requests:
    each prompt a tiled short cycle (``test_spec_decode.py``'s workload)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (ln, mn) in enumerate(zip(lens, max_news)):
        pat = rng.integers(0, vocab, (period,)).astype(np.int32)
        out.append((np.tile(pat, ln // period + 1)[:ln], mn, 0.8 if i in sampled else 0.0))
    return out


class _Mute:
    """Never proposes."""

    def propose(self, context, k):
        return []


def _anti(seq_cls, vocab):
    """Anti-oracle: proposes (truth + 1) % vocab, so every proposal is rejected."""
    class Anti(seq_cls):
        def propose(self, context, k):
            return [(t + 1) % vocab for t in super().propose(context, k)]
    return Anti


# name -> (engine options, workload options, draft: None | "mute" | "oracle" | "anti")
CASES = {
    "prompt_lookup": ({}, {}, None),
    "no_proposals": ({}, {}, "mute"),
    "oracle_page_boundary": ({}, {}, "oracle"),
    "full_rejection": ({}, {}, "anti"),
    "preemption_mid_verify": (dict(n_pages=8), {}, "oracle"),
    "sampled_rides_along": ({}, dict(sampled=(2,)), "oracle"),
    "budget_clamp_k8": (dict(max_len=96, spec_k=8), dict(lens=[3, 5], max_news=[2, 24], seed=11),
                        "oracle"),
}


def _workload(cfg, case):
    w = dict(lens=LENS, max_news=MAX_NEWS)
    w.update(CASES[case][1])
    return _cycle(cfg.vocab_size, **w)


def _event(e):
    return (e.rid, e.token, e.index, e.final, e.finish_reason)


def _drive(mod, eng, work):
    reqs = [mod.Request(prompt=p.copy(), max_new_tokens=m, temperature=t) for p, m, t in work]
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.has_work:
        ticks.append([_event(e) for e in eng.poll()])
        eng.stats(check=True)
    return ticks, reqs


def _plain_truth(cfg, tfolded, work, kw):
    """The port's plain-decode tokens (equal to the reference's,
    ``test_torch_engine.py``) and the truth sequences an oracle replays."""
    eng = E.Engine(cfg, tfolded, E.EngineConfig(**kw))
    _, reqs = _drive(E, eng, work)
    outs = [r.out.tolist() for r in reqs]
    return outs, [list(p) + o for (p, _, _), o in zip(work, outs)], eng.counters


def _draft(mod, kind, seqs, vocab):
    if kind is None:
        return "prompt_lookup"
    if kind == "mute":
        return type("Mute", (_Mute, mod.DraftSource), {})()
    if kind == "oracle":
        return mod.SequenceDraft(seqs)
    return _anti(mod.SequenceDraft, vocab)(seqs)


def _engine_kw(case):
    kw = dict(BASE, spec_k=3)
    kw.update(CASES[case][0])
    return kw


@pytest.fixture(scope="module")
def reference_runs(folded):
    """The reference engine's run of each case, made once: (events per tick,
    requests, counters, stats)."""
    jcfg, jfolded, cfg, tfolded = folded
    runs = {}

    def get(case):
        if case not in runs:
            kw = _engine_kw(case)
            work = _workload(cfg, case)
            _, seqs, _ = _plain_truth(cfg, tfolded, work, {k: v for k, v in kw.items()
                                                          if k != "spec_k"})
            eng = JE.Engine(jcfg, jfolded, JE.EngineConfig(
                **kw, draft=_draft(JD, CASES[case][2], seqs, cfg.vocab_size)))
            ticks, reqs = _drive(JE, eng, work)
            runs[case] = (ticks, reqs, eng.counters, eng.stats(check=True))
        return runs[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_engine_matches_reference(folded, reference_runs, case):
    cfg, tfolded = folded[2], folded[3]
    kw = _engine_kw(case)
    work = _workload(cfg, case)
    truth, seqs, plain = _plain_truth(cfg, tfolded, work, {k: v for k, v in kw.items()
                                                           if k != "spec_k"})
    eng = E.Engine(cfg, tfolded, E.EngineConfig(
        **kw, draft=_draft(D, CASES[case][2], seqs, cfg.vocab_size)))
    ticks, reqs = _drive(E, eng, work)
    jticks, jreqs, jcounters, jstats = reference_runs(case)
    assert ticks == jticks
    for t, j in zip(reqs, jreqs):
        assert t.status.value == j.status.value and t.finish_reason == j.finish_reason
        np.testing.assert_array_equal(t.out, j.out)
    assert eng.counters == jcounters
    assert eng.stats(check=True) == jstats
    c = eng.counters
    assert c["drafted"] == c["accepted"] + c["rejected"]
    assert eng.stats()["spec_k"] == kw["spec_k"]
    assert all(0 <= k <= kw["spec_k"] for k in c["accept_len_hist"])
    greedy = [i for i, (_, _, t) in enumerate(work) if t == 0]
    assert [reqs[i].out.tolist() for i in greedy] == [truth[i] for i in greedy]
    kind = CASES[case][2]
    if kind == "mute":
        assert c["drafted"] == 0 and c["accept_len_hist"] == {}
    elif kind == "anti":
        assert c["drafted"] > 0 and c["accepted"] == 0 and set(c["accept_len_hist"]) == {0}
    elif kind == "oracle":
        assert c["rejected"] == 0 and c["accepted"] == c["drafted"] > 0
        assert c["decode_steps"] < plain["decode_steps"]
    else:
        assert c["drafted"] > 0
    if case == "oracle_page_boundary":
        assert c["grown_pages"] > 0
    if case == "preemption_mid_verify":
        assert c["preemptions"] > 0 and c["restores"] > 0 and eng.alloc.live == 0
    if case == "sampled_rides_along":
        assert len(reqs[2].out) == MAX_NEWS[2]


# --- the verify forward at the layer level -------------------------------------

def _verify_inputs(cfg, seed=3):
    """A paged pool with random rows, three slots (a ragged two-proposal
    slot at an unaligned cursor, a slot one row from ``max_len`` whose
    padding columns lie past its table, an inactive slot) and S = 4."""
    rng = np.random.default_rng(seed)
    psize, nb, n_pages = 4, 4, 12
    pool = {f"slot{i}": {c: rng.integers(-127, 128, (cfg.n_reps, n_pages, psize,
                                                     cfg.n_kv_heads, cfg.hd)).astype(np.int8)
                         for c in ("k", "v")} for i in range(len(JT.slot_kinds(cfg)))}
    btab = np.asarray([[3, 7, 1, 0], [2, 5, 9, 11], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([5, 4 * nb - 1, 0], np.int32)
    nrows = np.asarray([3, 1, 1], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    return pool, btab, pos, nrows, toks


@pytest.mark.parametrize("seed", [3, 4])
def test_verify_forward_matches_reference(folded, seed):
    """Logits of every real row and every pool page but the trash page 0
    equal the reference's (inactive slots and padding columns all write
    row 0 of page 0, where which write wins is the framework's choice)."""
    jcfg, jfolded, cfg, tfolded = folded
    pool, btab, pos, nrows, toks = _verify_inputs(jcfg, seed)
    jlog, jcache = JS.serve_forward(
        jcfg, jfolded, jnp.asarray(toks), cache=jax.tree.map(jnp.asarray, pool),
        pos_offset=jnp.asarray(pos), mode="verify", block_tables=jnp.asarray(btab),
        verify_rows=jnp.asarray(nrows))
    tcache = {s: {c: torch.from_numpy(a.copy()) for c, a in d.items()} for s, d in pool.items()}
    tlog, tcache = S.serve_forward(cfg, tfolded, torch.from_numpy(toks), cache=tcache,
                                   pos_offset=torch.from_numpy(pos), mode="verify",
                                   block_tables=torch.from_numpy(btab),
                                   verify_rows=torch.from_numpy(nrows))
    assert tuple(tlog.shape) == (3, 4, cfg.vocab_size)
    jlog, tlog = np.asarray(jlog), tlog.numpy()
    for b in range(2):
        np.testing.assert_array_equal(tlog[b, :nrows[b]], jlog[b, :nrows[b]])
    for s in pool:
        for c in ("k", "v"):
            np.testing.assert_array_equal(tcache[s][c][:, 1:].numpy(),
                                          np.asarray(jcache[s][c])[:, 1:])


def test_verify_row_equals_decode_step(folded):
    """Row i of a verify forward equals the plain decode step at position
    pos + i after rows 0..i-1 were committed, on both backends."""
    cfg, tfolded = folded[2], folded[3]
    pool, btab, pos, nrows, toks = _verify_inputs(cfg)
    for impl in ("ref", "gpu"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_TORCH_KERNELS", impl)
            cache = {s: {c: torch.from_numpy(a.copy()) for c, a in d.items()}
                     for s, d in pool.items()}
            ver, _ = S.serve_forward(cfg, tfolded, torch.from_numpy(toks), cache=cache,
                                     pos_offset=torch.from_numpy(pos), mode="verify",
                                     block_tables=torch.from_numpy(btab),
                                     verify_rows=torch.tensor([4, 1, 1], dtype=torch.int32))
            cache = {s: {c: torch.from_numpy(a.copy()) for c, a in d.items()}
                     for s, d in pool.items()}
            for i in range(4):
                p = np.minimum(pos + i, 4 * btab.shape[1] - 1)
                dec, _ = S.serve_forward(cfg, tfolded, torch.from_numpy(toks[:, i:i + 1]),
                                         cache=cache, pos_offset=torch.from_numpy(p),
                                         mode="decode", block_tables=torch.from_numpy(btab))
                # slot 0's rows lie inside its chain; slot 1 holds only row 0
                torch.testing.assert_close(ver[0, i], dec[0, 0], rtol=0, atol=0)
                if i == 0:
                    torch.testing.assert_close(ver[1, 0], dec[1, 0], rtol=0, atol=0)


def test_verify_refuses_kv4_and_needs_its_arguments(folded):
    cfg, tfolded = folded[2], folded[3]
    toks = torch.zeros((1, 2), dtype=torch.int32)
    btab = torch.tensor([[1, 2]], dtype=torch.int32)
    kv4 = S.init_paged_cache(cfg, 3, 4, kv_bits=4, device="cpu")
    with pytest.raises(NotImplementedError, match="int8 pool"):
        S.serve_forward(cfg, tfolded, toks, cache=kv4, pos_offset=torch.tensor([1]),
                        mode="verify", block_tables=btab, verify_rows=torch.tensor([2]))
    with pytest.raises(ValueError, match="verify_rows"):
        S.serve_forward(cfg, tfolded, toks, cache=S.init_paged_cache(cfg, 3, 4, device="cpu"),
                        pos_offset=torch.tensor([1]), mode="verify", block_tables=btab)


def test_attn_rows_per_slot_mask_equals_shared_mask(folded):
    """A (B, S, Skv) mask gives each slot what a shared (S, Skv) mask gives
    that slot alone; the shared form is unchanged."""
    cfg, tfolded = folded[2], folded[3]
    rng = np.random.default_rng(5)
    b, s, skv = 3, 4, 12
    qc = torch.from_numpy(rng.integers(-127, 128, (b, s, cfg.n_heads, cfg.hd)).astype(np.int8))
    kc, vc = (torch.from_numpy(rng.integers(-127, 128, (b, skv, cfg.n_kv_heads, cfg.hd))
                               .astype(np.int8)) for _ in range(2))
    aq = S.layer_views(tfolded, cfg.n_reps)[0]["slot0"]["attn_q"]
    front = torch.tensor([2, 7, 11])
    kpos, qpos = torch.arange(skv), torch.arange(s)
    masks = kpos[None, None, :] <= (front[:, None] + qpos[None, :])[:, :, None]
    got = S._attn_rows_q8(qc, kc, vc, aq, cfg, masks)
    for i in range(b):
        want = S._attn_rows_q8(qc[i:i + 1], kc[i:i + 1], vc[i:i + 1], aq, cfg, masks[i])
        assert torch.equal(got[i:i + 1], want)


# --- row 3 at the verify shape ---------------------------------------------------

def _row3_inputs(pos0, sq=4, h=8, hkv=2, d=32, psize=4, seed=9):
    rng = np.random.default_rng(seed)
    nb = -(-(max(pos0) + sq) // psize) + 1
    n_pages = len(pos0) * nb + 1
    kp, vp = (rng.integers(-127, 128, (n_pages, psize, hkv, d)).astype(np.int8) for _ in "kv")
    perm = iter(rng.permutation(np.arange(1, n_pages)))
    btab = np.zeros((len(pos0), nb), np.int32)
    for b, p in enumerate(pos0):
        for i in range(-(-(p + sq) // psize)):
            btab[b, i] = next(perm)
    q = rng.integers(-127, 128, (len(pos0), h, sq, d)).astype(np.int8)
    s_logit = 1.0 / (0.05 * np.sqrt(d))
    M, sh = tfx.quantize_multiplier(1.0 / (s_logit * tqs.LUT_DELTA))
    return (q, kp, vp, btab, np.asarray(pos0, np.int32), M, sh, np.float32(1.0 / s_logit),
            np.float32(1.3))


def _t_args(args):
    *arrays, M, sh, inv, osc = args
    return (*[torch.from_numpy(np.array(a)) for a in arrays], torch.tensor(M, dtype=torch.int32),
            torch.tensor(sh, dtype=torch.int32), torch.from_numpy(tref.make_exp_lut_q7()),
            torch.tensor(inv), torch.tensor(osc))


def _j_args(args):
    *arrays, M, sh, inv, osc = args
    return (*[jnp.asarray(a) for a in arrays], jnp.int32(M), jnp.int32(sh),
            jnp.asarray(jref.make_exp_lut_q7()), jnp.float32(inv), jnp.float32(osc))


POS0 = [5, 33, 0, 18, 62, 7, 1, 47]     # ragged, unaligned, 4-row pages


def test_row3_verify_shape_plain_vs_reference():
    args = _row3_inputs(POS0)
    got = tref.paged_prefill_qattention_ref(*_t_args(args)).numpy().astype(np.int32)
    for want in (jref.paged_prefill_qattention_ref(*_j_args(args)),
                 j_prefill(*_j_args(args), bq=8, interpret=True)):
        diff = np.abs(got - np.asarray(want, np.int32))
        flips = int((diff > 0).sum())
        print(f"row 3 at S=4: {flips} of {diff.size} codes differ by +-1 (fp32 exp island)")
        assert diff.max() <= 1 and flips <= FLIP_FRACTION * diff.size


def test_row3_verify_rows_equal_row4_decode():
    """Row i of the plain paged prefill at pos0 equals the plain paged decode
    (page-serial, and as the CUDA kernels split it) at length pos0 + i + 1,
    bit for bit: a page wholly past a row's frontier leaves the carry
    unchanged (f = 1, and the LUT's tail codes are 0, so den_b = P.V = 0)."""
    q, kp, vp, btab, pos0, M, sh, lut, inv, osc = _t_args(_row3_inputs(POS0))
    assert (lut[-52:] == 0).all()
    pre = tref.paged_prefill_qattention_ref(q, kp, vp, btab, pos0, M, sh, lut, inv, osc)
    b, h, s, d = q.shape
    hkv = kp.shape[2]
    for i in range(s):
        qd = q[:, :, i].reshape(b, hkv, h // hkv, d)
        lengths = pos0 + i + 1
        for dec in (tref.paged_decode_qattention_ref, tref.paged_decode_split_ref):
            out = dec(qd, kp, vp, btab, lengths, M, sh, lut, inv, osc)
            assert torch.equal(out.reshape(b, h, d), pre[:, :, i])


# --- the gpu backend's control flow on the CPU ------------------------------------

@pytest.mark.parametrize("draft", ["prompt_lookup", "oracle", "anti"])
def test_gpu_backend_spec_equals_plain_decode(folded, monkeypatch, draft):
    """The q7 family (the plain versions of rows 3 and 4 on CPU tensors):
    speculative tokens equal plain-decode tokens, the CPU proof of the
    card's gate."""
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    cfg, tfolded = folded[2], folded[3]
    work = _cycle(cfg.vocab_size, LENS, MAX_NEWS)
    truth, seqs, plain = _plain_truth(cfg, tfolded, work, BASE)
    kind = {"prompt_lookup": None, "oracle": "oracle", "anti": "anti"}[draft]
    eng = E.Engine(cfg, tfolded, E.EngineConfig(
        spec_k=3, draft=_draft(D, kind, seqs, cfg.vocab_size), **BASE))
    _, reqs = _drive(E, eng, work)
    assert [r.out.tolist() for r in reqs] == truth
    c = eng.counters
    assert c["drafted"] == c["accepted"] + c["rejected"] > 0
    if draft == "oracle":
        assert c["rejected"] == 0 and c["decode_steps"] < plain["decode_steps"]


# --- config and draft sources ------------------------------------------------------

def test_spec_config_validation(folded):
    with pytest.raises(E.EngineConfigError, match="spec_k"):
        E.EngineConfig(spec_k=-1).validate()
    with pytest.raises(E.EngineConfigError, match="paged"):
        E.EngineConfig(spec_k=2, cache_layout="contiguous").validate()
    with pytest.raises(E.EngineConfigError, match="kv_bits"):
        E.EngineConfig(spec_k=2, cache_layout="paged", kv_bits=4).validate()
    with pytest.raises(ValueError, match="prompt_lookup"):
        E.Engine(folded[2], folded[3], E.EngineConfig(spec_k=3, draft="nope", **BASE))
    eng = E.Engine(folded[2], folded[3], E.EngineConfig(**BASE))
    assert eng.spec_k == 0 and eng.draft is None and eng.stats(check=True)["spec_k"] == 0


@pytest.mark.parametrize("ctx,k", [
    ([1, 2, 3, 4, 5, 1, 2, 3], 2), ([7, 2, 3, 9, 1, 2, 3], 1), ([1, 2, 3, 4], 3),
    ([1, 2, 3, 1], 0), ([5], 3), ([4, 4, 4, 4], 5), ([1, 2, 1, 2, 1], 4),
])
def test_prompt_lookup_draft_matches_reference(ctx, k):
    for lo, hi in ((1, 3), (2, 2), (1, 1)):
        assert D.PromptLookupDraft(lo, hi).propose(np.array(ctx), k) == \
            JD.PromptLookupDraft(lo, hi).propose(np.array(ctx), k)
    assert D.PromptLookupDraft().propose(np.array([1, 2, 3, 4, 5, 1, 2, 3]), 2) == [4, 5]
    assert D.PromptLookupDraft().propose(np.array([7, 2, 3, 9, 1, 2, 3]), 1) == [9]
    for lo, hi in ((0, 3), (3, 2)):
        with pytest.raises(ValueError):
            D.PromptLookupDraft(min_ngram=lo, max_ngram=hi)


def test_sequence_draft_and_make_draft_source():
    d = D.SequenceDraft([[1, 2, 3, 4, 5]])
    assert d.propose(np.array([1, 2]), 2) == [3, 4]
    assert d.propose(np.array([1, 2]), 9) == [3, 4, 5]
    assert d.propose(np.array([2, 1]), 2) == []
    assert d.propose(np.array([1, 2, 3, 4, 5]), 2) == []
    d.add([2, 1, 7])
    assert d.propose(np.array([2, 1]), 2) == [7]
    assert isinstance(D.make_draft_source("prompt_lookup"), D.PromptLookupDraft)
    assert D.make_draft_source(d) is d
    with pytest.raises(ValueError, match="prompt_lookup"):
        D.make_draft_source("no_such_draft")
    with pytest.raises(TypeError):
        D.make_draft_source(42)
