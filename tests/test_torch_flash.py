"""The causal flash prefill and the single-sequence decode of the port
against the reference, on the same numpy inputs: the row oracle
``qattention_ref``, the plain versions of ``flash_qattention`` and
``flash_qdecode`` against the Pallas kernels in interpret mode and the
pure-JAX mirror, ``ops.attention_q``, the batched cache-less prefill and
the quickstart.

The flash family carries an fp32 ``exp`` that differs between torch and
XLA by an ulp on some inputs, so those comparisons allow +-1 code on at
most 0.1 % of elements and print the count; the integer row oracle and
the port's own identities are bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import fixedpoint as jfx
from repro.core import qsoftmax as jqs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_qattention import flash_qattention as j_flash
from repro.kernels.flash_qattention import flash_qattention_jax
from repro.kernels.flash_qattention import flash_qdecode as j_qdecode
from repro.models import fold as JF
from repro.models import serve_int as JS
from repro.models import transformer as JT
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_qattention import flash_qattention_torch
from repro_torch.launch.quickstart import quickstart
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S

FLIP_FRACTION = 1e-3
LUT = jref.make_exp_lut_q7()


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn(h, hkv, sq, skv, d, seed, lead=()):
    """int8 q (*lead, H, Sq, D), k/v (*lead, Hkv, Skv, D) and the scalars
    as the reference's kernel tests make them."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-64, 65, (*lead, h, sq, d)).astype(np.int8)
    k = rng.integers(-64, 65, (*lead, hkv, skv, d)).astype(np.int8)
    v = rng.integers(-64, 65, (*lead, hkv, skv, d)).astype(np.int8)
    s_logit = 1.0 / (0.05 * np.sqrt(d))
    M, sh = jfx.quantize_multiplier(1.0 / (s_logit * jqs.LUT_DELTA))
    return q, k, v, M, sh, np.float32(1.0 / s_logit), np.float32(rng.uniform(0.5, 2.0))


def _flips(got, want, what):
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    n = int((diff > 0).sum())
    print(f"{what}: {n} of {diff.size} codes differ by at most {int(diff.max())}")
    assert diff.max() <= 1 and n <= FLIP_FRACTION * diff.size


def _plain(q, k, v, M, sh, inv, osc, **kw):
    return flash_qattention_torch(_t(q), _t(k), _t(v), M, sh, _t(LUT), inv, osc, **kw).numpy()


@pytest.mark.parametrize("h,hkv,sq,skv,causal,q_offset", [
    (4, 2, 64, 64, True, 0),
    (4, 1, 48, 48, False, 0),
    (8, 2, 8, 128, True, 120),      # decode-like rows at the cache tip
    (4, 4, 16, 80, True, 30),       # rows before the last keys: those stay masked
])
def test_qattention_ref_equals_reference(h, hkv, sq, skv, causal, q_offset):
    q, k, v, M, sh, _, osc = _attn(h, hkv, sq, skv, 32, seed=h + sq)
    want = np.asarray(jref.qattention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(M), jnp.int32(sh),
        jnp.asarray(LUT), jnp.float32(osc), causal=causal, q_offset=q_offset))
    got = tref.qattention_ref(_t(q), _t(k), _t(v), M, sh, _t(LUT), torch.tensor(osc),
                              causal=causal, q_offset=q_offset).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,hkv,s,sq,q_offset,bq,bkv,seed", [
    (4, 2, 256, 256, 0, 64, 64, 3), (4, 2, 256, 256, 0, 128, 32, 3),
    (4, 2, 256, 256, 0, 32, 128, 3), (4, 1, 128, 128, 0, 64, 32, 3),
    (4, 2, 128, 8, 120, 8, 32, 5),      # decode-like rows at the cache tip
])
def test_plain_flash_equals_pallas_kernel(h, hkv, s, sq, q_offset, bq, bkv, seed):
    q, k, v, M, sh, inv, osc = _attn(h, hkv, s, s, 64, seed=seed)
    q = q[:, :sq]
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(M),
                   jnp.int32(sh), jnp.asarray(LUT), jnp.float32(inv), jnp.float32(osc),
                   q_offset=q_offset, bq=bq, bkv=bkv, interpret=True)
    _flips(_plain(q, k, v, M, sh, inv, osc, q_offset=q_offset, bkv=bkv), want,
           f"plain flash vs Pallas (H {h}, Hkv {hkv}, Sq {sq} at {q_offset}, Skv {s}, "
           f"bq {bq}, bkv {bkv})")


@pytest.mark.parametrize("s,h,hkv", [(37, 4, 2), (592, 4, 1)])
def test_plain_flash_equals_the_mirror_at_odd_blocks(s, h, hkv):
    """The serving prefill's block: divisor_tile(512, S) — 37 for S 37, 296
    for S 592 (no power of two)."""
    bkv = JS._flash_bkv(s)
    assert bkv == {37: 37, 592: 296}[s]
    q, k, v, M, sh, inv, osc = _attn(h, hkv, s, s, 32, seed=s)
    want = flash_qattention_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(M),
                                jnp.int32(sh), jnp.asarray(LUT), jnp.float32(inv),
                                jnp.float32(osc), bkv=bkv)
    _flips(_plain(q, k, v, M, sh, inv, osc, bkv=bkv), want,
           f"plain flash vs flash_qattention_jax (S {s}, bkv {bkv})")


def _flash_every_block(q, k, v, M, sh, inv, osc, q_offset, bkv):
    """The plain flash without the dead-block skip: every KV block updates
    the carry, as the reference's mirror computes it."""
    q, k, v = _t(q), _t(k), _t(v)
    h, sq, d = q.shape
    group = h // k.shape[0]
    m = torch.full((h, sq, 1), tref.NEG_INIT, dtype=torch.int32)
    den = torch.zeros((h, sq, 1))
    acc = torch.zeros((h, sq, d))
    qpos = q_offset + torch.arange(sq, dtype=torch.int32)[:, None]
    for k_i in range(k.shape[1] // bkv):
        blk = slice(k_i * bkv, (k_i + 1) * bkv)
        s = tref.int_matmul(q, k[:, blk].repeat_interleave(group, 0).transpose(-1, -2))
        kpos = k_i * bkv + torch.arange(bkv, dtype=torch.int32)[None, :]
        s = torch.where(kpos <= qpos, s, s - jqs.MASK_OFFSET)
        m, den, acc = tref._online_update(m, den, acc, s,
                                          v[:, blk].repeat_interleave(group, 0), M, sh,
                                          _t(LUT), torch.tensor(inv))
    return tref._epilogue(acc, den, osc).numpy()


@pytest.mark.parametrize("sq,skv,q_offset,bkv", [(40, 128, 0, 16), (8, 128, 60, 32),
                                                 (37, 111, 0, 37)])
def test_skipping_dead_blocks_is_exact(sq, skv, q_offset, bkv):
    q, k, v, M, sh, inv, osc = _attn(4, 2, sq, skv, 32, seed=sq + skv)
    dead = skv // bkv - ((q_offset + sq - 1) // bkv + 1)
    assert dead >= 1
    np.testing.assert_array_equal(_plain(q, k, v, M, sh, inv, osc, q_offset=q_offset, bkv=bkv),
                                  _flash_every_block(q, k, v, M, sh, inv, osc, q_offset, bkv))


@pytest.mark.parametrize("bkv,cache_len", [(128, 128), (32, 100), (64, 37)])
def test_plain_qdecode_equals_pallas_kernel(bkv, cache_len):
    hkv, g, smax, d = 2, 4, 128, 64
    rng = np.random.default_rng(11)
    q = rng.integers(-64, 65, (hkv, g, d)).astype(np.int8)
    k = rng.integers(-64, 65, (hkv, smax, d)).astype(np.int8)
    v = rng.integers(-64, 65, (hkv, smax, d)).astype(np.int8)
    s_logit = 1.0 / (0.05 * np.sqrt(d))
    M, sh = jfx.quantize_multiplier(1.0 / (s_logit * jqs.LUT_DELTA))
    inv, osc = np.float32(1.0 / s_logit), np.float32(1.3)
    want = j_qdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(cache_len),
                     jnp.int32(M), jnp.int32(sh), jnp.asarray(LUT), jnp.float32(inv),
                     jnp.float32(osc), bkv=bkv, interpret=True)
    got = tref.flash_qdecode_ref(_t(q), _t(k), _t(v), cache_len, M, sh, _t(LUT), inv, osc,
                                 bkv=bkv)
    _flips(got.numpy(), want, f"plain flash_qdecode vs Pallas (bkv {bkv}, len {cache_len})")
    # it is the contiguous decode's plain version at B = 1 on the cache-native stripe
    stripe = tref.decode_qattention_ref(
        _t(q)[None], _t(k).transpose(0, 1)[None], _t(v).transpose(0, 1)[None],
        torch.tensor([cache_len], dtype=torch.int32), M, sh, _t(LUT), inv, osc, bkv)
    assert torch.equal(got, stripe[0])


@pytest.mark.parametrize("causal,q_offset,sq", [(True, 0, 32), (False, 0, 32), (True, 24, 8)])
def test_ops_attention_q_ref_equals_reference(causal, q_offset, sq):
    q, k, v, M, sh, inv, osc = _attn(4, 2, sq, 32, 32, seed=9, lead=(3,))
    want = np.asarray(jops.attention_q(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(M), jnp.int32(sh),
        jnp.asarray(LUT), jnp.float32(inv), jnp.float32(osc), causal=causal,
        q_offset=q_offset, impl="ref"))
    got = ops.attention_q(_t(q), _t(k), _t(v), M, sh, _t(LUT), inv, torch.tensor(osc),
                          causal=causal, q_offset=q_offset, impl="ref").numpy()
    np.testing.assert_array_equal(got, want)


def test_ops_attention_q_gpu_is_causal_only_and_takes_the_flash():
    q, k, v, M, sh, inv, osc = _attn(4, 2, 32, 32, 32, seed=9, lead=(2,))
    args = (_t(q), _t(k), _t(v), M, sh, _t(LUT), inv, osc)
    with pytest.raises(ValueError, match="causal"):
        ops.attention_q(*args, causal=False, impl="gpu")
    got = ops.attention_q(*args, impl="gpu")
    assert torch.equal(got, flash_qattention_torch(*args, bkv=128))


@pytest.fixture(scope="module")
def calibrated():
    jcfg = j_smoke("yi-6b")
    key = jax.random.PRNGKey(0)
    params = JT.init_params(jcfg, key)
    amax = JT.init_amax(jcfg)
    toks = jax.random.randint(key, (2, 32), 0, jcfg.vocab_size)
    return jcfg, params, amax, toks


def test_batched_cacheless_prefill_equals_per_sequence(calibrated, monkeypatch):
    """The prefill's attention runs once for the whole batch: the logits of
    a (3, 40) batch equal each sequence's own (1, 40) forward, on ``ref``
    and under the ``gpu`` backend's control flow (the plain versions on the
    CPU)."""
    jcfg, params, _, _ = calibrated
    cfg = smoke_config("yi-6b")
    tparams = F.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    amax = F.params_from_numpy(jax.tree.map(np.asarray, JT.init_amax(jcfg)), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 40))
                            .astype(np.int32))
    from repro_torch.models import transformer as T
    _, obs, _ = T.forward(cfg, tparams, amax, toks)
    folded = F.fold_params(cfg, tparams, obs)
    batched, _ = S.serve_forward(cfg, folded, toks)
    for i in range(3):
        one, _ = S.serve_forward(cfg, folded, toks[i:i + 1])
        assert torch.equal(batched[i:i + 1], one)
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "gpu")
    assert torch.equal(S.serve_forward(cfg, folded, toks)[0], batched)


def test_quickstart_matches_the_reference(calibrated):
    """examples/quickstart.py on the reference and the port's quickstart on
    the same float weights and tokens: the integer logits' argmax agrees on
    at least 99 % of positions (the same rule as the cache-less prefill's
    test), and both KLs are printed."""
    jcfg, params, amax, toks = calibrated
    logits_f, obs, _ = JT.forward(jcfg, params, amax, toks)
    logits_i, _ = JS.serve_forward(jcfg, JF.fold_params(jcfg, params, obs), toks,
                                   mode="prefill")
    pf = jax.nn.softmax(logits_f, -1)
    kl = float(jnp.mean(jnp.sum(pf * (jax.nn.log_softmax(logits_f, -1)
                                      - jax.nn.log_softmax(logits_i, -1)), -1)))
    cfg = smoke_config("yi-6b")
    r = quickstart(cfg, F.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                   F.params_from_numpy(jax.tree.map(np.asarray, amax), "cpu"),
                   torch.from_numpy(np.array(toks)))
    want = np.asarray(logits_i)
    got = r["logits_i"].numpy()
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"quickstart: KL reference {kl:.5f}, port {r['kl']:.5f}; integer argmax agrees "
          f"on {agree:.4f}; {int((got != want).sum())} of {got.size} logits differ")
    assert agree >= 0.99
    assert abs(r["kl"] - kl) <= 0.1 * kl + 1e-4
