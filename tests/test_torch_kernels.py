"""The port's four kernels.

On the CPU: each plain version (``repro_torch.kernels.ref``, which is also
what each wrapper computes for a CPU tensor) against both the reference's
oracle (``repro.kernels.ref``) and its Pallas kernel in interpret mode, on
the same numpy inputs.  int4_matmul and LN must be equal.  The two paged
attention kernels must be equal except for +-1 codes on at most 0.1 % of
elements: their fp32 online carry calls ``exp``, and torch's CPU ``exp``
differs from XLA's by an ulp on some inputs (ROADMAP §1); the count is
asserted and printed.

The CUDA kernels against their plain versions on the card are in
``test_torch_cuda.py``, which imports no JAX so that it runs where only
PyTorch is installed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfx
from repro.core import packing as jpk
from repro.core import qlayernorm as jln
from repro.core import qsoftmax as jqs
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_qattention as j_decode
from repro.kernels.int4_matmul import int4_matmul as j_int4
from repro.kernels.prefill_attention import paged_prefill_qattention as j_prefill
from repro.kernels.quant_layernorm import quant_layernorm as j_ln
from repro_torch.core import qlayernorm as tln
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import paged_decode_qattention
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.prefill_attention import paged_prefill_qattention
from repro_torch.kernels.quant_layernorm import quant_layernorm

FLIP_FRACTION = 1e-3


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _mm_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    codes = rng.integers(-8, 8, (k, n)).astype(np.int8)
    wp = np.asarray(jpk.pack_int4_planar(jnp.asarray(codes), axis=0))
    bias = rng.integers(-5000, 5000, (n,)).astype(np.int32)
    M, sh = jfx.quantize_multiplier(0.00071 * 128 / np.sqrt(k))
    return x, wp, bias, M, sh


def _ln_inputs(r, n, seed, subtract_mean):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (r, n)).astype(np.int8)
    x[0] = 5                                  # zero-variance row (eps)
    gamma = rng.integers(-127, 128, n).astype(np.int8)
    beta = (rng.integers(-(2**20), 2**20, n) if subtract_mean else np.zeros(n)).astype(np.int32)
    M, sh = jfx.quantize_multiplier(0.0021)
    return x, gamma, beta, M, sh


def _paged_pool(rng, n_pages, psize, hkv, d):
    kp = rng.integers(-127, 128, (n_pages, psize, hkv, d)).astype(np.int8)
    vp = rng.integers(-127, 128, (n_pages, psize, hkv, d)).astype(np.int8)
    return kp, vp


def _btab(rng, b, nb, n_pages, rows, psize):
    """Per-slot chains of distinct pages for ``rows[b]`` rows; table entries
    past a chain stay 0 (the trash page)."""
    perm = iter(rng.permutation(np.arange(1, n_pages)))
    btab = np.zeros((b, nb), np.int32)
    for bb, ln in enumerate(rows):
        for i in range(-(-int(ln) // psize)):
            btab[bb, i] = next(perm)
    return btab


def _attn_scalars(d, seed):
    rng = np.random.default_rng(seed)
    s_logit = 1.0 / (rng.uniform(0.02, 0.08) * np.sqrt(d))
    M, sh = jfx.quantize_multiplier(1.0 / (s_logit * jqs.LUT_DELTA))
    return M, sh, np.float32(1.0 / s_logit), np.float32(rng.uniform(0.5, 2.0))


def _decode_inputs(b, hkv, g, d, psize, nb, lengths, seed):
    rng = np.random.default_rng(seed)
    n_pages = b * nb + 1
    kp, vp = _paged_pool(rng, n_pages, psize, hkv, d)
    btab = _btab(rng, b, nb, n_pages, lengths, psize)
    q = rng.integers(-127, 128, (b, hkv, g, d)).astype(np.int8)
    return (q, kp, vp, btab, np.asarray(lengths, np.int32)) + _attn_scalars(d, seed)


def _prefill_inputs(b, h, hkv, d, psize, nb, sq, pos0, seed):
    rng = np.random.default_rng(seed)
    n_pages = b * nb + 1
    kp, vp = _paged_pool(rng, n_pages, psize, hkv, d)
    btab = _btab(rng, b, nb, n_pages, [int(p) + sq for p in pos0], psize)
    q = rng.integers(-127, 128, (b, h, sq, d)).astype(np.int8)
    return (q, kp, vp, btab, np.asarray(pos0, np.int32)) + _attn_scalars(d, seed)


def _jax_args(args):
    *arrays, M, sh, inv, osc = args
    lut = jnp.asarray(jref.make_exp_lut_q7())
    return (*[jnp.asarray(a) for a in arrays], jnp.int32(M), jnp.int32(sh), lut,
            jnp.float32(inv), jnp.float32(osc))


def _torch_args(args, device="cpu"):
    *arrays, M, sh, inv, osc = args
    lut = torch.from_numpy(tref.make_exp_lut_q7()).to(device)
    return (*[_t(a, device) for a in arrays], torch.tensor(M, dtype=torch.int32, device=device),
            torch.tensor(sh, dtype=torch.int32, device=device), lut,
            torch.tensor(inv, device=device), torch.tensor(osc, device=device))


def _assert_lsb_flips(got, want, what):
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    diff = np.abs(got - want)
    flips = int((diff > 0).sum())
    print(f"{what}: {flips} of {diff.size} codes differ by +-1 (fp32 exp island)")
    assert diff.max(initial=0) <= 1, what
    assert flips <= FLIP_FRACTION * diff.size, (what, flips)


# --- CPU: plain versions against the reference ---------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (5, 256, 96), (40, 512, 256)])
def test_int4_matmul_plain_equals_reference(m, k, n):
    x, wp, bias, M, sh = _mm_inputs(m, k, n, seed=m + k + n)
    got = int4_matmul(_t(x), _t(wp), _t(bias), M, sh).numpy()       # CPU: plain
    want = jref.int4_matmul_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(bias),
                                jnp.int32(M), jnp.int32(sh))
    np.testing.assert_array_equal(got, np.asarray(want))
    mp = -(-m // 8) * 8
    xp = np.zeros((mp, k), np.int8)
    xp[:m] = x
    pallas = j_int4(jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(bias), jnp.int32(M),
                    jnp.int32(sh), bm=8, bn=min(n, 128) if n % 128 == 0 else n,
                    bk2=64, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas)[:m])


@pytest.mark.parametrize("subtract_mean", [True, False])
def test_quant_layernorm_plain_equals_reference(subtract_mean):
    x, gamma, beta, M, sh = _ln_inputs(16, 256, 7, subtract_mean)
    tp = tln.QLNParams(_t(gamma), _t(beta), torch.tensor(M, dtype=torch.int32),
                       torch.tensor(sh, dtype=torch.int32), subtract_mean)
    got = quant_layernorm(_t(x), tp).numpy()
    jp = jln.QLNParams(jnp.asarray(gamma), jnp.asarray(beta), jnp.int32(M), jnp.int32(sh),
                       subtract_mean)
    np.testing.assert_array_equal(got, np.asarray(jref.quant_layernorm_ref(jnp.asarray(x), jp)))
    pallas = j_ln(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), jnp.int32(M),
                  jnp.int32(sh), subtract_mean=subtract_mean, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("hkv,g,psize,lengths", [
    (2, 4, 16, [1, 23, 48]),        # cross-page carry, a 1-row slot
    (1, 8, 8, [5, 17, 40, 0]),      # GQA group 8, an empty (inactive) slot
    (2, 2, 16, [64, 3, 33]),        # full chain, ragged lengths
])
def test_paged_decode_plain_vs_reference(hkv, g, psize, lengths):
    d = 32
    nb = 64 // psize
    args = _decode_inputs(len(lengths), hkv, g, d, psize, nb, lengths, seed=psize + g)
    got = paged_decode_qattention(*_torch_args(args)).numpy()
    want = jref.paged_decode_qattention_ref(*_jax_args(args))
    _assert_lsb_flips(got, want, "decode vs oracle")
    pallas = j_decode(*_jax_args(args), interpret=True)
    _assert_lsb_flips(got, pallas, "decode vs pallas")


@pytest.mark.parametrize("h,hkv,psize,sq,pos0", [
    (4, 2, 8, 16, [0, 8]),          # GQA 2, aligned chunks
    (8, 1, 16, 24, [5, 19, 0]),     # GQA 8, unaligned pos0
    (2, 2, 8, 40, [3, 0]),          # several q blocks in the kernel
])
def test_paged_prefill_plain_vs_reference(h, hkv, psize, sq, pos0):
    d = 32
    nb = -(-(max(pos0) + sq) // psize) + 1       # + a trailing trash entry
    args = _prefill_inputs(len(pos0), h, hkv, d, psize, nb, sq, pos0, seed=h + sq)
    got = paged_prefill_qattention(*_torch_args(args)).numpy()
    want = jref.paged_prefill_qattention_ref(*_jax_args(args))
    _assert_lsb_flips(got, want, "prefill vs oracle")
    pallas = j_prefill(*_jax_args(args), bq=8, interpret=True)
    _assert_lsb_flips(got, pallas, "prefill vs pallas")


def test_ops_backends_agree_on_cpu():
    """On CPU tensors the ``gpu`` backend's wrappers compute the plain
    versions, so both backends give the same arrays."""
    args = _torch_args(_decode_inputs(2, 2, 4, 32, 8, 4, [9, 30], seed=11))
    np.testing.assert_array_equal(ops.paged_decode_attention_q(*args, impl="ref").numpy(),
                                  ops.paged_decode_attention_q(*args, impl="gpu").numpy())
    args = _torch_args(_prefill_inputs(1, 4, 2, 32, 8, 3, 16, [8], seed=12))
    np.testing.assert_array_equal(ops.paged_prefill_attention_q(*args, impl="ref").numpy(),
                                  ops.paged_prefill_attention_q(*args, impl="gpu").numpy())
    with pytest.raises(ValueError):
        ops.backend("pallas")
