"""The port's six kernels.

On the CPU: each plain version (``repro_torch.kernels.ref``, which is also
what each wrapper computes for a CPU tensor) against both the reference's
oracle (``repro.kernels.ref``) and its Pallas kernel in interpret mode, on
the same numpy inputs.  The GEMMs, LN and the row softmax must be equal.
The two paged
attention kernels must be equal except for +-1 codes on at most 0.1 % of
elements: their fp32 online carry calls ``exp``, and torch's CPU ``exp``
differs from XLA's by an ulp on some inputs (ROADMAP §1); the count is
asserted and printed.

The CUDA kernels against their plain versions on the card are in
``test_torch_cuda.py``, which imports no JAX so that it runs where only
PyTorch is installed.
"""
import jax
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
from repro.kernels.int4_matmul import int8_bitsplit_matmul as j_bitsplit
from repro.kernels.prefill_attention import paged_prefill_qattention as j_prefill
from repro.kernels.quant_layernorm import quant_layernorm as j_ln
from repro.kernels.quant_softmax import quant_softmax as j_softmax
from repro.models import layers as j_layers
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import qlayernorm as tln
from repro_torch.core import qsoftmax as tqs
from repro_torch.core.qlinear import FoldedLinear
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import paged_decode_qattention
from repro_torch.kernels.int4_matmul import int4_matmul, int8_bitsplit_matmul
from repro_torch.kernels.prefill_attention import paged_prefill_qattention
from repro_torch.kernels.quant_layernorm import quant_layernorm
from repro_torch.kernels.quant_softmax import quant_softmax
from repro_torch.models import layers as t_layers

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


@pytest.mark.parametrize("r,s", [(13, 16), (30, 77), (9, 128), (5, 512)])
@pytest.mark.parametrize("masked", [False, True])
def test_quant_softmax_plain_equals_reference(r, s, masked):
    """Rows (R not a multiple of 8) of int32 logit codes, masked as the
    model masks them (2^30 below, half the rows cut after a ragged key
    count, one row wholly masked); the reference kernel gets the rows
    padded to 8 as its ops.softmax_q pads them."""
    rng = np.random.default_rng(r * s)
    x = rng.integers(-400_000, 400_000, (r, s)).astype(np.int32)
    if masked:
        x[::2, (s * 2) // 3:] -= jqs.MASK_OFFSET
        x[1] -= jqs.MASK_OFFSET
    M, sh = jfx.quantize_multiplier(1.0 / (rng.uniform(20, 60) * jqs.LUT_DELTA))
    lut = jqs.make_exp_lut()
    got = quant_softmax(_t(x), M, sh, _t(lut)).numpy()            # CPU: plain
    want = jref.quant_softmax_ref(jnp.asarray(x), jnp.int32(M), jnp.int32(sh), jnp.asarray(lut))
    np.testing.assert_array_equal(got, np.asarray(want))
    xp = np.concatenate([x, np.zeros((-r % 8, s), np.int32)])
    pallas = j_softmax(jnp.asarray(xp), jnp.int32(M), jnp.int32(sh), jnp.asarray(lut),
                       interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas)[:r])


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (5, 256, 96), (40, 512, 256)])
def test_int8_bitsplit_matmul_plain_equals_reference(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    bias = rng.integers(-50_000, 50_000, (n,)).astype(np.int32)
    M, sh = jfx.quantize_multiplier(0.0071 / np.sqrt(k))
    got = int8_bitsplit_matmul(_t(x), _t(w), _t(bias), M, sh).numpy()   # CPU: plain
    want = jref.int8_bitsplit_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                         jnp.int32(M), jnp.int32(sh))
    np.testing.assert_array_equal(got, np.asarray(want))
    mp = -(-m // 8) * 8
    xp = np.zeros((mp, k), np.int8)
    xp[:m] = x
    pallas = j_bitsplit(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(bias), jnp.int32(M),
                        jnp.int32(sh), bm=8, bn=min(n, 128) if n % 128 == 0 else n,
                        bk=128, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas)[:m])
    # the bit split is the direct int32 product, what the CUDA kernel computes
    direct = x.astype(np.int64) @ w.astype(np.int64) + bias
    assert np.abs(direct).max() < 2**31
    np.testing.assert_array_equal(
        got, jfx.requantize(jnp.asarray(direct.astype(np.int32)), jnp.int32(M), jnp.int32(sh)))


def test_ops_route_w8_linears_and_softmax_alike_on_both_backends():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 5, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (64, 12)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-999, 999, (12,)).astype(np.int32))
    f = FoldedLinear(w_packed=w, bias_i=b, M=torch.tensor(23170), shift=torch.tensor(21),
                         w_bits=8)
    y = ops.linear_w4a8(x, f, impl="gpu")
    assert y.shape == (2, 5, 12)
    np.testing.assert_array_equal(y.numpy(), ops.linear_w4a8(x, f, impl="ref").numpy())
    s = torch.from_numpy(rng.integers(-9000, 9000, (2, 3, 7, 7)).astype(np.int32))
    mask = torch.from_numpy(np.tril(np.ones((7, 7), bool)))
    lut = torch.from_numpy(jqs.make_exp_lut())
    np.testing.assert_array_equal(ops.softmax_q(s, 19000, 20, lut, mask, impl="gpu").numpy(),
                                  ops.softmax_q(s, 19000, 20, lut, mask, impl="ref").numpy())


@pytest.mark.parametrize("s", [16, 24, 32, 33, 77, 128, 512])
def test_lut_softmax_qat_matches_xla(s):
    """The QAT softmax simulator against the reference's, both float32,
    jitted as in its calibration forward: equal for rows of up to 17 and
    of more than 32 keys; rows of 18 to 32 keys are a float island (XLA
    fuses and reassociates that row sum), at most 0.05 % of probabilities
    off, each by exactly 1/128 (ROADMAP §3).  Half of one head is masked."""
    rng = np.random.default_rng(s)
    logits = (rng.standard_normal((2, 12, 64, s)) * 3).astype(np.float32)
    logits[0, 0, :, s // 2:] = -1e9
    s_logit = np.float32(rng.uniform(5, 60))
    want = np.asarray(jax.jit(lambda a, b: j_layers.lut_softmax_qat(a, b, True))(
        jnp.asarray(logits), jnp.float32(s_logit)))
    got = t_layers.lut_softmax_qat(torch.from_numpy(logits), torch.tensor(s_logit), True).numpy()
    flips = int((got != want).sum())
    print(f"lut_softmax_qat S={s}: {flips} of {got.size} probabilities differ")
    if s <= 17 or s > 32:
        assert flips == 0
    else:
        assert flips <= 5e-4 * got.size
        assert set(np.unique(np.abs(got - want))) <= {0.0, 1.0 / 128}


# --- numpy mirrors of the row kernels' arithmetic (csrc/quant_layernorm.cu,
# csrc/quant_softmax.cu): every identity the CUDA code relies on, held
# against the plain versions on the CPU -----------------------------------

I32_MAX = 2**31 - 1


def _wrap32(a):
    """int64 values modulo 2^32 as int32 (two's complement)."""
    return (np.asarray(a, np.int64) + 2**31) % 2**32 - 2**31


def _div_recip(a, n):
    """floor(a / n) for 0 <= a < 2^32 as the kernels take it: the high word
    of a * floor((2^32 - 1) / n), plus one correction step."""
    a = np.asarray(a, np.int64)
    n = np.asarray(n, np.int64)
    q = (a * ((2**32 - 1) // n)) >> 32
    return q + (a - q * n >= n)


def _ln_shifts(sh):
    """fixedpoint.rescale's two rounding shifts and their biases at out_bits 8."""
    pre = max(sh - 22, 0)
    n2 = sh - pre
    return pre, n2, (1 << (pre - 1)) if pre > 0 else 0, (1 << (n2 - 1)) if n2 > 0 else 0


def _ln_merged_clamp(M, sh):
    """The LN kernel's out_consts: whether the merged clamp may be taken at
    (M, sh), and its bound ahi (M a scalar or an int64 array)."""
    pre, n2, b1, b2 = _ln_shifts(sh)
    M = np.asarray(M, np.int64)
    if not (1 <= pre <= 30 and 1 <= n2 <= 30):
        return np.zeros(M.shape, bool), np.zeros(M.shape, np.int64)
    ok = (M > 0) & (32768 * M + b2 <= I32_MAX)
    vhi = np.minimum(((128 << n2) - b2 - 1) // np.maximum(M, 1), 32767)
    merge = ok & ((vhi * M + b2) >> n2 == 127)
    ahi = np.minimum((vhi + 1) * 2**pre - b1 - 1, I32_MAX)
    return merge, np.where(ok, ahi, 0)


def _ln_merged_out(acc, M, sh, ahi):
    """The merged path: one clamp of acc to +-ahi, then both rounding shifts
    as (v + b - [v < 0]) >> n."""
    pre, n2, b1, b2 = _ln_shifts(sh)
    acc = np.clip(np.asarray(acc, np.int64), -ahi, ahi)
    s = (acc < 0).astype(np.int64)
    out = (((acc + b1 - s) >> pre) * M + b2 - s) >> n2
    assert np.abs(out).max() <= 127
    return out


@pytest.mark.parametrize("sh", range(23, 53))
def test_ln_merged_clamp_equals_rescale_and_clip(sh):
    """At every output shift the merged clamp serves (23..52) and every Q15
    multiplier M in [2^14, 2^15), the kernel's one clamp of acc to +-ahi
    and its two sign-folded rounding shifts give clip(rescale(acc, M, sh),
    -127, 127): at the clamp's edges, at the first shift's rounding
    boundaries, at the accumulator's extremes and at seeded values."""
    M = np.arange(1 << 14, 1 << 15, dtype=np.int64)[:, None]
    merge, ahi = _ln_merged_clamp(M, sh)
    assert merge.all()
    pre, _, b1, _ = _ln_shifts(sh)
    hi = I32_MAX - b1 - (1 << 30)                 # |beta| the warps' check lets through
    rng = np.random.default_rng(sh)
    d = np.arange(-3, 4)
    k = (ahi + b1) >> pre                          # rounding boundaries k * 2^pre - b1 near ahi
    acc = np.concatenate([
        ahi + d, -ahi + d, (k << pre) - b1 + d, -((k << pre) - b1) + d,
        np.broadcast_to(d, (M.shape[0], d.size)),
        np.broadcast_to(np.array([hi + (1 << 30), -(hi + (1 << 30))]), (M.shape[0], 2)),
        rng.integers(-(hi + (1 << 30)), hi + (1 << 30), (M.shape[0], 8), endpoint=True),
        rng.integers(-4 * ahi.max(), 4 * ahi.max(), (M.shape[0], 8), endpoint=True)], axis=1)
    acc = np.clip(acc, -(hi + (1 << 30)), hi + (1 << 30))
    got = _ln_merged_out(acc, M, sh, ahi)
    want = torch.clamp(tfx.rescale(torch.from_numpy(acc.astype(np.int32)),
                                   torch.from_numpy(M.astype(np.int32)), sh), -127, 127)
    np.testing.assert_array_equal(got, want.numpy())


def _ln_kernel_mirror(x, gamma, beta, M, sh, sub_mean, eps=1):
    """quant_layernorm.cu in numpy: the one-reduction moments, the clz
    exponent, and the rounding shifts with one merged clamp where the
    output scale and |beta| allow them (|beta| over every column here, a
    warp's columns in the kernel).  Returns (out, ss, var, fast)."""
    x64 = x.astype(np.int64)
    n = x.shape[-1]
    sx = x64.sum(-1, keepdims=True)
    sq = (x64 * x64).sum(-1, keepdims=True)
    half = n // 2
    if sub_mean:
        q = _div_recip(np.abs(sx) + half, n)
        mean = np.where(sx >= 0, q, -q)
        ss = _wrap32(sq - 2 * mean * sx + n * mean * mean)   # modulo 2^32, as uint32
    else:
        mean, ss = np.zeros_like(sx), sq
    var = np.maximum(_div_recip(ss + half, n), eps)
    xv = np.maximum(var, 1)
    e = np.vectorize(lambda v: int(v).bit_length() - 1)(xv)  # 31 - clz(var)
    se = e >> 1
    shv = 14 - 2 * se
    m14 = np.where(shv >= 0, xv << np.maximum(shv, 0), xv >> np.maximum(-shv, 0))
    y = np.where(m14 < (1 << 15), 27853, 19661).astype(np.int64)
    for _ in range(3):
        y = (y * ((3 << 14) - ((m14 * ((y * y) >> 15)) >> 15))) >> 15
    prod = x64 * y - mean * y
    assert np.abs(prod).max() < 2**23
    nq = (prod + (1 << se) + (prod >> 63)) >> (se + 1)
    g = gamma.astype(np.int64)
    assert np.abs(nq * g).max() < 2**30            # the bound the kernel's check uses
    merge, ahi = _ln_merged_clamp(M, sh)
    b1 = (1 << (sh - 23)) if sh > 22 else 0
    fast = merge and int(np.abs(beta.astype(np.int64)).max()) + 2**30 + b1 <= I32_MAX
    if fast:
        out = _ln_merged_out(nq * g + beta, M, sh, ahi)
    else:
        acc = torch.from_numpy(_wrap32(nq * g + beta).astype(np.int32))
        out = tfx.rescale(acc, M, sh).numpy()
    return np.clip(out, -127, 127).astype(np.int8), ss, var, fast


LN_ROWS = ("seeded", "all_min", "all_max", "alternating", "single", "wide_beta",
           "small_shift")


@pytest.mark.parametrize("sub_mean", [True, False])
@pytest.mark.parametrize("n", [1, 7, 768, 4096, 16384])
@pytest.mark.parametrize("kind", LN_ROWS)
def test_ln_one_reduction_moments_are_exact(kind, n, sub_mean):
    """The LN kernel's centred sum of squares, sum x^2 - 2 m sum x + N m^2
    in int32 with the rounded mean m, equals the reference's sum (x - m)^2,
    and so its var and quant_layernorm_ref's codes, on seeded rows and the
    extremes; ``wide_beta`` (|beta| near 2^31) and ``small_shift`` (an
    output shift of 19, below the merged clamp's range) take the wrapping
    path."""
    rng = np.random.default_rng(n * 7 + LN_ROWS.index(kind) * 2 + sub_mean)
    x = {"seeded": lambda: rng.integers(-128, 128, (3, n)),
         "all_min": lambda: np.full((1, n), -128),
         "all_max": lambda: np.full((1, n), 127),
         "alternating": lambda: np.where(np.arange(n) % 2 == 0, 127, -127)[None],
         "single": lambda: np.eye(1, n, n // 3) * 91,
         "wide_beta": lambda: rng.integers(-128, 128, (3, n)),
         "small_shift": lambda: rng.integers(-128, 128, (3, n))}[kind]().astype(np.int8)
    gamma = rng.integers(-128, 128, n).astype(np.int8)
    lim = 2**31 - 1 if kind == "wide_beta" else 2**20
    beta = rng.integers(-lim, lim, n, endpoint=True).astype(np.int32)
    if kind == "wide_beta":
        beta[0] = -(2**31)
    M, sh = tfx.quantize_multiplier({"wide_beta": 3.3e-5, "small_shift": 0.05}.get(kind, 0.0021))
    got, ss, var, fast = _ln_kernel_mirror(x, gamma, beta, M, sh, sub_mean)
    assert fast == (kind not in ("wide_beta", "small_shift"))
    x64 = x.astype(np.int64)
    half = n // 2
    if sub_mean:
        s = x64.sum(-1, keepdims=True)
        mean = np.where(s >= 0, (s + half) // n, -((-s + half) // n))
    else:
        mean = 0
    ss_ref = ((x64 - mean) ** 2).sum(-1, keepdims=True)
    np.testing.assert_array_equal(ss, ss_ref)
    np.testing.assert_array_equal(var, np.maximum((ss_ref + half) // n, 1))
    p = tln.QLNParams(_t(gamma), _t(beta), torch.tensor(M, dtype=torch.int32),
                      torch.tensor(sh, dtype=torch.int32), sub_mean)
    np.testing.assert_array_equal(got, tref.quant_layernorm_ref(_t(x), p).numpy())


def _softmax_kernel_mirror(x, M, sh, lut):
    """quant_softmax.cu in numpy: the one-pass index where the block's and
    the row's checks allow it, the reciprocal division by den."""
    lut64 = lut.astype(np.int64)
    x64 = x.astype(np.int64)
    pre = max(sh - 21, 0)
    n2 = sh - pre
    b1 = (1 << (pre - 1)) if pre > 0 else 0
    b2 = (1 << (n2 - 1)) if n2 > 0 else 0
    fast_idx = pre <= 30 and n2 <= 30 and M >= 0 and 32767 * M + b2 <= I32_MAX
    fast_out = bool(((lut64 >= 0) & (lut64 < 32768)).all()) and x.shape[-1] <= 65536
    m = x64.max(-1, keepdims=True)
    fast = fast_idx & (m - x64.min(-1, keepdims=True) + b1 <= I32_MAX)
    v = np.minimum((m + b1 - x64) >> pre, 32767)
    idx_fast = np.minimum((v * M + b2) >> n2, 255)
    d = torch.from_numpy(_wrap32(m - x64).astype(np.int32))
    idx_ref = torch.clamp(tfx.rescale(d, M, sh, out_bits=9), 0, 255).numpy()
    num = lut64[np.where(fast, idx_fast, idx_ref)]
    den = np.maximum(_wrap32(num.sum(-1, keepdims=True)), 1)
    assert fast_out
    p = _div_recip(num * 128 + den // 2, den)
    return np.minimum(p, 127).astype(np.int8), fast


@pytest.mark.parametrize("s", [1, 77, 128, 512])
@pytest.mark.parametrize("rows", ["bert", "masked", "wrapping"])
def test_softmax_one_pass_index_and_reciprocal_are_exact(rows, s):
    """The softmax kernel's index min(min((m + b - x) >> pre, 2^15 - 1) * M
    + b' >> n, 255) on rows whose range cannot wrap, and floor((num * 128
    + den / 2) / den) through den's reciprocal, equal quant_softmax_ref;
    ``wrapping`` rows span more than 2^31 and take the reference's helpers."""
    rng = np.random.default_rng(s * 3 + len(rows))
    x = rng.integers(-400_000, 400_000, (24, s)).astype(np.int64)
    if rows == "masked":
        x[::3, (2 * s) // 3:] -= tqs.MASK_OFFSET
        x[1] -= tqs.MASK_OFFSET
    if rows == "wrapping":
        x[::2, 0] = I32_MAX
        x[::2, -1] = -(2**31)
    x = x.astype(np.int32)
    M, sh = tfx.quantize_multiplier(1.0 / (rng.uniform(20, 60) * jqs.LUT_DELTA))
    lut = jqs.make_exp_lut()
    got, fast = _softmax_kernel_mirror(x, M, sh, lut)
    assert fast.all() == (rows != "wrapping" or s == 1)
    np.testing.assert_array_equal(got, tref.quant_softmax_ref(_t(x), M, sh, _t(lut)).numpy())
