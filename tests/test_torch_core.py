"""Integer core of the port against the reference's, bit for bit: the same
inputs (numpy, from a seed) through both, equal arrays — not allclose."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfx
from repro.core import packing as jpk
from repro.core import qlayernorm as jln
from repro.core import qsoftmax as jqs
from repro.kernels import ref as jref
from repro_torch.core import fixedpoint as tfx
from repro_torch.core import packing as tpk
from repro_torch.core import qlayernorm as tln
from repro_torch.core import qsoftmax as tqs
from repro_torch.kernels import ref as tref


def _eq(t: torch.Tensor, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


MS = [(16384, 0), (16384, 7), (23170, 15), (32767, 22), (20000, 30), (16385, 40)]


@pytest.mark.parametrize("M,shift", MS)
@pytest.mark.parametrize("out_bits", [8, 9])
def test_rescale_requantize_match(M, shift, out_bits):
    rng = np.random.default_rng(M + shift)
    acc = np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, 100_000, dtype=np.int64),
        rng.integers(-70_000, 70_000, 20_000),
        [0, 1, -1, 2**31 - 1, -(2**31), 2**30, -(2**30), 2**15, -(2**15)],
    ]).astype(np.int32)
    _eq(tfx.rescale(torch.from_numpy(acc), M, shift, out_bits),
        jfx.rescale(jnp.asarray(acc), M, shift, out_bits))
    _eq(tfx.requantize(torch.from_numpy(acc), M, shift),
        jfx.requantize(jnp.asarray(acc), M, shift))


def test_rshift_round_per_element_shifts():
    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31), 2**31 - 1, 50_000, dtype=np.int64).astype(np.int32)
    n = rng.integers(0, 31, 50_000).astype(np.int32)
    _eq(tfx._rshift_round(torch.from_numpy(x), torch.from_numpy(n)),
        jfx._rshift_round(jnp.asarray(x), jnp.asarray(n)))


def test_rsqrt_mantexp_every_variance():
    var = np.arange(1, 1 << 16, dtype=np.int32)
    ty, ts = tfx.rsqrt_mantexp(torch.from_numpy(var))
    jy, js = jfx.rsqrt_mantexp(jnp.asarray(var))
    _eq(ty, jy)
    _eq(ts, js)


def test_clz_exponent_identity_over_ln_variance_range():
    """The CUDA LN kernel takes rsqrt_mantexp's exponent as 31 - clz(var);
    the reference as floor(log2(float32(var) * (1 + 2^-23))).  They agree on
    every var in [1, 2^16) — the whole range an int8 LN row can produce."""
    var = np.arange(1, 1 << 16, dtype=np.int64)
    bit_len = np.array([int(v).bit_length() - 1 for v in var])
    f = var.astype(np.float32) * np.float32(1.0 + 2.0**-23)
    assert np.float32(1.0 + 1e-7) == np.float32(1.0 + 2.0**-23)
    np.testing.assert_array_equal(np.floor(np.log2(f)).astype(np.int64), bit_len)
    t = torch.floor(torch.log2(torch.from_numpy(var.astype(np.float32)) * (1.0 + 1e-7)))
    np.testing.assert_array_equal(t.numpy().astype(np.int64), bit_len)
    j = jnp.floor(jnp.log2(jnp.asarray(var, jnp.int32).astype(jnp.float32) * (1.0 + 1e-7)))
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), bit_len)


@pytest.mark.parametrize("shape,axis", [((6, 5), 0), ((3, 10), 1), ((2, 14, 3), 1),
                                        ((34, 7), 0)])
def test_planar_pack_roundtrip_odd_shapes(shape, axis):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(-8, 8, shape).astype(np.int8)
    tp = tpk.pack_int4_planar(torch.from_numpy(codes), axis=axis)
    _eq(tp, jpk.pack_int4_planar(jnp.asarray(codes), axis=axis))
    _eq(tpk.unpack_int4_planar(tp, axis=axis), codes)


def test_exp_luts_match():
    np.testing.assert_array_equal(tqs.make_exp_lut(), jqs.make_exp_lut())
    np.testing.assert_array_equal(tref.make_exp_lut_q7(), jref.make_exp_lut_q7())
    assert (tqs.LUT_DELTA, tqs.MASK_OFFSET) == (jqs.LUT_DELTA, jqs.MASK_OFFSET)


def test_quantize_multiplier_array_matches():
    rng = np.random.default_rng(3)
    s = np.concatenate([10.0 ** rng.uniform(-9, 4, 20_000),
                        2.0 ** np.arange(-30, 12), [1e-40, 0.0, 3.0e4]]).astype(np.float32)
    tM, ts = tfx.quantize_multiplier_array(torch.from_numpy(s))
    jM, js = jfx.quantize_multiplier_array(jnp.asarray(s))
    _eq(tM, jM)
    _eq(ts, js)
    for v in s[:200]:
        assert tfx.quantize_multiplier(float(v)) == jfx.quantize_multiplier(float(v))


def test_quant_softmax_matches():
    rng = np.random.default_rng(4)
    x = rng.integers(-30_000, 30_000, (64, 48)).astype(np.int32)
    mask = rng.random((64, 48)) > 0.3
    M, sh = jfx.quantize_multiplier(1.0 / (0.003 * jqs.LUT_DELTA))
    lut = jqs.make_exp_lut()
    _eq(tqs.quant_softmax(torch.from_numpy(x), M, sh, torch.from_numpy(lut),
                          mask=torch.from_numpy(mask)),
        jqs.quant_softmax(jnp.asarray(x), M, sh, jnp.asarray(lut), mask=jnp.asarray(mask)))


@pytest.mark.parametrize("subtract_mean", [True, False])
@pytest.mark.parametrize("n", [128, 4096])
def test_quant_layernorm_matches(subtract_mean, n):
    rng = np.random.default_rng(n + subtract_mean)
    x = rng.integers(-127, 128, (40, n)).astype(np.int8)
    x[0] = 127                      # extreme rows: zero variance, max codes
    x[1] = -127
    x[2, ::2], x[2, 1::2] = 127, -127
    gamma = rng.integers(-127, 128, n).astype(np.int8)
    beta = rng.integers(-(2**20), 2**20, n).astype(np.int32)
    M, sh = jfx.quantize_multiplier(0.0021)
    jp = jln.QLNParams(jnp.asarray(gamma), jnp.asarray(beta), jnp.int32(M), jnp.int32(sh),
                       subtract_mean)
    tp = tln.QLNParams(torch.from_numpy(gamma), torch.from_numpy(beta),
                       torch.tensor(M, dtype=torch.int32), torch.tensor(sh, dtype=torch.int32),
                       subtract_mean)
    _eq(tln.quant_layernorm(torch.from_numpy(x), tp), jln.quant_layernorm(jnp.asarray(x), jp))
