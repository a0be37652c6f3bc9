"""The port's numpy threefry (``repro_torch.core.prng``) against the
installed ``jax.random`` on the CPU: block-function words, keys, ``split``,
random bits, uniform floats, Gumbel noise and ``categorical`` draws, equal
bit for bit.  The float32 log is XLA's CPU polynomial; it is checked on
every input a Gumbel draw can reach (the 2^23 uniform values and their
negated logs)."""
from fractions import Fraction

import jax
import jax.extend.random as jex
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2**31 - 1, -1, 123456789]
SHAPES = [(5,), (3, 1001), (2, 512), (4, 3, 7)]


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", range(4))
def test_threefry_words_match_jax(seed):
    rng = np.random.default_rng(seed)
    kp = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, 2 * 257, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jex.threefry_2x32((jnp.uint32(kp[0]), jnp.uint32(kp[1])), jnp.asarray(x)))
    o1, o2 = prng.threefry2x32(kp, x[:257], x[257:])
    np.testing.assert_array_equal(np.concatenate([o1, o2]), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_split_chain_match_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(k, np.asarray(jk))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(k, n), np.asarray(jax.random.split(jk, n)))
    for _ in range(12):                   # the engine's key, sub = split(key), step after step
        jk, jsub = jax.random.split(jk)
        k, sub = prng.split(k)
        np.testing.assert_array_equal(k, np.asarray(jk))
        np.testing.assert_array_equal(sub, np.asarray(jsub))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_uniform_gumbel_match_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(prng.random_bits(k, shape),
                                  np.asarray(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(_bits(prng.uniform(k, shape)),
                                  _bits(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(_bits(prng.uniform(k, shape, -3.0, 5.0)),
                                  _bits(jax.random.uniform(jk, shape, minval=-3.0, maxval=5.0)))
    np.testing.assert_array_equal(_bits(prng.gumbel(k, shape)),
                                  _bits(jax.random.gumbel(jk, shape)))


@pytest.mark.parametrize("temperature", [1.0, 0.7, 0.05])
@pytest.mark.parametrize("shape", [(8, 512), (3, 64000), (5, 17)])
def test_categorical_matches_jax(shape, temperature):
    rng = np.random.default_rng(shape[-1])
    logits = (rng.standard_normal(shape) * 4).astype(np.float32) / np.float32(temperature)
    jk, k = jax.random.PRNGKey(7), prng.key(7)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        k, sub = prng.split(k)
        want = np.asarray(jax.random.categorical(jsub, jnp.asarray(logits), -1))
        np.testing.assert_array_equal(prng.categorical(sub, logits, -1), want)


@pytest.mark.parametrize("spread", [0.0, 1e-6, 1e-4, 1e-2])
@pytest.mark.parametrize("shape", [(8, 64000), (4, 3001)])
def test_categorical_near_ties_match_jax(shape, spread):
    """Logits that cancel the draw's own Gumbel noise up to ``spread``: many
    scores sit within a few ulps of the row maximum, where numpy's log and
    XLA's can order them differently, so the draw rests on the exact
    recompute of the near-maximal scores."""
    jk, k = jax.random.PRNGKey(3), prng.key(3)
    rng = np.random.default_rng(int(spread * 1e6) + shape[-1])
    noise = (rng.standard_normal(shape) * spread).astype(np.float32)
    logits = np.float32(5.0) - prng.gumbel(k, shape) + noise
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), -1))
    np.testing.assert_array_equal(prng.categorical(k, logits, -1), want)
    want_t = np.asarray(jax.random.categorical(jk, jnp.asarray(logits.T), 0))
    np.testing.assert_array_equal(prng.categorical(k, logits.T, 0), want_t)


def test_log_matches_xla_on_every_gumbel_input():
    u = (np.arange(2**23, dtype=np.uint32) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    u = np.maximum(u, prng.TINY)
    xla_log = jax.jit(jnp.log)
    inner = np.asarray(xla_log(u))
    np.testing.assert_array_equal(_bits(prng.log_f32(u)), _bits(inner))
    np.testing.assert_array_equal(_bits(prng.log_f32(-inner)), _bits(xla_log(-inner)))
    special = np.array([0.0, -1.0, np.inf, np.nan, 1.0, prng.TINY], np.float32)
    np.testing.assert_array_equal(prng.log_f32(special), np.asarray(xla_log(special)))


def test_fma_rounds_once():
    """Against exact rationals, on random operands and on sums built to
    sit next to a float32 midpoint, where a float64 sum rounds twice."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    one_ulp = np.float32(2.0**-23)
    a[:1000], b[:1000] = np.float32(1.0) + one_ulp, np.float32(1.0) + one_ulp
    c[:1000] = np.float32(2.0**-24) * np.float32(rng.choice([-1.0, 1.0]))
    got = prng.fma(a, b, c)
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo, hi = np.float32(r), np.nextafter(np.float32(r), np.float32(np.inf))
        dn = np.nextafter(np.float32(r), np.float32(-np.inf))
        err = abs(Fraction(float(r)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact) and err <= abs(Fraction(float(dn)) - exact)
        assert lo == r
