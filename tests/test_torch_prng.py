"""The port's key derivation and random words against jax, bit for bit:
``PRNGKey`` / ``fold_in`` / ``key_data`` / ``split`` (threefry2x32 under the
installed jax's settings), the vectorised ``random_bits`` / ``uniform`` /
``bernoulli`` over several keys and shapes (rank 5, and a size that spans
more than one chunk of counters), ``draw_bits`` (the murmur3 counter hash),
stacks of keys, and ``normal``: its uniforms on [nextafter(-1, 0), 1) bit
for bit, its values within 3 float32 ulps of ``jax.random.normal`` (XLA's
``erf_inv`` polynomial, each Horner step rounded as one FMA; the gap is the
two libraries' ``log1p``), checked over every uniform the words can give."""
import jax
import numpy as np
import pytest

from repro.kernels import ops as j_ops
from repro_torch import prng
from repro_torch.kernels import ops as t_ops

SEEDS = (0, 1, 2 ** 31 - 1, 1234)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(
        prng.key_data(prng.PRNGKey(seed)),
        np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("seed", SEEDS)
def test_chained_fold_in_matches_jax(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in (0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1, 3):
        kj, kt = jax.random.fold_in(kj, data), prng.fold_in(kt, data)
        np.testing.assert_array_equal(prng.key_data(kt),
                                      np.asarray(jax.random.key_data(kj)))


def test_fold_in_known_value():
    np.testing.assert_array_equal(
        prng.key_data(prng.fold_in(prng.PRNGKey(0), 1)),
        np.asarray([928981903, 3453687069], np.uint32))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31)


@pytest.mark.parametrize("seed,data,n,c", [
    (0, None, 64, 32), (0, 0, 4096, 32), (1234, 17, 100, 8),
    (2 ** 31 - 1, 5, 3, 5)])
def test_draw_bits_matches_jax(seed, data, n, c):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    if data is not None:
        kj, kt = jax.random.fold_in(kj, data), prng.fold_in(kt, data)
    want = np.asarray(j_ops.draw_bits(kj, n, c)).astype(np.int64)
    got = t_ops.draw_bits(kt, n, c).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)


# --- split / random_bits / uniform / bernoulli (jax_threefry_partitionable) --

KEYS = ((0, None), (1234, 7), (2 ** 31 - 1, 3))
SHAPES = ((5,), (3, 7), (2, 4, 4, 3, 8), (1, 3, 5, 2, 4))


def _keys(seed, data):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    if data is not None:
        kj, kt = jax.random.fold_in(kj, data), prng.fold_in(kt, data)
    return kj, kt


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_matches_jax(seed, data, num):
    kj, kt = _keys(seed, data)
    np.testing.assert_array_equal(
        prng.split(kt, num), np.asarray(jax.random.key_data(
            jax.random.split(kj, num))))


@pytest.mark.parametrize("seed,data", KEYS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform_match_jax(seed, data, shape):
    kj, kt = _keys(seed, data)
    np.testing.assert_array_equal(
        prng.random_bits(kt, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(kj, shape)))
    got = prng.uniform(kt, shape).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.uniform(kj,
                                                                     shape)))
    assert got.dtype == np.float32


def test_words_span_chunks(monkeypatch):
    """Each word depends on its counter alone: a chunk boundary moves no
    bit (4,100 counters in chunks of 1,000)."""
    kj, kt = _keys(5, 11)
    shape = (2, 5, 10, 41)
    monkeypatch.setattr(prng, "_CHUNK", 1000)
    np.testing.assert_array_equal(
        prng.random_bits(kt, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(kj, shape)))
    np.testing.assert_array_equal(prng.uniform(kt, shape).numpy(),
                                  np.asarray(jax.random.uniform(kj, shape)))
    flat = np.asarray(jax.random.bits(kj, shape)).reshape(-1)
    for start, stop in ((0, 7), (990, 1013), (4000, 4100)):
        np.testing.assert_array_equal(
            prng.counter_words(kt, start, stop).numpy().astype(np.uint32),
            flat[start:stop])


@pytest.mark.parametrize("seed,data", KEYS)
def test_bernoulli_matches_jax(seed, data):
    import jax.numpy as jnp
    import torch
    kj, kt = _keys(seed, data)
    p = np.random.default_rng(seed % 97).uniform(size=(4, 6, 1)).astype(
        np.float32)
    shape = (4, 6, 8)
    np.testing.assert_array_equal(
        prng.bernoulli(kt, torch.from_numpy(p), shape).numpy(),
        np.asarray(jax.random.bernoulli(kj, jnp.asarray(p), shape)))
    for q in (0.05, 0.0, 0.5):
        np.testing.assert_array_equal(
            prng.bernoulli(kt, q, shape).numpy(),
            np.asarray(jax.random.bernoulli(kj, q, shape)))


def _ulps(a, b):
    """Distance in float32 ulps (a monotone integer map of the bits)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


# the largest gap of prng.normal from jax.random.normal, in float32 ulps
NORMAL_ULPS = 3


@pytest.mark.parametrize("seed,data", KEYS)
def test_normal_matches_jax(seed, data):
    kj, kt = _keys(seed, data)
    for shape in ((7,), (32, 8), (3, 5, 41)):
        got = prng.normal(kt, shape).numpy()
        want = np.asarray(jax.random.normal(kj, shape))
        assert got.dtype == np.float32 and got.shape == shape
        assert _ulps(got, want).max() <= NORMAL_ULPS


def test_erfinv_over_every_uniform_of_the_words():
    """All 2^23 values ``normal`` can feed ``erfinv``: the uniform grid
    moved onto [nextafter(-1, 0), 1) equals jax's bit for bit, and
    ``sqrt(2) * erfinv`` stays within NORMAL_ULPS of jax's (torch.erfinv
    does not: it is tens of ulps away near the tails)."""
    import jax.numpy as jnp
    import torch
    mant = np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)
    unit = mant.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u_t = torch.clamp(torch.from_numpy(unit) * (1.0 - float(lo)) + float(lo),
                      min=float(lo))
    u_j = jax.jit(lambda x: jnp.maximum(lo, x * (np.float32(1.0) - lo) + lo))(
        jnp.asarray(unit))
    np.testing.assert_array_equal(u_t.numpy().view(np.uint32),
                                  np.asarray(u_j).view(np.uint32))
    sqrt2 = np.float32(np.sqrt(2.0))
    want = np.asarray(jax.jit(lambda x: sqrt2 * jax.lax.erf_inv(x))(u_j))
    got = (float(sqrt2) * prng.erfinv(u_t)).numpy()
    assert _ulps(got, want).max() <= NORMAL_ULPS
    assert _ulps((float(sqrt2) * torch.erfinv(u_t)).numpy(),
                 want).max() > 4 * NORMAL_ULPS


def test_stacked_keys_give_each_keys_words():
    """A (G, 2) stack of keys gives (G, *shape): row g the words, uniforms
    and normals of key g alone."""
    keys = np.stack([prng.fold_in(prng.PRNGKey(3), d) for d in (0, 5, 9)])
    shape = (4, 5)
    for fn in (prng.random_bits, prng.uniform, prng.normal):
        stacked = fn(keys, shape)
        assert tuple(stacked.shape) == (3, *shape)
        for g in range(3):
            assert bool((stacked[g] == fn(keys[g], shape)).all()), fn
