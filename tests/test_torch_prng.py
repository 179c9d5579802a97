"""The port's key derivation and random words against jax, bit for bit:
``PRNGKey`` / ``fold_in`` / ``key_data`` / ``split`` (threefry2x32 under the
installed jax's settings), the vectorised ``random_bits`` / ``uniform`` /
``bernoulli`` over several keys and shapes (rank 5, and a size that spans
more than one chunk of counters), and ``draw_bits`` (the murmur3 counter
hash)."""
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
