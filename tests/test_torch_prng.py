"""The port's host-side key derivation and draw words against jax, bit for
bit: ``PRNGKey`` / ``fold_in`` / ``key_data`` (threefry2x32 under the
installed jax's settings) and ``draw_bits`` (the murmur3 counter hash)."""
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
