"""Threefry-2x32 key derivation, bit-exact with ``jax.random``'s raw keys.

The engine folds one key per microbatch (``fold_in``) and the frontend
kernels hash their draw words from the key's two 32-bit words. Keys are
tiny and live on the host: a key here is a ``(2,)`` numpy ``uint32`` array,
the same words ``jax.random.key_data`` returns, and a kernel receives only
those two words as scalar arguments.

``fold_in`` hashes ``[0, data]`` under the key with 20 Threefry rounds;
the ``jax_threefry_partitionable`` setting changes ``split`` and
``random_bits``, not ``fold_in`` (the tests check against jax itself).
"""
from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0: int, x1: int):
    """One Threefry-2x32 block (20 rounds) of the counter pair (x0, x1)."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """The raw ``(2,)`` uint32 key of ``jax.random.PRNGKey(seed)`` for a
    32-bit seed (jax's default mode): ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    return np.asarray((0, seed & _MASK), np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter ``[0, data]`` under ``key``."""
    return np.asarray(threefry2x32(key, 0, int(data) & _MASK), np.uint32)


def key_data(key) -> np.ndarray:
    """The key's two uint32 words (a key already is its data here)."""
    return np.asarray(key, np.uint32).reshape(2)
