"""Threefry-2x32 keys and random words, bit-exact with ``jax.random``.

The engine folds one key per microbatch (``fold_in``) and the frontend
kernels hash their draw words from the key's two 32-bit words. Keys are
tiny and live on the host: a key here is a ``(2,)`` numpy ``uint32`` array,
the same words ``jax.random.key_data`` returns, and a kernel receives only
those two words as scalar arguments.

With jax's ``jax_threefry_partitionable`` setting on, every word is the
20-round Threefry-2x32 block of a counter pair under the key:

* ``fold_in(key, d)`` is the block of ``(0, d)``, and ``split(key, n)[i]``
  the block of ``(0, i)``;
* ``random_bits(key, shape)`` at flat row-major index ``i`` is ``x0 ^ x1``
  of the block of ``(i >> 32, i & 0xFFFFFFFF)``;
* ``uniform`` keeps 23 bits of a word as a float32 mantissa in [1, 2) and
  subtracts 1; ``bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``;
* ``randint`` takes two words a value (the bits of ``split(key)``'s two
  keys) and reduces them modulo the span in wrapping uint32, as jax does;
* ``normal`` is ``sqrt(2) * erfinv(u)`` with u those uniforms moved onto
  [nextafter(-1, 0), 1), bit for bit; ``erfinv`` is XLA's single-precision
  polynomial (``torch.erfinv`` is up to 91 float32 ulps from it; this one
  at most 3 over every u the words can give, ``tests/test_torch_prng.py``).

The tests hold each against the installed jax. Random words are made in
plain PyTorch on the device of the tensor they are compared with, in int64
tensors masked to 32 bits after every add and shift (an int32 right shift
is arithmetic and would break the rotation), in chunks of counters to
bound memory: each word depends on its counter alone, so chunking changes
no bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# counters per chunk of the vectorised generator (a few int64 temporaries
# of this length are live at once: ~200 MB)
_CHUNK = 1 << 22
_ONE_F32_BITS = 0x3F800000      # float32 1.0
_MANTISSA_SHIFT = 32 - 23       # float32 keeps 23 mantissa bits


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


def _threefry2x32_tensor(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` over int64 tensors of counter words in [0, 2^32),
    under the key words ``k0``, ``k1``: Python ints, or int64 tensors that
    broadcast against the counters (one key a row)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
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


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``(num, 2)`` uint32 keys, row ``i`` the block
    of the counter ``(0, i)``."""
    return np.asarray([threefry2x32(key, 0, i) for i in range(num)],
                      np.uint32).reshape(num, 2)


def key_data(key) -> np.ndarray:
    """The key's two uint32 words (a key already is its data here)."""
    return np.asarray(key, np.uint32).reshape(2)


def _key_words(key, device):
    """The key's two words as ints, or for a ``(G, 2)`` stack of keys as
    two (G, 1) int64 tensors on ``device``."""
    k = np.asarray(key, np.uint32)
    if k.ndim == 1:
        return int(k[0]), int(k[1])
    if k.ndim != 2 or k.shape[1] != 2:
        raise ValueError(f"a key is (2,) or a (G, 2) stack, got {k.shape}")
    kt = torch.as_tensor(k.astype(np.int64), device=device)
    return kt[:, :1], kt[:, 1:]


def _lead(key) -> tuple:
    """``()`` for one key, ``(G,)`` for a stack of G keys."""
    return np.shape(key)[:-1]


def counter_words(key, start: int, stop: int, device=None) -> torch.Tensor:
    """The random words of the flat counters ``start`` .. ``stop - 1``
    (int64 values in [0, 2^32)): that slice of the flattened
    ``random_bits``, made without the words before it. A (G, 2) stack of
    keys gives (G, stop - start) words, row g under key g."""
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32_tensor(*_key_words(key, device), i >> 32,
                                  i & _MASK)
    return x0 ^ x1


def _word_chunks(key, n: int, device):
    """Yield ``(start, words)`` over the counters 0 .. n - 1, ``_CHUNK`` at
    a time."""
    for start in range(0, n, _CHUNK):
        yield start, counter_words(key, start, min(start + _CHUNK, n), device)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words) as an int64 tensor of
    values in [0, 2^32) on ``device``; a (G, 2) stack of keys gives
    (G, *shape), each row ``random_bits`` of its key."""
    n, lead = math.prod(shape), _lead(key)
    out = torch.empty(lead + (n,), dtype=torch.int64, device=device)
    for start, words in _word_chunks(key, n, device):
        out[..., start:start + words.shape[-1]] = words
    return out.reshape(lead + tuple(shape))


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) on ``device``;
    a (G, 2) stack of keys gives (G, *shape)."""
    n, lead = math.prod(shape), _lead(key)
    out = torch.empty(lead + (n,), dtype=torch.float32, device=device)
    for start, words in _word_chunks(key, n, device):
        mant = ((words >> _MANTISSA_SHIFT) | _ONE_F32_BITS).to(torch.int32)
        out[..., start:start + words.shape[-1]] = (
            mant.view(torch.float32) - 1.0)
    return out.reshape(lead + tuple(shape))


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 where w = -log1p(-x^2) < 5, else in
# sqrt(w) - 3, times x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor. Each Horner step
    ``c + p * w`` rounds once, as a fused multiply-add does (float64
    holds the float32 product exactly); +-1 map to +-inf."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    # 2.5 is XLA's erf_inv shift, not the pixel's 2.5 saturation
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)  # analysis: waive=physics-constants

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coef(0)
    w64 = w.to(torch.float64)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i).to(torch.float64) + p.to(torch.float64) * w64).to(
            torch.float32)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 on ``device``: the
    words of ``uniform`` scaled onto [nextafter(-1, 0), 1) (bit for bit
    jax's), then ``sqrt(2) * erfinv``; a (G, 2) stack of keys gives
    (G, *shape)."""
    u = uniform(key, shape, device) * (1.0 - _NORMAL_LO) + _NORMAL_LO
    return _SQRT2_F32 * erfinv(torch.clamp(u, min=_NORMAL_LO))


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``(a * m) mod 2^32`` for words a, m < 2^32, in int64 without
    overflow: m in 16-bit halves."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on
    ``device``, bit for bit: two words a value from the halves of
    ``split(key)``, ``span = maxval - minval`` as uint32 (1 where ``maxval
    <= minval``), then ``minval + ((hi % span) * m + lo % span) % span``
    with ``m = (2^16 % span)^2 % span``, all in wrapping uint32. Bounds
    outside int32 raise, as jax refuses them."""
    minval, maxval = int(minval), int(maxval)
    if not all(_I32_MIN <= b <= _I32_MAX for b in (minval, maxval)):
        raise OverflowError(f"randint bounds ({minval}, {maxval}) do not fit "
                            "int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK  # >= 1
    mult = (((1 << 16) % span) ** 2 & _MASK) % span
    offset = ((_mul32(higher % span, mult) + lower % span) & _MASK) % span
    # minval + offset, wrapping in int32
    return (((minval + offset + 2 ** 31) & _MASK) - 2 ** 31).to(torch.int32)


def bernoulli(key, p, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: a bool tensor, drawn on the
    device of ``p`` where ``p`` is a tensor (broadcast against ``shape``),
    else on ``device``."""
    if isinstance(p, torch.Tensor):
        device = p.device
    return uniform(key, tuple(shape), device) < p
