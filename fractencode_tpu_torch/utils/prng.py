"""The JAX PRNG draws VQ seeding needs, reproduced bit for bit in numpy.

Reproduces ``jax.random.PRNGKey``, ``split``, 32-bit ``random_bits``,
``permutation`` and ``choice(..., replace=False)`` of jax 0.9 with its
default ``threefry2x32`` implementation and ``jax_threefry_partitionable``
on (``jax/_src/prng.py``: ``_threefry_seed``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_shuffle``, ``choice``), so that
``encode.vq.train_codebook`` draws the JAX package's seeds and subsample
without importing jax.  A key is a [2] uint32 array, as JAX's legacy keys.
"""
from __future__ import annotations

import numpy as np

__all__ = ["prng_key", "split", "random_bits", "permutation", "choice"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key``: two uint32 arrays of their shape."""
    k0, k1 = (np.uint32(v) for v in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n: int):
    """The high and low words of a 64-bit iota of length n."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32 (jax's
    default 32-bit mode): the high word is 0, the low word the seed's bits."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError("seed must fit in int32")
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    """n uint32 draws, as JAX's 32-bit ``random_bits`` of shape (n,)."""
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``_shuffle`` of arange(n), a stable
    sort by fresh 32-bit keys in each of ceil(3 ln n / ln(2^32 - 1)) rounds
    (2 rounds for n from 1,626 to 2,642,245)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n, dtype=np.int32)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def choice(key: np.ndarray, n: int, k: int) -> np.ndarray:
    """``jax.random.choice(key, n, shape=(k,), replace=False)``: the first k
    of ``permutation(key, n)``."""
    if k > n:
        raise ValueError(f"cannot draw {k} of {n} without replacement")
    return permutation(key, n)[:k]
