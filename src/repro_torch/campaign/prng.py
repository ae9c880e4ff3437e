"""JAX's default counter-based PRNG (Threefry-2x32, the partitionable
layout JAX uses since 0.5), in numpy: key, split, fold_in, randint and
uniform draw the bits ``jax.random`` draws for the same key.

The adaptive grid (:mod:`repro_torch.campaign.adaptive`) takes its
table, bags and flips from this stream, so a cell of the port draws the
trials the reference's cell draws and the two are compared trial for
trial, not only in distribution.  Keys are ``(2,)`` uint32 arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x0, x1)``
    under ``key``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s key data in JAX's default 32-bit mode,
    which keeps the seed's low word."""
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def _counts(shape) -> Tuple[np.ndarray, np.ndarray]:
    """The row-major index of each element as (high, low) uint32 words."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)
                                               ).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: ``num`` keys, one a row."""
    b0, b1 = threefry2x32(k, *_counts((num,)))
    return np.stack([b0, b1], axis=1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    b0, b1 = threefry2x32(k, np.zeros(1, _U32),
                          np.array([data & 0xFFFFFFFF], _U32))
    return np.array([b0[0], b1[0]], _U32)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """Uniform uint32 words of ``shape``."""
    b0, b1 = threefry2x32(k, *_counts(shape))
    return b0 ^ b1


def randint(k: np.ndarray, shape, minval: int, maxval: int,
            dtype=np.int32) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, dtype)`` for
    ``minval < maxval`` inside int32 (an int8 range is sampled as int32,
    then cast, as JAX samples it): two words a value, each reduced
    modulo the span, joined in uint32 arithmetic as XLA's wrapping
    integer ops join them."""
    span = maxval - minval
    assert -2**31 <= minval < maxval < 2**31, (minval, maxval)
    k1, k2 = split(k)
    higher = random_bits(k1, shape).astype(np.uint64) % span
    lower = random_bits(k2, shape).astype(np.uint64) % span
    mult = ((1 << 16) % span) ** 2 % 2**32 % span
    word = np.uint64(2**32)
    off = (higher * np.uint64(mult) % word + lower) % word % span
    return (off.astype(np.int64) + minval).astype(dtype)


def uniform(k: np.ndarray, shape, minval: float, maxval: float
            ) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: 23
    random mantissa bits under exponent 0, then ``f * (hi - lo) + lo``
    rounded once, as XLA fuses it into one multiply-add (the float64
    product and sum are exact for these operands)."""
    bits = random_bits(k, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = (f.astype(np.float64) * np.float64(hi - lo)
             + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fused)


__all__ = ["threefry2x32", "key", "split", "fold_in", "random_bits",
           "randint", "uniform"]
