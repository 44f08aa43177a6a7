"""Threefry-2x32 counter-based random numbers, bit-identical to jax.random.

The reference keys every estimator decision by folding a threefry key
with (pass, bounce, purpose).  Reproducing jax 0.9.0's ``fold_in``,
``uniform`` (float32) and ``randint`` bit for bit lets a port render be
the same estimator realisation as a JAX render of the same seed, so the
two compare pixel by pixel.

Layout (jax with ``jax_threefry_partitionable`` on, its default):
- a key is a pair of u32 words; ``PRNGKey(s)`` is ``(0, s)``;
- ``fold_in(k, x)`` hashes the counter pair ``(0, x)`` under k;
- ``split(k)`` hashes counters ``(0, i)`` for i in 0, 1 and takes the two
  output words of each as the new key;
- random bits of element i (flat index) are ``y0 ^ y1`` of the hash of
  counters ``(i >> 32, i & 0xffffffff)``.

Keys are tuples of python ints (no device state, no sync); bulk bits
are int64 tensors holding u32 values, computed on the caller's device.
"""

from __future__ import annotations

import math

import torch

from .lds import M32, mul32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def hash2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words x0, x1 under key (k0, k1).

    x0, x1: python ints or int64 tensors of u32 values."""
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for blk in range(5):
        for r in _ROT[blk % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(blk + 1) % 3]) & M32
        x1 = (x1 + ks[(blk + 2) % 3] + blk + 1) & M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return (0, int(seed) & M32)


def fold_in(key, data: int):
    return hash2x32(key[0], key[1], 0, int(data) & M32)


def split(key, num: int = 2):
    return [hash2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key, shape, device=None):
    """u32 random bits (int64 tensor) of the given shape."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = hash2x32(key[0], key[1], lo >> 32, lo & M32)
    return (y0 ^ y1).reshape(shape)


def uniform(key, shape, device=None):
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    bits = random_bits(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def randint(key, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint(key, shape, minval, maxval, int32)``."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((mul32(hi % span, mult) + lo % span) & M32) % span
    out = (minval + off) & M32
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)
