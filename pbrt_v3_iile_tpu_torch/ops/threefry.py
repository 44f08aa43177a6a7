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

Metropolis (``integrators/mlt.py``) also draws ``uniform`` on a
[minval, maxval) range and ``categorical`` samples; both reproduce the
float32 arithmetic that XLA compiles for the CPU, where a multiply that
feeds an add becomes one fused multiply-add (``fma32``) and ``log`` is
the Cephes polynomial (``xla_log``), so that they too agree bit for bit
with the JAX package on the CPU.
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
    """``jax.random.split(key, num)`` as a list of keys; one hash over a
    tensor of counters when num is large."""
    if num <= 16:
        return [hash2x32(key[0], key[1], 0, i) for i in range(num)]
    y0, y1 = hash2x32(key[0], key[1], torch.zeros(num, dtype=torch.int64),
                      torch.arange(num, dtype=torch.int64))
    return list(zip(y0.tolist(), y1.tolist()))


def random_bits(key, shape, device=None):
    """u32 random bits (int64 tensor) of the given shape."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = hash2x32(key[0], key[1], lo >> 32, lo & M32)
    return (y0 ^ y1).reshape(shape)


def uniform(key, shape, device=None, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    [0, 1) floats scaled as max(minval, f * (maxval - minval) + minval),
    the multiply-add fused as XLA fuses it."""
    bits = random_bits(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fbits.view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = _f32(minval)
    span = _f32(_f32(maxval) - lo)
    return torch.clamp(fma32(f, span, lo), min=lo)


def _f32(x: float) -> float:
    """x rounded to float32, as a python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def fma32(a, b, c):
    """float32 a * b + c rounded once (a fused multiply-add): the product of
    two float32 values is exact in float64."""
    dbl = lambda v: v.double() if isinstance(v, torch.Tensor) else v
    return (dbl(a) * dbl(b) + dbl(c)).float()


# Cephes logf's polynomial, the one XLA compiles ``log`` to on the CPU
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def xla_log(v):
    """float32 natural log as XLA computes it on the CPU (range reduction
    to [sqrt(1/2), sqrt(2)), Cephes' degree-9 polynomial, its
    multiply-adds fused), bit for bit; NaN below 0, -inf at 0."""
    p = [_f32(c) for c in _LOG_P]
    bits = torch.clamp(v, min=_f32(1.17549435e-38)).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    below = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(torch.float32)
    z = x * x
    x3 = z * x
    a = fma32(fma32(x, p[0], p[1]), x, p[2])
    b = fma32(fma32(x, p[3], p[4]), x, p[5])
    c = fma32(fma32(x, p[6], p[7]), x, p[8])
    y = fma32(fma32(fma32(a, x3, b), x3, c), x3, e * _f32(-2.12194440e-4))
    r = fma32(e, 0.693359375, fma32(z, -0.5, x) + y)
    r = torch.where(v < 0, torch.full_like(r, float("nan")), r)
    r = torch.where(v == 0, torch.full_like(r, float("-inf")), r)
    return torch.where(v == float("inf"), v, r)


def gumbel(key, shape, device=None):
    """``jax.random.gumbel(key, shape)`` (mode "low"): -log(-log(u)), u
    uniform on [tiny, 1)."""
    u = uniform(key, shape, device, minval=1.17549435e-38, maxval=1.0)
    return -xla_log(-xla_log(u))


def categorical(key, logits, shape):
    """``jax.random.categorical(key, logits, shape=shape)`` for 1-D logits:
    the argmax of logits plus Gumbel noise of shape (*shape, K), the first
    index on ties."""
    g = gumbel(key, (*shape, logits.shape[-1]), logits.device)
    return torch.argmax(g + logits, dim=-1)


def uniform_folded(key, first: int, count: int, shape, device=None):
    """``uniform(fold_in(key, i), shape)`` for i in first .. first + count
    - 1, stacked on a leading axis: one hash over every row (the keys
    broadcast as (count, 1) tensors)."""
    keys = [fold_in(key, i) for i in range(first, first + count)]
    k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    y0, y1 = hash2x32(k0, k1, lo >> 32, lo & M32)
    fbits = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32)
    return (fbits.view(torch.float32) - 1.0).reshape(count, *shape)


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
