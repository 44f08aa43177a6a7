"""Low-discrepancy sequences by bit arithmetic (port of ``ops/lds.py``).

uint32 values live in int64 tensors holding [0, 2**32): torch's uint32
dtype supports few ops, and an int64 product of two 32-bit values can
pass 2**63.  So every op masks back to 32 bits, and every multiply is
split into 16-bit halves (``mul32``) so that no intermediate exceeds
2**48.  Results are bit-identical to the reference's jnp.uint32 math.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)
_INV_2_32 = 1.0 / (1 << 32)
_ONE_MINUS = torch.tensor(1.0 - 1e-7, dtype=torch.float32).item()


def u32(x):
    """uint32 values (an integer tensor) as an int64 tensor."""
    return x.to(torch.int64) & M32


def mul32(a, b):
    """(a * b) mod 2**32 for uint32-valued int64 tensors or ints."""
    if isinstance(b, int) and not isinstance(a, int):
        a, b = b, a
    if isinstance(a, int):
        lo = a & 0xFFFF
        hi = (a >> 16) & 0xFFFF
        return (b * lo + (((b * hi) & 0xFFFF) << 16)) & M32
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def to_unit_float(x):
    """u32 -> float32 in [0, 1) exactly as ``x.astype(f32) * 2**-32``."""
    return x.to(torch.float32) * _INV_2_32


def radical_inverse(base: int, i):
    """Radical inverse of u32 index i in a static base."""
    rem = u32(i)
    inv_base = 1.0 / base
    ndig, cap = 1, base
    while cap < (1 << 32):
        cap *= base
        ndig += 1
    val = torch.zeros(rem.shape, dtype=torch.float32, device=rem.device)
    scale = torch.full(rem.shape, inv_base, dtype=torch.float32,
                       device=rem.device)
    for _ in range(ndig):
        digit = rem % base
        val = val + digit.to(torch.float32) * scale
        rem = rem // base
        scale = scale * inv_base
    return torch.clamp(val, max=_ONE_MINUS)


def _reverse_bits32(v):
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & M32


def sobol02_bits(i):
    """(0,2)-sequence point i as u32 patterns: x = bit reversal (van der
    Corput), y = Sobol' second dimension via the v ^= v >> 1 recurrence."""
    i = u32(i)
    x = _reverse_bits32(i)
    v = torch.full_like(i, 1 << 31)
    rem = i
    y = torch.zeros_like(i)
    for _ in range(32):
        y = torch.where((rem & 1) == 1, y ^ v, y)
        v = v ^ (v >> 1)
        rem = rem >> 1
    return x, y


def sobol02_bits_int(i: int):
    """``sobol02_bits`` of one python-int index (the wavefront's shared
    pass index), so the 32-step recurrence runs once and not per lane."""
    i &= M32
    x = int(f"{i:032b}"[::-1], 2)
    v, y = 1 << 31, 0
    for b in range(32):
        if (i >> b) & 1:
            y ^= v
        v ^= v >> 1
    return x, y


def sobol02_owen_shared(i: int, seed_x, seed_y):
    """``sobol02_owen`` for one shared index i and per-lane seeds."""
    xb, yb = sobol02_bits_int(i)
    xu = owen_scramble_u32(torch.full_like(seed_x, xb), seed_x)
    yu = owen_scramble_u32(torch.full_like(seed_y, yb), seed_y)
    return (torch.clamp(to_unit_float(xu), max=_ONE_MINUS),
            torch.clamp(to_unit_float(yu), max=_ONE_MINUS))


def sobol02(i, scramble_x=None, scramble_y=None):
    """(0,2)-sequence point i with optional XOR scrambles -> (x, y) in [0,1)."""
    x, y = sobol02_bits(i)
    if scramble_x is not None:
        x = x ^ u32(scramble_x)
    if scramble_y is not None:
        y = y ^ u32(scramble_y)
    return to_unit_float(x), to_unit_float(y)


def hash_u32(x):
    """Integer mix (Wang hash) for per-pixel scrambles."""
    x = u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = mul32(x, 9)
    x = x ^ (x >> 4)
    x = mul32(x, 0x27D4EB2D)
    return x ^ (x >> 15)


def _laine_karras_permutation(x, seed):
    """Hash-based nested-uniform (Owen) permutation in the reversed-bit
    domain (Laine & Karras 2011 hash, Burley 2020 constants)."""
    x = (x + seed) & M32
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def owen_scramble_u32(x, seed):
    x = _reverse_bits32(u32(x))
    x = _laine_karras_permutation(x, u32(seed))
    return _reverse_bits32(x)


def sobol02_owen(i, seed_x, seed_y):
    """Owen-scrambled (0,2)-sequence point i with per-element u32 seeds."""
    xu, yu = sobol02_bits(i)
    xu = owen_scramble_u32(xu, seed_x)
    yu = owen_scramble_u32(yu, seed_y)
    return (torch.clamp(to_unit_float(xu), max=_ONE_MINUS),
            torch.clamp(to_unit_float(yu), max=_ONE_MINUS))
