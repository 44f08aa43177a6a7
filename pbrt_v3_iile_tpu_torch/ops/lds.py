"""Low-discrepancy sequences by bit arithmetic (port of ``ops/lds.py``).

uint32 values live in int64 tensors holding [0, 2**32): torch's uint32
dtype supports few ops, and an int64 product of two 32-bit values can
pass 2**63.  So every op masks back to 32 bits, and every multiply is
split into 16-bit halves (``mul32``) so that no intermediate exceeds
2**48.  Results are bit-identical to the reference's jnp.uint32 math.
"""

from __future__ import annotations

import numpy as np
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


def _ndigits(base: int) -> int:
    """Digits of a 32-bit index in ``base`` (the reference's loop count)."""
    ndig, cap = 1, base
    while cap < (1 << 32):
        cap *= base
        ndig += 1
    return ndig


def _digit_sum_np(i, base: int, ndig: int, inv_base, perm=None):
    """The reference's digit loop on the host, in float32: val += perm[d]
    * scale, scale *= inv_base, for ndig digits of the u32 indices i.

    XLA on the CPU contracts ``val + d * scale`` into a fused multiply-add,
    so the reference rounds once per digit: the float32 product is exact in
    float64, and the sum is rounded from there (a double rounding differs
    only on an exact float32 tie)."""
    rem = np.asarray(i, np.int64) & M32
    inv = np.float32(inv_base)
    val = np.zeros(rem.shape, np.float32)
    scale = np.full(rem.shape, inv, np.float32)
    for _ in range(ndig):
        d = rem % base
        pd = d if perm is None else perm[d]
        val = (pd.astype(np.float64) * scale.astype(np.float64)
               + val.astype(np.float64)).astype(np.float32)
        rem = rem // base
        scale = scale * inv
    return val


def radical_inverse_np(base: int, i):
    """Radical inverse of u32 indices i (numpy or int) in a static base,
    on the host: float32 numpy, the reference's bits."""
    val = _digit_sum_np(i, base, _ndigits(base), 1.0 / base)
    return np.minimum(val, np.float32(_ONE_MINUS))


def radical_inverse(base: int, i):
    """Radical inverse of a u32 index tensor in a static base."""
    out = radical_inverse_np(base, i.cpu().numpy())
    return torch.from_numpy(out).to(i.device)


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


# ---------------------------------------------------------------------------
# High-dimension scrambled Halton and MaxMinDist (0,2) patterns.  Their
# inputs are host values (the pass index is one python int per wavefront),
# so they run on the host in float32 numpy with the reference's bits, and
# the wavefront broadcasts the result.
# ---------------------------------------------------------------------------

N_HALTON_DIMS = 128


def _first_primes(n):
    out = []
    c = 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return out


PRIMES_FULL = tuple(_first_primes(N_HALTON_DIMS))

_PERM_CACHE = {}


def _digit_perms(seed: int = 0):
    """Per-base random digit permutations (seeded; keyed on the seed)."""
    if seed not in _PERM_CACHE:
        rng = np.random.default_rng(1879 + seed)
        _PERM_CACHE[seed] = {b: rng.permutation(b).astype(np.int32)
                             for b in PRIMES_FULL}
    return _PERM_CACHE[seed]


def scrambled_radical_inverse(dim: int, i, seed: int = 0):
    """Permuted radical inverse of u32 indices i in the dim-th prime base
    (every digit, leading zeros included, through the base's permutation;
    the tail of permuted zeros adds perm[0] * b^-ndig / (b - 1), summed in
    double and added in float32 as the reference adds it)."""
    base = PRIMES_FULL[dim % N_HALTON_DIMS]
    perm = _digit_perms(seed)[base]
    inv_base = 1.0 / base
    ndig = _ndigits(base)
    val = _digit_sum_np(i, base, ndig, inv_base, perm)
    tail = float(perm[0]) * (inv_base ** ndig) / (1.0 - inv_base)
    return np.minimum(val + np.float32(tail), np.float32(_ONE_MINUS))


def halton_dim(i, dim: int, scrambled: bool = True, seed: int = 0):
    """Halton dimension dim of indices i; dims >= 2 digit-permuted."""
    if scrambled and dim >= 2:
        return scrambled_radical_inverse(dim, i, seed)
    return radical_inverse_np(PRIMES_FULL[dim % N_HALTON_DIMS], i)


_DYN_CACHE = {}


def _dyn_tables(seed: int = 0):
    """(bases, offsets, flat permutations) of every dimension, per seed."""
    if seed not in _DYN_CACHE:
        perms = _digit_perms(seed)
        bases = np.asarray(PRIMES_FULL, np.int32)
        offs = np.concatenate([[0], np.cumsum(bases)[:-1]]).astype(np.int32)
        flat = np.concatenate([perms[b] for b in PRIMES_FULL]).astype(np.int32)
        _DYN_CACHE[seed] = (bases, offs, flat)
    return _DYN_CACHE[seed]


def scrambled_radical_inverse_dyn(dim: int, i, seed: int = 0):
    """Permuted radical inverse as the reference computes it for a
    dimension known only at run time: a fixed 32 digits (trailing zeros
    map through perm[0], the scrambled tail), inv_base divided in
    float32."""
    bases, offs, flat = _dyn_tables(seed)
    k = dim % N_HALTON_DIMS
    base = int(bases[k])
    inv_base = np.float32(1.0) / np.float32(base)
    perm = flat[offs[k]:offs[k] + base]
    val = _digit_sum_np(i, base, 32, inv_base, perm)
    return np.minimum(val, np.float32(_ONE_MINUS))


_MAXMIN_CACHE = {}


def _maxmin_matrix(m: int):
    """Generator matrix (m u32 columns) of a 2^m-point (0,2) pattern, y_i
    = C i over GF(2) and x_i = van der Corput, found by the reference's
    seeded search for the largest toroidal min distance (cached per m).
    Returns (columns, squared min distance)."""
    if m in _MAXMIN_CACHE:
        return _MAXMIN_CACHE[m]
    n = 1 << m
    rng = np.random.default_rng(977 + m)
    idx = np.arange(n, dtype=np.uint32)
    xs = np.zeros(n, np.float64)
    for b in range(m):
        xs += ((idx >> b) & 1) * (0.5 ** (b + 1))

    def score(cols):
        y = np.zeros(n, np.uint32)
        for b in range(m):
            bit = ((idx >> b) & 1).astype(bool)
            y = np.where(bit, y ^ cols[b], y)
        ys = y.astype(np.float64) / (1 << 32)
        dx = np.abs(xs[:, None] - xs[None, :])
        dy = np.abs(ys[:, None] - ys[None, :])
        dx = np.minimum(dx, 1 - dx)
        dy = np.minimum(dy, 1 - dy)
        d2 = dx * dx + dy * dy
        np.fill_diagonal(d2, 1e9)
        return d2.min()

    # candidate 0: Sobol' dim-2 columns
    v = np.uint32(1 << 31)
    sob = []
    for _ in range(m):
        sob.append(v)
        v = v ^ (v >> 1)
    best_cols = np.asarray(sob, np.uint32)
    best = score(best_cols)
    # hill-climb single bit flips below each column's leading bit, from
    # the Sobol' columns and three random restarts
    if n <= 1024:
        for restart in range(4):
            if restart == 0:
                cols = best_cols.copy()
                cur = best
            else:
                cols = np.asarray(
                    [np.uint32(1 << (31 - b))
                     | (np.uint32(rng.integers(0, 1 << 31))
                        >> np.uint32(b + 1)) for b in range(m)], np.uint32)
                cur = score(cols)
            stale = 0
            for _ in range(600):
                b = int(rng.integers(0, m))
                bit = int(rng.integers(0, 31 - b))
                trial = cols.copy()
                trial[b] = trial[b] ^ np.uint32(1 << bit)
                sc = score(trial)
                if sc > cur:
                    cols, cur, stale = trial, sc, 0
                else:
                    stale += 1
                    if stale > 150:
                        break
            if cur > best:
                best, best_cols = cur, cols
    _MAXMIN_CACHE[m] = (best_cols.astype(np.uint32), float(best))
    return _MAXMIN_CACHE[m]


def maxmin_m(n_samples: int) -> int:
    """log2 of the pattern size for n_samples (at least 2)."""
    return max(1, int(np.ceil(np.log2(max(n_samples, 2)))))


def maxmin02_bits_int(i: int, n_samples: int):
    """MaxMinDist point i of the 2^m pattern for n_samples as u32 (x, y);
    the Sobol' (0,2) point past m = 12, as the reference falls back."""
    m = maxmin_m(n_samples)
    if m > 12:
        return sobol02_bits_int(i)
    cols = _maxmin_matrix(m)[0]
    i &= M32
    x = int(f"{i:032b}"[::-1], 2)
    y = 0
    for b in range(m):
        if (i >> b) & 1:
            y ^= int(cols[b])
    return x, y


def maxmin02_shared(i: int, n_samples: int, scramble_x, scramble_y):
    """``maxmin02`` for one shared index i and per-lane XOR scrambles:
    (x, y) in [0, 1), clamped below 1 (no clamp on the Sobol' fallback)."""
    xb, yb = maxmin02_bits_int(i, n_samples)
    x = to_unit_float(u32(scramble_x) ^ xb)
    y = to_unit_float(u32(scramble_y) ^ yb)
    if maxmin_m(n_samples) > 12:
        return x, y
    return torch.clamp(x, max=_ONE_MINUS), torch.clamp(y, max=_ONE_MINUS)
