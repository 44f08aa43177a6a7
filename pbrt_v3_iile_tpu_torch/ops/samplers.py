"""Counter-based sample generation for wavefronts (port of ``ops/samplers.py``).

Keys are threefry key pairs (``ops/threefry.py``) folded by (pass,
bounce, purpose); the GlobalSampler context draws every integration
dimension from Owen-scrambled (0,2)-sequences keyed by u32 hashes of
(pixel, bounce, purpose), or under ``halton-global`` from permuted
radical inverses of the pass index.  The pass index is one host value
per wavefront, so the radical inverses and MaxMinDist points are
computed once on the host and broadcast.  There is no global generator
state: keys are passed down explicitly, and both streams reproduce the
reference's bits.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from . import lds
from . import threefry

DIM_PIXEL_JITTER = 0
DIM_LENS = 1
DIM_LIGHT_SELECT = 2
DIM_LIGHT_SAMPLE = 3
DIM_BSDF_LOBE = 4
DIM_BSDF_DIR = 5
DIM_RR = 6
DIM_HEMI = 7
DIM_PROBE = 8
DIM_MEDIUM_TRACK = 9
DIM_TIME = 10
DIM_MEDIUM_TR = 11
DIM_SSS_PROBE = 12
DIM_SSS_EXIT = 13
DIM_SSS_NEE = 14
DIM_COMPACT = 15

LD_KINDS = ("sobol", "lowdiscrepancy", "02sequence", "zerotwosequence",
            "maxmindist", "halton", "halton-global")
_SOBOL_KINDS = ("sobol", "lowdiscrepancy", "02sequence", "zerotwosequence")


def wave_key(base_key, pass_idx: int, bounce: int, purpose: int):
    k = threefry.fold_in(base_key, pass_idx)
    k = threefry.fold_in(k, bounce)
    return threefry.fold_in(k, purpose)


def uniform(key, shape, device=None):
    return threefry.uniform(key, shape, device)


def stratified_pixel_jitter(key, n, spp_index=0, strata=1, device=None):
    u = uniform(key, (n, 2), device)
    if strata > 1:
        sx = spp_index % strata
        sy = (spp_index // strata) % strata
        u = (u + torch.tensor([sx, sy], dtype=u.dtype, device=u.device)) / strata
    return u


def pixel_samples(kind: str, key, pixel_idx, pass_idx: int, spp: int):
    """In-pixel 2D sample for each pixel of a pass, by sampler kind.

    pixel_idx: (N,) flat pixel ids (u32 values, int64); pass_idx: int."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    if kind == "stratified":
        strata = max(1, int(spp ** 0.5))
        return stratified_pixel_jitter(key, n, pass_idx, strata, device=dev)
    if kind in _SOBOL_KINDS:
        i = torch.full((n,), pass_idx, dtype=torch.int64, device=dev)
        sx = lds.hash_u32(pixel_idx)
        sy = lds.hash_u32(lds.u32(pixel_idx) ^ 0x85EBCA77)
        x, y = lds.sobol02(i, sx, sy)
        return torch.stack([x, y], dim=-1)
    if kind in ("halton", "halton-global"):
        # radical inverses in bases 2 and 3 of the pass index (one host
        # value for the wave), each pixel rotated by its own hash
        hx = float(lds.radical_inverse_np(2, pass_idx))
        hy = float(lds.radical_inverse_np(3, pass_idx))
        rot = lds.to_unit_float(lds.hash_u32(pixel_idx))
        rot2 = lds.to_unit_float(lds.hash_u32(lds.u32(pixel_idx) ^ 0x9E3779B9))
        return torch.stack([torch.remainder(hx + rot, 1.0),
                            torch.remainder(hy + rot2, 1.0)], dim=-1)
    if kind == "maxmindist":
        sx = lds.hash_u32(pixel_idx)
        sy = lds.hash_u32(lds.u32(pixel_idx) ^ 0x85EBCA77)
        x, y = lds.maxmin02_shared(pass_idx, max(int(spp), 2), sx, sy)
        return torch.stack([x, y], dim=-1)
    return uniform(key, (n, 2), dev)


@dataclass
class SampleCtx:
    """Per-wavefront GlobalSampler context (the reference's SampleCtx).

    pixel: (N,) u32 flat pixel id of each lane (int64 tensor);
    index: sample index (the pass number); salt: u32 from the seed."""
    pixel: torch.Tensor
    index: int
    salt: int

    def with_pixel(self, pixel):
        return replace(self, pixel=pixel)


class HaltonCtx(SampleCtx):
    """``halton-global``: every dimension is one permuted radical inverse
    of the pass index at the dimension 2 + (bounce, purpose, k), shared by
    every pixel and rotated per pixel (the reference's HaltonCtx)."""


def make_sample_ctx(key, pixel_idx, pass_idx: int,
                    kind: str = "sobol") -> SampleCtx:
    salt = int(threefry.randint(threefry.fold_in(key, 0x5D5), (), 0,
                                2 ** 31 - 1)) & lds.M32
    cls = HaltonCtx if kind == "halton-global" else SampleCtx
    return cls(pixel=lds.u32(pixel_idx), index=int(pass_idx) & lds.M32,
               salt=salt)


def _dim_seed(ctx: SampleCtx, bounce: int, purpose: int, k: int):
    code = (bounce * 64 + purpose * 4 + k) & lds.M32
    return lds.hash_u32(ctx.pixel ^ lds.mul32(code, 0x9E3779B9) ^ ctx.salt)


def ctx_uniform(ctx, key, bounce: int, purpose: int, shape, device=None):
    """Uniform samples for one integration decision.

    ctx None -> threefry stream ``wave_key(key, 0, bounce, purpose)``;
    a HaltonCtx -> permuted radical inverses rotated per pixel;
    another ctx -> padded Owen-scrambled Sobol02 pairs.  shape: (N,) or (N, k)
    with k <= 4."""
    if ctx is None:
        return uniform(wave_key(key, 0, bounce, purpose), shape, device)
    k = 1 if len(shape) == 1 else shape[1]
    cols = []
    if isinstance(ctx, HaltonCtx):
        for kk in range(k):
            code = (bounce * 64 + purpose * 4 + kk) & lds.M32
            x1 = float(lds.scrambled_radical_inverse_dyn(2 + code, ctx.index))
            rot = lds.to_unit_float(_dim_seed(ctx, bounce, purpose, kk))
            cols.append(torch.remainder(x1 + rot, 1.0))
    else:
        for pair in range((k + 1) // 2):
            sx = _dim_seed(ctx, bounce, purpose, 2 * pair)
            sy = _dim_seed(ctx, bounce, purpose, 2 * pair + 1)
            x, y = lds.sobol02_owen_shared(ctx.index, sx, sy)
            cols.extend([x, y])
    if len(shape) == 1:
        return cols[0]
    return torch.stack(cols[:k], dim=-1)
