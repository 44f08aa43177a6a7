"""Counter-based sample generation for wavefronts (port of ``ops/samplers.py``).

Keys are threefry key pairs (``ops/threefry.py``) folded by (pass,
bounce, purpose); the GlobalSampler context draws every integration
dimension from Owen-scrambled (0,2)-sequences keyed by u32 hashes of
(pixel, bounce, purpose).  There is no global generator state: keys are
passed down explicitly, and both streams reproduce the reference's bits.
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
    if kind in LD_KINDS:
        raise NotImplementedError(
            f"sampler {kind!r} is not ported yet (ROADMAP Queue 1, samplers:"
            " Halton tables and maxmin02)")
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


def make_sample_ctx(key, pixel_idx, pass_idx: int,
                    kind: str = "sobol") -> SampleCtx:
    if kind not in _SOBOL_KINDS:
        raise NotImplementedError(
            f"GlobalSampler context for {kind!r} is not ported yet")
    salt = int(threefry.randint(threefry.fold_in(key, 0x5D5), (), 0,
                                2 ** 31 - 1)) & lds.M32
    return SampleCtx(pixel=lds.u32(pixel_idx), index=int(pass_idx) & lds.M32,
                     salt=salt)


def _dim_seed(ctx: SampleCtx, bounce: int, purpose: int, k: int):
    code = (bounce * 64 + purpose * 4 + k) & lds.M32
    return lds.hash_u32(ctx.pixel ^ lds.mul32(code, 0x9E3779B9) ^ ctx.salt)


def ctx_uniform(ctx, key, bounce: int, purpose: int, shape, device=None):
    """Uniform samples for one integration decision.

    ctx None -> threefry stream ``wave_key(key, 0, bounce, purpose)``;
    ctx set  -> padded Owen-scrambled Sobol02 pairs.  shape: (N,) or (N, k)
    with k <= 4."""
    if ctx is None:
        return uniform(wave_key(key, 0, bounce, purpose), shape, device)
    k = 1 if len(shape) == 1 else shape[1]
    cols = []
    for pair in range((k + 1) // 2):
        sx = _dim_seed(ctx, bounce, purpose, 2 * pair)
        sy = _dim_seed(ctx, bounce, purpose, 2 * pair + 1)
        x, y = lds.sobol02_owen_shared(ctx.index, sx, sy)
        cols.extend([x, y])
    if len(shape) == 1:
        return cols[0]
    return torch.stack(cols[:k], dim=-1)
