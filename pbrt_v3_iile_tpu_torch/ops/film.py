"""Film accumulation buffers and reconstruction filters (port of ``ops/film.py``).

The film is an (H, W, 3) weighted radiance sum and an (H, W) weight sum.
Filtering uses the regular sample grid: a sample at pixel p reaches the
neighbours p + o for offsets o in a static support window, so a filter
is a sum of shifted, weighted images.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class Film:
    rgb: torch.Tensor     # (H, W, 3) weighted radiance sum
    weight: torch.Tensor  # (H, W) filter-weight sum


def new_film(h: int, w: int, device) -> Film:
    return Film(rgb=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
                weight=torch.zeros((h, w), dtype=torch.float32, device=device))


def filter_eval(name: str, x, y, xw, yw, alpha=2.0, B=1.0 / 3, C=1.0 / 3,
                tau=3.0):
    """Filter kernels (box, triangle, gaussian, mitchell, sinc)."""
    ax, ay = torch.abs(x), torch.abs(y)
    zero = torch.zeros_like(x)
    if name == "box":
        return torch.where((ax <= xw) & (ay <= yw), 1.0, zero)
    if name == "triangle":
        return torch.clamp(xw - ax, min=0.0) * torch.clamp(yw - ay, min=0.0)
    if name == "gaussian":
        def g1(d, w):
            return torch.clamp(torch.exp(-alpha * d * d) - math.exp(-alpha * w * w),
                               min=0.0)
        return g1(x, xw) * g1(y, yw)
    if name == "mitchell":
        def m1(v, w):
            t = torch.abs(2.0 * v / w)
            t3, t2 = t ** 3, t ** 2
            inner = ((12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2
                     + (6 - 2 * B)) * (1.0 / 6.0)
            outer = ((-B - 6 * C) * t3 + (6 * B + 30 * C) * t2
                     + (-12 * B - 48 * C) * t + (8 * B + 24 * C)) * (1.0 / 6.0)
            return torch.where(t > 1.0, torch.where(t < 2.0, outer, zero), inner)
        return m1(x, xw) * m1(y, yw)
    if name == "sinc":
        def s1(v, w):
            v = torch.abs(v)
            one = torch.ones_like(v)
            sinc = torch.where(v < 1e-5, one, torch.sin(math.pi * v)
                               / torch.clamp(math.pi * v, min=1e-9))
            lanczos = torch.where(v < 1e-5, one, torch.sin(math.pi * v / tau)
                                  / torch.clamp(math.pi * v / tau, min=1e-9))
            return torch.where(v > w, torch.zeros_like(v), sinc * lanczos)
        return s1(x, xw) * s1(y, yw)
    raise ValueError(f"unknown filter {name}")


def add_sample_image(film: Film, L, jitter, filter_name: str = "box",
                     xw: float = 0.5, yw: float = 0.5, **fparams) -> Film:
    """Add one 1-spp pass: L (H,W,3) radiance, jitter (H,W,2) in-pixel
    sample offsets."""
    if filter_name == "box" and xw <= 0.5 and yw <= 0.5:
        return Film(rgb=film.rgb + L, weight=film.weight + 1.0)
    rx = int(math.ceil(xw - 0.5))
    ry = int(math.ceil(yw - 0.5))
    rgb, wsum = film.rgb, film.weight
    for oy in range(-ry, ry + 1):
        for ox in range(-rx, rx + 1):
            dx = jitter[..., 0] - 0.5 - ox
            dy = jitter[..., 1] - 0.5 - oy
            w = filter_eval(filter_name, dx, dy, xw, yw, **fparams)
            rgb = rgb + torch.roll(L * w[..., None], shifts=(oy, ox), dims=(0, 1))
            wsum = wsum + torch.roll(w, shifts=(oy, ox), dims=(0, 1))
    return Film(rgb=rgb, weight=wsum)


def resolve(film: Film):
    """Weighted average -> (H, W, 3) radiance."""
    w = torch.clamp(film.weight, min=1e-12)[..., None]
    return torch.where(film.weight[..., None] > 0, film.rgb / w,
                       torch.zeros_like(film.rgb))


def merge_films(a: Film, b: Film) -> Film:
    return Film(rgb=resolve(a) + resolve(b), weight=torch.ones_like(a.weight))
