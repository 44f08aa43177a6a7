"""Vector math over (..., 3) tensors (port of ``pbrt_v3_iile_tpu/utils/vecmath.py``).

No vector classes: every helper is a batched tensor op, so the whole
wavefront is one kernel launch per op.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-7
INF = math.inf
# Scale-relative ray-origin offset (the reference's RAY_EPS; 1e-4 was set
# from oracle evidence: 1e-3 caused false self-occlusion in fine creases).
RAY_EPS = 1e-4


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def length_sq(a):
    return dot(a, a)


def rsqrt_safe(x2):
    """1/sqrt(x2) with 0 -> 0 (degenerate vectors stay zero)."""
    return torch.where(x2 > 0.0, 1.0 / torch.sqrt(torch.clamp(x2, min=1e-30)),
                       torch.zeros_like(x2))


def normalize(a):
    return a * rsqrt_safe(dot(a, a)).unsqueeze(-1)


def distance(a, b):
    return length(a - b)


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where((dot(n, v) < 0.0).unsqueeze(-1), -n, n)


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n).unsqueeze(-1) * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta; returns (wt, valid)."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    valid = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -wi * eta.unsqueeze(-1) + (eta * cos_i - cos_t).unsqueeze(-1) * n
    return wt, valid


def coordinate_system(n):
    """Branchless orthonormal frame (t, b) around unit n (Duff et al.)."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_local(v, t, b, n):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, t, b, n):
    return (v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n)


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def luminance(rgb):
    """Relative luminance of linear RGB."""
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=rgb.dtype,
                     device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def max_component(rgb):
    return torch.amax(rgb, dim=-1)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def offset_ray_origin(p, n, d):
    """Offset p along n (sign-matched to d) by RAY_EPS * max(1, |p|_inf)."""
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1), min=1.0)
    off = (RAY_EPS * scale).unsqueeze(-1) * n
    return torch.where((dot(d, n) < 0.0).unsqueeze(-1), p - off, p + off)
