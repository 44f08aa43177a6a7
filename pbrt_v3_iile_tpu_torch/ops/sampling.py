"""Monte-Carlo warps and MIS heuristics (port of ``ops/sampling.py``).

Every function maps (..., k) uniform samples to (..., d) outputs.
"""

from __future__ import annotations

import math

import torch

PI = math.pi
INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)
INV_4PI = 1.0 / (4.0 * math.pi)


def concentric_sample_disk(u):
    u_offset = 2.0 * u - 1.0
    ux, uy = u_offset[..., 0], u_offset[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    one = torch.ones_like(ux)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (uy / torch.where(ux == 0.0, one, ux)),
        (PI / 2.0) - (PI / 4.0) * (ux / torch.where(uy == 0.0, one, uy)))
    pt = r.unsqueeze(-1) * torch.stack([torch.cos(theta), torch.sin(theta)],
                                       dim=-1)
    return torch.where(zero.unsqueeze(-1), torch.zeros_like(pt), pt)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z.unsqueeze(-1)], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_hemisphere(u):
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u[..., 1] * 2.0 * PI
    return torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
                        cos_theta], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_theta_max, min=1e-9))


def uniform_sample_triangle(u):
    su0 = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f, g = nf * f_pdf, ng * g_pdf
    denom = f * f + g * g
    pos = denom > 0.0
    return torch.where(pos, (f * f) / torch.where(pos, denom, 1.0),
                       torch.zeros_like(denom))


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    denom = nf * f_pdf + ng * g_pdf
    pos = denom > 0.0
    return torch.where(pos, nf * f_pdf / torch.where(pos, denom, 1.0),
                       torch.zeros_like(denom))


def stratified_offsets_2d(nx: int, ny: int, device=None):
    i = torch.arange(nx * ny, device=device)
    return torch.stack([(i % nx) / nx, (i // nx) / ny], dim=-1).float()
