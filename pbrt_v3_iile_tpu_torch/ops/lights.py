"""Wavefront light sampling, pdfs and emitted radiance (port of ``ops/lights.py``).

Point, spot, distant, infinite (constant or env map), triangle-area and
sphere-area lights, selected by the scene's power table or by its
spatial (per-voxel) table.  A triangle-mesh area light is one light with
an area-weighted CDF over its triangles.  All masks, no dispatch.
Goniometric and projection lights and ``sample_le`` are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pbrt_v3_iile_tpu.scene.api import (
    LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_AREA_TRI,
    LIGHT_AREA_SPHERE, LIGHT_SPOT,
)

from ..utils import vecmath as vm
from . import sampling as smp


@dataclass
class LightSample:
    wi: torch.Tensor        # (N,3) unit, towards the light
    li: torch.Tensor        # (N,3) incident radiance before visibility
    pdf: torch.Tensor       # (N,) solid-angle pdf (given the light)
    dist: torch.Tensor      # (N,) distance to the light point
    is_delta: torch.Tensor  # (N,) delta light
    n_l: torch.Tensor       # (N,3) normal at the sampled light point


def choose_light(scene, u):
    """Light selection by the global distribution -> (light_id, pdf)."""
    idx = torch.clamp(torch.searchsorted(scene.light_cdf, u.contiguous()), 0,
                      max(scene.n_lights - 1, 0)).to(torch.int32)
    return idx, scene.light_pdf[idx.long()]


def _spatial_voxel(scene, p):
    res = scene.spatial_res
    ext = torch.clamp(scene.world_max - scene.world_min, min=1e-6)
    q = ((p - scene.world_min[None, :]) / ext[None, :]
         * res[None, :].to(torch.float32)).to(torch.int32)
    q = torch.minimum(torch.clamp(q, min=0), res[None, :] - 1)
    return ((q[:, 2] * res[1] + q[:, 1]) * res[0] + q[:, 0]).long()


def _voxel_rows(scene, p):
    V = scene.spatial_cdf.shape[0]
    return torch.clamp(_spatial_voxel(scene, p), 0, V - 1)


def choose_light_spatial(scene, u, p):
    """Position-aware selection from the per-voxel distribution."""
    v = _voxel_rows(scene, p)
    cdf = scene.spatial_cdf[v]
    idx = torch.sum((cdf < u[:, None]).to(torch.int32), dim=-1)
    idx = torch.clamp(idx, 0, max(scene.n_lights - 1, 0)).long()
    pdf = torch.gather(scene.spatial_pdf[v], 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), pdf


def light_select_pdf_spatial(scene, p, lid):
    v = _voxel_rows(scene, p)
    return torch.gather(scene.spatial_pdf[v], 1,
                        torch.clamp(lid, min=0).long()[:, None])[:, 0]


def infinite_select_pdf_spatial(scene, p):
    v = _voxel_rows(scene, p)
    rows = scene.spatial_pdf[v]
    Ls = scene.light_kind.shape[0]
    live = torch.arange(Ls, device=p.device) < scene.n_lights
    m = (scene.light_kind == LIGHT_INFINITE) & live
    return torch.sum(torch.where(m[None, :], rows[:, :Ls],
                                 torch.zeros_like(rows[:, :Ls])), dim=-1)


def _sample_light_triangle(scene, light_id, u):
    """Area-weighted triangle pick within a light's range."""
    K = scene.ltri_cdf.shape[0]
    off = scene.light_tri_off[light_id]
    cnt = scene.light_tri_cnt[light_id]
    j = torch.arange(K, device=u.device)[None, :]
    in_range = (j >= off[:, None]) & (j < (off + cnt)[:, None])
    ge = in_range & (scene.ltri_cdf[None, :] >= u[:, None])
    tri = torch.amin(torch.where(ge, j, K), dim=-1)
    tri = torch.where(tri >= K, torch.clamp(off + cnt - 1, min=0).long(), tri)
    return torch.clamp(tri, 0, K - 1)


def sample_li(scene, light_id, p_ref, u3) -> LightSample:
    """Light::Sample_Li; u3 (N,3): triangle pick + a 2D point sample."""
    N = p_ref.shape[0]
    dev = p_ref.device
    lid = light_id.long()
    g = lambda a: a[lid]
    kind = g(scene.light_kind)
    L = g(scene.light_L)
    pos = g(scene.light_pos)
    ldir = g(scene.light_dir)
    two_sided = g(scene.light_two_sided) > 0.5
    u2 = u3[:, 1:3]
    ones = torch.ones(N, device=dev)

    # point / spot
    to_l = pos - p_ref
    d2 = torch.clamp(vm.length_sq(to_l), min=1e-12)
    dist_p = torch.sqrt(d2)
    wi_p = to_l / dist_p[:, None]
    li_point = L / d2[:, None]
    cos_t = vm.dot(-wi_p, ldir)
    ct, cf = g(scene.light_cos_total), g(scene.light_cos_falloff)
    delta_f = torch.clamp((cos_t - ct) / torch.clamp(cf - ct, min=1e-9), 0.0, 1.0)
    falloff = torch.where(cos_t >= cf, 1.0,
                          torch.where(cos_t <= ct, 0.0, (delta_f ** 2) ** 2))
    li_spot = li_point * falloff[:, None]

    # distant
    wi_d = ldir
    dist_d = torch.full((N,), 2.0, device=dev) * scene.world_radius

    # infinite: uniform sphere, or env-map importance sampling
    wi_u = smp.uniform_sample_sphere(u2)
    pdf_u = torch.full((N,), smp.INV_4PI, device=dev)
    if scene.has_env_map > 0:
        wi_e, pdf_e, li_e = _sample_env_map(scene, u2)
        use_env = light_id == scene.env_light_id
        wi_i = torch.where(use_env[:, None], wi_e, wi_u)
        pdf_i = torch.where(use_env, pdf_e, pdf_u)
        li_inf = torch.where(use_env[:, None], li_e, L)
    else:
        wi_i, pdf_i, li_inf = wi_u, pdf_u, L

    # area triangle
    tri = _sample_light_triangle(scene, lid, u3[:, 0])
    b = smp.uniform_sample_triangle(u2)
    p0, e1, e2 = scene.ltri_p0[tri], scene.ltri_e1[tri], scene.ltri_e2[tri]
    n_l = scene.ltri_ng[tri]
    p_l = p0 + b[:, 0:1] * e1 + b[:, 1:2] * e2
    to_t = p_l - p_ref
    d2_t = torch.clamp(vm.length_sq(to_t), min=1e-12)
    dist_t = torch.sqrt(d2_t)
    wi_t = to_t / dist_t[:, None]
    area = torch.clamp(g(scene.light_area), min=1e-12)
    cos_l = vm.dot(n_l, -wi_t)
    emit_t = two_sided | (cos_l > 0.0)
    pdf_t = d2_t / torch.clamp(torch.abs(cos_l) * area, min=1e-12)
    li_t = torch.where(emit_t[:, None], L, torch.zeros_like(L))
    pdf_t = torch.where(torch.abs(cos_l) > 1e-7, pdf_t, torch.zeros_like(pdf_t))

    # area sphere: cone sampling outside, area sampling inside
    sph = torch.clamp(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1).long()
    c = scene.sph_center[sph]
    r = scene.sph_radius[sph]
    to_c = c - p_ref
    dc2 = torch.clamp(vm.length_sq(to_c), min=1e-12)
    dc = torch.sqrt(dc2)
    outside = dc2 > r * r
    sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    wz = to_c / dc[:, None]
    tx, ty = vm.coordinate_system(wz)
    w_cone = smp.uniform_sample_cone(u2, cos_max)
    wi_s = vm.to_world(w_cone, tx, ty, wz)
    cos_alpha = w_cone[..., 2]
    ds = dc * cos_alpha - torch.sqrt(torch.clamp(
        r * r - dc2 * (1.0 - cos_alpha ** 2), min=0.0))
    pdf_s = smp.uniform_cone_pdf(cos_max)
    n_in = smp.uniform_sample_sphere(u2)
    p_in = c + r[:, None] * n_in
    to_in = p_in - p_ref
    d2_in = torch.clamp(vm.length_sq(to_in), min=1e-12)
    dist_in = torch.sqrt(d2_in)
    wi_in = to_in / dist_in[:, None]
    cos_in = vm.dot(n_in, -wi_in)
    pdf_in = d2_in / torch.clamp(torch.abs(cos_in) * 4.0 * math.pi * r * r,
                                 min=1e-12)
    wi_s = torch.where(outside[:, None], wi_s, wi_in)
    pdf_s = torch.where(outside, pdf_s, pdf_in)
    ds = torch.where(outside, ds, dist_in)

    is_pt = kind == LIGHT_POINT
    is_spot = kind == LIGHT_SPOT
    is_dist = kind == LIGHT_DISTANT
    is_inf = kind == LIGHT_INFINITE
    is_tri = kind == LIGHT_AREA_TRI
    is_sph = kind == LIGHT_AREA_SPHERE

    def sel(*pairs, default):
        out = default
        for m, v in pairs:
            if v.dim() > m.dim():
                m = m[..., None]
            out = torch.where(m, v, out)
        return out

    is_ptlike = is_pt | is_spot
    wi = sel((is_ptlike, wi_p), (is_dist, wi_d), (is_inf, wi_i),
             (is_tri, wi_t), (is_sph, wi_s), default=wi_i)
    li = sel((is_pt, li_point), (is_spot, li_spot), (is_dist, L),
             (is_inf, li_inf), (is_tri, li_t), (is_sph, L), default=L)
    pdf = sel((is_ptlike | is_dist, ones), (is_inf, pdf_i),
              (is_tri, pdf_t), (is_sph, pdf_s), default=ones)
    dist = sel((is_ptlike, dist_p), (is_dist | is_inf, dist_d),
               (is_tri, dist_t), (is_sph, ds), default=dist_d)
    n_sph_pt = vm.normalize(p_ref + ds[:, None] * wi_s - c)
    n_light = sel((is_tri, n_l), (is_sph, n_sph_pt), default=-wi)
    return LightSample(wi=wi, li=li, pdf=pdf, dist=dist,
                       is_delta=is_ptlike | is_dist, n_l=n_light)


def pdf_li(scene, light_id, p_ref, wi, hit_t, hit_cos):
    """Light::Pdf_Li for a BSDF-sampled direction that hit an area light
    (hit_t, |cos| at the light) or escaped (infinite)."""
    lid = light_id.long()
    g = lambda a: a[lid]
    kind = g(scene.light_kind)
    area = torch.clamp(g(scene.light_area), min=1e-12)
    pdf_tri = (hit_t * hit_t) / torch.clamp(hit_cos * area, min=1e-12)
    sph = torch.clamp(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1).long()
    c = scene.sph_center[sph]
    r = scene.sph_radius[sph]
    dc2 = torch.clamp(vm.length_sq(c - p_ref), min=1e-12)
    outside = dc2 > r * r
    sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    pdf_sph = torch.where(outside, smp.uniform_cone_pdf(cos_max),
                          (hit_t * hit_t) / torch.clamp(
                              hit_cos * 4.0 * math.pi * r * r, min=1e-12))
    pdf_inf = torch.full_like(hit_t, smp.INV_4PI)
    if scene.has_env_map > 0:
        pdf_inf = torch.where(light_id == scene.env_light_id,
                              _env_dir_pdf(scene, wi), pdf_inf)
    zero = torch.zeros_like(pdf_tri)
    return torch.where(kind == LIGHT_AREA_TRI, pdf_tri,
                       torch.where(kind == LIGHT_AREA_SPHERE, pdf_sph,
                                   torch.where(kind == LIGHT_INFINITE,
                                               pdf_inf, zero)))


def area_light_le(scene, light_id, n_l, w_out):
    """Emitted radiance of an area light towards w_out."""
    lid = light_id.long()
    L = scene.light_L[lid]
    two_sided = scene.light_two_sided[lid] > 0.5
    lit = two_sided | (vm.dot(n_l, w_out) > 0.0)
    k = scene.light_kind[lid]
    valid = (k == LIGHT_AREA_TRI) | (k == LIGHT_AREA_SPHERE)
    return torch.where((lit & valid & (light_id >= 0))[:, None], L,
                       torch.zeros_like(L))


def _env_uv(scene, d):
    dl = d @ scene.env_world_to.T
    theta = vm.spherical_theta(dl)
    phi = vm.spherical_phi(dl)
    return phi * smp.INV_2PI, theta * (1.0 / math.pi), theta


def _env_lookup(scene, d):
    """Bilinear radiance lookup of the env map."""
    EH, EW = scene.env_img.shape[:2]
    u, v, _ = _env_uv(scene, d)
    fx = u * EW - 0.5
    fy = v * EH - 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    x0m = torch.remainder(x0, EW)
    x1m = torch.remainder(x0 + 1, EW)
    y0c = torch.clamp(y0, 0, EH - 1)
    y1c = torch.clamp(y0 + 1, 0, EH - 1)
    flat = scene.env_img.reshape(-1, 3)
    at = lambda xm, ym: flat[ym * EW + xm]
    return ((1 - ax) * (1 - ay) * at(x0m, y0c) + ax * (1 - ay) * at(x1m, y0c)
            + (1 - ax) * ay * at(x0m, y1c) + ax * ay * at(x1m, y1c))


def _env_dir_pdf(scene, d):
    EH, EW = scene.env_pdf.shape
    u, v, _ = _env_uv(scene, d)
    x = torch.clamp((u * EW).long(), 0, EW - 1)
    y = torch.clamp((v * EH).long(), 0, EH - 1)
    return scene.env_pdf.reshape(-1)[y * EW + x]


def _sample_env_map(scene, u2):
    """Importance-sample the env map -> (wi, pdf, Li)."""
    EH, EW = scene.env_pdf.shape
    row = torch.clamp(torch.searchsorted(scene.env_marg_cdf,
                                         u2[..., 0].contiguous()), 0, EH - 1)
    cond_rows = scene.env_cond_cdf[row]
    col = torch.clamp(torch.searchsorted(cond_rows, u2[..., 1:2].contiguous())[:, 0],
                      0, EW - 1)
    v = (row.to(torch.float32) + 0.5) / EH
    u = (col.to(torch.float32) + 0.5) / EW
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    st = torch.sin(theta)
    d_light = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                           torch.cos(theta)], dim=-1)
    wi = d_light @ scene.env_to_world.T
    pdf = scene.env_pdf.reshape(-1)[row * EW + col]
    li = scene.env_img.reshape(-1, 3)[row * EW + col]
    return wi, pdf, li


def environment_le(scene, d):
    """Radiance of all infinite lights for escaped rays."""
    L = scene.light_kind.shape[0]
    ar = torch.arange(L, device=d.device)
    is_inf = scene.light_kind == LIGHT_INFINITE
    live = ar < scene.n_lights
    has_map = ar == scene.env_light_id
    total = torch.sum(torch.where((is_inf & live & ~has_map)[:, None],
                                  scene.light_L, torch.zeros_like(scene.light_L)),
                      dim=0)
    out = total.expand(d.shape)
    if scene.has_env_map > 0:
        return out + _env_lookup(scene, d)
    return out


def finite_light_distribution(scene):
    """(pdf, cdf) over the non-infinite lights, renormalized."""
    Ls = scene.light_kind.shape[0]
    live = torch.arange(Ls, device=scene.light_pdf.device) < scene.n_lights
    w = torch.where(live & (scene.light_kind != LIGHT_INFINITE),
                    scene.light_pdf, torch.zeros_like(scene.light_pdf))
    pdf = w / torch.clamp(torch.sum(w), min=1e-20)
    return pdf, torch.cumsum(pdf, dim=0)


def has_infinite(scene) -> bool:
    Ls = scene.light_kind.shape[0]
    live = torch.arange(Ls, device=scene.light_kind.device) < scene.n_lights
    return bool(torch.any((scene.light_kind == LIGHT_INFINITE) & live))
