"""Wavefront light sampling, pdfs and emitted radiance (port of ``ops/lights.py``).

Point, spot, goniometric and projection (point lights scaled by a
direction map), distant, infinite (constant or env map), triangle-area
and sphere-area lights, selected by the scene's power table or by its
spatial (per-voxel) table.  A triangle-mesh area light is one light with
an area-weighted CDF over its triangles.  All masks, no dispatch.
Emission for light paths and photons (BDPT, SPPM): ``sample_le`` with
the separated pdfs of BDPT's MIS, ``pdf_le_dir`` and
``pdf_light_origin``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..scene.api import (
    LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_AREA_TRI,
    LIGHT_AREA_SPHERE, LIGHT_SPOT, LIGHT_GONIO, LIGHT_PROJECTION,
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
    if scene.has_map_lights:
        li_gonio = li_point * _gonio_scale(scene, lid, -wi_p)
        li_proj = li_point * _projection_scale(scene, lid, -wi_p)

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
    is_gon = kind == LIGHT_GONIO
    is_prj = kind == LIGHT_PROJECTION

    def sel(*pairs, default):
        out = default
        for m, v in pairs:
            if v.dim() > m.dim():
                m = m[..., None]
            out = torch.where(m, v, out)
        return out

    is_ptlike = is_pt | is_spot | is_gon | is_prj
    wi = sel((is_ptlike, wi_p), (is_dist, wi_d), (is_inf, wi_i),
             (is_tri, wi_t), (is_sph, wi_s), default=wi_i)
    maps = (((is_gon, li_gonio), (is_prj, li_proj))
            if scene.has_map_lights else ())
    li = sel((is_pt, li_point), (is_spot, li_spot), *maps, (is_dist, L),
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


def _light_map_lookup(scene, img_id, u, v):
    """Bilinear lookup in the stacked light maps; 1 where img_id < 0."""
    G, MH, MW = scene.light_img.shape[:3]
    gi = torch.clamp(img_id, 0, G - 1).long()
    fx = u * MW - 0.5
    fy = v * MH - 0.5
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    x0c, x1c = torch.clamp(x0, 0, MW - 1), torch.clamp(x0 + 1, 0, MW - 1)
    y0c, y1c = torch.clamp(y0, 0, MH - 1), torch.clamp(y0 + 1, 0, MH - 1)
    flat = scene.light_img.reshape(-1, 3)
    at = lambda x, y: flat[(gi * MH + y) * MW + x]
    val = ((1 - ax) * (1 - ay) * at(x0c, y0c) + ax * (1 - ay) * at(x1c, y0c)
           + (1 - ax) * ay * at(x0c, y1c) + ax * ay * at(x1c, y1c))
    return torch.where((img_id >= 0)[..., None], val, torch.ones_like(val))


def _gonio_scale(scene, lid, w):
    """Goniophotometric scale for the world direction w leaving the light
    (goniometric.h Scale: to light space, y and z swapped, a lat-long
    lookup)."""
    wl = torch.einsum("nij,nj->ni", scene.light_w2l[lid], w)
    wl = wl / torch.clamp(vm.length(wl), min=1e-12)[..., None]
    wl = torch.stack([wl[..., 0], wl[..., 2], wl[..., 1]], dim=-1)
    theta = vm.spherical_theta(wl)
    phi = vm.spherical_phi(wl)
    return _light_map_lookup(scene, scene.light_img_id[lid], phi * smp.INV_2PI,
                             theta / math.pi)


def _projection_scale(scene, lid, w):
    """Projection light's screen lookup for the world direction w
    (projection.cpp Projection: a perspective projection into the fov
    window, 0 outside it)."""
    wl = torch.einsum("nij,nj->ni", scene.light_w2l[lid], w)
    z = wl[..., 2]
    ax = scene.light_proj_ax[lid]
    ay = scene.light_proj_ay[lid]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = (wl[..., 0] / (zs * ax) + 1.0) * 0.5
    v = (wl[..., 1] / (zs * ay) + 1.0) * 0.5
    inside = (z > 1e-3) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    val = _light_map_lookup(scene, scene.light_img_id[lid], u, 1.0 - v)
    return torch.where(inside[..., None], val, torch.zeros_like(val))


@dataclass
class LightEmission:
    o: torch.Tensor          # (N,3) photon origin
    d: torch.Tensor          # (N,3) photon direction, into the scene
    beta: torch.Tensor       # (N,3) Le |cos| / (pdf_pos pdf_dir): the photon's
                             # power before the light-selection pdf
    valid: torch.Tensor      # (N,)
    le: torch.Tensor         # (N,3) emitted radiance or intensity
    n_l: torch.Tensor        # (N,3) emission normal (= d for point-like)
    pdf_pos: torch.Tensor    # (N,) area-measure position pdf (1 for a delta)
    pdf_dir: torch.Tensor    # (N,) solid-angle direction pdf (1 for a delta)
    delta_pos: torch.Tensor  # (N,) the position is a delta (point-like)
    delta_dir: torch.Tensor  # (N,) the direction is a delta (distant)


def sample_le(scene, light_id, u6) -> LightEmission:
    """Light::Sample_Le (point.cpp, spot.cpp, goniometric.cpp,
    projection.cpp: a point's uniform sphere or cone; distant.cpp and
    infinite.cpp: a disk of the world's radius; diffuse.cpp: an
    area-uniform point and a cosine direction).  u6 (N,6): [triangle or
    env pick, side, position u0, u1, direction u0, u1]."""
    N = u6.shape[0]
    dev = u6.device
    L_cnt = scene.light_kind.shape[0]
    lid = torch.clamp(light_id, 0, L_cnt - 1).long()
    g = lambda a: a[lid]
    kind = g(scene.light_kind)
    L = g(scene.light_L)
    pos = g(scene.light_pos)
    ldir = g(scene.light_dir)      # distant: towards the light
    two_sided = g(scene.light_two_sided) > 0.5
    u_pos, u_dir = u6[:, 2:4], u6[:, 4:6]
    wr = scene.world_radius
    wc = 0.5 * (scene.world_min + scene.world_max)
    is_pt = kind == LIGHT_POINT
    is_spot = kind == LIGHT_SPOT
    is_gon = kind == LIGHT_GONIO
    is_prj = kind == LIGHT_PROJECTION
    is_dist = kind == LIGHT_DISTANT
    is_inf = kind == LIGHT_INFINITE
    is_tri = kind == LIGHT_AREA_TRI
    is_sph = kind == LIGHT_AREA_SPHERE

    # point-like: a uniform sphere direction; spot: a uniform cone
    d_sph = smp.uniform_sample_sphere(u_dir)
    beta_pt = L * (4.0 * math.pi)
    ct, cf = g(scene.light_cos_total), g(scene.light_cos_falloff)
    tx_s, ty_s = vm.coordinate_system(ldir)
    d_spot = vm.to_world(smp.uniform_sample_cone(u_dir, ct), tx_s, ty_s, ldir)
    cos_sp = vm.dot(d_spot, ldir)
    delta_f = torch.clamp((cos_sp - ct) / torch.clamp(cf - ct, min=1e-9), 0.0, 1.0)
    falloff = torch.where(cos_sp >= cf, 1.0,
                          torch.where(cos_sp <= ct, 0.0, (delta_f ** 2) ** 2))
    beta_spot = L * (falloff / torch.clamp(smp.uniform_cone_pdf(ct),
                                           min=1e-12))[:, None]
    if scene.has_map_lights:
        sc_gon = _gonio_scale(scene, lid, d_sph)
        sc_prj = _projection_scale(scene, lid, d_sph)
    else:
        sc_gon = sc_prj = torch.ones_like(L)

    # distant: a disk of the world's radius across the direction
    v1, v2 = vm.coordinate_system(ldir)
    cd = smp.concentric_sample_disk(u_pos)
    o_dist = wc + wr * (cd[:, 0:1] * v1 + cd[:, 1:2] * v2) + wr * ldir
    beta_dist = L * (math.pi * wr * wr)

    # area triangle: an area-uniform point and a cosine direction
    tri = _sample_light_triangle(scene, lid, u6[:, 0])
    b = smp.uniform_sample_triangle(u_pos)
    n_t = scene.ltri_ng[tri]
    p_t = scene.ltri_p0[tri] + b[:, 0:1] * scene.ltri_e1[tri] \
        + b[:, 1:2] * scene.ltri_e2[tri]
    flip = two_sided & (u6[:, 1] < 0.5)
    n_emit = torch.where(flip[:, None], -n_t, n_t)
    w_loc = smp.cosine_sample_hemisphere(u_dir)
    tx_t, ty_t = vm.coordinate_system(n_emit)
    d_tri = vm.to_world(w_loc, tx_t, ty_t, n_emit)
    area = torch.clamp(g(scene.light_area), min=1e-12)
    # L cos / (pdf_pos pdf_dir) = L area pi; two-sided emits twice the power
    beta_tri = L * (area * math.pi * torch.where(two_sided, 2.0, 1.0))[:, None]

    # area sphere: a uniform surface point and a cosine direction
    sph = torch.clamp(g(scene.light_sphere), 0, scene.sph_center.shape[0] - 1).long()
    c_s, r_s = scene.sph_center[sph], scene.sph_radius[sph]
    n_s = smp.uniform_sample_sphere(u_pos)
    p_s = c_s + r_s[:, None] * n_s
    tx_p, ty_p = vm.coordinate_system(n_s)
    d_sphl = vm.to_world(w_loc, tx_p, ty_p, n_s)
    beta_sphl = L * (4.0 * math.pi * math.pi * r_s * r_s)[:, None]

    # infinite: the env distribution's (or a uniform) direction, the origin
    # on the world-bounding disk behind it
    wi_inf = smp.uniform_sample_sphere(u_dir)
    pdf_inf = torch.full((N,), smp.INV_4PI, device=dev)
    le_inf = L
    if scene.has_env_map > 0:
        wi_e, pdf_e, li_e = _sample_env_map(scene, u_dir)
        use_env = light_id == scene.env_light_id
        wi_inf = torch.where(use_env[:, None], wi_e, wi_inf)
        pdf_inf = torch.where(use_env, pdf_e, pdf_inf)
        le_inf = torch.where(use_env[:, None], li_e, L)
    v1i, v2i = vm.coordinate_system(wi_inf)
    o_inf = wc + wr * (cd[:, 0:1] * v1i + cd[:, 1:2] * v2i) + wr * wi_inf
    beta_inf = le_inf * (math.pi * wr * wr / torch.clamp(pdf_inf, min=1e-12))[:, None]

    def sel3(*pairs, default):
        out = default
        for m, v in pairs:
            out = torch.where(m[:, None], v, out)
        return out

    o = sel3((is_pt | is_spot | is_gon | is_prj, pos), (is_dist, o_dist),
             (is_inf, o_inf), (is_tri, p_t), (is_sph, p_s), default=pos)
    d = sel3((is_pt | is_gon | is_prj, d_sph), (is_spot, d_spot),
             (is_dist, -ldir), (is_inf, -wi_inf), (is_tri, d_tri),
             (is_sph, d_sphl), default=d_sph)
    beta = sel3((is_pt, beta_pt), (is_spot, beta_spot),
                (is_gon, beta_pt * sc_gon), (is_prj, beta_pt * sc_prj),
                (is_dist, beta_dist), (is_inf, beta_inf), (is_tri, beta_tri),
                (is_sph, beta_sphl), default=beta_pt)
    valid = ((light_id >= 0) & (light_id < scene.n_lights)
             & (vm.luminance(torch.abs(beta)) > 0.0))
    le = sel3((is_pt, L), (is_spot, L * falloff[:, None]), (is_gon, L * sc_gon),
              (is_prj, L * sc_prj), (is_dist, L), (is_inf, le_inf),
              (is_tri, L), (is_sph, L), default=L)
    n_emit_out = sel3((is_tri, n_emit), (is_sph, n_s), default=d)
    ones = torch.ones(N, device=dev)
    inv_disk = 1.0 / max(math.pi * wr * wr, 1e-12)
    pdf_pos = torch.where(
        is_tri, 1.0 / area,
        torch.where(is_sph, 1.0 / torch.clamp(4.0 * math.pi * r_s * r_s, min=1e-12),
                    torch.where(is_dist | is_inf, inv_disk, ones)))
    cos_emit = torch.where(is_tri | is_sph, vm.absdot(d, n_emit_out), ones)
    pdf_dir = torch.where(
        is_tri | is_sph, smp.cosine_hemisphere_pdf(cos_emit),
        torch.where(is_pt | is_gon | is_prj, smp.INV_4PI,
                    torch.where(is_spot, smp.uniform_cone_pdf(ct),
                                torch.where(is_inf, pdf_inf, ones))))
    return LightEmission(o=o, d=d, beta=beta, valid=valid, le=le, n_l=n_emit_out,
                         pdf_pos=pdf_pos, pdf_dir=pdf_dir,
                         delta_pos=is_pt | is_spot | is_gon | is_prj,
                         delta_dir=is_dist)


def pdf_le_dir(scene, light_id, n_l, w):
    """Solid-angle pdf of a light emitting towards w from a point with
    normal n_l (the direction half of diffuse.cpp, point.cpp, spot.cpp
    Pdf_Le); 0 for a delta direction (distant)."""
    lid = light_id.long()
    g = lambda a: a[lid]
    kind = g(scene.light_kind)
    two_sided = g(scene.light_two_sided) > 0.5
    cos_w = vm.dot(n_l, w)
    pdf_area = torch.where(two_sided,
                           0.5 * smp.cosine_hemisphere_pdf(torch.abs(cos_w)),
                           torch.where(cos_w > 0.0,
                                       smp.cosine_hemisphere_pdf(cos_w), 0.0))
    ct = g(scene.light_cos_total)
    cos_sp = vm.dot(g(scene.light_dir), w)
    pdf_spot = torch.where(cos_sp >= ct, smp.uniform_cone_pdf(ct), 0.0)
    pdf_inf = torch.full_like(cos_w, smp.INV_4PI)
    if scene.has_env_map > 0:
        pdf_inf = torch.where(light_id == scene.env_light_id,
                              _env_dir_pdf(scene, -w), pdf_inf)
    is_area = (kind == LIGHT_AREA_TRI) | (kind == LIGHT_AREA_SPHERE)
    is_ptlike = (kind == LIGHT_POINT) | (kind == LIGHT_GONIO) | \
        (kind == LIGHT_PROJECTION)
    return torch.where(is_area, pdf_area,
           torch.where(is_ptlike, smp.INV_4PI,
           torch.where(kind == LIGHT_SPOT, pdf_spot,
           torch.where(kind == LIGHT_INFINITE, pdf_inf, 0.0))))


def pdf_light_origin(scene, light_id):
    """Area-measure pdf of a light's emission origin times its selection
    pdf (bdpt.h Vertex::PdfLightOrigin); 0 for a delta position."""
    lid = light_id.long()
    kind = scene.light_kind[lid]
    area = torch.clamp(scene.light_area[lid], min=1e-12)
    sph = torch.clamp(scene.light_sphere[lid], 0, scene.sph_center.shape[0] - 1).long()
    r_s = scene.sph_radius[sph]
    inv_disk = 1.0 / max(math.pi * scene.world_radius ** 2, 1e-12)
    pdf_pos = torch.where(
        kind == LIGHT_AREA_TRI, 1.0 / area,
        torch.where(kind == LIGHT_AREA_SPHERE,
                    1.0 / torch.clamp(4.0 * math.pi * r_s * r_s, min=1e-12),
                    torch.where(kind == LIGHT_DISTANT, inv_disk,
                                torch.zeros_like(area))))
    return pdf_pos * scene.light_pdf[lid]


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
