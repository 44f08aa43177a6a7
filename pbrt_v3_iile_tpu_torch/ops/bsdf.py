"""Wavefront BSDF evaluation and sampling (port of ``ops/bsdf.py``).

Every material is a fixed set of lobes (diffuse, glossy microfacet,
specular reflection, specular transmission) evaluated for the whole
wavefront with per-ray masks; lobe selection is luminance-weighted.
All directions are in the local shading frame (+z = shading normal).
The hair fiber lobe (``ops/hair.py``) and the exact Fourier table
(``ops/fourierbsdf.py``, sampled through its fitted proxy lobes) replace
the lobe mix on their lanes; each is computed only when the scene holds
such a material.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

from ..scene.api import (
    MAT_NONE, MAT_MATTE, MAT_PLASTIC, MAT_MIRROR, MAT_GLASS, MAT_METAL,
    MAT_UBER, MAT_SUBSTRATE, MAT_TRANSLUCENT, MAT_DISNEY, MAT_HAIR,
    MAT_FOURIER, MAT_SUBSURFACE,
)
from ..utils import vecmath as vm
from . import fourierbsdf as fourierlib
from . import hair as hairlib
from . import sampling as smp

INV_PI = 1.0 / math.pi


@dataclass
class BsdfParams:
    kind: torch.Tensor       # (N,) i32
    kd: torch.Tensor         # (N,3)
    ks: torch.Tensor         # (N,3)
    kr: torch.Tensor         # (N,3)
    kt: torch.Tensor         # (N,3)
    alpha: torch.Tensor      # (N,) microfacet alpha (after the remap)
    eta: torch.Tensor        # (N,)
    metal_eta: torch.Tensor  # (N,3)
    metal_k: torch.Tensor    # (N,3)
    sigma: torch.Tensor      # (N,) oren-nayar sigma (degrees)
    aux: torch.Tensor        # (N,8) disney extras; hair: beta_m, beta_n,
                             # alpha (degrees), with sigma_a in kd
    h: torch.Tensor = None   # (N,) hair fiber offset in [-1, 1]
                             # (hair.cpp h = -1 + 2v); None: 0
    fourier_id: torch.Tensor = None  # (N,) i32 Fourier table or -1
    fourier: object = None   # the scene's FourierDev, None without one
    has_hair: bool = False   # the scene holds a hair material


def map_params(fn, *ps: BsdfParams) -> BsdfParams:
    """BsdfParams whose tensor fields are fn(field of each of ps); the
    scene's tables (``fourier``, ``has_hair``) come from the first."""
    out = {}
    for f in fields(BsdfParams):
        vals = [getattr(q, f.name) for q in ps]
        out[f.name] = (fn(*vals) if isinstance(vals[0], torch.Tensor)
                       else vals[0])
    return BsdfParams(**out)


def concat_params(ps) -> BsdfParams:
    """The lanes of several BsdfParams, concatenated in order."""
    return map_params(lambda *xs: torch.cat(xs), *ps)


def select_params(mask, a: BsdfParams, b: BsdfParams) -> BsdfParams:
    """a where mask (N,), else b."""
    return map_params(lambda x, y: torch.where(
        mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y), a, b)


def roughness_to_alpha(rough):
    x = torch.log(torch.clamp(rough, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def gather_params(scene, mat_id, uv=None, p=None, tex_width=None,
                  face=None) -> BsdfParams:
    """Material SoA gather plus texture evaluation at the hit: uv (N,2)
    and the world point p (N,3; zeros when None) feed the textures,
    tex_width (N,) is the ray cone's UV footprint, face (N,) the ptex face
    index."""
    from ..scene import textures as texlib

    mid = mat_id.long()
    g = lambda a: a[mid]
    rough = g(scene.mat_rough)
    uro = g(scene.mat_urough)
    rough = torch.where(uro >= 0.0, torch.where(uro > 0, uro, rough), rough)
    kd = g(scene.mat_kd)
    ks = g(scene.mat_ks)
    sigma = g(scene.mat_sigma)
    if uv is not None and scene.textures.kind.shape[0] > 1:
        tt = scene.textures
        if p is None:
            p = torch.zeros(uv.shape[:-1] + (3,), dtype=uv.dtype,
                            device=uv.device)
        kd_t, ks_t = g(scene.mat_kd_tex), g(scene.mat_ks_tex)
        sg_t, ro_t = g(scene.mat_sigma_tex), g(scene.mat_rough_tex)
        ev = lambda tid: texlib.eval_texture(tt, tid, uv, p, tex_width, face)
        kd = torch.where((kd_t >= 0)[..., None], ev(kd_t), kd)
        ks = torch.where((ks_t >= 0)[..., None], ev(ks_t), ks)
        sigma = torch.where(sg_t >= 0, ev(sg_t)[..., 0], sigma)
        rough = torch.where(ro_t >= 0, ev(ro_t)[..., 0], rough)
    remap = g(scene.mat_remap) > 0.5
    kind = g(scene.mat_kind)
    alpha = torch.where(remap, roughness_to_alpha(rough),
                        torch.clamp(rough, min=1e-3))
    alpha = torch.where(kind == MAT_DISNEY,
                        torch.clamp(rough * rough, min=1e-3), alpha)
    # hair: tessellated curves carry the across-fiber coordinate in v, so
    # the ray's fiber offset is h = -1 + 2 frac(v)
    h = None
    if scene.has_hair and uv is not None:
        v_coord = uv[..., 1] - torch.floor(uv[..., 1])
        h = torch.clamp(-1.0 + 2.0 * v_coord, -0.9995, 0.9995)
    fourier = scene.fourier
    return BsdfParams(kind=kind, kd=kd, ks=ks, kr=g(scene.mat_kr),
                      kt=g(scene.mat_kt), alpha=alpha, eta=g(scene.mat_eta),
                      metal_eta=g(scene.mat_metal_eta),
                      metal_k=g(scene.mat_metal_k), sigma=sigma,
                      aux=g(scene.mat_aux), h=h,
                      fourier_id=(g(scene.mat_fourier_id) if fourier is not None
                                  else None),
                      fourier=fourier, has_hair=scene.has_hair)


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------

def fr_dielectric(cos_i, eta_i, eta_t):
    """FrDielectric; cos_i may be signed."""
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(torch.clamp(cos_i, -1.0, 1.0))
    sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-9)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-9)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(fr), fr)


def fr_conductor(cos_i, eta, k):
    """FrConductor; eta, k are (N,3) rgb."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-9)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-9)
    return 0.5 * (rp + rs)


def schlick_fresnel(rs, cos_i):
    pw = torch.pow(torch.clamp(1.0 - cos_i, 0.0, 1.0), 5.0)[..., None]
    return rs + pw * (1.0 - rs)


def fresnel_moment1(eta):
    """First moment of the Fresnel reflectance, the polynomial fits of
    bssrdf.cpp FresnelMoment1."""
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX), isotropic
# ---------------------------------------------------------------------------

def _cos2(w):
    return torch.clamp(w[..., 2] * w[..., 2], 0.0, 1.0)


def tr_d(wh, alpha):
    c2 = _cos2(wh)
    s2 = torch.clamp(1.0 - c2, min=0.0)
    a2 = alpha * alpha
    e = c2 + s2 / torch.clamp(a2, min=1e-9)
    d = 1.0 / (math.pi * a2 * torch.clamp(e * e, min=1e-12))
    return torch.where(c2 > 0.0, d, torch.zeros_like(d))


def tr_lambda(w, alpha):
    c2 = _cos2(w)
    s2 = torch.clamp(1.0 - c2, min=0.0)
    tan2 = s2 / torch.clamp(c2, min=1e-9)
    lam = 0.5 * (-1.0 + torch.sqrt(torch.clamp(1.0 + alpha * alpha * tan2,
                                               min=0.0)))
    return torch.where(c2 > 1e-9, lam, torch.full_like(lam, 1e9))


def tr_g(wo, wi, alpha):
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_sample_wh(wo, u, alpha):
    """Sample the full NDF (its pdf is tr_pdf), flipped to wo's side."""
    tan2 = alpha * alpha * u[..., 0] / torch.clamp(1.0 - u[..., 0], min=1e-9)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    wh = vm.spherical_direction(sin_t, cos_t, phi)
    return torch.where((wo[..., 2:3] * wh[..., 2:3]) < 0.0, -wh, wh)


def tr_pdf(wo, wh, alpha):
    return tr_d(wh, alpha) * torch.abs(wh[..., 2])


def gtr1_d(wh, a):
    a2 = a * a
    c2 = _cos2(wh)
    denom = math.pi * torch.log(torch.clamp(a2, min=1e-6)) * (1.0 + (a2 - 1.0) * c2)
    return (a2 - 1.0) / torch.where(torch.abs(denom) > 1e-12, denom,
                                    torch.full_like(denom, 1e-12))


def _smith_g_ggx(cos_t, a):
    c2 = cos_t * cos_t
    a2 = a * a
    return 1.0 / torch.clamp(cos_t + torch.sqrt(a2 + c2 - a2 * c2), min=1e-7)


def _schlick_weight(c):
    return torch.pow(torch.clamp(1.0 - c, 0.0, 1.0), 5.0)


def _lum(rgb):
    return vm.luminance(torch.clamp(rgb, min=0.0))


def _isin(k, *kinds):
    m = k == kinds[0]
    for x in kinds[1:]:
        m = m | (k == x)
    return m


def _lobe_weights(p: BsdfParams):
    """(N,4) selection weights: diffuse, glossy, specular reflect, transmit."""
    k = p.kind
    zero = torch.zeros_like(p.eta)
    w_d = torch.where(_isin(k, MAT_MATTE, MAT_PLASTIC, MAT_UBER, MAT_SUBSTRATE,
                            MAT_TRANSLUCENT, MAT_FOURIER, MAT_SUBSURFACE),
                      _lum(p.kd), zero)
    w_g = torch.where(_isin(k, MAT_PLASTIC, MAT_UBER, MAT_TRANSLUCENT,
                            MAT_FOURIER), _lum(p.ks), zero)
    w_g = torch.where(_isin(k, MAT_METAL, MAT_HAIR), 1.0, w_g)
    w_g = torch.where(k == MAT_SUBSTRATE, _lum(p.ks), w_g)
    w_r = torch.where(_isin(k, MAT_MIRROR, MAT_UBER, MAT_SUBSURFACE, MAT_GLASS),
                      _lum(p.kr), zero)
    w_t = torch.where(k == MAT_GLASS, _lum(p.kt), zero)
    is_dis = k == MAT_DISNEY
    metallic = p.aux[..., 0]
    spec_trans = p.aux[..., 6]
    w_d = torch.where(is_dis, (1.0 - metallic) * (1.0 - spec_trans) * _lum(p.kd),
                      w_d)
    w_g = torch.where(is_dis, 0.25 * p.aux[..., 4]
                      + torch.clamp(metallic * _lum(p.kd), min=0.08), w_g)
    w_t = torch.where(is_dis, spec_trans * (1.0 - metallic), w_t)
    w = torch.stack([w_d, w_g, w_r, w_t], dim=-1)
    tot = torch.sum(w, dim=-1, keepdim=True)
    return torch.where(tot > 0.0, w / torch.clamp(tot, min=1e-12),
                       torch.zeros_like(w))


def _same_hemisphere(a, b):
    return (a[..., 2] * b[..., 2]) > 0.0


def _hair_args(p: BsdfParams):
    h = p.h if p.h is not None else torch.zeros_like(p.eta)
    return h, p.kd, p.aux[..., 0], p.aux[..., 1], p.aux[..., 2], p.eta


def evaluate(p: BsdfParams, wo, wi, enable_hair: bool = None):
    """(f (N,3), pdf (N,)) of the non-delta lobes (BSDF::f + BSDF::Pdf).

    enable_hair statically gates the fiber lobe (None: whether the scene
    holds a hair material)."""
    w = _lobe_weights(p)
    refl = _same_hemisphere(wo, wi)
    cos_o = torch.abs(wo[..., 2])
    cos_i = torch.abs(wi[..., 2])

    # diffuse: lambert / oren-nayar
    sigma_rad = torch.deg2rad(torch.clamp(p.sigma, min=0.0))
    s2 = sigma_rad * sigma_rad
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    cos_dphi = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / (
        torch.clamp(sin_i, min=1e-9) * torch.clamp(sin_o, min=1e-9))
    max_cos = torch.where((sin_i > 1e-4) & (sin_o > 1e-4),
                          torch.clamp(cos_dphi, min=0.0), torch.zeros_like(cos_dphi))
    sin_alpha = torch.maximum(sin_i, sin_o)
    tan_beta = torch.minimum(sin_i, sin_o) / torch.clamp(
        torch.minimum(cos_i, cos_o), min=1e-4)
    on = A + B * max_cos * sin_alpha * tan_beta
    f_diff = p.kd * (INV_PI * torch.where(p.sigma > 0, on, torch.ones_like(on)))[..., None]
    pdf_diff = smp.cosine_hemisphere_pdf(cos_i)

    # glossy microfacet
    wh = wo + wi
    wh_len = vm.length(wh)
    wh = torch.where((wh_len > 1e-9)[..., None],
                     wh / torch.clamp(wh_len, min=1e-9)[..., None],
                     torch.zeros_like(wh))
    d = tr_d(wh, p.alpha)
    g = tr_g(wo, wi, p.alpha)
    is_metal = p.kind == MAT_METAL
    is_substrate = p.kind == MAT_SUBSTRATE
    ones = torch.ones_like(p.eta)
    fr_d = fr_dielectric(vm.dot(wi, wh), ones, p.eta)[..., None]
    # pbrt-v3's plastic builds its microfacet Fresnel with the indices
    # reversed, FresnelDielectric(1.5, 1) (plastic.cpp:59); parity with the
    # reference means reproducing it
    fr_pl = fr_dielectric(vm.dot(wi, wh), p.eta, ones)[..., None]
    fr_d = torch.where((p.kind == MAT_PLASTIC)[..., None], fr_pl, fr_d)
    fr_c = fr_conductor(vm.dot(wi, wh), p.metal_eta, p.metal_k)
    fr = torch.where(is_metal[..., None], fr_c, fr_d)
    spec_coef = torch.where(is_metal[..., None], torch.ones_like(p.ks), p.ks)
    denom = 4.0 * torch.clamp(cos_i * cos_o, min=1e-7)
    f_gloss = spec_coef * (d * g / denom)[..., None] * fr
    # substrate FresnelBlend
    fb_diff = (28.0 / (23.0 * math.pi)) * p.kd * (1.0 - p.ks) * (
        (1.0 - torch.pow(1.0 - 0.5 * cos_i, 5.0))
        * (1.0 - torch.pow(1.0 - 0.5 * cos_o, 5.0)))[..., None]
    fb_spec = (d / (4.0 * torch.clamp(torch.abs(vm.dot(wi, wh)), min=1e-7)
                    * torch.clamp(torch.maximum(cos_i, cos_o), min=1e-7)))[..., None] \
        * schlick_fresnel(p.ks, vm.dot(wi, wh))
    f_diff = torch.where(is_substrate[..., None], fb_diff, f_diff)
    f_gloss = torch.where(is_substrate[..., None], fb_spec, f_gloss)

    # disney principled lobes
    is_dis = p.kind == MAT_DISNEY
    metallic, spec_tint = p.aux[..., 0], p.aux[..., 1]
    sheen_amt, sheen_tint = p.aux[..., 2], p.aux[..., 3]
    clearcoat, cc_gloss, spec_trans = p.aux[..., 4], p.aux[..., 5], p.aux[..., 6]
    cos_d = torch.abs(vm.dot(wi, wh))
    FL = _schlick_weight(cos_i)
    FV = _schlick_weight(cos_o)
    rough_dis = torch.sqrt(torch.clamp(p.alpha, min=1e-6))
    base_diff = p.kd * (INV_PI * (1.0 - 0.5 * FL) * (1.0 - 0.5 * FV))[..., None]
    RR = 2.0 * rough_dis * cos_d * cos_d
    retro = p.kd * (INV_PI * RR * (FL + FV + FL * FV * (RR - 1.0)))[..., None]
    ctint = p.kd / torch.clamp(_lum(p.kd), min=1e-4)[..., None]
    white = torch.ones_like(p.kd)
    csheen = vm.lerp(sheen_tint[..., None], white, ctint)
    f_sheen = (sheen_amt * _schlick_weight(cos_d))[..., None] * csheen
    dif_w = ((1.0 - metallic) * (1.0 - spec_trans))[..., None]
    f_diff_dis = dif_w * (base_diff + retro) + (1.0 - metallic)[..., None] * f_sheen
    r0 = ((p.eta - 1.0) / torch.clamp(p.eta + 1.0, min=1e-6)) ** 2
    cspec0 = vm.lerp(metallic[..., None],
                     r0[..., None] * vm.lerp(spec_tint[..., None], white, ctint),
                     p.kd)
    F_dis = cspec0 + _schlick_weight(cos_d)[..., None] * (1.0 - cspec0)
    f_spec_dis = (d * g / denom)[..., None] * F_dis
    a_cc = vm.lerp(cc_gloss, 0.1, 0.001)
    d_cc = gtr1_d(wh, a_cc)
    g_cc = _smith_g_ggx(cos_i, 0.25) * _smith_g_ggx(cos_o, 0.25)
    f_cc_s = 0.04 + 0.96 * _schlick_weight(cos_d)
    f_cc = (0.25 * clearcoat * d_cc * g_cc * f_cc_s)[..., None] * white
    f_diff = torch.where(is_dis[..., None], f_diff_dis, f_diff)
    f_gloss = torch.where(is_dis[..., None], f_spec_dis + f_cc, f_gloss)
    pdf_gloss = tr_pdf(wo, wh, p.alpha) / (
        4.0 * torch.clamp(torch.abs(vm.dot(wo, wh)), min=1e-7))
    pdf_gloss = torch.where(wh_len > 1e-9, pdf_gloss, torch.zeros_like(pdf_gloss))

    valid_d = refl & (w[..., 0] > 0.0)
    valid_g = refl & (w[..., 1] > 0.0) & (d > 0.0)
    zero3 = torch.zeros_like(f_diff)
    f = (torch.where(valid_d[..., None], f_diff, zero3)
         + torch.where(valid_g[..., None], f_gloss, zero3))
    zero = torch.zeros_like(pdf_diff)
    pdf = (torch.where(valid_d, w[..., 0] * pdf_diff, zero)
           + torch.where(valid_g, w[..., 1] * pdf_gloss, zero))

    # exact FourierBSDF: f from the table, the pdf the proxy lobes' mix;
    # a transmissive table (kt proxy > 0) makes the diffuse proxy a
    # two-sided cosine so that transmitted directions are samplable
    if p.fourier is not None:
        is_fourier = p.kind == MAT_FOURIER
        f_four = fourierlib.evaluate_device(p.fourier, p.fourier_id, wo, wi)
        f = torch.where(is_fourier[..., None], f_four, f)
        kt_l = _lum(p.kt)
        pt = kt_l / torch.clamp(_lum(p.kd) + kt_l, min=1e-9)
        cos_pdf = torch.abs(wi[..., 2]) * smp.INV_PI
        pdf_diff_2s = torch.where(refl, 1.0 - pt, pt) * cos_pdf
        pdf_four = (w[..., 0] * pdf_diff_2s
                    + torch.where(refl & (d > 0.0), w[..., 1] * pdf_gloss, zero))
        pdf = torch.where(is_fourier, pdf_four, pdf)

    # hair fiber lobe over the full sphere (materials/hair.cpp)
    if p.has_hair if enable_hair is None else enable_hair:
        is_hair = p.kind == MAT_HAIR
        f_h, pdf_h = hairlib.evaluate_pdf(wo, wi, *_hair_args(p))
        f = torch.where(is_hair[..., None], f_h, f)
        pdf = torch.where(is_hair, pdf_h, pdf)
    return f, pdf


@dataclass
class BsdfSample:
    wi: torch.Tensor               # (N,3) local
    f: torch.Tensor                # (N,3)
    pdf: torch.Tensor              # (N,)
    is_specular: torch.Tensor      # (N,) bool
    is_transmission: torch.Tensor  # (N,) bool
    valid: torch.Tensor            # (N,) bool


def sample(p: BsdfParams, wo, u_lobe, u2,
           enable_hair: bool = None) -> BsdfSample:
    """BSDF::Sample_f: u_lobe (N,) picks the lobe, u2 (N,2) the direction
    (enable_hair as for evaluate)."""
    w = _lobe_weights(p)
    cdf = torch.cumsum(w, dim=-1)
    lobe = torch.sum((u_lobe[..., None] > cdf).to(torch.int32), dim=-1)
    lobe = torch.clamp(lobe, 0, 3)
    cos_o = torch.abs(wo[..., 2])
    sign_o = torch.where(wo[..., 2] >= 0.0, 1.0, -1.0)

    # diffuse: the cosine hemisphere on wo's side; a transmissive Fourier
    # table flips to the far side with probability pt = kt / (kd + kt),
    # as its two-sided proxy pdf in evaluate
    wi_d = smp.cosine_sample_hemisphere(u2)
    d_sign = sign_o
    if p.fourier is not None:
        is_four_s = p.kind == MAT_FOURIER
        kt_l_s = _lum(p.kt)
        pt_s = torch.where(is_four_s,
                           kt_l_s / torch.clamp(_lum(p.kd) + kt_l_s, min=1e-9),
                           torch.zeros_like(kt_l_s))
        u_c0 = torch.clamp(u_lobe / torch.clamp(w[..., 0], min=1e-9), 0.0, 1.0)
        d_sign = torch.where(is_four_s & (u_c0 < pt_s), -sign_o, sign_o)
    wi_d = wi_d * torch.stack([torch.ones_like(sign_o), torch.ones_like(sign_o),
                               d_sign], dim=-1)
    wh = tr_sample_wh(wo, u2, p.alpha)
    wi_g = vm.reflect(wo, wh)
    wi_r = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    entering = wo[..., 2] > 0.0
    eta_rel = torch.where(entering, 1.0 / p.eta, p.eta)
    zeros = torch.zeros_like(sign_o)
    n_face = torch.stack([zeros, zeros, sign_o], dim=-1)
    wi_t, t_ok = vm.refract(wo, n_face, eta_rel)

    is_glass = p.kind == MAT_GLASS
    is_dis_t = (p.kind == MAT_DISNEY) & (lobe == 3)
    ones = torch.ones_like(p.eta)
    fr_g = fr_dielectric(wo[..., 2], ones, p.eta)
    cdf2 = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    w_lobe3 = torch.clamp(w[..., 3], min=1e-9)
    u_cond = torch.clamp((u_lobe - cdf2[..., 3]) / w_lobe3, 0.0, 1.0)
    u_fres = torch.where(is_glass, u_lobe, u_cond)
    glass_like = is_glass | is_dis_t
    lobe = torch.where(glass_like, torch.where(u_fres < fr_g, 2, 3), lobe)

    wi = torch.where((lobe == 0)[..., None], wi_d,
                     torch.where((lobe == 1)[..., None], wi_g,
                                 torch.where((lobe == 2)[..., None], wi_r, wi_t)))
    is_delta = lobe >= 2
    # the smooth lobes' f and pdf (hair has its own sampler below)
    f_sm, pdf_sm = evaluate(p, wo, wi, enable_hair=False)

    cos_i = torch.abs(wi[..., 2])
    fr_sr = torch.where(is_glass[..., None], fr_g[..., None],
                        torch.where(_isin(p.kind, MAT_UBER, MAT_SUBSURFACE)[..., None],
                                    fr_g[..., None], torch.ones_like(p.kr)))
    f_r = p.kr * fr_sr / torch.clamp(cos_i, min=1e-7)[..., None]
    pdf_r = torch.where(is_glass, fr_g, w[..., 2])
    scale_t = (1.0 / torch.clamp(eta_rel, min=1e-6)) ** 2
    f_t = p.kt * ((1.0 - fr_g) * scale_t / torch.clamp(cos_i, min=1e-7))[..., None]
    pdf_t = 1.0 - fr_g
    f = torch.where(is_delta[..., None],
                    torch.where((lobe == 2)[..., None], f_r, f_t), f_sm)
    pdf = torch.where(is_delta, torch.where(lobe == 2, pdf_r, pdf_t), pdf_sm)

    valid = pdf > 0.0
    valid = valid & torch.where(lobe == 3, t_ok, True)
    # diffuse and glossy lobes stay on wo's side, but for the Fourier
    # two-sided diffuse proxy, whose far-side flips are intended
    same_h = _same_hemisphere(wo, wi)
    hemi_ok, is_trans = same_h, lobe == 3
    if p.fourier is not None:
        hemi_ok = same_h | (is_four_s & (lobe == 0))
        is_trans = is_trans | (is_four_s & (lobe == 0) & ~same_h)
    valid = valid & torch.where(lobe <= 1, hemi_ok, True)
    valid = valid & (cos_o > 0.0)

    # hair fiber sampling (hair.cpp HairBSDF::Sample_f)
    if p.has_hair if enable_hair is None else enable_hair:
        is_hair = p.kind == MAT_HAIR
        # four uniforms from the three: the phi sample's low bits demuxed
        # for the conditional theta dimension (the reference's DemuxFloat)
        u4 = torch.stack([u_lobe, u2[..., 0], u2[..., 1],
                          torch.remainder(u2[..., 0] * 4096.0, 1.0)], dim=-1)
        wi_h, f_h, pdf_h = hairlib.sample(wo, u4, *_hair_args(p))
        wi = torch.where(is_hair[..., None], wi_h, wi)
        f = torch.where(is_hair[..., None], f_h, f)
        pdf = torch.where(is_hair, pdf_h, pdf)
        is_delta = is_delta & ~is_hair
        # hair scatters over the full sphere: a crossing of the hemisphere
        # is a transmission, so that the ray's origin moves to that side
        is_trans = torch.where(is_hair, ~_same_hemisphere(wo, wi), is_trans)
        valid = torch.where(is_hair, pdf > 0.0, valid)
    return BsdfSample(wi=wi, f=f, pdf=pdf, is_specular=is_delta,
                      is_transmission=is_trans, valid=valid)


def has_nonspecular(p: BsdfParams):
    w = _lobe_weights(p)
    return (w[..., 0] + w[..., 1]) > 0.0


def is_black(p: BsdfParams):
    tot = (_lum(p.kd) + _lum(p.ks) + _lum(p.kr) + _lum(p.kt)
           + torch.where(_isin(p.kind, MAT_METAL, MAT_HAIR), 1.0,
                         torch.zeros_like(p.eta)))
    return (tot <= 0.0) | (p.kind == MAT_NONE)
