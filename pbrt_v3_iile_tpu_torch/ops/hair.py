"""Hair fiber BSDF for the wavefront (port of ``ops/hair.py``).

The reference's hair material (materials/hair.cpp: HairBSDF::f,
::Sample_f, ::Pdf, ::ComputeApPdf and the helpers Mp, Ap, Np, Phi,
Logistic and TrimmedLogistic), the pbrt-v3 implementation of Chiang et
al. 2016, "A Practical and Controllable Hair and Fur Model for
Production Path Tracing".  Every quantity is computed for the whole
wavefront at once: the p = 0..2 lobe loop is unrolled, with no per-ray
control flow.

Directions are in the fiber's local frame (+x along the tangent, (y, z)
the normal plane); ``h`` in [-1, 1] is the ray's offset across the fiber
(hair.cpp h = -1 + 2v; curves are tessellated, so h comes from the
interpolated v coordinate).
"""

from __future__ import annotations

import math

import torch

PMAX = 3
SQRT_PI_OVER_8 = 0.626657069
TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# numeric helpers (hair.cpp I0, LogI0, Logistic, LogisticCDF,
# TrimmedLogistic)
# ---------------------------------------------------------------------------

def _i0(x):
    """Modified Bessel I0, 10-term series."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    big = x > 12.0
    safe = torch.clamp(x, min=1e-6)
    log_big = safe + 0.5 * (-math.log(TWO_PI) + torch.log(1.0 / safe)
                            + 1.0 / (8.0 * safe))
    return torch.where(big, log_big, torch.log(_i0(torch.clamp(x, max=12.0))))


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _as_tensor(v, like):
    return torch.full_like(like, v) if not torch.is_tensor(v) else v


def _sample_trimmed_logistic(u, s, a, b):
    """hair.cpp SampleTrimmedLogistic (a, b python floats)."""
    a_t, b_t = _as_tensor(a, s), _as_tensor(b, s)
    k = _logistic_cdf(b_t, s) - _logistic_cdf(a_t, s)
    t = u * k + _logistic_cdf(a_t, s)
    t = torch.clamp(t, 1e-6, 1.0 - 1e-6)
    x = -s * torch.log(1.0 / t - 1.0)
    return torch.clamp(x, a, b)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def _fr_dielectric(cos_i, eta):
    """Unpolarized Fresnel from the outside (reflection.cpp FrDielectric)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t = _safe_sqrt(1.0 - cos_i * cos_i) / eta
    total = sin_t >= 1.0
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-9)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-9)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(total, torch.ones_like(f), f)


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def beta_to_v(beta_m):
    """Longitudinal roughness -> the lobes' variances (4, N)."""
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20) ** 2
    return torch.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], dim=0)


def beta_to_s(beta_n):
    """Azimuthal roughness -> the logistic scale."""
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                             + 5.372 * beta_n ** 22)


def _tilt_tables(alpha_deg):
    """sin and cos of 2^k alpha for k = 0, 1, 2 (the doubling recurrence
    of the HairBSDF constructor)."""
    a = torch.deg2rad(alpha_deg)
    s0 = torch.sin(a)
    c0 = _safe_sqrt(1.0 - s0 * s0)
    s1 = 2.0 * c0 * s0
    c1 = c0 * c0 - s0 * s0
    s2 = 2.0 * c1 * s1
    c2 = c1 * c1 - s1 * s1
    return (s0, s1, s2), (c0, c1, c2)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering (hair.cpp Mp)."""
    v = torch.clamp(v, min=1e-7)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    mp_small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                         + torch.log(1.0 / (2.0 * v)))
    # sinh(1/v) overflows for small v: used only where v > .1
    one = torch.ones_like(v)
    v_big = torch.where(small, one, v)
    mp_big = torch.exp(-b) * _i0(a) / (torch.sinh(1.0 / v_big) * 2.0 * v_big)
    return torch.where(small, mp_small, mp_big)


def _ap(cos_to, eta, h, transmittance):
    """Attenuation of the lobes p = 0..3 (hair.cpp Ap) -> (4, N, 3)."""
    cos_go = _safe_sqrt(1.0 - h * h)
    cos_theta = cos_to * cos_go
    f = _fr_dielectric(cos_theta, eta)[..., None]
    T = transmittance
    a0 = torch.broadcast_to(f, T.shape)
    a1 = (1.0 - f) ** 2 * T
    a2 = a1 * T * f
    # the rest: the geometric series of the remaining bounces
    a3 = a2 * f * T / torch.clamp(1.0 - T * f, min=1e-4)
    return torch.stack([a0, a1, a2, a3], dim=0)


def _phi_fn(p, gamma_o, gamma_t):
    """Net azimuthal deflection of lobe p (hair.cpp Phi)."""
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _np(phi, p, s, gamma_o, gamma_t):
    """Azimuthal scattering (hair.cpp Np)."""
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = torch.remainder(dphi + math.pi, TWO_PI) - math.pi
    return _trimmed_logistic(dphi, s, _as_tensor(-math.pi, s),
                             _as_tensor(math.pi, s))


def _tilted_to(p_idx, sin_to, cos_to, sin2k, cos2k):
    """theta_o tilted by lobe p's scale angle (hair.cpp f(),
    sinThetaOp / cosThetaOp).  p_idx in {0, 1, 2}."""
    if p_idx == 0:
        s = sin_to * cos2k[1] - cos_to * sin2k[1]
        c = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p_idx == 1:
        s = sin_to * cos2k[0] + cos_to * sin2k[0]
        c = cos_to * cos2k[0] - sin_to * sin2k[0]
    else:
        s = sin_to * cos2k[2] + cos_to * sin2k[2]
        c = cos_to * cos2k[2] - sin_to * sin2k[2]
    return s, torch.abs(c)


def _fiber(sin_to, cos_to, h, eta, sigma_a):
    """gamma_o, gamma_t and the absorption T along the internal chord."""
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(1.0 - sin_tt * sin_tt)
    etap = _safe_sqrt(eta * eta - sin_to * sin_to) / torch.clamp(cos_to, min=1e-6)
    sin_gt = h / torch.clamp(etap, min=1e-6)
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    gamma_o = _safe_asin(h)
    # hair.cpp f(): T = Exp(-sigma_a * (2 cosGammaT / cosThetaT))
    T = torch.exp(-sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-5))[..., None])
    return gamma_o, gamma_t, T


def _geom(wo, wi, h, eta, sigma_a):
    """The quantities that f and pdf share."""
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)
    phi_i = torch.atan2(wi[..., 2], wi[..., 1])
    gamma_o, gamma_t, T = _fiber(sin_to, cos_to, h, eta, sigma_a)
    return (sin_to, cos_to, phi_o, sin_ti, cos_ti, phi_i, gamma_o, gamma_t, T)


def _per_lane(v, h):
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32,
                                              device=h.device), h.shape)


# ---------------------------------------------------------------------------
# evaluate / pdf / sample
# ---------------------------------------------------------------------------

def _ap_pdf(ap):
    """The lobes' selection pdf by luminance (hair.cpp ComputeApPdf) from
    their attenuations ap (4, N, 3) -> (4, N)."""
    y = 0.212671 * ap[..., 0] + 0.715160 * ap[..., 1] + 0.072169 * ap[..., 2]
    tot = torch.sum(y, dim=0, keepdim=True)
    return y / torch.clamp(tot, min=1e-9)


def evaluate_pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::f and ::Pdf together (they share every lobe's Mp and Np).
    wo/wi (N,3) local (+x the fiber tangent), h (N,), sigma_a (N,3),
    beta_m/beta_n (N,).  Returns (f (N,3), pdf (N,))."""
    eta = _per_lane(eta, h)
    (sin_to, cos_to, phi_o, sin_ti, cos_ti, phi_i,
     gamma_o, gamma_t, T) = _geom(wo, wi, h, eta, sigma_a)
    v = beta_to_v(beta_m)
    s = beta_to_s(beta_n)
    sin2k, cos2k = _tilt_tables(_per_lane(alpha_deg, h))
    ap = _ap(cos_to, eta, h, T)
    appdf = _ap_pdf(ap)
    phi = phi_i - phi_o

    fsum = torch.zeros_like(sigma_a)
    psum = torch.zeros_like(h)
    for p in range(PMAX):
        sin_top, cos_top = _tilted_to(p, sin_to, cos_to, sin2k, cos2k)
        mp = _mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
        np_ = _np(phi, float(p), s, gamma_o, gamma_t)
        fsum = fsum + (mp * np_)[..., None] * ap[p]
        psum = psum + mp * appdf[p] * np_
    mp_last = _mp(cos_ti, cos_to, sin_ti, sin_to, v[PMAX])
    fsum = fsum + (mp_last / TWO_PI)[..., None] * ap[PMAX]
    psum = psum + mp_last * appdf[PMAX] / TWO_PI

    abscos = torch.abs(wi[..., 2])
    f = torch.where((abscos > 0.0)[..., None],
                    fsum / torch.clamp(abscos, min=1e-6)[..., None], fsum)
    return f, psum


def evaluate(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::f -> (N,3)."""
    return evaluate_pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg, eta)[0]


def pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::Pdf -> (N,)."""
    return evaluate_pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg, eta)[1]


def sample(wo, u4, h, sigma_a, beta_m, beta_n, alpha_deg=2.0, eta=1.55):
    """HairBSDF::Sample_f.  u4 (N,4): [lobe pick, phi, theta u0,
    theta u1].  Returns (wi (N,3), f (N,3), pdf (N,))."""
    eta = _per_lane(eta, h)
    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    gamma_o, gamma_t, T = _fiber(sin_to, cos_to, h, eta, sigma_a)

    v = beta_to_v(beta_m)
    s = beta_to_s(beta_n)
    sin2k, cos2k = _tilt_tables(_per_lane(alpha_deg, h))
    appdf = _ap_pdf(_ap(cos_to, eta, h, T))     # (4, N)

    # the lobe p by inversion of the cdf
    cdf = torch.cumsum(appdf, dim=0)
    u0 = u4[..., 0]
    p_pick = torch.sum((u0[None] > cdf).to(torch.int32), dim=0)
    p_pick = torch.clamp(p_pick, 0, PMAX)

    # theta_o tilted for the picked lobe (untilted for the residual lobe)
    tilts = [_tilted_to(p, sin_to, cos_to, sin2k, cos2k) for p in range(PMAX)]
    tilts.append((sin_to, cos_to))
    sin_top, cos_top = tilts[PMAX]
    for p in range(PMAX - 1, -1, -1):
        sin_top = torch.where(p_pick == p, tilts[p][0], sin_top)
        cos_top = torch.where(p_pick == p, tilts[p][1], cos_top)

    # longitudinal sample (Sample_f: cosTheta = 1 + v log(...))
    vp = torch.gather(v, 0, p_pick.long()[None])[0]
    u_th = torch.clamp(u4[..., 2], min=1e-5)
    cos_theta = 1.0 + vp * torch.log(u_th + (1.0 - u_th)
                                     * torch.exp(-2.0 / torch.clamp(vp, min=1e-7)))
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi_l = torch.cos(TWO_PI * u4[..., 3])
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi_l * cos_top
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)

    # azimuthal sample
    u_phi = u4[..., 1]
    dphi_smooth = torch.stack(
        [_phi_fn(float(p), gamma_o, gamma_t)
         + _sample_trimmed_logistic(u_phi, s, -math.pi, math.pi)
         for p in range(PMAX)], dim=0)
    picked = torch.gather(dphi_smooth, 0,
                          torch.clamp(p_pick, 0, PMAX - 1).long()[None])[0]
    dphi = torch.where(p_pick < PMAX, picked, TWO_PI * u_phi)
    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], dim=-1)

    f, p_ = evaluate_pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha_deg, eta)
    return wi, f, p_


def sigma_a_from_concentration(eumelanin, pheomelanin):
    """hair.cpp SigmaAFromConcentration -> (3,) RGB absorption."""
    eum = torch.tensor([0.419, 0.697, 1.37], dtype=torch.float32)
    pheo = torch.tensor([0.187, 0.4, 1.05], dtype=torch.float32)
    return eumelanin * eum + pheomelanin * pheo


def sigma_a_from_reflectance(c, beta_n):
    """hair.cpp SigmaAFromReflectance."""
    t = (torch.log(torch.clamp(torch.as_tensor(c, dtype=torch.float32), min=1e-5))
         / (5.969 - 0.215 * beta_n + 2.532 * beta_n ** 2
            - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
            + 0.245 * beta_n ** 5))
    return t * t
