"""Plain PyTorch reference of IILE, the neural indirect lighting of
pbrt-v3-IILE (``IISPTIntegrator::render_normal_2`` with its
``IisptRenderRunner``), for the scenes the benchmark renders.

It imports nothing of the program under test: the scene reader, the BVH,
the camera, the materials and the lights are ``pbrt_path``'s (the same
subset of pbrt-v3), IISPTNet's weights are read with numpy from the
committed npz by path, and every random number comes from a
``torch.Generator`` seeded by the caller.  It computes in float32 with
TF32 off, or in the ``dtype`` it is given (``torch.bfloat16`` is the
benchmark's control).

A frame, as the C++ reference renders one:

- **Schedule.**  Tasks sweep the image in squares of NUMBER_TILES (10)
  tiles of floor(radius) pixels; the radius starts at 100 and decays by
  sqrt(0.79541357) each time a sweep ends (``schedule``).
- **Probes.**  An 11 x 11 grid of probe pixels a task, at multiples of the
  tile size clamped to the task and the image; a jittered camera ray
  through each is followed through smooth glass, at most 24 bounces, to
  its first non-specular hit (``chase``), whose point and geometric
  normal, turned towards the viewer, place the probe.
- **G-buffer.**  Each probe renders a hemisphere of hemi x hemi pixels
  (theta over the rows, phi over the columns, both over [0, pi], around
  the probe's look-at frame) with one jittered path a pixel: depth 3,
  next-event estimation of one light a vertex weighted against the BSDF
  sample by the power heuristic, no emission on the primary segment, and
  the primary hit's distance (-1 on a miss) and geometric normal in the
  probe's camera space (``probe_gbuffer``).
- **IISPTNet.**  The G-buffer goes through the network-input transforms
  (``network_input``), the U-Net's eval forward (``unet``) and the
  inverse transform (``network_output``); a probe that found no surface
  gets a zero map.
- **Hemisphere MIS.**  Each pixel of the task is chased to its first
  non-specular hit and estimated over the maps of its four neighbouring
  probes: 16 attempts a neighbour, each taken with the neighbour's weight
  (``neighbour_weights``), each adding the map-sampled and the
  BSDF-sampled strategy with LIGHT_PDF 1/6.28, BSDF_RATIO 0.4394,
  EM_RATIO 1.098 and the sin(theta) Jacobian of the map; the taken
  attempts are averaged (``hemisphere_mis``).  A pixel's indirect light is
  the mean of its valid estimates over the tasks.
- **Direct light.**  Passes of one jittered path a pixel that take one
  light sample of every light at the first non-specular vertex, follow
  specular bounces, and let the BSDF-sampled continuation collect the
  emission it hits, MIS-weighted (``direct_passes``); the frame is their
  mean plus the indirect image.

Each piece is a function of its inputs and of uniforms passed in (an
explicit tensor, or ``draw(*shape)`` where the number drawn depends on
the paths' fates), so that tests can feed both sides the same draws.

Departures from the C++ reference:

- the scene subset, the BVH and the camera are ``pbrt_path``'s; ray
  origins move off a surface along the geometric normal by 1e-4 x
  max(1, |p|_inf) instead of pbrt-v3's error bounds, and a distant
  light's shadow ray is 2 world radii long;
- random numbers are independent uniforms, not the scene's sampler;
- the schedule is a precomputed list and a frame takes its first tasks,
  not a work queue shared by threads;
- a task's pixels go through the MIS in chunks of whole pixels, not one
  pixel at a time;
- the probe's light selection follows the program's probe estimator, since
  IISPTNet is not linear in its noisy input and G-buffers with another
  noise give another expected image: lights are chosen by power (a
  distant or infinite light pi r^2 L, r half the diagonal of the
  triangles' bounds; the area lights pi L area, their triangles one light
  chosen by area), where pbrt-v3's default is the spatial distribution;
- likewise the BSDF's lobe is chosen by the luminance of its
  coefficients (diffuse Kd, glossy Ks, a metal's glossy lobe 1), the
  glossy lobe samples the full Trowbridge-Reitz distribution, and the
  BSDF's pdf is the weighted sum of the lobes' (pbrt-v3 picks a matching
  component uniformly and samples the visible normals);
- no Russian roulette: probe paths end at depth 3 before it starts, and
  elsewhere it changes the noise, not the expectation;
- the shading frame is Duff et al.'s branchless orthonormal basis about
  the shading normal turned to the geometric normal's side, with the
  tests of same-hemisphere in that frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import pbrt_path as pp

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NUMBER_TILES = 10
RADIUS_START = 100.0
RADIUS_DECAY = math.sqrt(0.79541357)
MAX_CHASE = 24
PROBE_DEPTH = 3
HEMI_SAMPLES = 16
LIGHT_PDF = 1.0 / 6.28
BSDF_RATIO = 0.4394
EM_RATIO = 1.098
OFFSET_EPS = 1e-4
LUM = (0.212671, 0.715160, 0.072169)
INV_4PI = 1.0 / (4.0 * math.pi)
PIXEL_CHUNK = 32768         # pixels a block of the hemisphere MIS
BN_EPS = 1e-5
LEAKY = 0.2


# ---------------------------------------------------------------------------
# small vector helpers (any leading shape)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _lum(rgb):
    w = torch.tensor(LUM, dtype=rgb.dtype, device=rgb.device)
    return (rgb * w).sum(-1)


def _face_forward(n, v):
    return torch.where((_dot(n, v) < 0)[..., None], -n, n)


def _frame(n):
    """Duff et al.'s orthonormal basis (t, b) about unit n."""
    nz = n[..., 2]
    sign = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def _to_local(v, t, b, n):
    return torch.stack([_dot(v, t), _dot(v, b), _dot(v, n)], -1)


def _to_world(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def _offset(p, n, d):
    """p moved off its surface along n, to d's side."""
    scale = torch.clamp(p.abs().amax(-1), min=1.0)
    off = (OFFSET_EPS * scale)[..., None] * n
    return torch.where((_dot(d, n) < 0)[..., None], p - off, p + off)


def _power_heuristic(f, g):
    den = f * f + g * g
    return torch.where(den > 0, f * f / torch.where(den > 0, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def _fr_dielectric(cos_i, eta_i, eta_t):
    """pbrt-v3 FrDielectric, any shape."""
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(torch.clamp(cos_i, -1.0, 1.0))
    sin_i = torch.sqrt(torch.clamp(1 - ci * ci, min=0))
    sin_t = ei / et * sin_i
    ct = torch.sqrt(torch.clamp(1 - sin_t * sin_t, min=0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-9)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-9)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin_t >= 1, torch.ones_like(fr), fr)


def _fr_conductor(cos_i, eta, k):
    """pbrt-v3 FrConductor with eta_i = 1: cos_i (...), eta, k (..., 3)."""
    c = torch.clamp(torch.abs(cos_i), 0, 1)[..., None]
    c2 = c * c
    s2 = 1 - c2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4 * e2 * k2, min=0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0))
    t2 = 2 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-9)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-9)
    return 0.5 * (rp + rs)


def _tr_d(wh, alpha):
    c2 = torch.clamp(wh[..., 2] * wh[..., 2], 0, 1)
    s2 = torch.clamp(1 - c2, min=0)
    a2 = alpha * alpha
    e = c2 + s2 / torch.clamp(a2, min=1e-9)
    d = 1 / (math.pi * a2 * torch.clamp(e * e, min=1e-12))
    return torch.where(c2 > 0, d, torch.zeros_like(d))


def _tr_lambda(w, alpha):
    c2 = torch.clamp(w[..., 2] * w[..., 2], 0, 1)
    tan2 = torch.clamp(1 - c2, min=0) / torch.clamp(c2, min=1e-9)
    lam = 0.5 * (-1 + torch.sqrt(torch.clamp(1 + alpha * alpha * tan2, min=0)))
    return torch.where(c2 > 1e-9, lam, torch.full_like(lam, 1e9))


def _concentric_disk(u):
    o = 2 * u - 1
    ux, uy = o[..., 0], o[..., 1]
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    one = torch.ones_like(ux)
    th = torch.where(use_x, (math.pi / 4) * (uy / torch.where(ux == 0, one, ux)),
                     math.pi / 2 - (math.pi / 4) * (ux / torch.where(uy == 0, one, uy)))
    pt = r[..., None] * torch.stack([torch.cos(th), torch.sin(th)], -1)
    return torch.where(((ux == 0) & (uy == 0))[..., None], torch.zeros_like(pt), pt)


def _cosine_hemisphere(u):
    dd = _concentric_disk(u)
    z = torch.sqrt(torch.clamp(1 - dd[..., 0] ** 2 - dd[..., 1] ** 2, min=0))
    return torch.cat([dd, z[..., None]], -1)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def schedule(width: int, height: int, n_tasks: int, radius: float = RADIUS_START,
             decay: float = RADIUS_DECAY):
    """The first n_tasks tasks of the progressive sweep -> [(x0, y0,
    tile size)]."""
    out, x, y = [], 0, 0
    for _ in range(n_tasks):
        ts = max(1, int(math.floor(radius)))
        size = ts * NUMBER_TILES
        out.append((x, y, ts))
        x += size
        if x >= width:
            x, y = 0, y + size
        if y >= height:
            y = 0
            radius *= decay
    return out


def probe_pixels(x0, y0, ts, width, height, device=None):
    """(NUMBER_TILES + 1)^2 probe pixels (x, y) of a task, x fastest:
    multiples of the tile size, clamped to the task's and the image's
    last pixel."""
    g = NUMBER_TILES + 1
    i = torch.arange(g, device=device)
    xs = torch.clamp(x0 + i * ts, max=min(x0 + NUMBER_TILES * ts, width) - 1)
    ys = torch.clamp(y0 + i * ts, max=min(y0 + NUMBER_TILES * ts, height) - 1)
    return torch.stack([xs[None, :].expand(g, g), ys[:, None].expand(g, g)],
                       -1).reshape(-1, 2)


# ---------------------------------------------------------------------------
# IISPTNet: the transforms and the U-Net
# ---------------------------------------------------------------------------

def load_weights(path: str) -> dict:
    """The committed npz (float16, flax's names, HWIO kernels) -> {name:
    float32 numpy array}."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def _positive_log(x):
    return torch.log(torch.clamp(x + 1, min=1))


def _safe_div(x, d):
    pos = d > 0
    return torch.where(pos, x / torch.where(pos, d, torch.ones_like(d)), x)


def network_input(intensity, normals, distance):
    """G-buffer (P, H, W, 3 / 3 / 1) -> (x (P, H, W, 7), channel means (P,
    3)): the intensity over 10 x its mean, then log(1 + .) - 0.1; the
    normals clamped to [-1, 1]; the distance plus 1 over 10 x (its mean +
    1), then log(1 + .) - 0.1."""
    chan = intensity.mean(dim=(-3, -2))
    mean = intensity.mean(dim=(-3, -2, -1))[..., None, None, None]
    x_i = _positive_log(_safe_div(intensity, 10 * mean)) - 0.1
    zm = distance.mean(dim=(-3, -2, -1))[..., None, None, None]
    dz = 10 * (zm + 1)
    dz = torch.where(dz == 0, torch.ones_like(dz), dz)
    x_d = _positive_log((distance + 1) / dz) - 0.1
    return torch.cat([x_i, torch.clamp(normals, -1, 1), x_d], -1), chan


def network_output(y, chan):
    """The net's output -> radiance: exp(max(y, 0)) - 1, each channel scaled
    to the probe's channel mean (zero where the output's mean is 0)."""
    lin = torch.exp(torch.clamp(y, min=0)) - 1
    actual = lin.mean(dim=(-3, -2))
    mul = torch.where(actual > 1e-10, chan / torch.clamp(actual, min=1e-10),
                      torch.zeros_like(actual))
    return lin * mul[..., None, None, :]


def unet(x, w: dict):
    """IISPTNet's eval forward: x (P, H, W, 7) -> (P, H, W, 3); w the npz's
    arrays as tensors on x's device and dtype.  Encoders of K, 2K, 4K, 8K
    channels of 3x3 convolutions with LeakyReLU(0.2), each deeper level
    after a 2x2 max-pool and with eval BatchNorm after its first
    activation; the decoder upsamples bilinearly by 2, concatenates the
    skip, and runs two 3x3 convolutions (the first with BatchNorm) except
    at the top level; a 1x1 convolution and a ReLU make the output."""
    def conv(v, name):
        k = w[f"params/{name}/kernel"].permute(3, 2, 0, 1)
        return F.conv2d(v, k, w[f"params/{name}/bias"], padding=k.shape[-1] // 2)

    def bn(v, i):
        mean = w[f"batch_stats/BatchNorm_{i}/mean"]
        var = w[f"batch_stats/BatchNorm_{i}/var"]
        scale = w[f"params/BatchNorm_{i}/scale"] / torch.sqrt(var + BN_EPS)
        shift = w[f"params/BatchNorm_{i}/bias"] - mean * scale
        return v * scale[:, None, None] + shift[:, None, None]

    act = lambda v: F.leaky_relu(v, LEAKY)
    pool = lambda v: F.max_pool2d(v, 2, 2)
    up = lambda v: F.interpolate(v, scale_factor=2, mode="bilinear", align_corners=False)
    c = lambda i: f"Conv_{i}"
    t = lambda i: f"ConvTranspose_{i}"
    v = x.permute(0, 3, 1, 2)
    x0 = act(conv(act(conv(v, c(0))), c(1)))
    x1 = act(conv(bn(act(conv(pool(x0), c(2))), 0), c(3)))
    x2 = act(conv(bn(act(conv(pool(x1), c(4))), 1), c(5)))
    x3 = up(act(conv(bn(act(conv(pool(x2), c(6))), 2), c(7))))
    x4 = up(act(conv(bn(act(conv(torch.cat([x3, x2], 1), t(0))), 3), t(1))))
    x5 = up(act(conv(bn(act(conv(torch.cat([x4, x1], 1), t(2))), 4), t(3))))
    x6 = act(conv(act(conv(torch.cat([x5, x0], 1), t(4))), t(5)))
    return F.relu(conv(x6, c(8))).permute(0, 2, 3, 1)


def radiance_maps(intensity, normals, distance, valid, weights):
    """A probe's G-buffer -> its radiance map through IISPTNet (zero where
    ``valid`` is false); weights: name -> tensor on the inputs' device and
    dtype."""
    with torch.no_grad():
        x, chan = network_input(intensity, normals, distance)
        R = network_output(unet(x, weights), chan)
    return torch.where(valid[:, None, None, None], R, torch.zeros_like(R))


# ---------------------------------------------------------------------------
# materials in the probe estimator's law
# ---------------------------------------------------------------------------

class Mat:
    """Per-element material parameters (any leading shape): kind (one of
    pbrt_path's MATTE .. GLASS), kd, ks, metal eta and k (..., 3), alpha
    (the remapped roughness) and eta (...)."""

    def __init__(self, kind, kd, ks, alpha, eta, meta, mk):
        self.kind, self.kd, self.ks = kind, kd, ks
        self.alpha, self.eta, self.meta, self.mk = alpha, eta, meta, mk

    def expand(self, shape):
        """Each field, of leading size shape[0], broadcast to leading shape
        ``shape`` (views)."""
        def e(v):
            lead = v.shape[:1] + (1,) * (len(shape) - 1)
            return v.reshape(lead + v.shape[1:]).expand(*shape, *v.shape[1:])
        return Mat(*(e(v) for v in (self.kind, self.kd, self.ks, self.alpha, self.eta,
                                    self.meta, self.mk)))

    def weights(self):
        """Lobe selection weights (diffuse, glossy, specular reflection,
        specular transmission), by luminance, normalised."""
        k = self.kind
        lum = lambda v: _lum(torch.clamp(v, min=0))
        zero = torch.zeros_like(self.eta)
        diffuse = (k == pp.MATTE) | (k == pp.PLASTIC) | (k == pp.UBER)
        w_d = torch.where(diffuse, lum(self.kd), zero)
        w_g = torch.where((k == pp.PLASTIC) | (k == pp.UBER), lum(self.ks), zero)
        w_g = torch.where(k == pp.METAL, torch.ones_like(zero), w_g)
        glass = (k == pp.GLASS).to(zero.dtype)
        w = torch.stack([w_d, w_g, glass, glass], -1)
        tot = w.sum(-1, keepdim=True)
        return torch.where(tot > 0, w / torch.clamp(tot, min=1e-12), torch.zeros_like(w))

    def black(self):
        lum = lambda v: _lum(torch.clamp(v, min=0))
        return ((self.kind == pp.MATTE) & (lum(self.kd) <= 0)) | (
            ((self.kind == pp.PLASTIC) | (self.kind == pp.UBER))
            & (lum(self.kd) + lum(self.ks) <= 0))


def bsdf_eval(m: Mat, wo, wi):
    """(f (..., 3), pdf (...)) of the non-specular lobes, in the local
    shading frame."""
    w = m.weights()
    refl = wo[..., 2] * wi[..., 2] > 0
    cos_o, cos_i = torch.abs(wo[..., 2]), torch.abs(wi[..., 2])
    f_d = m.kd / math.pi
    pdf_d = cos_i / math.pi
    wh = wo + wi
    wl = torch.linalg.vector_norm(wh, dim=-1)
    wh = torch.where((wl > 1e-9)[..., None], wh / torch.clamp(wl, min=1e-9)[..., None],
                     torch.zeros_like(wh))
    d = _tr_d(wh, m.alpha)
    g = 1 / (1 + _tr_lambda(wo, m.alpha) + _tr_lambda(wi, m.alpha))
    one = torch.ones_like(m.eta)
    cos_h = _dot(wi, wh)
    fr = torch.where((m.kind == pp.PLASTIC)[..., None],
                     _fr_dielectric(cos_h, m.eta, one)[..., None],
                     _fr_dielectric(cos_h, one, m.eta)[..., None])
    metal = m.kind == pp.METAL
    fr = torch.where(metal[..., None], _fr_conductor(cos_h, m.meta, m.mk), fr)
    spec = torch.where(metal[..., None], torch.ones_like(m.ks), m.ks)
    f_g = spec * (d * g / (4 * torch.clamp(cos_i * cos_o, min=1e-7)))[..., None] * fr
    pdf_g = d * torch.abs(wh[..., 2]) / (4 * torch.clamp(torch.abs(_dot(wo, wh)), min=1e-7))
    pdf_g = torch.where(wl > 1e-9, pdf_g, torch.zeros_like(pdf_g))
    ok_d = refl & (w[..., 0] > 0)
    ok_g = refl & (w[..., 1] > 0) & (d > 0)
    z3, z = torch.zeros_like(f_d), torch.zeros_like(pdf_d)
    f = torch.where(ok_d[..., None], f_d, z3) + torch.where(ok_g[..., None], f_g, z3)
    pdf = torch.where(ok_d, w[..., 0] * pdf_d, z) + torch.where(ok_g, w[..., 1] * pdf_g, z)
    return f, pdf


def bsdf_sample(m: Mat, wo, u_lobe, u2):
    """A direction from the BSDF -> (wi, f, pdf, specular, valid): the
    lobe by its weight; the diffuse lobe's cosine hemisphere and the
    glossy lobe's reflection about a Trowbridge-Reitz normal on wo's side;
    smooth glass reflects with the Fresnel probability and refracts
    otherwise."""
    w = m.weights()
    cdf = torch.cumsum(w, -1)
    lobe = torch.clamp((u_lobe[..., None] > cdf).sum(-1), max=3)
    cos_o = wo[..., 2]
    sign = torch.where(cos_o >= 0, 1.0, -1.0).to(wo.dtype)
    wi_d = _cosine_hemisphere(u2)
    wi_d = torch.cat([wi_d[..., :2], wi_d[..., 2:] * sign[..., None]], -1)
    tan2 = m.alpha * m.alpha * u2[..., 0] / torch.clamp(1 - u2[..., 0], min=1e-9)
    ct = 1 / torch.sqrt(1 + tan2)
    st = torch.sqrt(torch.clamp(1 - ct * ct, min=0))
    ph = 2 * math.pi * u2[..., 1]
    wh = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], -1)
    wh = torch.where((cos_o * wh[..., 2] < 0)[..., None], -wh, wh)
    wi_g = -wo + 2 * _dot(wo, wh)[..., None] * wh
    # smooth glass
    one = torch.ones_like(m.eta)
    fr = _fr_dielectric(cos_o, one, m.eta)
    glass = m.kind == pp.GLASS
    refl_g = u_lobe < fr
    entering = cos_o > 0
    e = torch.where(entering, one / m.eta, m.eta)       # eta_i / eta_t
    ci = torch.abs(cos_o)
    sin2_t = e * e * torch.clamp(1 - ci * ci, min=0)
    ct_t = torch.sqrt(torch.clamp(1 - sin2_t, min=0))
    nz = torch.stack([torch.zeros_like(sign), torch.zeros_like(sign), sign], -1)
    wi_t = -e[..., None] * wo + (e * ci - ct_t)[..., None] * nz
    wi_r = torch.cat([-wo[..., :2], wo[..., 2:]], -1)
    wi = torch.where((lobe == 0)[..., None], wi_d, wi_g)
    wi = torch.where(glass[..., None], torch.where(refl_g[..., None], wi_r, wi_t), wi)
    f, pdf = bsdf_eval(m, wo, wi)
    cos_i = torch.clamp(torch.abs(wi[..., 2]), min=1e-7)
    f_r = (fr / cos_i)[..., None].expand_as(f)
    f_t = ((1 - fr) * e * e / cos_i)[..., None].expand_as(f)
    f = torch.where(glass[..., None], torch.where(refl_g[..., None], f_r, f_t), f)
    pdf = torch.where(glass, torch.where(refl_g, fr, 1 - fr), pdf)
    valid = (pdf > 0) & (cos_o != 0)
    valid = valid & torch.where(glass, refl_g | (sin2_t < 1),
                                (lobe <= 1) & (cos_o * wi[..., 2] > 0))
    return wi, f, pdf, glass, valid


# ---------------------------------------------------------------------------
# the scene: pbrt_path's, with the probe estimator's light selection
# ---------------------------------------------------------------------------

class Scene(pp.Tracer):
    """The scene on ``device`` in ``dtype``: pbrt_path's geometry, camera,
    materials and lights, the lights also as slots chosen by power."""

    def __init__(self, sd: pp.SceneData, device, dtype=torch.float32):
        super().__init__(sd, device, dtype)
        verts = sd.tris.reshape(-1, 3)
        self.world_radius = max(0.5 * float(np.linalg.norm(verts.max(0) - verts.min(0))),
                                1e-3)
        lum = lambda L: float(np.dot(np.asarray(L, np.float64), LUM))
        r2 = math.pi * self.world_radius ** 2
        power = [r2 * lum(L) for _, L in sd.distant]
        if sd.infinite:
            power.append(r2 * lum(np.sum(sd.infinite, 0)))
        lit = np.nonzero(sd.emit.max(1) > 0)[0]
        if len(lit):
            ar = 0.5 * np.linalg.norm(np.cross(sd.tris[lit, 1] - sd.tris[lit, 0],
                                               sd.tris[lit, 2] - sd.tris[lit, 0]), axis=1)
            power.append(math.pi * float(sum(lum(e) * a for e, a in zip(sd.emit[lit], ar))))
        power = np.asarray(power, np.float64)
        sel = (power / power.sum() if power.sum() > 0 and len(power)
               else np.full(len(power), 1.0 / max(len(power), 1)))
        self.sel_pdf = [float(s) for s in sel]
        self.sel_cdf = torch.as_tensor(np.cumsum(sel), device=self.dev).to(dtype)
        self.m_lut = (self.m_kind, self.m_kd, self.m_ks, self.m_alpha, self.m_eta,
                      self.m_meta, self.m_mk)

    # -- geometry ----------------------------------------------------------

    def material(self, mat) -> Mat:
        m = mat.long()
        return Mat(*(x[m] for x in self.m_lut))

    def surface(self, tri, b1, b2):
        """-> (p, raw geometric normal, shading normal, material row)."""
        e1, e2 = self.e1[tri], self.e2[tri]
        p = self.p0[tri] + b1[:, None] * e1 + b2[:, None] * e2
        ng = pp._normalize(pp._cross(e1, e2))
        nv = self.nrm[tri]
        ns = pp._normalize((1 - b1 - b2)[:, None] * nv[:, 0] + b1[:, None] * nv[:, 1]
                           + b2[:, None] * nv[:, 2])
        ns = torch.where(self.has_n[tri][:, None], ns, ng)
        return p, ng, ns, self.mat[tri]

    def raster_rays(self, xy):
        """Camera rays through raster positions xy (N, 2)."""
        W, H = self.sd.width, self.sd.height
        sx, sy = self.screen
        px = (-sx + xy[:, 0] / W * (2 * sx)) * self.tan_half
        py = (sy - xy[:, 1] / H * (2 * sy)) * self.tan_half
        dc = pp._normalize(torch.stack([px, py, torch.ones_like(px)], -1))
        d = pp._normalize(dc @ self.c2w[:3, :3].T)
        return self.c2w[:3, 3].expand_as(d).clone(), d

    # -- lights --------------------------------------------------------------

    def _slots(self):
        """[(kind, index)] in selection order: distant lights, the
        infinite light, the area lights."""
        out = [("distant", i) for i in range(len(self.sun))]
        if self.sky is not None:
            out.append(("infinite", 0))
        if self.area_total > 0:
            out.append(("area", 0))
        return out

    def _slot_pdf(self, kind, nee_all):
        if nee_all:
            return 1.0
        for (k, _), s in zip(self._slots(), self.sel_pdf):
            if k == kind:
                return s
        return 0.0

    def sample_light(self, kind, idx, p, u3):
        """One light sample from p -> (wi, li, pdf, dist, delta)."""
        n = p.shape[0]
        dev, dt = self.dev, self.dt
        if kind == "distant":
            w, L = self.sun[idx]
            return (w.expand(n, 3), L.expand(n, 3), torch.ones(n, dtype=dt, device=dev),
                    torch.full((n,), 2 * self.world_radius, dtype=dt, device=dev), True)
        if kind == "infinite":
            z = 1 - 2 * u3[:, 1]
            r = torch.sqrt(torch.clamp(1 - z * z, min=0))
            ph = 2 * math.pi * u3[:, 2]
            wi = torch.stack([r * torch.cos(ph), r * torch.sin(ph), z], -1)
            return (wi, self.sky.expand(n, 3), torch.full((n,), INV_4PI, dtype=dt, device=dev),
                    torch.full((n,), 2 * self.world_radius, dtype=dt, device=dev), False)
        j = torch.clamp(torch.searchsorted(self.area_cdf, u3[:, 0].contiguous(), right=True),
                        max=self.area_tri.numel() - 1)
        at = self.area_tri[j]
        su = torch.sqrt(u3[:, 1])
        q = (self.p0[at] + (1 - su)[:, None] * self.e1[at]
             + (u3[:, 2] * su)[:, None] * self.e2[at])
        v = q - p
        dist = torch.linalg.vector_norm(v, dim=-1)
        wi = v / torch.clamp(dist, min=1e-30)[:, None]
        nl = pp._normalize(pp._cross(self.e1[at], self.e2[at]))
        cq = _dot(nl, -wi)
        li = torch.where((cq > 0)[:, None], self.emit[at], torch.zeros_like(self.emit[at]))
        pdf = dist * dist / torch.clamp(torch.abs(cq) * self.area_total, min=1e-12)
        pdf = torch.where(torch.abs(cq) > 1e-7, pdf, torch.zeros_like(pdf))
        return wi, li, pdf, dist, False

    # -- the path estimators ---------------------------------------------------

    def trace(self, o, d, draw, depth, probe=False, direct_only=False):
        """Radiance (N, 3) of one path a ray, and with ``probe`` the primary
        hit's distance (N,) (-1 on a miss) and raw geometric normal (N, 3).

        probe: next-event estimation of one light chosen by power, no
        emission on the primary segment.  direct_only: one sample of every
        light at the first non-specular vertex; after it, the BSDF's
        continuation lives one more segment to collect the emission it
        hits, MIS-weighted; specular bounces continue.  draw(*shape)
        gives the uniforms."""
        dev, dt = self.dev, self.dt
        N = o.shape[0]
        L = torch.zeros((N, 3), dtype=dt, device=dev)
        aux_t = torch.full((N,), -1.0, dtype=dt, device=dev)
        aux_n = torch.zeros((N, 3), dtype=dt, device=dev)
        lane = torch.arange(N, device=dev)
        beta = torch.ones((N, 3), dtype=dt, device=dev)
        spec = torch.zeros(N, dtype=torch.bool, device=dev)
        ghost = torch.zeros(N, dtype=torch.bool, device=dev)
        prev_pdf = torch.ones(N, dtype=dt, device=dev)
        nee_all = direct_only
        sel_inf = self._slot_pdf("infinite", nee_all)
        sel_area = self._slot_pdf("area", nee_all)
        slots = self._slots()
        for bounce in range(depth + 1):
            n = lane.shape[0]
            if n == 0:
                break
            t, tri, b1, b2 = self.intersect(o, d, torch.full((n,), 1e30, dtype=dt, device=dev))
            hit = tri >= 0
            skip = probe and bounce == 0

            def mis(light_pdf):
                if bounce == 0:
                    return torch.ones_like(prev_pdf)
                return torch.where(spec, torch.ones_like(prev_pdf),
                                   _power_heuristic(prev_pdf, light_pdf))

            if self.sky is not None and not skip:
                w = mis(torch.full_like(prev_pdf, INV_4PI * sel_inf))
                L.index_add_(0, lane, torch.where((~hit)[:, None], beta * self.sky * w[:, None],
                                                  torch.zeros_like(beta)))
            trs = torch.clamp(tri, min=0)
            p, ng, ns, m_id = self.surface(trs, b1, b2)
            if probe and bounce == 0:
                aux_t[lane] = torch.where(hit, t, torch.full_like(t, -1.0))
                aux_n[lane] = torch.where(hit[:, None], ng, torch.zeros_like(ng))
            if self.area_total > 0 and not skip:
                cos_l = _dot(ng, -d)
                le = torch.where((hit & (cos_l > 0))[:, None], self.emit[trs],
                                 torch.zeros_like(beta))
                pdf_l = t * t / torch.clamp(torch.abs(cos_l) * self.area_total, min=1e-12)
                L.index_add_(0, lane, beta * le * mis(pdf_l * sel_area)[:, None])
            mat = self.material(m_id)
            alive = hit & (bounce < depth) & ~mat.black()
            if direct_only:
                alive = alive & ~ghost
            ns = _face_forward(ns, ng)
            ng_f = _face_forward(ng, -d)
            tf, bf = _frame(ns)
            wo = _to_local(-d, tf, bf, ns)
            w_lobe = mat.weights()
            smooth = (w_lobe[:, 0] + w_lobe[:, 1]) > 0
            # next-event estimation
            if nee_all:
                picks = [(k, i, torch.ones(n, dtype=torch.bool, device=dev), 1.0)
                         for k, i in slots]
                u_all = draw(n, len(slots), 3)
                us = [u_all[:, j] for j in range(len(slots))]
            else:
                u_sel = draw(n)
                u3 = draw(n, 3)
                s = torch.clamp(torch.searchsorted(self.sel_cdf, u_sel.contiguous()),
                                max=len(slots) - 1)
                picks = [(k, i, s == j, self.sel_pdf[j]) for j, (k, i) in enumerate(slots)]
                us = [u3] * len(slots)
            for (kind, idx, chosen, sel), u in zip(picks, us):
                wi, li, pdf, dist, delta = self.sample_light(kind, idx, p, u)
                can = alive & smooth & chosen & (pdf > 0) & (_lum(li) > 0)
                if not bool(can.any()):
                    continue
                wi_l = _to_local(wi, tf, bf, ns)
                f, pdf_b = bsdf_eval(mat, wo, wi_l)
                w = (torch.ones_like(pdf) if delta
                     else _power_heuristic(pdf * sel, pdf_b))
                c = beta * f * li * (torch.abs(_dot(wi, ns)) * w
                                     / torch.clamp(pdf * sel, min=1e-12))[:, None]
                k = can.nonzero()[:, 0]
                o_sh = _offset(p[k], ng_f[k], wi[k])
                tmax = (dist[k] - _dot(o_sh - p[k], wi[k])) * 0.999
                blocked = self.occluded(o_sh, wi[k], tmax)
                L.index_add_(0, lane[k], torch.where(blocked[:, None], torch.zeros_like(c[k]),
                                                     c[k]))
            # continuation
            u_lobe = draw(n)
            u2 = draw(n, 2)
            wi_l, f, pdf, is_spec, ok = bsdf_sample(mat, wo, u_lobe, u2)
            wi = _to_world(wi_l, tf, bf, ns)
            nb = beta * f * (torch.abs(_dot(wi, ns)) / torch.clamp(pdf, min=1e-12))[:, None]
            ok = ok & alive & (_lum(torch.abs(nb)) > 0) & torch.isfinite(_lum(nb))
            if direct_only:
                ghost = ok & ~is_spec
            keep = ok.nonzero()[:, 0]
            o = _offset(p[keep], ng_f[keep], wi[keep])
            d = wi[keep]
            lane, beta = lane[keep], nb[keep]
            spec, ghost = is_spec[keep], ghost[keep]
            prev_pdf = torch.where(spec, torch.ones_like(pdf[keep]), pdf[keep])
        L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
        return L, aux_t, aux_n

    def chase(self, o, d, draw):
        """Each ray through smooth glass, at most MAX_CHASE bounces, to its
        first non-specular hit -> dict(found, p, n (the geometric normal
        turned towards the ray), wo, mat, beta (the chain's throughput))."""
        dev, dt = self.dev, self.dt
        N = o.shape[0]
        out = dict(found=torch.zeros(N, dtype=torch.bool, device=dev),
                   p=torch.zeros((N, 3), dtype=dt, device=dev),
                   n=torch.zeros((N, 3), dtype=dt, device=dev),
                   wo=torch.zeros((N, 3), dtype=dt, device=dev),
                   mat=torch.zeros(N, dtype=torch.int64, device=dev),
                   beta=torch.ones((N, 3), dtype=dt, device=dev))
        lane = torch.arange(N, device=dev)
        beta = out["beta"].clone()
        for _ in range(MAX_CHASE):
            n = lane.shape[0]
            if n == 0:
                break
            t, tri, b1, b2 = self.intersect(o, d, torch.full((n,), 1e30, dtype=dt, device=dev))
            hit = tri >= 0
            p, ng, ns, m_id = self.surface(torch.clamp(tri, min=0), b1, b2)
            glass = self.m_kind[m_id] == pp.GLASS
            stop = (hit & ~glass).nonzero()[:, 0]
            ls = lane[stop]
            out["found"][ls] = True
            out["p"][ls] = p[stop]
            out["n"][ls] = _face_forward(ng[stop], -d[stop])
            out["wo"][ls] = -d[stop]
            out["mat"][ls] = m_id[stop]
            out["beta"][ls] = beta[stop]
            go = (hit & glass).nonzero()[:, 0]
            u_lobe, u2 = draw(go.numel()), draw(go.numel(), 2)
            if go.numel() == 0:
                break
            lane, beta, p, ng, ns, d = lane[go], beta[go], p[go], ng[go], ns[go], d[go]
            ns = _face_forward(ns, ng)
            tf, bf = _frame(ns)
            mat = self.material(m_id[go])
            wi_l, f, pdf, _, ok = bsdf_sample(mat, _to_local(-d, tf, bf, ns), u_lobe, u2)
            wi = _to_world(wi_l, tf, bf, ns)
            beta = beta * f * (torch.abs(_dot(wi, ns)) / torch.clamp(pdf, min=1e-12))[:, None]
            keep = ok.nonzero()[:, 0]
            lane, beta = lane[keep], beta[keep]
            o = _offset(p[keep], _face_forward(ng[keep], -d[keep]), wi[keep])
            d = wi[keep]
        return out


# ---------------------------------------------------------------------------
# probes and the hemisphere MIS
# ---------------------------------------------------------------------------

def hemi_frames(normal):
    """Probe look-at frames -> (right, up, look): look the normal, the up
    hint +z (+y where the normal is the z axis)."""
    look = pp._normalize(normal)
    pole = (torch.abs(look[..., 0]) < 1e-9) & (torch.abs(look[..., 1]) < 1e-9)
    y = torch.tensor([0.0, 1.0, 0.0], dtype=look.dtype, device=look.device)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=look.dtype, device=look.device)
    hint = torch.where(pole[..., None], y, z).expand(look.shape)
    right = pp._normalize(pp._cross(hint, look))
    return right, pp._cross(look, right), look


def pixel_direction(x, y, right, up, look, hemi: int):
    """Probe map position (column x, row y; may be fractional) -> world
    direction: theta = pi y / hemi, phi = pi x / hemi."""
    th = math.pi * y / hemi
    ph = math.pi * x / hemi
    st = torch.sin(th)
    return ((st * torch.cos(ph))[..., None] * right + torch.cos(th)[..., None] * up
            + (st * torch.sin(ph))[..., None] * look)


def probe_gbuffer(sc: Scene, pos, normal, hemi: int, draw):
    """Probes at pos with normals (P, 3) -> dict(intensity, normals,
    distance, right, up, look, origin): one jittered path a map pixel,
    depth 3."""
    P = pos.shape[0]
    right, up, look = hemi_frames(normal)
    jit = draw(P, hemi, hemi, 2)
    idx = torch.arange(hemi, dtype=sc.dt, device=sc.dev)
    f = lambda v: v[:, None, None, :]
    d = pixel_direction(idx[None, None, :] + jit[..., 0], idx[None, :, None] + jit[..., 1],
                        f(right), f(up), f(look), hemi).reshape(-1, 3)
    nn = normal.repeat_interleave(hemi * hemi, 0)
    o = _offset(pos.repeat_interleave(hemi * hemi, 0), nn, d)
    L, t, ng = sc.trace(o, d, draw, PROBE_DEPTH, probe=True)
    ng = ng.reshape(P, hemi, hemi, 3)
    n_cam = torch.stack([_dot(ng, f(right)), _dot(ng, f(up)), _dot(ng, f(look))], -1)
    return dict(intensity=L.reshape(P, hemi, hemi, 3), normals=n_cam,
                distance=t.reshape(P, hemi, hemi, 1), right=right, up=up, look=look,
                origin=pos)


def neighbour_weights(fx, fy, n_px, cam_o, ff_p, ff_n, look_n, origin_n, valid_n, ts):
    """Each pixel's selection probabilities of its 4 neighbouring probes
    (Np, 4): by pixel distance over the tile size, the normals' agreement
    and the relative difference of the camera distances to the pixel's
    surface and to the probe."""
    fpix = torch.stack([fx, fy], -1).to(n_px.dtype)[:, None, :]
    wdpos = torch.clamp(torch.sqrt(((fpix - n_px) ** 2).sum(-1)) / float(ts), 0, 1)
    ndot = _dot(ff_n[:, None, :], look_n)
    zero = torch.zeros_like(ndot)
    wdnor = torch.where(valid_n, torch.where(ndot < 0, torch.ones_like(ndot), 1 - ndot), zero)
    d_isect = torch.linalg.vector_norm(ff_p - cam_o, dim=-1)
    d_probe = torch.linalg.vector_norm(origin_n - cam_o, dim=-1)
    rel = torch.abs(d_isect[:, None] - d_probe) / torch.clamp(d_isect[:, None], min=1e-10)
    wdd = torch.where(valid_n & (d_isect[:, None] >= 1e-10), torch.clamp(1 - rel, 0, 1), zero)
    raw = torch.clamp(2 - (wdpos * wdnor + wdpos * wdd + wdpos), min=0) + 0.001
    return raw / torch.clamp(raw.sum(-1, keepdim=True), min=1e-12)


def _map_lookup(R, probe, x, y, hemi):
    """R[probe, y, x] times the map's sin(theta) Jacobian."""
    th = math.pi * (y.to(R.dtype) + 0.5) / hemi
    return R[probe, y, x] * torch.sin(th)[..., None]


def hemisphere_mis(R, mat: Mat, ff_n, ff_wo, ff_beta, valid_px, w_prob, n_ids,
                   right, up, look, hemi: int, u_sel, u_xy, u_bs, u_bl):
    """The estimate of Np pixels over their 4 neighbours' maps R (P, hemi,
    hemi, 3) -> (rgb (Np, 3), valid (Np,)).  Slots (Np, 4, 16): an attempt
    at neighbour j is taken where u_sel < w_prob[:, j]; it adds EM_RATIO f
    Li cos w1 / LIGHT_PDF for the map pixel u_xy picks and BSDF_RATIO f Li
    cos w2 / pdf for the BSDF direction (u_bl, u_bs) looked up in the map,
    w1 and w2 the power heuristic between LIGHT_PDF and the BSDF's pdf.
    The shading frame is the geometric normal's."""
    Np = ff_n.shape[0]
    S = HEMI_SAMPLES
    slots = (Np, 4, S)
    tf, bf = _frame(ff_n)
    frame = lambda v: v[:, None, None, :].expand(*slots, 3)
    t_b, b_b, n_b = frame(tf), frame(bf), frame(ff_n)
    wo = frame(_to_local(ff_wo, tf, bf, ff_n))
    m = mat.expand(slots)
    probe = n_ids[:, :, None].expand(slots)
    pr, pu, pl = right[probe], up[probe], look[probe]
    taken = u_sel < w_prob[:, :, None]
    # strategy 1: a pixel of the map
    rx = torch.clamp((u_xy[..., 0] * hemi).to(torch.int64), max=hemi - 1)
    ry = torch.clamp((u_xy[..., 1] * hemi).to(torch.int64), max=hemi - 1)
    Li1 = _map_lookup(R, probe, rx, ry, hemi)
    wi1 = _to_local(pixel_direction(rx.to(R.dtype) + 0.5, ry.to(R.dtype) + 0.5,
                                    pr, pu, pl, hemi), t_b, b_b, n_b)
    f1, pdf1 = bsdf_eval(m, wo, wi1)
    w1 = _power_heuristic(torch.full_like(pdf1, LIGHT_PDF), pdf1)
    c1 = EM_RATIO * f1 * Li1 * (torch.abs(wi1[..., 2]) * w1 / LIGHT_PDF)[..., None]
    c1 = torch.where((_lum(Li1) > 0)[..., None], c1, torch.zeros_like(c1))
    # strategy 2: a direction of the BSDF
    wi2, f2, pdf2, spec2, ok2 = bsdf_sample(m, wo, u_bl, u_bs)
    w2d = _to_world(wi2, t_b, b_b, n_b)
    xc, yc, zc = _dot(w2d, pr), _dot(w2d, pu), _dot(w2d, pl)
    x2 = torch.floor(hemi * torch.atan2(zc, xc) / math.pi).to(torch.int64)
    y2 = torch.floor(hemi * torch.arccos(torch.clamp(yc, -1, 1)) / math.pi).to(torch.int64)
    in_map = (x2 >= 0) & (x2 < hemi) & (y2 >= 0) & (y2 < hemi)
    Li2 = _map_lookup(R, probe, torch.clamp(x2, 0, hemi - 1), torch.clamp(y2, 0, hemi - 1),
                      hemi)
    Li2 = torch.where(in_map[..., None], Li2, torch.zeros_like(Li2))
    w2 = torch.where(spec2, torch.ones_like(pdf2),
                     _power_heuristic(pdf2, torch.full_like(pdf2, LIGHT_PDF)))
    c2 = BSDF_RATIO * f2 * Li2 * (torch.abs(wi2[..., 2]) * w2
                                  / torch.clamp(pdf2, min=1e-12))[..., None]
    c2 = torch.where((ok2 & (_lum(Li2) > 0))[..., None], c2, torch.zeros_like(c2))
    contrib = torch.where(taken[..., None], c1 + c2, torch.zeros_like(c1))
    n_taken = taken.sum(dim=(1, 2))
    Lh = contrib.sum(dim=(1, 2)) / torch.clamp(n_taken, min=1)[:, None].to(R.dtype)
    Lh = torch.where((n_taken > 0)[:, None], Lh, torch.zeros_like(Lh))
    rgb = ff_beta * Lh
    rgb = torch.where(torch.isfinite(rgb), rgb, torch.zeros_like(rgb))
    return torch.where(valid_px[:, None], rgb, torch.zeros_like(rgb)), valid_px


# ---------------------------------------------------------------------------
# a frame
# ---------------------------------------------------------------------------

class Iile:
    """The reference renderer of one scene: built once, frames from seeds."""

    def __init__(self, sd: pp.SceneData, weights: dict, device, dtype=torch.float32):
        self.sc = Scene(sd, device, dtype)
        self.w = {k: torch.as_tensor(v, device=self.sc.dev).to(dtype)
                  for k, v in weights.items()}

    def maps(self, gb, valid):
        return radiance_maps(gb["intensity"], gb["normals"], gb["distance"], valid, self.w)

    def task(self, x0, y0, ts, hemi, draw, chunk=PIXEL_CHUNK):
        """One task -> (flat pixel index, rgb, valid) of its pixels."""
        sc = self.sc
        W, H = sc.sd.width, sc.sd.height
        dev, dt = sc.dev, sc.dt
        coords = probe_pixels(x0, y0, ts, W, H, dev)
        o, d = sc.raster_rays(coords.to(dt) + draw(coords.shape[0], 2))
        fi = sc.chase(o, d, draw)
        valid = fi["found"] & (_lum(fi["beta"]) > 0)
        gb = probe_gbuffer(sc, fi["p"], fi["n"], hemi, draw)
        R = self.maps(gb, valid)
        size = NUMBER_TILES * ts
        x1, y1 = min(x0 + size, W), min(y0 + size, H)
        wx, wy = max(x1 - x0, 1), max(y1 - y0, 1)
        g = NUMBER_TILES + 1
        cam_o = sc.c2w[:3, 3]
        out = []
        for c0 in range(0, wx * wy, chunk):
            li = torch.arange(c0, min(c0 + chunk, wx * wy), device=dev)
            lx, ly = li % wx, li // wx
            fx, fy = x0 + lx, y0 + ly
            po, pd = sc.raster_rays(torch.stack([fx, fy], -1).to(dt) + draw(li.numel(), 2))
            ff = sc.chase(po, pd, draw)
            gi = torch.clamp(lx // ts, 0, g - 2)
            gj = torch.clamp(ly // ts, 0, g - 2)
            n_ids = torch.stack([gj * g + gi, (gj + 1) * g + gi + 1, gj * g + gi + 1,
                                 (gj + 1) * g + gi], -1)
            w_prob = neighbour_weights(fx, fy, coords.to(dt)[n_ids], cam_o, ff["p"], ff["n"],
                                       gb["look"][n_ids], gb["origin"][n_ids], valid[n_ids], ts)
            Np = li.numel()
            s = (Np, 4, HEMI_SAMPLES)
            rgb, ok = hemisphere_mis(
                R, sc.material(ff["mat"]), ff["n"], ff["wo"], ff["beta"],
                ff["found"] & (_lum(ff["beta"]) > 0), w_prob, n_ids, gb["right"], gb["up"],
                gb["look"], hemi, draw(*s), draw(*s, 2), draw(*s, 2), draw(*s))
            out.append((fy * W + fx, rgb, ok))
        return tuple(torch.cat(x) for x in zip(*out))

    def indirect(self, n_tasks, hemi, draw):
        sc = self.sc
        W, H = sc.sd.width, sc.sd.height
        acc = torch.zeros((W * H, 3), dtype=torch.float32, device=sc.dev)
        cnt = torch.zeros(W * H, dtype=torch.float32, device=sc.dev)
        for x0, y0, ts in schedule(W, H, n_tasks):
            idx, rgb, ok = self.task(x0, y0, ts, hemi, draw)
            acc.index_add_(0, idx, rgb.float())
            cnt.index_add_(0, idx, ok.float())
        return (acc / torch.clamp(cnt, min=1)[:, None]).reshape(H, W, 3)

    def direct(self, n_passes, draw, chunk=1 << 20):
        sc = self.sc
        W, H = sc.sd.width, sc.sd.height
        img = torch.zeros((W * H, 3), dtype=torch.float32, device=sc.dev)
        for _ in range(n_passes):
            for s in range(0, W * H, chunk):
                pix = torch.arange(s, min(s + chunk, W * H), device=sc.dev)
                xy = torch.stack([pix % W, pix // W], -1).to(sc.dt) + draw(pix.numel(), 2)
                o, d = sc.raster_rays(xy)
                L, _, _ = sc.trace(o, d, draw, sc.sd.max_depth, direct_only=True)
                img.index_add_(0, pix, L.float())
        return (img / n_passes).reshape(H, W, 3)

    def frame(self, seed, n_tasks, n_direct, hemi):
        """-> (combined, direct, indirect) (H, W, 3) float32 tensors."""
        gen = torch.Generator(device=self.sc.dev)
        gen.manual_seed(int(seed) % (1 << 63))
        draw = lambda *shape: self.sc._rand(gen, *shape)
        with torch.no_grad():
            ind = self.indirect(n_tasks, hemi, draw)
            dire = self.direct(n_direct, draw)
        return dire + ind, dire, ind


def load_scene(path, width=None, height=None, max_depth=None) -> pp.SceneData:
    return pp.load_scene(path, width, height, max_depth)
