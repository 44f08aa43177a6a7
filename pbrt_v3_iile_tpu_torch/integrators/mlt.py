"""Primary-sample-space Metropolis light transport (port of
``integrators/mlt.py``).

mlt.cpp's estimator over many chains at once: each chain is a row of a
(C, D) matrix of primary samples, one evaluation traces every chain's
proposal as one wave, and the chains advance one mutation a step
(Kelemen's mutations: a fresh uniform vector with probability p_large,
else a wrapped Gaussian perturbation of every coordinate).  Both the
proposal and the current state splat with the expected-values weights,
and the film is scaled by b H W / mutations, b the bootstrap's mean
luminance.

Proposals are BDPT paths by default (``MLTConfig.bdpt``: one depth and
one (s, t) strategy picked from u, ``integrators/bdpt.py`` on explicit
samples, scaled by the strategy count times max_depth + 1), or with
``bdpt=False`` the older unidirectional PSSMLT over ``trace_paths`` with
explicit primary samples.

Every draw is keyed as the reference keys it, and the float32 arithmetic
of the draws (the ranged uniform, ``erfinv``, the Gumbel chain starts)
is XLA's on the CPU, so that the chains follow the reference's chains
for as long as the two evaluations agree to the bit.

Primary samples of a chain: u[0:2] the film position in [0, 1)^2, then
(BDPT) the depth, the strategy, the lens, and the camera, light, light
root and NEE samples of ``_dims_bdpt``; (PSSMLT) the lens and
(max_depth + 1) x PRIM_DIMS_PER_BOUNCE bounce samples.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import camera as camlib
from ..ops import threefry
from ..utils import vecmath as vm
from . import bdpt as bdptlib
from . import path as pathlib_


@dataclass(frozen=True)
class MLTConfig:
    max_depth: int = 5
    n_chains: int = 1024         # chains advanced together (the wave)
    n_bootstrap: int = 4096      # samples of the b estimate and the starts
    p_large: float = 0.3         # large-step probability (mlt.cpp default)
    sigma: float = 0.01          # small-step size (mlt.cpp default)
    bdpt: bool = True            # BDPT proposals; False: PSSMLT

    def replace(self, **kw):
        return replace(self, **kw)


def _dims(cfg: MLTConfig) -> int:
    if cfg.bdpt:
        return _dims_bdpt(cfg.max_depth)
    return 4 + (cfg.max_depth + 1) * pathlib_.PRIM_DIMS_PER_BOUNCE


def _dims_bdpt(max_depth: int) -> int:
    T, S = max_depth + 1, max_depth
    # film 2, depth, strategy, lens 2, camera T*3, light S*3, root 7, NEE T*4
    return 6 + 3 * T + 3 * S + 7 + 4 * T


def _film_rays(cam, cam_kind, u_film, u_lens):
    res = torch.tensor([float(cam.resolution[0]), float(cam.resolution[1])],
                       device=u_film.device)
    return camlib.generate_rays(cam, u_film * res, u_lens, kind=cam_kind)


def _eval_bdpt(scene, cam, cam_kind, has_lens, u, max_depth):
    """The single-strategy BDPT estimate of the paths encoded by u (mlt.cpp
    MLT::L: the depth from one coordinate, (s, t) from the next, scaled by
    the strategy count and the depth's selection) -> (L (C,3), film_xy)."""
    C = u.shape[0]
    T, S = max_depth + 1, max_depth
    film_xy = u[:, 0:2]
    depth = torch.clamp((u[:, 2] * (max_depth + 1)).to(torch.int32), max=max_depth)
    nstrat = depth + 1
    s_sel = torch.minimum((u[:, 3] * nstrat.to(torch.float32)).to(torch.int32),
                          nstrat - 1)
    t_sel = depth + 2 - s_sel
    o, d = _film_rays(cam, cam_kind, film_xy, u[:, 4:6] if has_lens else None)
    off = 6
    u_cam = u[:, off:off + 3 * T].reshape(C, T, 3)
    off += 3 * T
    u_lit = u[:, off:off + 3 * S].reshape(C, S, 3)
    off += 3 * S
    u_root = u[:, off:off + 7]
    off += 7
    u_nee = u[:, off:off + 4 * T].reshape(C, T, 4)
    L, _ = bdptlib.trace_bdpt(scene, o, d, threefry.prng_key(0), max_depth,
                              u_ext=dict(cam=u_cam, lit=u_lit, root=u_root,
                                         nee=u_nee),
                              sel_st=(s_sel, t_sel))
    scale = (nstrat.to(torch.float32) * (max_depth + 1))[:, None]
    return L * scale, film_xy


def _eval(scene, cam, cam_kind, has_lens, u, path_cfg):
    """f(u) of PSSMLT: the radiance of the path encoded by u -> (L (C,3),
    film_xy (C,2))."""
    C = u.shape[0]
    film_xy = u[:, 0:2]
    o, d = _film_rays(cam, cam_kind, film_xy, u[:, 2:4] if has_lens else None)
    u_prim = u[:, 4:].reshape(C, path_cfg.max_depth + 1,
                              pathlib_.PRIM_DIMS_PER_BOUNCE)
    L, _ = pathlib_.trace_paths(scene, o, d, threefry.prng_key(0), path_cfg,
                                u_prim=u_prim)
    return L, film_xy


# XLA's float32 erfinv (Giles' single-precision approximation), the two
# polynomials in w = -log1p(-x^2) below and above 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)
# Cephes log1p's rational approximation below sqrt(2) - 1 (XLA's log1p)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _f32(x):
    return float(np.float32(x))


def _log1p(x):
    """float32 log1p as XLA computes it on the CPU, bit for bit."""
    large = threefry.xla_log(x + 1.0)
    x2 = x * x

    def poly(cs):
        p = x * 0.0 + _f32(cs[0])
        for c in cs[1:]:
            p = threefry.fma32(p, x, _f32(c))
        return p

    small = x + threefry.fma32(x2, -0.5, (x * x2) * (poly(_LOG1P_NUM)
                                                    / poly(_LOG1P_DEN)))
    return torch.where(torch.abs(x) < _f32(math.sqrt(2.0) - 1.0), small, large)


def erfinv(x):
    """float32 inverse error function as XLA computes it on the CPU (its
    sqrt correctly rounded, its multiply-adds fused), bit for bit."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = lambda i: torch.where(lt, _f32(_ERFINV_LT5[i]), _f32(_ERFINV_GE5[i]))
    p = coef(0)
    for i in range(1, 9):
        p = threefry.fma32(p, w, coef(i))
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def _mutate(u, key, sigma, p_large):
    """Kelemen's mutation (mlt.cpp MLTSampler): a large step draws a fresh
    uniform vector, a small step adds sqrt(2) sigma erfinv(2 eps - 1) to
    every coordinate, wrapped to [0, 1).  -> (u', is_large (C,))."""
    C, D = u.shape
    dev = u.device
    k_large, k_u, k_pert = threefry.split(key, 3)
    fresh = threefry.uniform(k_large, (C, D), dev)
    eps = threefry.uniform(k_pert, (C, D), dev, minval=1e-7, maxval=1.0 - 1e-7)
    c = _f32(_f32(math.sqrt(2.0)) * _f32(sigma))
    # u + c erfinv(...) as one fused multiply-add, as XLA fuses it
    x = threefry.fma32(erfinv(2.0 * eps - 1.0), c, u)
    r = torch.fmod(x, 1.0)
    perturbed = torch.where((r != 0.0) & (r < 0.0), r + 1.0, r)
    is_large = threefry.uniform(k_u, (C, 1), dev) < _f32(p_large)
    return torch.where(is_large, fresh, perturbed), is_large[:, 0]


def chain_step(eval_fn, chain, k_step, cfg: MLTConfig, film, H: int, W: int):
    """One Metropolis step of every chain: mutate, evaluate, splat both
    states by their expected values into film (H*W, 3) and accept.
    chain: (u, L, I, xy) -> the chain after the step."""
    u, L, I, xy = chain
    u_new, _ = _mutate(u, k_step, cfg.sigma, cfg.p_large)
    L_new, xy_new = eval_fn(u_new)
    I_new = vm.luminance(torch.abs(L_new))
    a = torch.clamp(I_new / torch.clamp(I, min=1e-20), max=1.0)
    # expected-values splatting (mlt.cpp Run)
    w_new = torch.where(I_new > 0.0, a / torch.clamp(I_new, min=1e-20), 0.0)
    w_cur = torch.where(I > 0.0, (1.0 - a) / torch.clamp(I, min=1e-20), 0.0)
    for xy_s, w, L_s in ((xy_new, w_new, L_new), (xy, w_cur, L)):
        px = torch.clamp((xy_s[:, 0] * W).to(torch.int64), 0, W - 1)
        py = torch.clamp((xy_s[:, 1] * H).to(torch.int64), 0, H - 1)
        film.index_add_(0, py * W + px, w[:, None] * L_s)
    accept = threefry.uniform(threefry.fold_in(k_step, 7), a.shape,
                              u.device) < a
    return (torch.where(accept[:, None], u_new, u),
            torch.where(accept[:, None], L_new, L),
            torch.where(accept, I_new, I),
            torch.where(accept[:, None], xy_new, xy))


def render_mlt(sd, mutations_per_pixel: int = 64, seed: int = 0,
               cfg: MLTConfig = None, device="cuda", accel: str = None,
               prebuilt=None):
    """Full Metropolis render -> (image (H,W,3) np.ndarray, stats dict).
    accel: the traversal of PSSMLT's ``trace_paths`` (BDPT proposals
    traverse the BVH whatever it is); prebuilt: (scene, cam) as
    ``render.build`` returns them."""
    from . import render as renderlib

    device = torch.device(device)
    t0 = time.time()
    H, W = sd.film.y_resolution, sd.film.x_resolution
    if cfg is None:
        cfg = MLTConfig(max_depth=sd.integrator.max_depth,
                        p_large=sd.integrator.mlt_p_large,
                        sigma=sd.integrator.mlt_sigma)
    base = renderlib.make_integrator_config(sd, accel=accel, device=device)
    path_cfg = base.replace(max_depth=cfg.max_depth, nee_all=False,
                            direct_only=False)
    if prebuilt is None:
        scene, cam = renderlib.build(sd, device,
                                     with_clusters=(not cfg.bdpt
                                                    and path_cfg.accel == "clusters"),
                                     with_kdtree=(not cfg.bdpt
                                                  and path_cfg.accel == "kdtree"))
    else:
        scene, cam = prebuilt
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    has_lens = sd.camera.lens_radius > 0.0
    D = _dims(cfg)

    if cfg.bdpt:
        def eval_fn(u):
            return _eval_bdpt(scene, cam, cam_kind, has_lens, u, cfg.max_depth)
    else:
        def eval_fn(u):
            return _eval(scene, cam, cam_kind, has_lens, u, path_cfg)

    # the bootstrap: b = E[I(u)] and the chains' starts ~ I
    k_boot, k_sel, k_run = threefry.split(threefry.prng_key(seed), 3)
    u_boot = threefry.uniform(k_boot, (cfg.n_bootstrap, D), device)
    L_boot, _ = eval_fn(u_boot)
    I_boot = vm.luminance(torch.abs(L_boot))
    b = float(torch.mean(I_boot))
    if b <= 0.0:
        return np.zeros((H, W, 3), np.float32), dict(seconds=0.0, b=0.0)
    idx = threefry.categorical(
        k_sel, threefry.xla_log(torch.clamp(I_boot, min=1e-20)), (cfg.n_chains,))
    u = u_boot[idx]

    n_steps = max(1, mutations_per_pixel * H * W // cfg.n_chains)
    L, xy = eval_fn(u)
    chain = (u, L, vm.luminance(torch.abs(L)), xy)
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=device)
    for k_step in threefry.split(k_run, n_steps):
        chain = chain_step(eval_fn, chain, k_step, cfg, film, H, W)
    u = chain[0]
    done = n_steps * cfg.n_chains
    img = (film * (b * H * W / done)).reshape(H, W, 3)
    img = img.cpu().numpy()
    stats = dict(seconds=time.time() - t0, b=b, mutations=done,
                 chains=cfg.n_chains, u=u)
    return img, stats
