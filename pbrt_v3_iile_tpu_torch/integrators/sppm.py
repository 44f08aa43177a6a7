"""Stochastic progressive photon mapping (port of ``integrators/sppm.py``).

sppm.cpp's estimator, iteration by iteration: a camera pass follows each
pixel's ray through specular chains, adding emission and one-light NEE,
and stores one visible point at the first vertex with a non-specular
lobe; a photon pass emits photons with ``sample_le`` and deposits them at
every surface vertex after the first; the gather sums, for each visible
point, the BSDF-weighted flux of the photons within its radius; the
radius and the flux statistics shrink with alpha = 2/3.

The photon map is a sorted array: photons hash into m = next_pow2(Pn)
buckets of a grid of cells of twice the largest radius, a stable sort
orders them by bucket, and each visible point scans the <= 8 cells its
ball overlaps, at most K_CAP photons a cell (the overflow is counted in
``dropped``).  The scan is the range query of ``ops/photon_kernel.py``
(K4, CUDA kernels on the card), which lists the (point, photon) pairs in
the reference's slot order; the BSDF evaluation of the pairs is
``bsdf.evaluate`` in batches of at most PAIR_CHUNK pairs, added to each
point's flux with ``index_add_``: on the CPU in pair order, as the
reference's loop adds them, on the card by atomics in no fixed order (so
there Phi may differ from the CPU's in its last bits).  Both passes
traverse the BVH (K2) whatever the accel.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..ops import bsdf as bsdflib
from ..ops import camera as camlib
from ..ops import intersect as isect
from ..ops import lights as lightlib
from ..ops import photon_kernel
from ..ops import samplers as smplr
from ..ops import threefry
from ..utils import log
from ..utils import vecmath as vm

ALPHA = 2.0 / 3.0             # the radius-shrink exponent (sppm.cpp alpha)
K_CAP = photon_kernel.K_CAP   # photons gathered per cell per visible point
PAIR_CHUNK = 1 << 21          # (visible point, photon) pairs per evaluation


def _camera_pass(scene, o0, d0, key, max_depth):
    """Camera rays through specular chains -> (Ld (N,3), visible points):
    emission at depth 0 and after specular bounces, one-light NEE at every
    surface vertex, the path ends at its first vertex with a non-specular
    lobe and records it."""
    N = o0.shape[0]
    dev = o0.device
    o, d = o0, d0
    zero3 = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((N, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    spec = torch.zeros(N, dtype=torch.bool, device=dev)
    Ld = zero3
    vp_valid = torch.zeros(N, dtype=torch.bool, device=dev)
    vp_p = vp_wo = vp_beta = zero3
    vp_frame = (zero3,) * 3
    vp_params = None
    for b in range(max_depth):
        t_max = torch.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max, accel="bvh")
        it = isect.make_interaction(scene, o, d, hit)
        found = hit.valid & alive

        le_ok = spec | (b == 0)
        esc = alive & ~hit.valid
        Ld = Ld + torch.where((esc & le_ok)[:, None],
                              beta * lightlib.environment_le(scene, d), zero3)
        emissive = found & (it.light >= 0)
        le = lightlib.area_light_le(scene, torch.clamp(it.light, min=0), it.ng,
                                    it.wo)
        Ld = Ld + torch.where((emissive & le_ok)[:, None], beta * le, zero3)

        ns = vm.face_forward(it.ns, it.ng)
        ng_f = vm.face_forward(it.ng, -d)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        params = bsdflib.gather_params(scene, torch.clamp(it.mat, min=0),
                                       uv=it.uv, p=it.p)
        alive = found & ~bsdflib.is_black(params)

        # one-light NEE (the light strategy alone: the camera path collects
        # no emission past a non-specular vertex, so it needs no MIS)
        u_sel = smplr.uniform(smplr.wave_key(key, 1, b, smplr.DIM_LIGHT_SELECT),
                              (N,), dev)
        u_l = smplr.uniform(smplr.wave_key(key, 1, b, smplr.DIM_LIGHT_SAMPLE),
                            (N, 3), dev)
        light_id, sel_pdf = lightlib.choose_light(scene, u_sel)
        ls = lightlib.sample_li(scene, light_id, it.p, u_l)
        f_l, _ = bsdflib.evaluate(params, wo_l, vm.to_local(ls.wi, t_f, b_f, ns))
        cos_l = vm.absdot(ls.wi, ns)
        nonspec = bsdflib.has_nonspecular(params)
        can = (alive & nonspec & (ls.pdf > 0.0) & (vm.luminance(ls.li) > 0.0)
               & (scene.n_lights > 0))
        o_sh = vm.offset_ray_origin(it.p, ng_f, ls.wi)
        # the shadow length from the offset origin
        sh_tmax = torch.where(can, (ls.dist - vm.dot(o_sh - it.p, ls.wi)) * 0.999,
                              -1.0)
        occ = isect.occluded(scene, o_sh, ls.wi, sh_tmax, accel="bvh")
        contrib = beta * f_l * ls.li * (cos_l / torch.clamp(ls.pdf * sel_pdf,
                                                            min=1e-12))[:, None]
        Ld = Ld + torch.where((can & ~occ)[:, None], contrib, zero3)

        # the visible point: the first non-specular vertex
        is_vp = alive & nonspec & ~vp_valid
        v3 = is_vp[:, None]
        vp_p = torch.where(v3, it.p, vp_p)
        vp_wo = torch.where(v3, it.wo, vp_wo)
        vp_beta = torch.where(v3, beta, vp_beta)
        vp_frame = tuple(torch.where(v3, new, old)
                         for new, old in zip((t_f, b_f, ns), vp_frame))
        vp_params = (params if vp_params is None
                     else bsdflib.select_params(is_vp, params, vp_params))
        vp_valid = vp_valid | is_vp
        alive = alive & ~is_vp     # the camera path ends at its visible point

        # the specular continuation
        u_lobe = smplr.uniform(smplr.wave_key(key, 1, b, smplr.DIM_BSDF_LOBE),
                               (N,), dev)
        u_dir = smplr.uniform(smplr.wave_key(key, 1, b, smplr.DIM_BSDF_DIR),
                              (N, 2), dev)
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None]
        ok = bs.valid & alive & (vm.luminance(torch.abs(beta_new)) > 0.0)
        beta = torch.where(ok[:, None], beta_new, beta)
        alive = alive & ok
        spec = bs.is_specular
        o = vm.offset_ray_origin(it.p, ng_f, wi_w)
        d = wi_w
    vp = dict(valid=vp_valid, p=vp_p, wo=vp_wo, beta=vp_beta, frame=vp_frame,
              params=vp_params)
    return Ld, vp


def _photon_pass(scene, key, n_photons, max_depth, device):
    """Emit and trace photons -> the deposits (positions, power, incident
    direction, valid), n_photons * (max_depth - 1) of each, depth-major;
    the first segment deposits nothing (the camera pass's NEE covers it)."""
    P = n_photons
    u_sel = smplr.uniform(smplr.wave_key(key, 2, 0, smplr.DIM_LIGHT_SELECT),
                          (P,), device)
    light_id, sel_pdf = lightlib.choose_light(scene, u_sel)
    em = lightlib.sample_le(scene, light_id, smplr.uniform(
        smplr.wave_key(key, 2, 0, smplr.DIM_LIGHT_SAMPLE), (P, 6), device))
    beta = em.beta / torch.clamp(sel_pdf, min=1e-12)[:, None]
    o = vm.offset_ray_origin(em.o, em.d, em.d)
    d = em.d
    alive = em.valid & (scene.n_lights > 0)
    dep_p, dep_pow, dep_wi, dep_ok = [], [], [], []
    for b in range(max_depth):
        t_max = torch.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max, accel="bvh")
        it = isect.make_interaction(scene, o, d, hit)
        found = hit.valid & alive
        params = bsdflib.gather_params(scene, torch.clamp(it.mat, min=0),
                                       uv=it.uv, p=it.p)
        if b > 0:
            dep_p.append(it.p)
            dep_pow.append(beta)
            dep_wi.append(-d)
            dep_ok.append(found)
        alive = found & ~bsdflib.is_black(params)
        ns = vm.face_forward(it.ns, it.ng)
        ng_f = vm.face_forward(it.ng, -d)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        u_lobe = smplr.uniform(smplr.wave_key(key, 3, b, smplr.DIM_BSDF_LOBE),
                               (P,), device)
        u_dir = smplr.uniform(smplr.wave_key(key, 3, b, smplr.DIM_BSDF_DIR),
                              (P, 2), device)
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None]
        ok = bs.valid & alive & (vm.luminance(torch.abs(beta_new)) > 0.0)
        # the photon's roulette (sppm.cpp q = max(0, 1 - y(beta') / y(beta)))
        q = torch.clamp(1.0 - vm.luminance(beta_new) / torch.clamp(
            vm.luminance(beta), min=1e-12), min=0.0)
        u_rr = smplr.uniform(smplr.wave_key(key, 3, b, smplr.DIM_RR), (P,), device)
        ok = ok & (u_rr >= q)
        beta = torch.where(ok[:, None], beta_new / torch.clamp(
            1.0 - q, min=1e-6)[:, None], beta)
        alive = alive & ok
        o = vm.offset_ray_origin(it.p, ng_f, wi_w)
        d = wi_w
    return (torch.cat(dep_p), torch.cat(dep_pow), torch.cat(dep_wi),
            torch.cat(dep_ok))


def _hash_cells(ic, m: int):
    """Spatial hash of int cell coordinates (N,3) into [0, m)."""
    return photon_kernel.hash_cells(ic, m)


def photon_map(ph_p, ph_ok, grid_origin, cell):
    """The photon map: (m, h_sorted, order) of the deposits hashed into
    m = next_pow2(Pn) buckets (an invalid deposit into the sentinel m) and
    stably sorted by bucket, so that a bucket's run keeps deposit order."""
    Pn = ph_p.shape[0]
    m = max(1, int(2 ** np.ceil(np.log2(max(Pn, 2)))))
    ic = torch.floor((ph_p - grid_origin) / cell).to(torch.int32)
    h = torch.where(ph_ok, _hash_cells(ic, m), m)
    h_sorted, order = torch.sort(h, stable=True)
    return m, h_sorted, order


def cell_ranges(vp, radius, grid_origin, cell):
    """The cells (lo_c, hi_c) (N,3) int32 of each visible point's ball."""
    r = radius[:, None]
    lo_c = torch.floor((vp["p"] - r) / cell - grid_origin / cell).to(torch.int32)
    hi_c = torch.floor((vp["p"] + r) / cell - grid_origin / cell).to(torch.int32)
    return lo_c, hi_c


def _gather(vp, ph_p, ph_pow, ph_wi, ph_ok, radius, grid_origin, cell):
    """For each visible point, the flux of the photons within its radius
    -> (Phi (N,3) with the point's beta and f, M (N,), dropped ())."""
    m, h_sorted, order = photon_map(ph_p, ph_ok, grid_origin, cell)
    lo_c, hi_c = cell_ranges(vp, radius, grid_origin, cell)
    pair_point, pair_photon, M, dropped = photon_kernel.photon_query(
        lo_c, hi_c, vp["valid"], vp["p"], radius * radius, h_sorted,
        ph_p[order], m)
    t_f, b_f, ns = vp["frame"]
    wo_l = vm.to_local(vp["wo"], t_f, b_f, ns)
    Phi = torch.zeros_like(vp["p"])
    # the pairs in (point, slot) order; index_add_ sums a point's photons
    # in that order on the CPU, as the reference's loop adds them, and by
    # atomics on the card
    n_idx = pair_point.long()
    ph_idx = order[pair_photon.long()]
    for c0 in range(0, n_idx.shape[0], PAIR_CHUNK):
        n_c = n_idx[c0:c0 + PAIR_CHUNK]
        ph = ph_idx[c0:c0 + PAIR_CHUNK]
        params = bsdflib.map_params(lambda x: x[n_c], vp["params"])
        wi_l = vm.to_local(ph_wi[ph], t_f[n_c], b_f[n_c], ns[n_c])
        f, _ = bsdflib.evaluate(params, wo_l[n_c], wi_l)
        Phi.index_add_(0, n_c, vp["beta"][n_c] * f * ph_pow[ph])
    return Phi, M, dropped.sum()


def render_sppm(sd, n_iterations: int = 64, seed: int = 0, device="cuda",
                report=None, prebuilt=None):
    """Full SPPM render -> (image (H,W,3) np.ndarray, stats dict with
    seconds, rays, mrays_per_s, dropped).  prebuilt: (scene, cam) as
    ``render.build`` returns them."""
    from . import render as renderlib

    device = torch.device(device)
    t0 = time.time()
    H, W = sd.film.y_resolution, sd.film.x_resolution
    N = H * W
    max_depth = sd.integrator.max_depth
    if max_depth < 2:
        raise ValueError("sppm deposits photons from the second vertex on: "
                         "maxdepth must be at least 2")
    n_photons = sd.integrator.photons_per_iteration
    if n_photons <= 0:
        n_photons = N          # sppm.cpp's default: one photon per pixel
    renderlib.make_integrator_config(sd, device=device)
    scene, cam = (renderlib.build(sd, device, with_clusters=False)
                  if prebuilt is None else prebuilt)
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    key = threefry.prng_key(seed)
    grid_origin = 0.5 * (scene.world_min + scene.world_max) - scene.world_radius
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    pix = torch.stack([px, py], dim=-1).reshape(-1, 2)

    radius = torch.full((N,), float(np.float32(sd.integrator.initial_radius)),
                        dtype=torch.float32, device=device)
    Nacc = torch.zeros(N, dtype=torch.float32, device=device)
    tau = torch.zeros((N, 3), dtype=torch.float32, device=device)
    Ld_acc = torch.zeros((N, 3), dtype=torch.float32, device=device)
    dropped = []
    for i in range(n_iterations):
        it_key = threefry.fold_in(key, i)
        jitter = smplr.uniform(smplr.wave_key(it_key, 0, 0,
                                              smplr.DIM_PIXEL_JITTER), (N, 2), device)
        o0, d0 = camlib.generate_rays(cam, pix + jitter, kind=cam_kind)
        Ld, vp = _camera_pass(scene, o0, d0, it_key, max_depth)
        ph = _photon_pass(scene, it_key, n_photons, max_depth, device)
        cell = 2.0 * torch.clamp(torch.max(radius), min=1e-6)
        Phi, M, drop = _gather(vp, *ph, radius, grid_origin, cell)
        # the statistics update (sppm.cpp "Update pixel values from this
        # pass's photons")
        has = M > 0.0
        N_new = Nacc + ALPHA * M
        r_new = torch.where(has, radius * torch.sqrt(
            N_new / torch.clamp(Nacc + M, min=1e-6)), radius)
        ratio2 = torch.where(has, (r_new / torch.clamp(radius, min=1e-9)) ** 2, 1.0)
        tau = (tau + Phi) * ratio2[:, None]
        radius, Nacc = r_new, torch.where(has, N_new, Nacc)
        Ld_acc = Ld_acc + Ld
        dropped.append(drop)
        if report is not None:
            report(i + 1, n_iterations, None)
    Np = n_iterations * n_photons
    L = Ld_acc / n_iterations + tau / (
        Np * math.pi * torch.clamp(radius, min=1e-9)[:, None] ** 2)
    img = L.reshape(H, W, 3).cpu().numpy()
    total_dropped = int(torch.stack(dropped).sum())
    dt = time.time() - t0
    rays = n_iterations * (N + n_photons) * max_depth
    if total_dropped:
        log.warning(f"sppm: {total_dropped} photon-cell overflows "
                    f"(K_CAP={K_CAP}): a slight loss of energy")
    return img, dict(seconds=dt, rays=rays, mrays_per_s=rays / max(dt, 1e-9) / 1e6,
                     dropped=total_dropped)
