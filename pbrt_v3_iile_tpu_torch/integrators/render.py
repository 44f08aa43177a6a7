"""Render driver: scene file -> device scene -> passes -> film (port of
``integrators/render.py``, the ``path`` integrator only).

Each pass is one wavefront of 1 spp over the image (or over row chunks
when the image exceeds ``max_wave`` rays); passes loop on the host and
the film accumulates on the device.
"""

from __future__ import annotations

import time

import torch

from ..ops import camera as camlib
from ..ops import film as filmlib
from ..ops import samplers as smplr
from ..ops import threefry
from ..scene import device as devlib
from . import path as pathlib_

COMPACT_SCHEDULE = (1.0, 1.0, 0.5, 0.25, 0.25, 0.125)


def make_integrator_config(sd, accel: str = None, device="cpu"):
    """Resolve the path integrator's config.  accel None = auto: the
    fused cluster kernel on CUDA, the BVH kernel's plain walker on CPU."""
    device = torch.device(device)
    if sd.integrator.kind != "path":
        raise NotImplementedError(
            f"integrator {sd.integrator.kind!r} is not ported yet "
            "(ROADMAP Queue 1, slices 2-3)")
    if accel is None:
        accel = sd.accelerator if sd.accelerator in ("kdtree", "clusters") \
            else ("clusters" if device.type == "cuda" else "bvh")
    if accel not in ("bvh", "clusters"):
        raise NotImplementedError(f"accel {accel!r} is not ported yet")
    return pathlib_.PathConfig(
        max_depth=sd.integrator.max_depth,
        rr_threshold=sd.integrator.rr_threshold,
        accel=accel,
        spatial_lights=sd.integrator.light_strategy == "spatial")


def build(sd, device, with_clusters: bool = None):
    scene = devlib.build_device_scene(sd, device, with_clusters=with_clusters)
    cam = camlib.make_camera(sd.camera, sd.film, device)
    return scene, cam


def make_wave_prep(sd, device, chunk_rows: int = 0):
    """Camera-wave generator f(cam, key, pass_idx, row0) -> (o, d,
    jitter, k, ctx) for rows [row0, row0 + CH)."""
    device = torch.device(device)
    H, W = sd.film.y_resolution, sd.film.x_resolution
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    if cam_kind == 3 and not sd.camera.lens_file:
        cam_kind = 0  # realistic without a lens file: perspective
    has_lens = sd.camera.lens_radius > 0.0
    CH = chunk_rows if chunk_rows > 0 else H

    def prep(cam, key, pass_idx: int, row0: int):
        py, px = torch.meshgrid(
            row0 + torch.arange(CH, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
        pix = torch.stack([px, py], dim=-1).reshape(-1, 2)
        k = threefry.fold_in(threefry.fold_in(key, pass_idx), row0)
        kj = smplr.wave_key(k, 0, 0, smplr.DIM_PIXEL_JITTER)
        flat_pix = ((row0 + torch.arange(CH, dtype=torch.int64, device=device))
                    [:, None] * W
                    + torch.arange(W, dtype=torch.int64, device=device)[None, :]
                    ).reshape(-1)
        jitter = smplr.pixel_samples(sd.sampler.kind, kj, flat_pix, pass_idx,
                                     sd.sampler.pixel_samples)
        p_film = pix + jitter
        u_lens = None
        if has_lens:
            u_lens = smplr.uniform(smplr.wave_key(k, 0, 0, smplr.DIM_LENS),
                                   (CH * W, 2), device)
        o, d = camlib.generate_rays(cam, p_film, u_lens, kind=cam_kind)
        ctx = None
        if sd.sampler.kind in smplr.LD_KINDS:
            ctx = smplr.make_sample_ctx(key, flat_pix, pass_idx,
                                        kind=sd.sampler.kind)
        return o, d, jitter, k, ctx

    return prep


def render_pass_fn(sd, cfg, device, chunk_rows: int = 0):
    """f(scene, cam, key, pass_idx, row0=0) -> (L (CH,W,3), jitter
    (CH,W,2), aux) for one pass over rows [row0, row0 + CH)."""
    H, W = sd.film.y_resolution, sd.film.x_resolution
    CH = chunk_rows if chunk_rows > 0 else H
    prep = make_wave_prep(sd, device, chunk_rows)

    def run(scene, cam, key, pass_idx: int, row0: int = 0):
        o, d, jitter, k, ctx = prep(cam, key, pass_idx, row0)
        L, aux = pathlib_.trace_paths(scene, o, d, k, cfg, sample_ctx=ctx)
        return L.reshape(CH, W, 3), jitter.reshape(CH, W, 2), aux

    return run


def render(sd, spp: int = None, seed: int = 0, max_wave: int = 1 << 16,
           accel: str = None, compact: bool = False, device="cuda",
           cluster_maxc: int = None):
    """Full render -> (image (H,W,3) np.ndarray, stats dict).

    compact: the compacted-wavefront loop with the bench schedule
    (1, 1, .5, .25, .25, .125).  Waves are cut to about max_wave rays."""
    device = torch.device(device)
    cfg = make_integrator_config(sd, accel=accel, device=device)
    if compact:
        cfg = cfg.replace(compact_schedule=COMPACT_SCHEDULE)
    if cluster_maxc is not None:
        cfg = cfg.replace(cluster_maxc=cluster_maxc)
    scene, cam = build(sd, device, with_clusters=cfg.accel == "clusters")
    H, W = sd.film.y_resolution, sd.film.x_resolution
    spp = spp if spp is not None else sd.sampler.pixel_samples
    chunk_rows = 0
    if H * W > max_wave:
        chunk_rows = max(1, max_wave // W)
        while H % chunk_rows:
            chunk_rows -= 1
    CH = chunk_rows if chunk_rows else H
    run = render_pass_fn(sd, cfg, device, chunk_rows=chunk_rows)
    key = threefry.prng_key(seed)
    film = filmlib.new_film(H, W, device)
    fkw = dict(filter_name=sd.film.filter_name, xw=sd.film.filter_xwidth,
               yw=sd.film.filter_ywidth, alpha=sd.film.filter_alpha,
               B=sd.film.filter_b, C=sd.film.filter_c, tau=sd.film.filter_tau)
    ray_parts = []
    t0 = time.time()
    for p in range(spp):
        Ls, Js = [], []
        for row0 in range(0, H, CH):
            L, jitter, aux = run(scene, cam, key, p, row0)
            Ls.append(L)
            Js.append(jitter)
            ray_parts.append(aux["rays"])
        film = filmlib.add_sample_image(film, torch.cat(Ls), torch.cat(Js), **fkw)
    img = filmlib.resolve(film).cpu().numpy()
    total_rays = int(torch.stack(ray_parts).sum()) if ray_parts else 0
    dt = time.time() - t0
    return img, dict(seconds=dt, rays=total_rays,
                     mrays_per_s=total_rays / max(dt, 1e-9) / 1e6)
