"""Render driver: scene file -> device scene -> passes -> film (port of
``integrators/render.py``: the ``path``, ``volpath``, ``directlighting``,
``whitted``, ``ambientocclusion`` and ``bdpt`` integrators; ``mlt`` and
``sppm`` have their own drivers in ``integrators/mlt.py`` and
``integrators/sppm.py``, ``iispt`` renders through
``integrators/iispt.py``), with every camera (the realistic lens camera
weights its rays), camera and object motion blur (a shutter time per
pixel sample) and the three accels (``clusters``, ``bvh``, ``kdtree``).
``bdpt``, ``sppm`` and BDPT-MLT traverse the BVH whatever the accel, as
the reference does; they take no object motion and no media.

Each pass is one wavefront of 1 spp over the image (or over row chunks
when the image exceeds ``max_wave`` rays); passes loop on the host and
the film accumulates on the device.  A film checkpoint (the JAX
package's npz keys ``rgb``, ``weight``, ``passes``, ``seed``) lets a
render resume.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops import camera as camlib
from ..ops import film as filmlib
from ..ops import samplers as smplr
from ..ops import threefry
from ..scene import api as apilib
from ..scene import device as devlib
from ..utils import stats as statslib
from . import ao as aolib
from . import bdpt as bdptlib
from . import path as pathlib_

COMPACT_SCHEDULE = (1.0, 1.0, 0.5, 0.25, 0.25, 0.125)


def resolve_accel(sd, accel: str = None, device="cuda") -> str:
    """accel None = auto: the scene file's choice, else the fused cluster
    kernel on CUDA and the BVH kernel's plain walker on CPU.  A scene with
    object motion renders ``clusters`` on the BVH (its motion variant
    carries every traversal whatever the accel)."""
    if accel is None:
        accel = sd.accelerator if sd.accelerator in ("kdtree", "clusters") \
            else ("clusters" if torch.device(device).type == "cuda" else "bvh")
    if accel not in ("bvh", "clusters", "kdtree"):
        raise ValueError(f"unknown accel {accel!r}")
    if accel == "clusters" and sd.has_motion:
        accel = "bvh"
    return accel


def make_integrator_config(sd, accel: str = None, device="cuda"):
    """Resolve the integrator's config for ``device`` (the card unless the
    caller asks for the CPU).  ``path``, ``volpath`` and ``iispt`` (the
    path integrator settings; IILE's own stages set theirs; a scene with
    media is volumetric whatever its integrator, and its media, hair and
    subsurface materials switch on their code), ``bdpt``, ``mlt`` and
    ``sppm`` (the shared knobs; each has its own estimator, and the
    reference's ignores object motion and media, which they refuse),
    ``directlighting``
    (specular paths only, all lights sampled under the "all" strategy),
    ``whitted`` (as the reference maps it: every light sampled, specular
    paths only) and ``ambientocclusion`` (only the accel is read:
    ``integrators/ao.py`` traces it)."""
    kind = sd.integrator.kind
    accel = resolve_accel(sd, accel, device)
    has_hair = any(m.kind == apilib.MAT_HAIR for m in sd.materials)
    if kind in ("bdpt", "mlt", "sppm"):
        if sd.has_motion or sd.media:
            raise ValueError(
                f"integrator {kind!r}: the reference renders a scene with "
                "object motion or media as if both were absent; render it "
                "with 'path' or 'volpath'")
        return pathlib_.PathConfig(
            max_depth=sd.integrator.max_depth,
            rr_threshold=sd.integrator.rr_threshold, accel=accel,
            spatial_lights=sd.integrator.light_strategy == "spatial",
            has_hair=has_hair,
            has_subsurface=any(m.kind == apilib.MAT_SUBSURFACE
                               for m in sd.materials))
    if kind in ("path", "volpath", "iispt"):
        media = sd.media
        return pathlib_.PathConfig(
            max_depth=sd.integrator.max_depth,
            rr_threshold=sd.integrator.rr_threshold,
            accel=accel,
            spatial_lights=sd.integrator.light_strategy == "spatial",
            volumetric=kind == "volpath" or len(media) > 0,
            grid_media=any(m.density is not None for m in media),
            has_hair=has_hair,
            has_subsurface=any(m.kind == apilib.MAT_SUBSURFACE
                               for m in sd.materials))
    if kind in ("directlighting", "whitted"):
        return pathlib_.PathConfig(
            max_depth=sd.integrator.max_depth,
            nee_all=kind == "whitted" or sd.integrator.dl_strategy == "all",
            direct_only=True, accel=accel, has_hair=has_hair)
    if kind == "ambientocclusion":
        return pathlib_.PathConfig(max_depth=sd.integrator.max_depth,
                                   accel=accel)
    raise ValueError(f"unknown integrator {kind!r}")


def build(sd, device, with_clusters: bool = None, with_kdtree: bool = None):
    """The device scene and the camera.  with_kdtree None builds the
    kd-tree when the scene file asks for it; render() builds it whenever
    the resolved accel is ``kdtree`` (a scene built without it refuses
    that accel: the reference renders it black)."""
    scene = devlib.build_device_scene(sd, device, with_clusters=with_clusters,
                                      with_kdtree=with_kdtree)
    cam = camlib.make_camera(sd.camera, sd.film, device)
    return scene, cam


def make_wave_prep(sd, device, chunk_rows: int = 0):
    """Camera-wave generator f(cam, key, pass_idx, row0) -> (o, d, w,
    jitter, k, ctx, ray_time) for rows [row0, row0 + CH): w is the
    realistic camera's ray weight (None for the other cameras), ray_time
    each ray's shutter time mapped to [0, 1] for object motion (None in a
    static scene)."""
    device = torch.device(device)
    H, W = sd.film.y_resolution, sd.film.x_resolution
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    is_realistic = cam_kind == 3 and bool(sd.camera.lens_file)
    if cam_kind == 3 and not sd.camera.lens_file:
        cam_kind = 0  # realistic without a lens file: perspective
    has_lens = sd.camera.lens_radius > 0.0 or is_realistic
    is_animated = sd.camera.cam_to_world_end is not None
    has_motion = sd.has_motion
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
        u_lens = ray_time = w = None
        if has_lens:
            u_lens = smplr.uniform(smplr.wave_key(k, 0, 0, smplr.DIM_LENS),
                                   (CH * W, 2), device)
        if is_animated or has_motion:
            ray_time = camlib.shutter_time(sd.camera, smplr.uniform(
                smplr.wave_key(k, 0, 0, smplr.DIM_TIME), (CH * W,), device))
        if is_realistic:
            o, d, w = camlib.realistic_generate_rays(cam, p_film, u_lens)
        else:
            o, d = camlib.generate_rays(cam, p_film, u_lens, kind=cam_kind,
                                        time=ray_time if is_animated else None)
        ctx = None
        if sd.sampler.kind in smplr.LD_KINDS:
            ctx = smplr.make_sample_ctx(key, flat_pix, pass_idx,
                                        kind=sd.sampler.kind)
        return o, d, w, jitter, k, ctx, ray_time if has_motion else None

    return prep


def render_pass_fn(sd, cfg, device, chunk_rows: int = 0):
    """f(scene, cam, key, pass_idx, row0=0) -> (L (CH,W,3), jitter
    (CH,W,2), aux) for one pass over rows [row0, row0 + CH); for ``bdpt``
    aux["splat"] is the pass's (H*W + 1, 3) light-tracing film."""
    H, W = sd.film.y_resolution, sd.film.x_resolution
    CH = chunk_rows if chunk_rows > 0 else H
    prep = make_wave_prep(sd, device, chunk_rows)
    # t = 1 light tracing needs the camera's importance: the pinhole only
    pinhole = (camlib.KIND.get(sd.camera.kind, 0) == 0
               and sd.camera.lens_radius <= 0.0)

    def run(scene, cam, key, pass_idx: int, row0: int = 0):
        o, d, w, jitter, k, ctx, rtime = prep(cam, key, pass_idx, row0)
        if sd.integrator.kind == "ambientocclusion":
            L = aolib.trace_ao(scene, o, d, k, accel=cfg.accel,
                               cos_sample=sd.integrator.cos_sample)
            if w is not None:
                L = L * w[:, None]
            aux = {"rays": torch.tensor(2 * CH * W, device=o.device)}
        elif sd.integrator.kind == "bdpt":
            L, aux = bdptlib.trace_bdpt(
                scene, o, d, k, max_depth=sd.integrator.max_depth,
                cam=cam if pinhole else None, film_hw=(H, W) if pinhole else None)
            if w is not None:
                L = L * w[:, None]
        else:
            beta0 = None if w is None else w[:, None].expand(-1, 3).contiguous()
            L, aux = pathlib_.trace_paths(scene, o, d, k, cfg, beta0=beta0,
                                          sample_ctx=ctx, time=rtime)
        return L.reshape(CH, W, 3), jitter.reshape(CH, W, 2), aux

    return run


def save_film_checkpoint(path: str, film, passes_done: int, seed: int):
    """The film state after passes_done passes, as the JAX package writes
    it (npz: rgb, weight, passes, seed), so either package resumes it."""
    np.savez(path, rgb=film.rgb.cpu().numpy(), weight=film.weight.cpu().numpy(),
             passes=passes_done, seed=seed)


def load_film_checkpoint(path: str, device="cuda"):
    """-> (Film on device, passes done, seed)."""
    z = np.load(path)
    film = filmlib.Film(rgb=torch.as_tensor(z["rgb"], device=device),
                        weight=torch.as_tensor(z["weight"], device=device))
    return film, int(z["passes"]), int(z["seed"])


def render(sd, spp: int = None, seed: int = 0, max_wave: int = 1 << 16,
           accel: str = None, compact: bool = False, device="cuda",
           cluster_maxc: int = None, checkpoint: str = None,
           checkpoint_every: int = 0, report=None, prebuilt=None):
    """Full render -> (image (H,W,3) np.ndarray, stats dict).

    compact: the compacted-wavefront loop with the bench schedule
    (1, 1, .5, .25, .25, .125).  Waves are cut to about max_wave rays.
    checkpoint: a film checkpoint file, resumed from when it exists (its
    seed must be this render's) and written every checkpoint_every
    passes.  report(passes_done, spp, film) is called after each pass.
    For ``bdpt`` the stats also carry "splat", the light-tracing film
    (H,W,3) that the image includes.
    prebuilt: (scene, cam) of ``build(sd, device, ...)`` with what the
    resolved accel needs (the cluster pack, the kd-tree), to render
    without building them again; a scene without it raises."""
    device = torch.device(device)
    cfg = make_integrator_config(sd, accel=accel, device=device)
    kind = sd.integrator.kind
    if kind in ("mlt", "sppm"):
        # Metropolis and photon mapping have their own drivers; spp, when
        # given, sets their mutations per pixel or iterations, at least 4
        if kind == "mlt":
            from . import mlt as mltlib
            mpp = (sd.integrator.mutations_per_pixel if spp is None
                   else max(spp, 4))
            img, st = mltlib.render_mlt(sd, mutations_per_pixel=mpp, seed=seed,
                                        device=device, accel=cfg.accel,
                                        prebuilt=prebuilt)
            if report is not None:
                report(1, 1, None)
            return img, st
        from . import sppm as sppmlib
        n_it = sd.integrator.sppm_iterations if spp is None else max(spp, 4)
        return sppmlib.render_sppm(sd, n_iterations=n_it, seed=seed,
                                   device=device, report=report,
                                   prebuilt=prebuilt)
    if compact:
        cfg = cfg.replace(compact_schedule=COMPACT_SCHEDULE)
    if cluster_maxc is not None:
        cfg = cfg.replace(cluster_maxc=cluster_maxc)
    if prebuilt is None:
        scene, cam = build(sd, device, with_clusters=cfg.accel == "clusters",
                           with_kdtree=cfg.accel == "kdtree")
    else:
        scene, cam = prebuilt
        if cfg.accel == "clusters" and scene.clusters is None:
            raise ValueError("accel 'clusters': the prebuilt scene has no "
                             "cluster pack (build(..., with_clusters=True))")
        if cfg.accel == "kdtree" and not scene.has_kdtree:
            raise ValueError("accel 'kdtree': the prebuilt scene has no "
                             "kd-tree (build(..., with_kdtree=True))")
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
    start_pass = 0
    if checkpoint and os.path.exists(checkpoint):
        film, start_pass, ck_seed = load_film_checkpoint(checkpoint, device)
        if ck_seed != seed:
            raise ValueError("checkpoint was rendered with a different seed")
    fkw = dict(filter_name=sd.film.filter_name, xw=sd.film.filter_xwidth,
               yw=sd.film.filter_ywidth, alpha=sd.film.filter_alpha,
               B=sd.film.filter_b, C=sd.film.filter_c, tau=sd.film.filter_tau)
    ray_parts = []
    splat = None
    t0 = time.time()
    for p in range(start_pass, spp):
        Ls, Js = [], []
        with statslib.stage("render/pass", sync=Ls):
            for row0 in range(0, H, CH):
                L, jitter, aux = run(scene, cam, key, p, row0)
                Ls.append(L)
                Js.append(jitter)
                ray_parts.append(aux["rays"])
                if "splat" in aux:
                    splat = aux["splat"] if splat is None else splat + aux["splat"]
        # (a stage's sync waits for all of its device's work, this add too)
        with statslib.stage("render/film_add", sync=Ls):
            film = filmlib.add_sample_image(film, torch.cat(Ls), torch.cat(Js),
                                            **fkw)
        if checkpoint and checkpoint_every and (p + 1) % checkpoint_every == 0:
            save_film_checkpoint(checkpoint, film, p + 1, seed)
        if report is not None:
            report(p + 1, spp, film)
    img = filmlib.resolve(film)
    extra = {}
    if splat is not None:
        # the light-tracing splats, scaled by 1/spp (film.cpp WriteImage)
        splat_img = splat[:H * W].reshape(H, W, 3) / spp
        img = img + splat_img
        extra["splat"] = splat_img.cpu().numpy()
    img = img.cpu().numpy()
    total_rays = int(torch.stack(ray_parts).sum()) if ray_parts else 0
    if statslib.enabled():
        statslib.add_counter("rays/total", total_rays)
        statslib.add_counter("pixels x passes", (spp - start_pass) * H * W)
    dt = time.time() - t0
    return img, dict(seconds=dt, rays=total_rays,
                     mrays_per_s=total_rays / max(dt, 1e-9) / 1e6, **extra)
