"""The IILE / IISPT integrator: neural indirect lighting from hemispherical
probes plus a progressive direct pass (port of ``integrators/iispt.py``;
the reference's IISPTIntegrator::render_normal_2 and IisptRenderRunner).

A task of the precomputed schedule (``schedule.py``) places an 11 x 11
grid of probes on the first non-specular surface seen through its
pixels, renders each probe's hemispherical G-buffer (``probes.py``),
turns it into an indirect radiance map with IISPTNet, and estimates each
pixel of the task's square by hemisphere MIS over the maps of its four
neighbouring probes (iisptrenderrunner.cpp sample_hemisphere /
estimate_direct, with its constants: lightPdf = 1/6.28, BSDF_RATIO =
0.4394, EM_RATIO = 1.098, 16 attempts per neighbour, the sin(theta) map
Jacobian).  Pixel estimates are scatter-added into a flat film and
averaged; the direct light comes from progressive 1-spp passes of the
path integrator with direct_only and nee_all, and the two are summed
(iisptfilmmonitor.cpp).

Everything runs eagerly on the caller's device; there are no caches.

With the tracer on (``utils/stats.py``), ``iile/task`` spans each task
around ``iile/probes`` (the probes' specular chase and G-buffer trace),
``iile/cnn``, and ``iile/chase`` and ``iile/mis`` of each pixel chunk;
``iile/direct`` spans each direct pass and ``iile/merge`` each task's
scatter into the film and the final resolve.  The counters ``iile/tasks``,
``iile/probes``, ``iile/cnn_probes``, ``iile/probe_rays``,
``iile/pixel_chunks``, ``iile/chase_steps`` and ``iile/mis_slots`` are
host integers counted from the shapes, without a sync.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from ..models import iisptnet
from ..models import transforms as nnx
from ..models import weights as weightlib
from ..ops import bsdf as bsdflib
from ..ops import camera as camlib
from ..ops import film as filmlib
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..ops import threefry
from ..utils import stats as statslib
from ..utils import vecmath as vm
from . import path as pathlib_
from . import probes as probelib
from . import render as renderlib
from . import schedule as schedlib

HEMISPHERIC_IMPORTANCE_SAMPLES = 16   # (iisptrenderrunner.h:33)
LIGHT_PDF = 1.0 / 6.28                # (iisptrenderrunner.cpp:31)
BSDF_RATIO = 0.4394                   # (iisptrenderrunner.cpp:33)
EM_RATIO = 1.098                      # (iisptrenderrunner.cpp:34)
PIXEL_CHUNK = 65536
# a task's pixels go in chunks of the least of these that holds them all
# (the largest otherwise): the reference's ladder, so that the random
# streams, keyed by shape, are the same
CHUNK_LADDER = (8192, 16384, 32768, PIXEL_CHUNK)
DIRECT_COMPACT_SCHEDULE = (1.0, 0.5, 0.25, 0.25)


def _no_span(name):
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the probe grid and the hemisphere maps
# ---------------------------------------------------------------------------

def task_probe_coords(x0: int, y0: int, ts: int, width: int, height: int,
                      device=None):
    """(G+1)^2 probe pixel coordinates (int64) of a task anchored at (x0,
    y0) with tile size ts: multiples of ts, clamped to the task's and the
    image's last pixel (iisptrenderrunner.cpp:380-420)."""
    G = schedlib.NUMBER_TILES + 1
    i = torch.arange(G, device=device)
    xs = torch.clamp(x0 + i * ts, max=min(x0 + schedlib.NUMBER_TILES * ts, width) - 1)
    ys = torch.clamp(y0 + i * ts, max=min(y0 + schedlib.NUMBER_TILES * ts, height) - 1)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)


def _map_lookup_jacobian(R, probe_id, x, y, hemi_size: int):
    """R (P,H,W,3) -> R[probe, y, x] * sin(pi (y + .5) / H)
    (intensityfilm.cpp get_camera_coord_jacobian)."""
    v = R[probe_id.long(), y.long(), x.long()]
    theta = math.pi * (y.to(torch.float32) + 0.5) / hemi_size
    return v * torch.sin(theta)[..., None]


def _pixel_to_dir(x, y, right, up, look, hemi_size: int):
    """Probe pixel -> world direction (hemispheric.cpp:89-105)."""
    theta = math.pi * (y.to(torch.float32) + 0.5) / hemi_size
    phi = math.pi * (x.to(torch.float32) + 0.5) / hemi_size
    st = torch.sin(theta)
    dc = torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)],
                     dim=-1)
    return dc[..., 0:1] * right + dc[..., 1:2] * up + dc[..., 2:3] * look


def probe_radiance(net, gb: probelib.ProbeGBuffer, probe_valid):
    """The probes' G-buffers -> indirect radiance maps (P,H,W,3) through
    IISPTNet in fp32; invalid probes give zero maps."""
    x_in, aux = nnx.probe_to_network_input(gb.intensity, gb.normals, gb.distance)
    with torch.no_grad(), iisptnet.fp32_convolutions(x_in.device):
        y = net(x_in)
    R = nnx.network_output_to_radiance(y, aux)
    return torch.where(probe_valid[:, None, None, None], R, torch.zeros_like(R))


# ---------------------------------------------------------------------------
# per-pixel hemisphere MIS
# ---------------------------------------------------------------------------

def neighbour_weights(cam, n_px, cam_valid_n, cam_look_n, cam_orig_n, fx, fy,
                      ff_p, ff_n, ts: int):
    """Each pixel's selection probabilities of its 4 neighbour probes (Np,
    4) (compute_fpixel_weights :961-1037): n_px (Np,4,2) the probes'
    pixels, cam_valid_n, cam_look_n, cam_orig_n their validity, look and
    origin; fx, fy the pixels; ff_p, ff_n their first diffuse hit."""
    fpix = torch.stack([fx, fy], dim=-1).to(torch.float32)[:, None, :]
    pdist = torch.sqrt(torch.sum((fpix - n_px) ** 2, dim=-1))
    wdpos = torch.clamp(pdist / float(ts), 0.0, 1.0)
    ndot = torch.sum(ff_n[:, None, :] * cam_look_n, dim=-1)
    zero = torch.zeros_like(ndot)
    wdnor = torch.where(cam_valid_n, torch.where(ndot < 0.0, 1.0, 1.0 - ndot),
                        zero)
    cam_o = camlib.camera_position(cam)
    d_isect = torch.sqrt(torch.sum((ff_p - cam_o) ** 2, dim=-1))
    d_probe = torch.sqrt(torch.sum((cam_orig_n - cam_o) ** 2, dim=-1))
    rel_err = torch.abs(d_isect[:, None] - d_probe) / torch.clamp(
        d_isect[:, None], min=1e-10)
    wdd = torch.where(cam_valid_n & (d_isect[:, None] >= 1e-10),
                      torch.clamp(1.0 - rel_err, 0.0, 1.0), zero)
    wod = wdpos * wdnor + wdpos * wdd + wdpos
    w_raw = torch.clamp(2.0 - wod, min=0.0) + 0.001
    return w_raw / torch.clamp(torch.sum(w_raw, dim=-1, keepdim=True),
                               min=1e-12)


def _mis_stage(scene, cam, R, probe_valid, cam_look, cam_orig, right, up,
               look, coords_f, n_ids, fx, fy, in_img, ff_found, ff_beta,
               ff_p, ff_n, ff_wo, ff_mat, ff_uv, key, ts: int, hemi_size: int):
    """Hemisphere MIS for a chunk of Np pixels over their 4 neighbour
    probes, 16 attempts each: slots of shape (Np, 4, 16).  Returns (rgb
    (Np,3), valid (Np,))."""
    Np = fx.shape[0]
    S = HEMISPHERIC_IMPORTANCE_SAMPLES
    dev = fx.device
    px_valid = in_img & ff_found & (vm.luminance(ff_beta) > 0.0)

    n_px = coords_f[n_ids]                          # (Np, 4, 2)
    cam_valid_n = probe_valid[n_ids]                # (Np, 4)
    cam_look_n = cam_look[n_ids]                    # (Np, 4, 3)
    cam_orig_n = cam_orig[n_ids]

    w_prob = neighbour_weights(cam, n_px, cam_valid_n, cam_look_n, cam_orig_n,
                               fx, fy, ff_p, ff_n, ts)

    # ---- shading data, broadcast over the slots (views, no copies) ----
    params = bsdflib.gather_params(scene, torch.clamp(ff_mat, min=0), uv=ff_uv,
                                   p=ff_p)
    ns = ff_n
    t_f, b_f = vm.coordinate_system(ns)
    wo_l = vm.to_local(ff_wo, t_f, b_f, ns)
    slots = (Np, 4, S)
    params_b = bsdflib.BsdfParams(**{
        f: (v if not torch.is_tensor(v)
            else v[:, None, None].expand(slots) if v.ndim == 1
            else v[:, None, None, :].expand(*slots, v.shape[-1]))
        for f, v in vars(params).items()})
    frame = lambda v: v[:, None, None, :].expand(*slots, 3)
    t_b, b_b, n_b, wo_b = frame(t_f), frame(b_f), frame(ns), frame(wo_l)

    # ---- the slots' samples ----
    u_sel = smplr.uniform(smplr.wave_key(key, 4, 0, smplr.DIM_HEMI), slots, dev)
    selected = u_sel < w_prob[:, :, None]
    del u_sel
    u_xy = smplr.uniform(smplr.wave_key(key, 4, 1, smplr.DIM_HEMI),
                         (*slots, 2), dev)
    rx = torch.clamp((u_xy[..., 0] * hemi_size).to(torch.int32), max=hemi_size - 1)
    ry = torch.clamp((u_xy[..., 1] * hemi_size).to(torch.int32), max=hemi_size - 1)
    del u_xy
    u_bs = smplr.uniform(smplr.wave_key(key, 4, 2, smplr.DIM_BSDF_DIR),
                         (*slots, 2), dev)
    u_bl = smplr.uniform(smplr.wave_key(key, 4, 3, smplr.DIM_BSDF_LOBE),
                         slots, dev)
    probe_ids = n_ids[:, :, None].expand(slots)
    pr, pu, pl = right[probe_ids], up[probe_ids], look[probe_ids]

    # ---- strategy 1: sample the probe's map ----
    Li1 = _map_lookup_jacobian(R, probe_ids, rx, ry, hemi_size)
    wi1_l = vm.to_local(_pixel_to_dir(rx, ry, pr, pu, pl, hemi_size),
                        t_b, b_b, n_b)
    del rx, ry
    f1, pdf1 = bsdflib.evaluate(params_b, wo_b, wi1_l)
    cos1 = torch.abs(wi1_l[..., 2])
    del wi1_l
    w1 = smp.power_heuristic(1.0, LIGHT_PDF, 1.0, pdf1)
    c1 = EM_RATIO * f1 * Li1 * (cos1 * w1 / LIGHT_PDF)[..., None]
    c1 = torch.where((vm.luminance(Li1) > 0.0)[..., None], c1,
                     torch.zeros_like(c1))
    del f1, pdf1, cos1, w1, Li1

    # ---- strategy 2: sample the BSDF, look the direction up in the map ----
    bs = bsdflib.sample(params_b, wo_b, u_bl, u_bs)
    del u_bl, u_bs
    wi2_w = vm.to_world(bs.wi, t_b, b_b, n_b)
    x2, y2, ok2 = camlib.hemi_dir_to_pixel(wi2_w, pr, pu, pl, hemi_size)
    del wi2_w, pr, pu, pl
    Li2 = _map_lookup_jacobian(R, probe_ids, torch.clamp(x2, 0, hemi_size - 1),
                               torch.clamp(y2, 0, hemi_size - 1), hemi_size)
    Li2 = torch.where(ok2[..., None], Li2, torch.zeros_like(Li2))
    del x2, y2, ok2
    cos2 = torch.abs(bs.wi[..., 2])
    w2 = torch.where(bs.is_specular, 1.0,
                     smp.power_heuristic(1.0, bs.pdf, 1.0, LIGHT_PDF))
    c2 = BSDF_RATIO * bs.f * Li2 * (cos2 * w2 / torch.clamp(bs.pdf, min=1e-12)
                                    )[..., None]
    c2 = torch.where((bs.valid & (vm.luminance(Li2) > 0.0))[..., None], c2,
                     torch.zeros_like(c2))
    del bs, Li2, cos2, w2

    contrib = torch.where(selected[..., None], c1 + c2, torch.zeros_like(c1))
    del c1, c2
    taken = torch.sum(selected, dim=(1, 2))
    Lh = torch.sum(contrib, dim=(1, 2)) / torch.clamp(taken, min=1)[:, None].to(
        torch.float32)
    Lh = torch.where((taken > 0)[:, None], Lh, torch.zeros_like(Lh))
    rgb = ff_beta * Lh
    rgb = torch.where(torch.isfinite(rgb), rgb, torch.zeros_like(rgb))
    return torch.where(px_valid[:, None], rgb, torch.zeros_like(rgb)), px_valid


# ---------------------------------------------------------------------------
# one task of the schedule
# ---------------------------------------------------------------------------

def run_task(scene, cam, sd, net, key, task, hemi_size: int = 32,
             accel: str = "bvh", span=_no_span):
    """One schedule task: probe anchors -> probe G-buffers -> IISPTNet ->
    per-pixel MIS over the task's in-image rectangle, in chunks.  Returns
    (flat pixel index (n,) (W*H for padding lanes), rgb (n,3), valid (n,)).
    span(name) is a context manager around each stage ("probes", "cnn",
    "chase", "mis"), for timing."""
    W, H = sd.film.x_resolution, sd.film.y_resolution
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    dev = cam.cam_to_world.device
    G = schedlib.NUMBER_TILES + 1
    ts = task.tilesize
    task_size = schedlib.NUMBER_TILES * ts

    with span("probes"), statslib.stage("iile/probes"):
        coords = task_probe_coords(task.x0, task.y0, ts, W, H, dev)
        o, d = _probe_rays(cam, key, coords, cam_kind)
        fi = probelib.find_first_nonspecular(scene, o, d, key, accel=accel)
        probe_valid = fi["found"] & (vm.luminance(fi["beta"]) > 0.0)
        gb = probelib.render_probes(scene, fi["p"], fi["n"], key, hemi_size,
                                    accel=accel)
    with span("cnn"), statslib.stage("iile/cnn"):
        R = probe_radiance(net, gb, probe_valid)
    if statslib.enabled():
        P = coords.shape[0]
        statslib.add_counter("iile/probes", P)
        statslib.add_counter("iile/cnn_probes", P)
        statslib.add_counter("iile/probe_rays", P * hemi_size * hemi_size)

    coords_f = coords.to(torch.float32)
    x1 = min(task.x0 + task_size, W)
    y1 = min(task.y0 + task_size, H)
    wx = max(x1 - task.x0, 1)
    wy = max(y1 - task.y0, 1)
    npix = wx * wy
    chunk = next(c for c in CHUNK_LADDER if c >= min(npix, PIXEL_CHUNK))
    idx_all, rgb_all, val_all = [], [], []
    for c0 in range(0, npix, chunk):
        if statslib.enabled():
            statslib.add_counter("iile/pixel_chunks", 1)
            statslib.add_counter("iile/chase_steps", probelib.MAX_CHASE)
            statslib.add_counter("iile/mis_slots",
                                 chunk * 4 * HEMISPHERIC_IMPORTANCE_SAMPLES)
        with span("chase"), statslib.stage("iile/chase"):
            li = torch.arange(c0, c0 + chunk, device=dev)
            lx = li % wx
            ly = torch.clamp(li // wx, max=wy - 1)
            fx = task.x0 + lx
            fy = task.y0 + ly
            in_img = (fx < x1) & (fy < y1) & (li < npix)
            fo, fd = _pixel_rays(cam, threefry.fold_in(key, 7 + c0), fx, fy,
                                 cam_kind)
            ff = probelib.find_first_nonspecular(
                scene, fo, fd, threefry.fold_in(key, 8 + c0), accel=accel)
        with span("mis"), statslib.stage("iile/mis"):
            gi = torch.clamp(lx // ts, 0, G - 2)
            gj = torch.clamp(ly // ts, 0, G - 2)
            n_ids = torch.stack([gj * G + gi,             # S (ref ordering,
                                 (gj + 1) * G + gi + 1,   # E  iisptrenderrunner
                                 gj * G + gi + 1,         # R  .cpp:434)
                                 (gj + 1) * G + gi], dim=-1)  # B
            rgb, valid = _mis_stage(
                scene, cam, R, probe_valid, gb.look, gb.origin, gb.right,
                gb.up, gb.look, coords_f, n_ids, fx, fy, in_img,
                ff["found"], ff["beta"], ff["p"], ff["n"], ff["wo"],
                ff["mat"], ff["uv"], threefry.fold_in(key, 9 + c0), ts,
                hemi_size)
        idx_all.append(torch.where(in_img, fy * W + fx, W * H))
        rgb_all.append(rgb)
        val_all.append(valid)
    return torch.cat(idx_all), torch.cat(rgb_all), torch.cat(val_all)


def _probe_rays(cam, key, coords, cam_kind: int):
    """Camera rays through the probe pixels, jittered (stream: pass 2)."""
    kj = smplr.wave_key(key, 2, 0, smplr.DIM_PIXEL_JITTER)
    jit = smplr.uniform(kj, tuple(coords.shape), coords.device)
    return camlib.generate_rays(cam, coords.to(torch.float32) + jit,
                                kind=cam_kind)


def _pixel_rays(cam, key, fx, fy, cam_kind: int):
    """Camera rays through the chunk's pixels, jittered (stream: pass 3)."""
    kj = smplr.wave_key(key, 3, 0, smplr.DIM_PIXEL_JITTER)
    jit = smplr.uniform(kj, (fx.shape[0], 2), fx.device)
    pf = torch.stack([fx, fy], dim=-1).to(torch.float32) + jit
    return camlib.generate_rays(cam, pf, kind=cam_kind)


# ---------------------------------------------------------------------------
# the direct component
# ---------------------------------------------------------------------------

def direct_passes(sd, scene, cam, dkey, direct_samples: int, accel: str,
                  device, report=None):
    """IILE's direct light: ``direct_samples`` progressive 1-spp passes of
    the path integrator with direct_only and nee_all (compacted on
    ``clusters``) -> (H,W,3) numpy image.  report("direct", done, total)
    is called after each pass."""
    H, W = sd.film.y_resolution, sd.film.x_resolution
    dcfg = pathlib_.PathConfig(
        max_depth=sd.integrator.max_depth, nee_all=True,
        direct_only=True, accel=accel,
        # direct-only paths end after one non-specular bounce: the
        # compacted loop shrinks the wave fast
        compact_schedule=DIRECT_COMPACT_SCHEDULE if accel == "clusters" else ())
    run = renderlib.render_pass_fn(sd, dcfg, device)
    film = filmlib.new_film(H, W, device)
    for p in range(direct_samples):
        with statslib.stage("iile/direct"):
            L, jitter, _ = run(scene, cam, dkey, p)
            film = filmlib.add_sample_image(film, L, jitter)
        if report is not None:
            report("direct", p + 1, direct_samples)
    with statslib.stage("iile/merge"):
        img = filmlib.resolve(film)
        with statslib.sync_point("iile_direct_image"):
            return img.cpu().numpy()


# ---------------------------------------------------------------------------
# the full IILE render
# ---------------------------------------------------------------------------

def render_iile(sd, weights: str = None, net=None, seed: int = 0,
                indirect_tasks: int = 16, direct_samples: int = 16,
                hemi_size: int = 32, report=None, accel: str = None,
                device="cuda", span=_no_span, prebuilt=None):
    """IILE render of a scene description (iispt.cpp render_normal_2) on
    ``device`` (the card unless the caller asks for the CPU).

    weights: an IISPTNet npz (default: the committed pretrained model; a
    missing file raises).  net: a trained net instead, an ``IISPTNet``
    (switched to eval mode and moved to ``device``) or flax-style
    variables {"params", "batch_stats"} (numpy trees, as
    ``ml/train.py::load_checkpoint`` returns them).  accel None:
    ``clusters`` on CUDA, ``bvh`` on the CPU, as ``make_integrator_config``
    resolves it.  report(phase, done,
    total) is called after each indirect task and direct pass; span is
    passed to ``run_task``.  prebuilt: (scene, cam) of
    ``render.build(sd, device, ...)`` with what the resolved accel needs,
    to render without building them again (the same images as a call
    that builds them); a scene without it raises.  Returns (combined,
    direct, indirect) (H,W,3) numpy images and a stats dict."""
    device = torch.device(device)
    accel = renderlib.resolve_accel(sd, accel, device)
    if net is None:
        net = weightlib.load_iisptnet(weights, device)
    elif isinstance(net, dict):
        net = weightlib.iisptnet_from_flax(net).to(device)
    else:
        net = net.eval().to(device)
    scene, cam = renderlib.scene_and_camera(sd, accel, device, prebuilt)
    W, H = sd.film.x_resolution, sd.film.y_resolution
    key = threefry.prng_key(seed)

    # ---------- indirect ----------
    t0 = time.time()
    tasks = schedlib.compute_schedule(W, H, indirect_tasks)
    ind_rgb = torch.zeros((W * H + 1, 3), dtype=torch.float32, device=device)
    ind_cnt = torch.zeros((W * H + 1,), dtype=torch.float32, device=device)
    for task in tasks:
        tkey = threefry.fold_in(key, 1000 + task.task_number)
        if statslib.enabled():
            statslib.add_counter("iile/tasks", 1)
        with statslib.stage("iile/task"):
            idx, rgb, valid = run_task(scene, cam, sd, net, tkey, task,
                                       hemi_size=hemi_size, accel=accel, span=span)
        with statslib.stage("iile/merge"):
            ind_rgb.index_add_(0, idx, rgb)
            ind_cnt.index_add_(0, idx, valid.to(torch.float32))
        if report is not None:
            report("indirect", task.task_number + 1, indirect_tasks)
    with statslib.stage("iile/merge"):
        ind_img = (ind_rgb[:W * H] / torch.clamp(ind_cnt[:W * H, None], min=1.0)
                   ).reshape(H, W, 3)
        with statslib.sync_point("iile_indirect_image"):
            ind_img = ind_img.cpu().numpy()
    t_ind = time.time() - t0

    # ---------- direct: progressive 1-spp passes ----------
    t0 = time.time()
    dir_img = direct_passes(sd, scene, cam, threefry.fold_in(key, 5000),
                            direct_samples, accel, device, report)
    t_dir = time.time() - t0

    # ---------- merge (iisptfilmmonitor.cpp:231-276) ----------
    return (dir_img + ind_img, dir_img, ind_img,
            dict(seconds=t_ind + t_dir, indirect_seconds=t_ind,
                 direct_seconds=t_dir, tasks=len(tasks), accel=accel))
