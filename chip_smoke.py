"""End-to-end smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (one line each):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build the three CUDA sources from pbrt_v3_iile_tpu_torch/csrc (K1, K2
     with its motion variant, K3), one nvcc each, in parallel, printing
     ptxas's registers, shared memory and spills per kernel;
  3. build the device scene of scenes/atrium.pbrt on the GPU (with the
     BVH kernel's 4-wide nodes and the kd-tree);
  4. the BVH kernel (K2, 4-wide) against its plain version in its own
     order (bvh_traverse_wide_plain: t, prim and barycentrics identical on
     every ray) and against the binary BVH walker of the CPU path (prims
     on >= 99.9%, t and barycentrics within the tolerances below, with the
     rays that differ counted), on two 65,536-ray waves of the 512^2 film
     (primary rays and one diffuse bounce from their hits), closest-hit,
     and on the bounce and a shadow wave, any-hit;
  5. the cluster kernel (K1: cull, candidate order and traversal in one
     kernel) against its plain version (the torch cull, candidate tables
     and a dense evaluation) on the same waves: n_cand per group, prim on
     every ray and t bit for bit, any-hit validity; the whole cluster
     traversal against K2; then with 8-candidate lists: K1 against its
     plain version, and the whole traversal with cluster_maxc=8 so that
     the overflow groups go through K2;
  6. the main paths through render(): atrium 128^2, 64 spp, seed 3, the
     default CUDA config (clusters), plain and compacted, then compacted
     with accel="bvh", each held against the reference C++ renderer's
     image with the atrium-path tolerances of tests/test_oracle_parity.py;
     with clusters also one pass with cluster_maxc=8 (the forced overflow
     path).  Kernel launch counts and the calls of the torch cull
     (per_ray_cull, which must make none) are read around each path: the
     clusters path must launch both kernels, the bvh path K2 and not K1;
  7. IILE (integrators/iispt.py::render_iile, the pretrained IISPTNet),
     before any profiler session: (a) atrium 128^2, accel "bvh", 2
     indirect tasks, 4 direct passes, 32^2 hemispheres, seed 0, held
     against the JAX package's CPU render of the same settings
     (tests/golden/iile_atrium128_bvh_t2_d4_s0.npz, made by
     tools/make_iile_golden.py): each of combined, direct and indirect
     within 1% globally, 2% in each horizontal third and 3% blurred
     relative L1, with K2 launched and K1 not; then two controls read
     against the same tolerances and printed, not held: the same render
     with TF32 in the U-Net's convolutions, and with seed 1; (b) the
     directlighting integrator at 128^2, 64 spp, seed 3, on clusters, against the
     reference C++ renderer's image with the atrium-direct tolerances of
     tests/test_oracle_parity.py; (c) the default CUDA configuration
     (clusters) at the settings of (a): the combined image against the
     same golden at the oracle's atrium-path tolerances, direct and
     indirect readings printed, K1 launched; (c') IILE's direct pass
     alone (iispt.direct_passes) at 128^2, 64 passes, seed 3, compacted on
     clusters and uncompacted on bvh, each against the C++ direct image
     at the atrium-direct tolerances;
     (d) measured, no threshold:
     the full-width render, atrium 512^2, 16 tasks of 121 probes of 32^2,
     16 direct passes, on clusters: wall seconds of the indirect and
     direct phases, per task the probe stage, the CNN, the specular chase
     and the MIS stage by CUDA events, kernel launches per task, the
     device memory peak, the PSNR against the 320-spp reference
     (tests/golden/atrium_gt_oracle_path320_512.npz), and the U-Net alone
     on one task's 121 probes by CUDA events against its bound;
  9. training (ml/, run after phase 7 and before phase 8's profiler
     sessions): (a) the port's generate_examples on scenes/interior_v1.pbrt
     (16 probes of 32^2, 4 ground-truth samples, seed 0) against the JAX
     package's (tests/golden/train_interior_v1_bvh_h32_g4_s4_s0.npz, made
     by tools/make_train_golden.py): valid identical, each of p, d, n and
     z over the valid probes within the IILE tolerances of phase 7 on
     bvh (K2 launched, K1 not) and within the atrium-path ones on
     clusters (K1 launched); (b) measured: 196 probes at gt_spp 32 on
     clusters, probe renders a second, launches, finite maps; (c) the
     full-width train step (K = 64, batch 32, from the pretrained
     weights, 3 Adam steps on batches of (b)) on the card and on the CPU,
     in fp32 (losses within 1e-4 relative, the running statistics
     within 1e-3 of each tensor's max; the gradients and parameters
     printed) and in fp64 (the losses, and the first step's gradients and
     every parameter and running statistic within 1e-3 of its tensor's
     max: in fp32 the bottleneck's weight gradients cancel heavily, so
     the devices' summation orders show, and Adam turns any gradient
     difference into a step of lr); (d) 300 steps from a
     fresh flax-style initialization, the last 20 losses' mean below 0.9
     times the first 20's, the step's ms by CUDA events against its
     bound, steps and examples a second, the memory peak; (e) the npz,
     pickle and torch.save checkpoints reloaded: the eval-mode net's
     output on 121 probes identical (the npz against the net rounded to
     float16), then the 128^2 IILE render of (a) of phase 7 with the
     trained net, its PSNR beside the pretrained net's; (f) the
     evaluation statistics of the pretrained net on 64 held-out atrium
     probes, printed;
  10. scenes as pbrt-v3 writes them (run after phase 9 and before phase
     8's profiler sessions): (a) atrium with its Sampler line removed
     (pbrt's default, halton) at 128^2, 64 spp, seed 3, on clusters,
     then maxmindist (64 pixel samples) at the same settings, each
     against the C++ image at the atrium-path tolerances, K1 launched;
     (b) halton-global, ambientocclusion and whitted on atrium at 128^2,
     16 spp, seed 0, on each accel, against the JAX package's renders of
     the same settings (tests/golden/scenes128_*.npz, made by
     tools/make_scenes_golden.py) at phase 7's tolerances, with K1 and
     not K2 launched on clusters and K2 and not K1 on bvh; (c) the same
     for scenes/atrium_features.pbrt (procedural textures, goniometric
     and projection lights, no Sampler line) and a ptex scene; (d) atrium
     128^2 checkpointed after 4 passes and resumed to 8, identical to
     the unbroken 8-pass render; (e) measured, no threshold: atrium
     512^2, three passes each of halton, ambientocclusion and whitted
     on clusters (ms a pass, Mrays/s as path.py counts rays, launches a
     pass) and the host seconds of the MaxMinDist search at 16 spp;
  11. materials and transport (run after phase 10 and before phase 8's
     profiler sessions; its own profiled passes run after phase 8's
     timed passes): (a) on the card, at the JAX tests' own tolerances:
     Beer-Lambert through homogeneous fog (tests/test_media.py's
     ABSORB_SCENE, rtol 0.06) and through a grid medium
     (GRID_ABSORB_SCENE, 5 exp(-1.75), rtol 0.08), the hair white furnace
     unsampled (atol 0.06) and sampled (0.08), a Lambertian Fourier table
     against the same-albedo matte (3% of the mean); (b)
     scenes/atrium_transport.pbrt with only its fog, smoke, kdsubsurface
     vase, hair or Fourier bowl on bvh, and with all of them on each
     accel, at 128^2, 16 spp, seed 0, against the JAX package's renders
     (tests/golden/transport128_*.npz, made by
     tools/make_transport_golden.py) at phase 7's tolerances, the bowl a
     Fourier material, K1 launched on clusters (K2 there only as its
     overflow, at most once a K1 call) and K2 and not K1 on bvh; the
     CLI's --quick volpath render; (c) measured, no
     threshold: atrium_transport at 512^2, the file's depth 6, on
     clusters, with and without its smoke: three passes each (ms,
     Mrays/s as path.py counts rays, the probe rays among them, launches
     a pass, and the traversal calls and launches of the last pass by
     site: closest-hit, shadow, BSSRDF probe, BSSRDF exit shadow), then
     one profiled pass each with the delta- and ratio-tracking loops'
     calls, launches, device and host ms;
  12. cameras and aggregates (run after phase 11 and before phase 8's
     profiler sessions): (a) K2's motion variant against its plain
     version (bvh_traverse_wide_plain with times) on two 65,536-ray waves
     of scenes/atrium_motion.pbrt at 512^2 (primary rays with their
     shutter times, a cosine bounce from their hits), closest-hit and
     any-hit, t, prim and barycentrics identical, and against the
     keyframe-lerping binary walker (phase 4's tolerances); at time 0 on
     atrium against the static K2, identical; K3 against
     intersect_kd_plain on phase 4's atrium waves, identical, and
     against K2 (prims on >= 99.9%); (b) atrium_motion on bvh, atrium
     with ``Accelerator "kdtree"``, and atrium_lens.pbrt (the realistic
     camera) on bvh and on clusters, at 128^2, 16 spp, seed 0, against
     the JAX package's renders (tests/golden/camera128_*.npz, made by
     tools/make_camera_golden.py) at phase 7's tolerances: K2-motion and
     nothing else under motion, K3 and nothing else on kdtree, K1 on
     clusters (K2 only as its overflow), K2 alone on bvh; the CLI's
     ``--accel kdtree --quick`` render of atrium (no Accelerator line)
     not black, with K3 launched; (c) measured, no threshold: 512^2 at
     the file's depth, uncompacted, three passes each of atrium_motion on
     bvh, atrium on kdtree and atrium_lens on clusters (ms, Mrays/s as
     path.py counts rays, launches a pass).  ``--cameras-only`` runs
     phases 1-5 and 12 with the timing of its two kernels, and stops
     without a result line;
  8. timing (printed, no threshold): each kernel and the torch
     candidate tables K1 no longer needs, at the main-path shapes, by
     CUDA events (each plain version on the call of phase 4, 5 or 12
     that holds its kernel to it), with each kernel's bound computed
     from this run's inputs (K3 on atrium's bounce wave, K2-motion on
     atrium_motion's); K2 at every wave of a bvh pass; the atrium 512^2 depth-5 compacted
     pass as bench.py configures it, with each accel, passes in turns, in
     Mrays/s counted as path.py counts rays, the kernel launches per pass,
     and one profiled pass each: device-busy ms and idle share; then the
     first task of the 512^2 IILE render, and last 10 train steps of
     phase 9, each unprofiled and then profiled.
Prints the kernel JSON line, the device line, and as its last line
{"ok": true, "device": {...}}.  Any failure exits non-zero with no result.
Long output (the profiler tables) goes to files in OUT_DIR.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# tolerances (the CPU parity tests use the same ones):
PRIM_AGREE = 0.999   # kernel vs its plain version: same prim on >= 99.9%
T_RTOL = 1e-5        # t error where the prims agree: 1e-5 relative
T_ATOL = 1e-6        # plus 1e-6 absolute (short bounce segments near the
                     # offset origin: torch's 3-term sums round differently)
B_ATOL = 1e-4        # barycentrics where the prims agree
XALG_AGREE = 0.995   # cluster (Pluecker) vs BVH (Moller) traversal: the
                     # two triangle tests differ on rays grazing shared edges
ORACLE = ("atrium_ref_path96_128.npy", 0.015, (0.02, 0.02, 0.02), 0.07)
ORACLE_DIRECT = ("atrium_ref_direct96_128.npy", 0.02, (0.03, 0.025, 0.02), 0.07)
# IILE against the JAX package's render of the same settings and seed:
IILE_GOLDEN = "iile_atrium128_bvh_t2_d4_s0.npz"
IILE_TOL = (0.01, (0.02, 0.02, 0.02), 0.03)
IILE_SMALL = dict(indirect_tasks=2, direct_samples=4, hemi_size=32, seed=0)
IILE_FULL = dict(indirect_tasks=16, direct_samples=16, hemi_size=32, seed=0)
# training: the JAX package's dataset of the same settings, the full-width
# generation and the number of training steps measured
TRAIN_GOLDEN = "train_interior_v1_bvh_h32_g4_s4_s0.npz"
TRAIN_GEN = dict(grid=14, gt_spp=32, hemi=32)
TRAIN_STEPS = 300
# phase 10: the JAX goldens of tools/make_scenes_golden.py, held at the
# IILE gate's tolerances
SCENES_GOLDEN = ("halton_global", "ao", "whitted", "features", "ptex")

# the H100 SXM's published peaks (700 W): fp32 outside the tensor cores,
# and HBM bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per test, counted from the CUDA sources:
CULL_OPS = 28      # K1 slab test: per axis 2 sub, 2 mul, min, max, max, min;
                   # tf scale; 3 compares
PLUCKER_OPS = 50   # K1 triangle: 3 x (6 mul + 5 add), 4 mul + 3 add, 2 add,
                   # 3 sign products and compares, |s| and its compare
                   # (the divide only where the signs agree)
NODE_OPS = 26      # K2 node: 6 sub, 6 mul, 10 min/max, 1 mul, 3 compares
MOLLER_OPS = 53    # K2 triangle: two crosses (18), four dots (20), 3 subs,
                   # 3 scalings, |det| test (2), the divide, 5 compares + 1 add


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def line(tag, **kw):
    print(f"[{tag}] " + json.dumps(kw), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed_once(fn):
    """fn() and its device time in ms by CUDA events: a plain version is
    timed on the call that holds its kernel to it, not called again."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def bound(ops, nbytes):
    """Least time the card could take (ms) and which term sets it."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare_hits(name, ta, pa, tb, pb, b1a=None, b2a=None, b1b=None, b2b=None,
                 agree_min=PRIM_AGREE):
    """prim agreement, and t (and barycentric) error where prims agree."""
    ta, pa, tb, pb = (x.cpu().numpy() for x in (ta, pa, tb, pb))
    same = pa == pb
    frac = float(same.mean())
    both = same & (pa >= 0)
    terr = np.abs(ta - tb)[both]
    trel = float((terr / np.maximum(np.abs(tb[both]), 1e-6)).max()) if both.any() else 0.0
    t_ok = bool((terr <= T_RTOL * np.abs(tb[both]) + T_ATOL).all())
    out = dict(agree=frac, hits=int((pa >= 0).sum()), t_max_rel=trel,
               t_max_abs=float(terr.max()) if both.any() else 0.0)
    check(frac >= agree_min, f"{name}: prim agreement {frac} < {agree_min}")
    check(t_ok or agree_min < PRIM_AGREE,
          f"{name}: t err beyond {T_RTOL} rel + {T_ATOL} abs: {out}")
    if b1a is not None:
        db = max(float(np.abs((b1a - b1b).cpu().numpy()[both]).max(initial=0.0)),
                 float(np.abs((b2a - b2b).cpu().numpy()[both]).max(initial=0.0)))
        out["b_max_abs"] = db
        check(db <= B_ATOL or agree_min < PRIM_AGREE,
              f"{name}: barycentric err {db} > {B_ATOL}")
    line(name, **out)
    return out


def image_check(name, img, ref, gtol, rtols, btol, enforce=True):
    """Global mean, the means of the horizontal thirds and the 4x4-blurred
    relative L1 of img against ref (tests/test_oracle_parity.py's
    criterion); printed with whether they meet the tolerances, held to
    them when enforce.  Returns whether they meet them."""
    g = abs(img.mean() - ref.mean()) / ref.mean()
    res = img.shape[0]
    h = res // 3
    regions, signed, ok_regions = [], [], True
    for (lo, hi), tol in zip(((0, h), (h, 2 * h), (2 * h, res)), rtols):
        m, r = img[lo:hi].mean(), ref[lo:hi].mean()
        signed.append(float((m - r) / max(r, 1e-3)))
        regions.append(abs(signed[-1]))
        ok_regions &= bool(abs(m - r) < tol * max(r, 1e-3))
        check(not enforce or abs(m - r) < tol * max(r, 1e-3),
              f"{name}: rows {lo}:{hi} mean {m} vs reference {r}")
    n = res // 4 * 4
    blur = lambda x: x[:n, :n].reshape(n // 4, 4, n // 4, 4, 3).mean((1, 3))
    bm, br = blur(img), blur(ref)
    rel = float(np.abs(bm - br).mean() / br.mean())
    finite = bool(np.isfinite(img).all())
    ok = finite and ok_regions and bool(g < gtol) and rel < btol
    line(name, mean=float(img.mean()), ref_mean=float(ref.mean()),
         global_rel=float(g), region_rel=regions, region_signed=signed,
         blur_rel_l1=rel,
         finite=finite, within_tolerance=ok, held=enforce)
    check(finite, f"{name}: non-finite pixels")
    check(not enforce or g < gtol, f"{name}: global mean off by {g}")
    check(not enforce or rel < btol, f"{name}: blurred rel L1 {rel}")
    return ok


def oracle_check(name, img, oracle=ORACLE):
    fixture, gtol, rtols, btol = oracle
    ref = np.load(os.path.join(REPO, "tests", "golden", fixture))
    image_check(name, img, ref, gtol, rtols, btol)


class StageTimer:
    """Context manager factory for render_iile's span hook: CUDA events
    around each stage, summed per stage name after a synchronize."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self.events.append((name, a, b))

    def totals_ms(self):
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def run_counted(fn, K1, K2):
    """fn() with every kernel's launch count set to 0 just before it:
    returns its result, its wall seconds and the launches it made (K1,
    K2, K2's motion variant and K3)."""
    from pbrt_v3_iile_tpu_torch.ops import kd_kernel as K3

    K1.LAUNCHES = K2.LAUNCHES = K2.LAUNCHES_MOTION = K3.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, launch_counts(K1, K2, K3)


def psnr(img, ref):
    """PSNR in dB against the reference's peak (scripts/bench_quality.py)."""
    mse = float(np.mean((img.astype(np.float64) - ref) ** 2))
    return 10.0 * np.log10(float(ref.max()) ** 2 / mse)


def iile_phase(dev, scene_path, smi, K1, K2):
    """Phase 7: the IILE gates (a)-(c) and the full-width measurement (d).
    Returns the launch counts of the bvh and clusters renders and per task
    of the full-width one."""
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.models import iisptnet, weights
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    def atrium(res, kind=None):
        sd = apilib.load_scene(scene_path)
        sd.film.x_resolution = sd.film.y_resolution = res
        if kind:
            sd.integrator.kind = kind
        return sd

    counted = lambda fn: run_counted(fn, K1, K2)

    golden = np.load(os.path.join(REPO, "tests", "golden", IILE_GOLDEN))
    gtol, rtols, btol = IILE_TOL
    res = {}
    # (a) bvh against the JAX package's render
    (c, d, i, st), secs, n = counted(lambda: iispt.render_iile(
        atrium(128), accel="bvh", device=dev, **IILE_SMALL))
    for name, img in (("combined", c), ("direct", d), ("indirect", i)):
        image_check(f"iile128_bvh_vs_jax_{name}", img,
                    golden[name].astype(np.float32), gtol, rtols, btol)
    line("iile128_bvh", wall_seconds=secs, launches=n, **st)
    check(n["bvh_traverse"] > 0, "K2 never launched in the bvh IILE render")
    check(n["cluster_traverse"] == 0, "K1 launched in the bvh IILE render")
    res["bvh"] = n
    res["bvh_combined"] = c

    # controls of gate (a), read against its tolerances and not held: the
    # same render with TF32 convolutions in the U-Net, and with seed 1 (an
    # independent realisation of the same estimator)
    @contextlib.contextmanager
    def tf32_convolutions(device):
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev

    fp32_convolutions = iisptnet.fp32_convolutions
    iisptnet.fp32_convolutions = tf32_convolutions
    try:
        tf32_imgs = iispt.render_iile(atrium(128), accel="bvh", device=dev,
                                      **IILE_SMALL)[:3]
    finally:
        iisptnet.fp32_convolutions = fp32_convolutions
    seed1_imgs = iispt.render_iile(atrium(128), accel="bvh", device=dev,
                                   **dict(IILE_SMALL, seed=1))[:3]
    for control, imgs in (("tf32", tf32_imgs), ("seed1", seed1_imgs)):
        passes = [image_check(f"iile128_bvh_{control}_vs_jax_{name}", img,
                              golden[name].astype(np.float32), gtol, rtols,
                              btol, enforce=False)
                  for name, img in zip(("combined", "direct", "indirect"),
                                       imgs)]
        line(f"iile128_bvh_{control}_control", within_tolerance=passes)

    # (b) directlighting against the reference C++ renderer
    (img, st), _, n = counted(lambda: renderlib.render(
        atrium(128, "directlighting"), spp=64, seed=3, device=dev))
    oracle_check("directlighting128", img, ORACLE_DIRECT)
    line("directlighting128_stats", launches=n, **st)
    check(n["cluster_traverse"] > 0, "K1 never launched in directlighting")

    # (c) the default configuration (clusters)
    (c, d, i, st), secs, n = counted(lambda: iispt.render_iile(
        atrium(128), device=dev, **IILE_SMALL))
    check(st["accel"] == "clusters", f"default IILE accel is {st['accel']}")
    _, g_tol, g_rtols, g_btol = ORACLE
    for name, img in (("combined", c), ("direct", d), ("indirect", i)):
        image_check(f"iile128_clusters_vs_jax_{name}", img,
                    golden[name].astype(np.float32), g_tol, g_rtols, g_btol,
                    enforce=name == "combined")
    line("iile128_clusters", wall_seconds=secs, launches=n, **st)
    check(n["cluster_traverse"] > 0, "K1 never launched in the IILE render")
    res["clusters"] = n

    # (c') IILE's direct pass alone at 64 passes against the reference C++
    # renderer's direct image at the atrium-direct tolerances (the direct
    # image of (c) is only printed): compacted on clusters and uncompacted
    # on bvh, the same estimator without the compaction, seed 3 (a second
    # compacted seed read the estimator's own top-third offset, JAX's too:
    # tests/test_torch_path_variants.py holds the pass to the JAX package)
    sd = atrium(128)
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    for accel, seed in (("clusters", 3), ("bvh", 3)):
        dkey = threefry.fold_in(threefry.prng_key(seed), 5000)
        img, secs, n = counted(lambda: iispt.direct_passes(
            sd, scene, cam, dkey, 64, accel, dev))
        name = f"iile128_direct_pass_{accel}_64_s{seed}"
        oracle_check(name, img, ORACLE_DIRECT)
        line(f"{name}_stats", wall_seconds=secs, launches=n)
        k = "cluster_traverse" if accel == "clusters" else "bvh_traverse"
        check(n[k] > 0, f"{k} never launched in {name}")
    del scene, cam

    # (d) the full-width render, measured
    timer = StageTimer()
    per_task = []

    def report(phase, done, total):
        if phase == "indirect":
            per_task.append((K1.LAUNCHES, K2.LAUNCHES))

    torch.cuda.reset_peak_memory_stats()
    (c, d, i, st), secs, n = counted(lambda: iispt.render_iile(
        atrium(512), device=dev, report=report, span=timer, **IILE_FULL))
    peak = torch.cuda.max_memory_allocated()
    stages = timer.totals_ms()
    k1_task = [b[0] - a[0] for a, b in zip([(0, 0)] + per_task, per_task)]
    k2_task = [b[1] - a[1] for a, b in zip([(0, 0)] + per_task, per_task)]
    gt = np.load(os.path.join(REPO, "tests", "golden",
                              "atrium_gt_oracle_path320_512.npz"))["img"]
    gt = gt.astype(np.float64)
    check(all(np.isfinite(x).all() for x in (c, d, i)),
          "non-finite 512^2 IILE image")
    check(c.mean() > 0 and i.mean() > 0, "black 512^2 IILE image")
    n_tasks = st["tasks"]
    line("iile512_full", wall_seconds=secs, indirect_seconds=st["indirect_seconds"],
         direct_seconds=st["direct_seconds"], tasks=n_tasks,
         stage_ms_total=stages,
         stage_ms_per_task={k: v / n_tasks for k, v in stages.items()},
         launches=n, k1_per_task=k1_task, k2_per_task=k2_task,
         max_memory_allocated_gb=peak / 1e9,
         psnr_combined=psnr(c, gt), psnr_direct_only=psnr(d, gt),
         means=[float(c.mean()), float(d.mean()), float(i.mean())],
         gt_mean=float(gt.mean()), power=smi)

    # the U-Net alone on one task's 121 probes (fp32, no TF32), and its bound
    net = weights.load_iisptnet(device=dev)
    x = torch.randn(121, 32, 32, 7, generator=torch.Generator().manual_seed(0)
                    ).to(dev)
    with torch.no_grad(), iisptnet.fp32_convolutions(dev):
        cnn_ms = cuda_ms(lambda: net(x), 20)
    with torch.no_grad():
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(lambda: net(x), 20)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
    flops = 121 * iisptnet.forward_flops(32)
    wbytes = sum(p.numel() * 4 for p in net.parameters())
    cnn_bound, cnn_by = bound(flops, wbytes + x.numel() * 4 + 121 * 32 * 32 * 3 * 4)
    line("iisptnet_121_probes", ms=cnn_ms, tf32_ms=tf32_ms, gflop=flops / 1e9,
         bound_ms=cnn_bound, bound_by=cnn_by, power=smi)
    res["per_task"] = {"cluster_traverse": sum(k1_task) / n_tasks,
                       "bvh_traverse": sum(k2_task) / n_tasks}
    return res


def map_check(name, got, want, gtol, rtols, btol):
    """image_check's readings over probe maps (P, H, W, C), held: the
    global mean, the means of the horizontal thirds of every map and the
    4x4-blurred L1, each relative to the reference's mean |value| (the
    maps of normals and distances are signed)."""
    a, b = got.astype(np.float64), want.astype(np.float64)
    scale = lambda x: max(float(np.abs(x).mean()), 1e-3)
    g = abs(a.mean() - b.mean()) / scale(b)
    H = a.shape[1]
    h = H // 3
    regions = [abs(a[:, lo:hi].mean() - b[:, lo:hi].mean()) / scale(b[:, lo:hi])
               for lo, hi in ((0, h), (h, 2 * h), (2 * h, H))]
    blur = lambda x: x.reshape(x.shape[0], H // 4, 4, x.shape[2] // 4, 4,
                               x.shape[3]).mean((2, 4))
    rel = float(np.abs(blur(a) - blur(b)).mean() / scale(blur(b)))
    finite = bool(np.isfinite(a).all())
    line(name, probes=int(a.shape[0]), global_rel=float(g), region_rel=regions,
         blur_rel_l1=rel, max_abs=float(np.abs(a - b).max()), finite=finite)
    check(finite, f"{name}: non-finite values")
    check(g < gtol, f"{name}: global mean off by {g}")
    for r, tol in zip(regions, rtols):
        check(r < tol, f"{name}: a third's mean off by {r}")
    check(rel < btol, f"{name}: blurred rel L1 {rel}")


def train_phase(dev, smi, K1, K2, atrium, pretrained_img):
    """Phase 9: IISPTNet training.  (a) the dataset gates, (b) full-width
    generation measured, (c) the train step on the card against the same
    code on the CPU, (d) training measured and its loss-decrease gate, (e)
    the checkpoints reloaded and a render with the trained net, (f) the
    evaluation statistics of the pretrained net.  atrium: the 512^2
    atrium's (scene description, device scene, camera).  Returns the
    launch counts of the generation runs."""
    import copy
    import itertools

    from pbrt_v3_iile_tpu_torch.cli import train as clitrain
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ml import dataset as datasetlib
    from pbrt_v3_iile_tpu_torch.ml import evalstats
    from pbrt_v3_iile_tpu_torch.ml import train as trainlib
    from pbrt_v3_iile_tpu_torch.models import iisptnet, weights
    from pbrt_v3_iile_tpu_torch.models import transforms as nnx
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    t_phase = time.time()
    counted = lambda fn: run_counted(fn, K1, K2)
    res = {}

    # (a) the dataset gates against the JAX package's generate_examples
    g = np.load(os.path.join(REPO, "tests", "golden", TRAIN_GOLDEN))
    sd = apilib.load_scene(os.path.join(REPO, "scenes", str(g["scene_file"])))
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    kind = camlib.KIND.get(sd.camera.kind, 0)
    for accel, tol in (("bvh", IILE_TOL), ("clusters", ORACLE[1:])):
        maps, secs, n = counted(lambda: datasetlib.generate_examples(
            scene, cam, kind, threefry.prng_key(int(g["seed"])),
            torch.as_tensor(g["coords"], device=dev),
            hemi_size=int(g["hemi_size"]), gt_spp=int(g["gt_spp"]),
            accel=accel))
        m = {k: v.cpu().numpy() for k, v in maps.items()}
        same = bool(np.array_equal(m["valid"], g["valid"]))
        line(f"train_dataset_{accel}", valid_identical=same,
             valid=int(m["valid"].sum()), probes=int(g["valid"].size),
             wall_seconds=secs, launches=n)
        check(same, f"dataset {accel}: valid differs from the JAX golden")
        for k in "pdnz":
            map_check(f"train_dataset_{accel}_vs_jax_{k}", m[k][g["valid"]],
                      g[k][g["valid"]], *tol)
        if accel == "bvh":
            check(n["bvh_traverse"] > 0 and n["cluster_traverse"] == 0,
                  f"dataset bvh: launches {n}")
        else:
            check(n["cluster_traverse"] > 0, f"dataset clusters: launches {n}")
        res[f"gate_{accel}"] = n

    # (b) full-width generation, measured
    gen = TRAIN_GEN
    coords = clitrain.probe_grid(sd.film.x_resolution, sd.film.y_resolution,
                                 gen["grid"])
    P = coords.shape[0]
    torch.cuda.reset_peak_memory_stats()
    maps, secs, n = counted(lambda: datasetlib.generate_examples(
        scene, cam, kind, threefry.prng_key(1), torch.as_tensor(coords, device=dev),
        hemi_size=gen["hemi"], gt_spp=gen["gt_spp"], accel="clusters"))
    m = {k: v.cpu().numpy() for k, v in maps.items()}
    finite = all(bool(np.isfinite(m[k]).all()) for k in "pdnz")
    raws = [{k: m[k][i] for k in "pdnz"} for i in range(P) if m["valid"][i]]
    renders = P * (1 + gen["gt_spp"])
    line("train_generate_full", scene=str(g["scene_file"]), probes=P,
         valid=len(raws), hemi=gen["hemi"], gt_spp=gen["gt_spp"],
         wall_seconds=secs, probe_renders=renders,
         probe_renders_per_s=renders / secs,
         rays=renders * gen["hemi"] ** 2, launches=n, finite=finite,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         power=smi)
    check(finite, "non-finite maps in the full-width dataset")
    check(n["cluster_traverse"] > 0, "K1 never launched in the generation")
    check(len(raws) >= 3 * trainlib.BATCH_SIZE // 16, "too few valid probes")
    res["generation"] = n

    # (c) the train step at full width, on the card and on the CPU, from the
    # pretrained weights in training mode, on three batches of (b)
    batches = list(itertools.islice(datasetlib.batches_from_raw(
        raws, trainlib.BATCH_SIZE, threefry.prng_key(2)), 3))
    lr = trainlib.LEARNING_RATE
    for dtype in (torch.float32, torch.float64):
        runs = []
        for device in (dev, torch.device("cpu")):
            net = weights.load_iisptnet(device=device).to(dtype)
            step = trainlib.make_train_step(
                net, torch.optim.Adam(net.parameters(), lr=lr))
            losses, grads = [], None
            t0 = time.time()
            for x, y in batches:
                losses.append(float(step(x.to(device, dtype), y.to(device, dtype))))
                if grads is None:
                    grads = {k: p.grad.to("cpu", torch.float64)
                             for k, p in net.named_parameters()}
            tensors = {k: v.to("cpu", torch.float64)
                       for k, v in net.state_dict().items() if v.is_floating_point()}
            runs.append((losses, grads, tensors, time.time() - t0))
        (lg, gg, sg, tg), (lc, gc, sc, tc) = runs
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        grad_rel = {k: rel(gg[k], gc[k]) for k in gc}
        state_rel = {k: rel(sg[k], sc[k]) for k in sc}
        stats_rel = {k: v for k, v in state_rel.items() if ".running_" in k}
        params_rel = {k: v for k, v in state_rel.items() if ".running_" not in k}
        # Adam moves every parameter by about lr a step whatever its
        # gradient's size: the parameters' gap against that movement
        moved = max(float((sg[k] - sc[k]).abs().max()) for k in params_rel) / (3 * lr)
        worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]
        tag = "fp32" if dtype == torch.float32 else "fp64"
        line(f"train_step_card_vs_cpu_{tag}", losses_card=lg, losses_cpu=lc,
             loss_max_rel=loss_rel, grad_step1_max_rel=max(grad_rel.values()),
             grad_worst=worst(grad_rel), running_stats_max_rel=max(stats_rel.values()),
             params_max_rel=max(params_rel.values()), params_worst=worst(params_rel),
             params_gap_over_adam_movement=moved, seconds_card=tg, seconds_cpu=tc)
        check(loss_rel <= 1e-4, f"train step {tag}: losses differ by {loss_rel}")
        check(max(stats_rel.values()) <= 1e-3,
              f"train step {tag}: running statistics {worst(stats_rel)}")
        # in fp32 the gradients and the parameters are printed only: the
        # weight gradients of the bottleneck convolutions are sums that
        # cancel heavily, so each device's algorithm shows (the CPU's fp32
        # against its fp64: 9.3e-4 of the max on conv.6; cuDNN picks
        # FFT-based algorithms for some of them), and Adam then moves a
        # parameter by a whole step of lr whatever its gradient's size
        if dtype == torch.float64:
            check(max(grad_rel.values()) <= 1e-3,
                  f"train step fp64: gradients {worst(grad_rel)}")
            check(max(params_rel.values()) <= 1e-3,
                  f"train step fp64: parameters {worst(params_rel)}")

    # (d) training from a flax-style initialization, measured and gated
    state = trainlib.init_training(torch.Generator().manual_seed(0),
                                   hemi_size=gen["hemi"], device=dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    state, losses = trainlib.train(raws, state, threefry.prng_key(3),
                                   max_epochs=1000, time_budget_s=120.0,
                                   log=None, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    x, y = (t.to(dev) for t in batches[0])
    step_ms = cuda_ms(lambda: state["step"](x, y), 20)
    net = state["net"]
    k = net.k
    flops = (3 * trainlib.BATCH_SIZE * iisptnet.forward_flops(gen["hemi"], k)
             - trainlib.BATCH_SIZE * 2 * gen["hemi"] ** 2 * 9 * 7 * k)
    n_params = sum(p.numel() for p in net.parameters())
    adam_bytes = n_params * 28   # reads p, g, m, v; writes p, m, v (fp32)
    step_bound, step_by = bound(flops, adam_bytes + x.numel() * 4 + y.numel() * 4)
    line("train_full_width", steps=len(losses), wall_seconds=secs,
         steps_per_s=len(losses) / secs,
         examples_per_s=len(losses) * trainlib.BATCH_SIZE / secs,
         examples=len(raws), loss_first20=first, loss_last20=last,
         loss_ratio=last / first, step_ms=step_ms, step_gflop=flops / 1e9,
         step_bound_ms=step_bound, step_bound_by=step_by,
         params=n_params, adam_mbytes=adam_bytes / 1e6,
         adam_bound_ms=adam_bytes / PEAK_BYTES * 1e3,
         max_memory_allocated_gb=peak / 1e9, power=smi)
    check(np.isfinite(losses).all(), "non-finite training loss")
    check(last < 0.9 * first,
          f"training loss did not fall: first 20 {first}, last 20 {last}")
    res["train_step"] = lambda: state["step"](x, y)

    # (e) the checkpoints, each reloaded, against the net in memory on
    # 121 probes of (b)
    ck = os.path.join(REPO, "build", "chip_smoke_train")
    os.makedirs(ck, exist_ok=True)
    paths = {f: os.path.join(ck, f) for f in ("net.npz", "net.ckpt", "state.pt")}
    trainlib.save_pretrained(paths["net.npz"], state)
    trainlib.save_checkpoint(paths["net.ckpt"], state)
    trainlib.save_state(paths["state.pt"], state, step=len(losses))
    t = lambda key: torch.as_tensor(np.stack([r[key] for r in raws[:121]]),
                                    device=dev)
    x121, _ = nnx.probe_to_network_input(t("d"), t("n"), t("z"))

    def infer(n):
        n.eval()
        with torch.no_grad(), iisptnet.fp32_convolutions(dev):
            return n(x121)

    y_mem = infer(net)
    rounded = copy.deepcopy(net)
    with torch.no_grad():
        for v in rounded.state_dict().values():
            if v.is_floating_point():
                v.copy_(v.half().float())
    y_npz = infer(weights.load_iisptnet(paths["net.npz"], device=dev))
    y_pkl = infer(weights.iisptnet_from_flax(
        trainlib.load_checkpoint(paths["net.ckpt"])).to(dev))
    fresh = trainlib.init_training(torch.Generator().manual_seed(9),
                                   hemi_size=gen["hemi"], device=dev)
    fresh, step_count = trainlib.load_state(paths["state.pt"], fresh)
    y_pt = infer(fresh["net"])
    same = dict(torch_save=bool(torch.equal(y_pt, y_mem)),
                pickle=bool(torch.equal(y_pkl, y_mem)),
                npz_vs_float16_rounded=bool(torch.equal(y_npz, infer(rounded))))
    line("train_checkpoints", probes=int(x121.shape[0]), identical=same,
         npz_max_abs_vs_memory=float((y_npz - y_mem).abs().max()),
         y_max=float(y_mem.abs().max()), state_step=step_count,
         bytes={f: os.path.getsize(p) for f, p in paths.items()})
    check(all(same.values()), f"a reloaded checkpoint differs: {same}")
    check(step_count == len(losses), "save_state lost the step count")

    sd128 = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd128.film.x_resolution = sd128.film.y_resolution = 128
    (c, d, i, st), secs, n = counted(lambda: iispt.render_iile(
        sd128, net=net, accel="bvh", device=dev, **IILE_SMALL))
    ref = np.load(os.path.join(REPO, "tests", "golden", ORACLE[0])).astype(np.float64)
    finite = all(bool(np.isfinite(im).all()) for im in (c, d, i))
    line("train_render_atrium128_bvh", wall_seconds=secs, launches=n,
         finite=finite, psnr_trained=psnr(c, ref),
         psnr_pretrained=psnr(pretrained_img, ref),
         means=[float(c.mean()), float(d.mean()), float(i.mean())])
    check(finite, "non-finite image from the trained net")

    # (f) the evaluation statistics of the committed pretrained net on
    # held-out atrium probes
    a_sd, a_scene, a_cam = atrium
    coords = clitrain.probe_grid(a_sd.film.x_resolution, a_sd.film.y_resolution, 8)
    raw, secs, n = counted(lambda: datasetlib.generate_examples(
        a_scene, a_cam, camlib.KIND.get(a_sd.camera.kind, 0), threefry.prng_key(4),
        torch.as_tensor(coords, device=dev), hemi_size=32, gt_spp=16,
        accel="clusters"))
    stats = evalstats.compare_predictions(raw, weights.load_iisptnet(device=dev))
    line("train_evalstats_atrium", probes=int(coords.shape[0]),
         valid=int(raw["valid"].sum()), gt_spp=16, wall_seconds=secs,
         means=stats["means"], p_values=stats["p_values"])
    line("train_phase", wall_seconds=time.time() - t_phase)
    return res


def scene_from_golden(apilib, z):
    """A scenes golden's scene parsed by the port (its Sampler line
    dropped when the golden says so), with the golden's overrides."""
    name = str(z["scene"])
    base = os.path.join(REPO, "scenes")
    if name.endswith(".pbrt"):
        text = open(os.path.join(base, name)).read()
        if bool(z["strip_sampler"]):
            text = re.sub(r"(?m)^Sampler .*\n", "", text)
    else:
        text = name.replace("{repo}", REPO)
    sd = apilib.load_scene_string(text, base)
    for path, value in json.loads(str(z["overrides"])).items():
        obj = sd
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return sd


def scenes_phase(dev, smi, K1, K2):
    """Phase 10: the default sampler, the other samplers, integrators,
    textures and lights of pbrt-v3 scenes (a)-(d), and the 512^2 passes
    measured (e).  Returns the launches a pass of (e)."""
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import lds, threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    t_phase = time.time()
    scenes = os.path.join(REPO, "scenes")
    text = re.sub(r"(?m)^Sampler .*\n", "",
                  open(os.path.join(scenes, "atrium.pbrt")).read())

    def atrium(res):
        sd = apilib.load_scene_string(text, scenes)
        sd.film.x_resolution = sd.film.y_resolution = res
        return sd

    # (a) no Sampler line: halton; then maxmindist; against the C++ image
    sd = atrium(128)
    check(sd.sampler.kind == "halton", f"default sampler {sd.sampler.kind}")
    for kind in ("halton", "maxmindist"):
        sd.sampler.kind = kind
        if kind == "maxmindist":
            sd.sampler.pixel_samples = 64
            t0 = time.time()
            lds._maxmin_matrix(lds.maxmin_m(64))
            line("maxmin_search_m6", host_seconds=time.time() - t0)
        (img, st), secs, launches = run_counted(
            lambda: renderlib.render(sd, spp=64, seed=3, device=dev), K1, K2)
        oracle_check(f"scenes_{kind}128", img)
        line(f"scenes_{kind}128_stats", wall_seconds=secs, launches=launches,
             **st)
        check(launches["cluster_traverse"] > 0, f"{kind}: K1 never launched")

    # (b), (c): against the JAX package's renders, on each accel
    for case in SCENES_GOLDEN:
        z = np.load(os.path.join(REPO, "tests", "golden",
                                 f"scenes128_{case}.npz"))
        for accel in ("clusters", "bvh"):
            sd = scene_from_golden(apilib, z)
            (img, st), secs, launches = run_counted(
                lambda: renderlib.render(sd, spp=int(z["spp"]),
                                         seed=int(z["seed"]), accel=accel,
                                         device=dev), K1, K2)
            image_check(f"scenes_{case}128_{accel}", img, z["img"], *IILE_TOL)
            line(f"scenes_{case}128_{accel}_stats", wall_seconds=secs,
                 launches=launches, **st)
            own, other = (("cluster_traverse", "bvh_traverse")
                          if accel == "clusters"
                          else ("bvh_traverse", "cluster_traverse"))
            check(launches[own] > 0, f"{case} {accel}: {own} never launched")
            check(launches[other] == 0,
                  f"{case} {accel}: {other} launched {launches[other]}")

    # (d) a film checkpoint resumes to the unbroken render exactly
    sd = atrium(128)
    sd.sampler.kind = "sobol"
    ck = os.path.join(REPO, "build", "chip_smoke_film.npz")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    full, _ = renderlib.render(sd, spp=8, seed=0, device=dev)
    renderlib.render(sd, spp=4, seed=0, device=dev, checkpoint=ck,
                     checkpoint_every=4)
    resumed, _ = renderlib.render(sd, spp=8, seed=0, device=dev,
                                  checkpoint=ck, checkpoint_every=4)
    same = bool(np.array_equal(full, resumed))
    line("scenes_film_checkpoint128", identical=same,
         passes=int(np.load(ck)["passes"]))
    check(same, "the resumed render differs from the unbroken one")

    # (e) measured: the 512^2 passes of the new paths on clusters
    key = threefry.prng_key(0)
    per_pass = {}
    for kind in ("halton", "ambientocclusion", "whitted"):
        sd = atrium(512)
        if kind != "halton":
            sd.integrator.kind = kind
        cfg = renderlib.make_integrator_config(sd, accel="clusters", device=dev)
        scene, cam = renderlib.build(sd, dev, with_clusters=True)
        run = renderlib.render_pass_fn(sd, cfg, dev)
        float(run(scene, cam, key, 0)[0].sum())   # warmup pass
        times, rays, k1, k2 = [], [], 0, 0
        for p in range(1, 4):
            a1, a2 = K1.LAUNCHES, K2.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.time()
            L, _, aux = run(scene, cam, key, p)
            checksum = float(L.sum())                  # data-dependent sync
            times.append(time.time() - t0)
            rays.append(int(aux["rays"]))
            k1 += K1.LAUNCHES - a1
            k2 += K2.LAUNCHES - a2
            check(np.isfinite(checksum), f"non-finite 512^2 {kind} pass")
        per_pass[kind] = {"cluster_traverse": k1 / 3, "bvh_traverse": k2 / 3}
        check(k1 > 0, f"512^2 {kind}: K1 never launched")
        line(f"scenes512_{kind}_clusters", pass_ms=[t * 1e3 for t in times],
             rays=rays, mrays_per_s=[n / t / 1e6 for n, t in zip(rays, times)],
             launches_per_pass=per_pass[kind], power=smi)
    t0 = time.time()
    lds._MAXMIN_CACHE.pop(lds.maxmin_m(16), None)
    lds._maxmin_matrix(lds.maxmin_m(16))
    line("maxmin_search_16spp", m=lds.maxmin_m(16),
         host_seconds=time.time() - t0)
    line("scenes_phase", wall_seconds=time.time() - t_phase)
    return per_pass


# phase 11: tests/test_media.py's analytic scenes (their tolerances), and
# the JAX goldens of tools/make_transport_golden.py at the IILE tolerances
ABSORB_SCENE = """
LookAt 0 0 0  0 0 1  0 1 0
Camera "perspective" "float fov" [30]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "volpath" "integer maxdepth" [4]
MakeNamedMedium "fog" "string type" "homogeneous"
  "color sigma_a" [0.2 0.4 0.6] "color sigma_s" [0 0 0]
MediumInterface "" "fog"
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [5 5 5] "bool twosided" "true"
  Shape "trianglemesh" "point P" [-9 -9 4 9 -9 4 9 9 4 -9 9 4]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
WorldEnd
"""
GRID_ABSORB_SCENE = """
LookAt 0 0 0  0 0 1  0 1 0
Camera "perspective" "float fov" [20]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "volpath" "integer maxdepth" [4]
MakeNamedMedium "smoke" "string type" "heterogeneous"
  "color sigma_a" [0.5 0.5 0.5] "color sigma_s" [0 0 0]
  "integer nx" [2] "integer ny" [2] "integer nz" [2]
  "float density" [1 1 1 1 1 1 1 1]
  "point p0" [-10 -10 0] "point p1" [10 10 4]
MediumInterface "" "smoke"
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [5 5 5] "bool twosided" "true"
  Shape "trianglemesh" "point P" [-9 -9 4 9 -9 4 9 9 4 -9 9 4]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
WorldEnd
"""
FOURIER_SCENE = """
LookAt 0 1.5 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Integrator "path" "integer maxdepth" [2]
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point from" [0 3 -1]
{mat}
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
WorldEnd
"""
TRANSPORT_GOLDEN = ("fog", "smoke", "sss", "hair", "fourier", "all")


def transport_tool():
    """tools/make_transport_golden.py (its top level imports no jax): the
    scene's variant() and load_case()."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_transport_golden",
        os.path.join(REPO, "tools", "make_transport_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def traversal_sites(K1, K2):
    """Counts each traversal call of the path integrator by its site
    (closest-hit waves, shadow waves of surface and medium vertices,
    BSSRDF probe waves, BSSRDF exit-shadow waves) with the kernel
    launches it made; yields the dict of counts."""
    import sys

    from pbrt_v3_iile_tpu_torch.ops import intersect as isect

    counts = {}
    inner, inner_occ = isect.intersect, isect.occluded
    site = {("_bounce", False): "closest_hit", ("_bssrdf", False): "bssrdf_probe",
            ("nee_once", True): "shadow", ("_bssrdf", True): "bssrdf_exit_shadow"}

    def tally(name, fn):
        a1, a2 = K1.LAUNCHES, K2.LAUNCHES
        res = fn()
        c = counts.setdefault(name, dict(calls=0, cluster_traverse=0,
                                         bvh_traverse=0))
        c["calls"] += 1
        c["cluster_traverse"] += K1.LAUNCHES - a1
        c["bvh_traverse"] += K2.LAUNCHES - a2
        return res

    def intersect(*a, **kw):
        caller = sys._getframe(1).f_code.co_name
        if caller == "occluded":
            return inner(*a, **kw)
        return tally(site.get((caller, False), caller), lambda: inner(*a, **kw))

    def occluded(*a, **kw):
        caller = sys._getframe(1).f_code.co_name
        return tally(site.get((caller, True), caller), lambda: inner_occ(*a, **kw))

    isect.intersect, isect.occluded = intersect, occluded
    try:
        yield counts
    finally:
        isect.intersect, isect.occluded = inner, inner_occ


def transport_phase(dev, smi, K1, K2):
    """Phase 11: materials and transport.  (a) the analytic gates, (b) the
    JAX goldens on both accels and the CLI, (c) the 512^2 passes of
    atrium_transport with and without its smoke, measured.  Returns the
    launches a pass of (c), those of (b), and the profile step of (c),
    which runs after phase 8's timed passes."""
    from pbrt_v3_iile_tpu_torch.cli import main as climain
    from pbrt_v3_iile_tpu_torch.integrators import path as pathlib_
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import fourierbsdf as fblib
    from pbrt_v3_iile_tpu_torch.ops import hair as hairlib
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.utils import image as imglib

    t_phase = time.time()
    tool = transport_tool()

    # (a) the analytic gates on the card, at the JAX tests' tolerances
    for name, text, spp, want, rtol in (
            ("beer_lambert_fog", ABSORB_SCENE, 32,
             5.0 * np.exp(-np.array([0.2, 0.4, 0.6]) * 4.0), 0.06),
            ("beer_lambert_grid", GRID_ABSORB_SCENE, 48,
             np.full(3, 5.0 * np.exp(-1.75)), 0.08)):
        sd = apilib.load_scene_string(text)
        check(len(sd.media) == 1, f"{name}: {len(sd.media)} media")
        (img, st), secs, launches = run_counted(
            lambda: renderlib.render(sd, spp=spp, device=dev), K1, K2)
        got = img.mean(axis=(0, 1))
        ok = bool(np.allclose(got, want, rtol=rtol))
        line(f"transport_{name}", got=got.tolist(), want=want.tolist(),
             rtol=rtol, within_tolerance=ok, wall_seconds=secs,
             launches=launches)
        check(ok, f"{name}: {got} against {want}")
        check(launches["cluster_traverse"] > 0, f"{name}: K1 never launched")

    def sphere(u):
        z = 1.0 - 2.0 * u[..., 0]
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * np.pi * u[..., 1]
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)

    full = lambda n, v: torch.full((n,), v, device=dev)
    zeros3 = lambda n: torch.zeros(n, 3, device=dev)
    for beta in ((0.6, 0.6), (0.4, 0.4)):   # tests/test_hair.py's furnaces
        N = 200_000
        k1, k2 = threefry.split(threefry.prng_key(7))
        wo = sphere(threefry.uniform(k1, (1, 2), dev)).expand(N, 3)
        wi = sphere(threefry.uniform(k2, (N, 2), dev))
        f = hairlib.evaluate(wo, wi, full(N, 0.33), zeros3(N), full(N, beta[0]),
                             full(N, beta[1]))
        est = ((f * wi[:, 2:3].abs()).mean(0) * 4.0 * np.pi).cpu().numpy()
        ok = bool(np.allclose(est, 1.0, atol=0.06))
        line("transport_hair_white_furnace", beta=beta, estimate=est.tolist(),
             atol=0.06, within_tolerance=ok)
        check(ok, f"hair white furnace {beta}: {est}")
    N = 100_000
    ko, ku = threefry.split(threefry.prng_key(3))
    wo = sphere(threefry.uniform(ko, (1, 2), dev)).expand(N, 3)
    wi, f, pdf = hairlib.sample(wo, threefry.uniform(ku, (N, 4), dev),
                                full(N, -0.25), zeros3(N), full(N, 0.5),
                                full(N, 0.4))
    w = torch.where((pdf > 0)[:, None],
                    f * wi[:, 2:3].abs() / torch.clamp(pdf, min=1e-9)[:, None],
                    torch.zeros_like(f))
    est = w.mean(0).cpu().numpy()
    ok = bool(np.allclose(est, 1.0, atol=0.08))
    line("transport_hair_white_furnace_sampled", estimate=est.tolist(),
         atol=0.08, within_tolerance=ok)
    check(ok, f"sampled hair white furnace: {est}")
    # a Lambertian Fourier table renders as the same-albedo matte
    # (tests/test_fourier.py::test_fourier_render_matches_matte)
    bsdf = os.path.join(REPO, "build", "chip_smoke_lambert.bsdf")
    os.makedirs(os.path.dirname(bsdf), exist_ok=True)
    fblib.write_bsdf(bsdf, fblib.make_lambertian_table(albedo=0.5, n_mu=24))
    sd_f = apilib.load_scene_string(FOURIER_SCENE.format(
        mat=f'Material "fourier" "string bsdffile" "{bsdf}"'))
    check(sd_f.materials[-1].kind == apilib.MAT_FOURIER,
          "the Lambertian table did not load as a Fourier material")
    sd_m = apilib.load_scene_string(FOURIER_SCENE.format(
        mat='Material "matte" "rgb Kd" [0.5 0.5 0.5]'))
    img_f, _ = renderlib.render(sd_f, spp=8, seed=3, device=dev)
    img_m, _ = renderlib.render(sd_m, spp=8, seed=3, device=dev)
    rel = abs(img_f.mean() - img_m.mean()) / max(img_m.mean(), 1e-6)
    line("transport_fourier_vs_matte", fourier_mean=float(img_f.mean()),
         matte_mean=float(img_m.mean()), rel=float(rel), tol=0.03,
         finite=bool(np.isfinite(img_f).all()))
    check(np.isfinite(img_f).all() and rel < 0.03, f"fourier vs matte {rel}")

    # (b) the JAX package's renders: each feature alone on bvh, all of
    # them on each accel (the all-features render drives every feature on
    # clusters)
    launches_128 = {}
    for case in TRANSPORT_GOLDEN:
        z = np.load(os.path.join(REPO, "tests", "golden",
                                 f"transport128_{case}.npz"))
        spec = dict(features=json.loads(str(z["features"])),
                    lookat=str(z["lookat"]),
                    overrides=json.loads(str(z["overrides"])))
        for accel in (("clusters", "bvh") if case == "all" else ("bvh",)):
            sd = tool.load_case(apilib, spec)
            if "fourier" in spec["features"]:
                # a read error would degrade the bowl to matte
                check(sum(m.kind == apilib.MAT_FOURIER for m in sd.materials)
                      == 1, f"{case}: the bowl is not a Fourier material")
            (img, st), secs, launches = run_counted(
                lambda: renderlib.render(sd, spp=int(z["spp"]),
                                         seed=int(z["seed"]), accel=accel,
                                         device=dev), K1, K2)
            image_check(f"transport_{case}128_{accel}", img, z["img"], *IILE_TOL)
            line(f"transport_{case}128_{accel}_stats", wall_seconds=secs,
                 launches=launches, jax_rays=int(z["rays"]), **st)
            if accel == "clusters":
                # K2 only as K1's overflow: at most one call a traversal
                check(launches["cluster_traverse"] > 0, f"{case}: K1 never launched")
                check(launches["bvh_traverse"] <= launches["cluster_traverse"],
                      f"{case} clusters: {launches} beyond K1's overflow")
            else:
                check(launches["bvh_traverse"] > 0, f"{case}: K2 never launched")
                check(launches["cluster_traverse"] == 0,
                      f"{case} bvh: K1 launched {launches['cluster_traverse']}")
            launches_128[f"{case}_{accel}"] = launches

    # the CLI on the card (quarter resolution)
    cli_out = os.path.join(OUT_DIR, "atrium_transport_quick.pfm")
    scene_file = os.path.join(REPO, "scenes", tool.TRANSPORT)
    rc, secs, launches = run_counted(lambda: climain.main(
        [scene_file, cli_out, "--quick", "--spp", "2", "--quiet",
         "--integrator", "volpath"]), K1, K2)
    cli_img = imglib.read_pfm(cli_out)
    line("transport_cli_quick", rc=rc, shape=list(cli_img.shape),
         mean=float(cli_img.mean()), wall_seconds=secs, launches=launches)
    check(rc == 0 and np.isfinite(cli_img).all() and cli_img.mean() > 0,
          "the CLI's volpath render")

    # (c) measured: atrium_transport at 512^2, the file's depth, clusters
    key = threefry.prng_key(0)
    text = open(scene_file).read()
    per_pass, runs = {}, {}
    for name, feats in (("all", tool.FEATURES),
                        ("no_smoke", [f for f in tool.FEATURES if f != "smoke"])):
        sd = apilib.load_scene_string(tool.variant(text, feats),
                                      os.path.dirname(scene_file))
        cfg = renderlib.make_integrator_config(sd, accel="clusters", device=dev)
        check(cfg.volumetric and cfg.has_hair and cfg.has_subsurface
              and cfg.grid_media == (name == "all"), f"{name}: {cfg}")
        scene, cam = renderlib.build(sd, dev, with_clusters=True)
        run = renderlib.render_pass_fn(sd, cfg, dev)
        float(run(scene, cam, key, 0)[0].sum())   # warmup pass
        times, rays = [], []
        a1, a2 = K1.LAUNCHES, K2.LAUNCHES
        for p in range(1, 4):
            with traversal_sites(K1, K2) as sites:
                torch.cuda.synchronize()
                t0 = time.time()
                L, _, aux = run(scene, cam, key, p)
                checksum = float(L.sum())              # data-dependent sync
                times.append(time.time() - t0)
            rays.append(int(aux["rays"]))
            check(np.isfinite(checksum), f"non-finite 512^2 {name} pass")
        per_pass[name] = {"cluster_traverse": (K1.LAUNCHES - a1) / 3,
                          "bvh_traverse": (K2.LAUNCHES - a2) / 3}
        check(per_pass[name]["cluster_traverse"] > 0, f"{name}: K1 never launched")
        line(f"transport512_{name}_clusters", pass_ms=[t * 1e3 for t in times],
             rays=rays, mrays_per_s=[n / t / 1e6 for n, t in zip(rays, times)],
             launches_per_pass=per_pass[name], sites_last_pass=sites,
             power=smi)
        runs[name] = (run, scene, cam, float(np.median(times)))

    def profile(profiled):
        """One profiled pass of each, with the tracking loops' spans: their
        calls, kernel launches, device and host ms."""
        from torch.autograd import DeviceType

        inner = (pathlib_._delta_track, pathlib_._ratio_track)

        def spanned(span, fn):
            def wrap(*a, **kw):
                with torch.profiler.record_function(span):
                    return fn(*a, **kw)
            return wrap

        pathlib_._delta_track = spanned("delta_track", inner[0])
        pathlib_._ratio_track = spanned("ratio_track", inner[1])
        try:
            for name, (run, scene, cam, med_s) in runs.items():
                prof = profiled(f"profile_transport512_{name}",
                                lambda: float(run(scene, cam, key, 4)[0].sum()),
                                med_s, f"profile_transport512_{name}.txt",
                                ("profiled_pass_ms", "median_pass_ms"),
                                spans=("delta_track", "ratio_track"))
                spans = {}
                for sp in ("delta_track", "ratio_track"):
                    host = [e for e in prof.events() if e.name == sp
                            and e.device_type == DeviceType.CPU]
                    ranges = [e for e in prof.events() if e.name == sp
                              and e.device_type == DeviceType.CUDA]
                    launches, stack = 0, [c for e in host for c in e.cpu_children]
                    while stack:
                        e = stack.pop()
                        launches += e.name in ("cudaLaunchKernel",
                                               "cudaLaunchKernelExC",
                                               "cuLaunchKernel",
                                               "cuLaunchKernelEx")
                        stack.extend(e.cpu_children)
                    # kernel time launched inside the span, the span's
                    # extent on the device timeline, and its host time
                    spans[sp] = dict(
                        calls=len(host), launches=launches,
                        device_kernel_ms=sum(e.device_time_total
                                             for e in host) / 1e3,
                        device_span_ms=sum(e.time_range.elapsed_us()
                                           for e in ranges) / 1e3,
                        host_ms=sum(e.cpu_time_total for e in host) / 1e3)
                line(f"profile_transport512_{name}_tracking", power=smi, **spans)
        finally:
            pathlib_._delta_track, pathlib_._ratio_track = inner

    line("transport_phase", wall_seconds=time.time() - t_phase)
    return dict(per_pass=per_pass, launches_128=launches_128, profile=profile)


# phase 12: cameras and aggregates.  K3's and K2-motion's fp32 operations,
# counted from the CUDA sources as the others above
KD_NODE_OPS = 10   # K3 node: the early-out compare, tplane (sub, mul), the
                   # near/far tests (5 compares), the push compare and select
LERP_OPS = 27      # K2-motion: 9 floats of a triangle lerped (sub, mul, add)
CAMERA_GOLDEN = (("motion", "bvh"), ("kdtree", "kdtree"),
                 ("realistic", "bvh"), ("realistic", "clusters"))
CAMERA_FILM, CAMERA_WAVE_ROWS = 512, 128   # phase 12's film, its waves' rows


def camera_tool():
    """tools/make_camera_golden.py (its top level imports no jax): the
    scenes' names, load_case() and case_from_golden()."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_camera_golden", os.path.join(REPO, "tools", "make_camera_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_counts(K1, K2, K3):
    return {"cluster_traverse": K1.LAUNCHES, "bvh_traverse": K2.LAUNCHES,
            "bvh_traverse_motion": K2.LAUNCHES_MOTION,
            "kd_traverse": K3.LAUNCHES}


def cameras_phase(dev, smi, K1, K2, K3, atrium, waves):
    """Phase 12: cameras and aggregates.  (a) K2's motion variant and K3
    bit for bit against their plain versions, K3 against K2; (b) the JAX
    goldens of tools/make_camera_golden.py and the CLI's --accel kdtree;
    (c) the 512^2 passes measured.  atrium: phase 3's (sd, scene, cam),
    its scene built with the kd-tree; waves: phase 4's atrium waves.
    Returns the launches of (b) and (c), the errors of (a), and the
    inputs of phase 8's timing of both kernels."""
    from pbrt_v3_iile_tpu_torch.cli import main as climain
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import kdtree
    from pbrt_v3_iile_tpu_torch.ops import sampling as smp
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.utils import image as imglib
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    t_phase = time.time()
    tool = camera_tool()
    scenes = os.path.join(REPO, "scenes")
    sd_a, scene_a, cam_a = atrium
    check(scene_a.has_kdtree, "phase 3's scene has no kd-tree")

    # the motion scene at 512^2, built once: the numpy BVH over the union
    # of its sub-keyframes
    t0 = time.time()
    sd_m = apilib.load_scene(os.path.join(scenes, tool.MOTION))
    sd_m.film.x_resolution = sd_m.film.y_resolution = CAMERA_FILM
    scene_m, cam_m = renderlib.build(sd_m, dev)
    torch.cuda.synchronize()
    steps = scene_m.tris_steps_packed
    line("cameras_motion_scene", seconds=time.time() - t0,
         sub_keyframes=int(steps.shape[0]), triangles=int(steps.shape[1]),
         wide_nodes=scene_m.bvh4_nodes.shape[0], stack_bound=scene_m.bvh4_stack,
         steps_mbytes=steps.nbytes / 1e6,
         ns_steps_mbytes=scene_m.tri_ns_steps.nbytes / 1e6)
    check(steps.shape[0] == 7, f"atrium_motion has {steps.shape[0]} sub-keyframes")

    # (a) the motion waves: the primary rays of the film's first 65,536
    # pixels with their shutter times, and a cosine bounce from their hits
    # at the same times
    prep = renderlib.make_wave_prep(sd_m, dev, chunk_rows=CAMERA_WAVE_ROWS)
    o_p, d_p, _, _, _, _, time_p = prep(cam_m, threefry.prng_key(0), 0, 0)
    big = torch.full_like(time_p, 1e30)
    hp = isect.intersect(scene_m, o_p, d_p, big, time=time_p)
    it = isect.make_interaction(scene_m, o_p, d_p, hp, time=time_p)
    ng_f = vm.face_forward(it.ng, -d_p)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.random((o_p.shape[0], 2), dtype=np.float32), device=dev)
    tf, bf = vm.coordinate_system(ng_f)
    d_b = vm.to_world(smp.cosine_sample_hemisphere(u), tf, bf, ng_f)
    o_b = vm.offset_ray_origin(it.p, ng_f, d_b)
    mwaves = {"primary": (o_p, d_p, big),
              "bounce": (o_b, d_b, torch.where(hp.valid, 1e30, -1.0))}

    def k2m(o, d, tm, any_hit=False):
        return K2.bvh_traverse_cuda(scene_m.bvh4_nodes, scene_m.bvh4_stack,
                                    scene_m.tris_packed, o, d, tm,
                                    any_hit=any_hit, time=time_p, tris_steps=steps)

    def k2m_plain(o, d, tm, any_hit=False):
        return K2.bvh_traverse_wide_plain(scene_m.bvh4_nodes, scene_m.tris_packed,
                                          o, d, tm, any_hit=any_hit,
                                          time=time_p, tris_steps=steps)

    k2m_err = k3_err = 0.0
    plain_ms = {}   # the plain versions' ms on their comparison calls
    wm = {}   # the keyframe-lerping walker's work on the bounce wave
    for wname in ("primary", "bounce"):
        for any_hit in (False, True):
            o, d, tm = mwaves[wname]
            tag = f"{wname}{'_anyhit' if any_hit else ''}"
            got = k2m(o, d, tm, any_hit)
            want, plain_ms[f"motion_{tag}"] = timed_once(
                lambda: k2m_plain(o, d, tm, any_hit))
            same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            t_abs = float((got[0] - want[0]).abs().max())
            line(f"K2_motion_vs_wide_plain_{tag}", t_prim_b1_b2_identical=same,
                 t_max_abs=t_abs, hits=int((got[1] >= 0).sum()))
            check(all(same), f"K2-motion {tag}: differs from its plain version")
            k2m_err = max(k2m_err, t_abs)
            # against the keyframe-lerping binary walker of the CPU path
            ref = isect.intersect_bvh(scene_m, o, d, tm, any_hit=any_hit,
                                      time=time_p,
                                      work=wm if tag == "bounce" else None)
            if any_hit:
                frac = float(((got[1] >= 0) == ref.valid).float().mean())
                line(f"K2_motion_anyhit_vs_walker_{wname}", agree=frac)
                check(frac >= PRIM_AGREE, f"K2-motion any-hit {wname}: {frac}")
            else:
                compare_hits(f"K2_motion_vs_walker_{wname}", got[0], got[1],
                             ref.t, ref.prim, got[2], got[3], ref.b1, ref.b2)
    # at time 0 on atrium (its triangles as two equal keyframes) the motion
    # variant is the static kernel
    o, d, tm = waves["bounce"]
    two = scene_a.tris_packed[None].expand(2, -1, -1).contiguous()
    got = K2.bvh_traverse_cuda(scene_a.bvh4_nodes, scene_a.bvh4_stack,
                               scene_a.tris_packed, o, d, tm,
                               time=torch.zeros_like(tm), tris_steps=two)
    want = K2.bvh_traverse_cuda(scene_a.bvh4_nodes, scene_a.bvh4_stack,
                                scene_a.tris_packed, o, d, tm)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    line("K2_motion_time0_vs_K2_atrium_bounce", t_prim_b1_b2_identical=same)
    check(all(same), "K2-motion at time 0 differs from the static K2")
    del two

    # K3 against its plain version and against K2, on phase 4's waves
    for wname in ("primary", "bounce"):
        for any_hit in (False, True):
            o, d, tm = waves[wname]
            tag = f"{wname}{'_anyhit' if any_hit else ''}"
            got = K3.kd_traverse_cuda(scene_a, o, d, tm, any_hit=any_hit)
            want, plain_ms[f"kd_{tag}"] = timed_once(
                lambda: kdtree.intersect_kd_plain(scene_a, o, d, tm,
                                                  any_hit=any_hit))
            want = (want.t, want.prim, want.b1, want.b2)
            same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            t_abs = float((got[0] - want[0]).abs().max())
            line(f"K3_vs_plain_{tag}", t_prim_b1_b2_identical=same,
                 t_max_abs=t_abs, hits=int((got[1] >= 0).sum()))
            check(all(same), f"K3 {tag}: differs from intersect_kd_plain")
            k3_err = max(k3_err, t_abs)
            k2 = K2.bvh_traverse_cuda(scene_a.bvh4_nodes, scene_a.bvh4_stack,
                                      scene_a.tris_packed, o, d, tm,
                                      any_hit=any_hit)
            if any_hit:
                frac = float(((got[1] >= 0) == (k2[1] >= 0)).float().mean())
                line(f"K3_anyhit_vs_K2_{wname}", agree=frac)
                check(frac >= PRIM_AGREE, f"K3 any-hit vs K2 {wname}: {frac}")
            else:
                compare_hits(f"K3_vs_K2_{wname}", got[0], got[1], k2[0], k2[1],
                             got[2], got[3], k2[2], k2[3])

    # (b) the JAX package's renders; each scene is built once
    t0 = time.time()
    sd_l = apilib.load_scene(os.path.join(scenes, tool.LENS_SCENE))
    scene_l, cam_l = renderlib.build(sd_l, dev, with_clusters=True)
    line("cameras_lens_scene", seconds=time.time() - t0,
         lens_elements=int(cam_l.lens_curv.shape[0]),
         rear_thickness_mm=float(cam_l.lens_thick[-1]) * 1e3)
    built = {"motion": scene_m, "kdtree": scene_a, "realistic": scene_l}
    launches_128 = {}
    for case, accel in CAMERA_GOLDEN:
        z = np.load(os.path.join(REPO, "tests", "golden", f"camera128_{case}.npz"))
        sd = tool.load_case(apilib, tool.case_from_golden(z))
        cam = camlib.make_camera(sd.camera, sd.film, dev)
        (img, st), secs, n = run_counted(
            lambda: renderlib.render(sd, spp=int(z["spp"]), seed=int(z["seed"]),
                                     accel=accel, device=dev,
                                     prebuilt=(built[case], cam)), K1, K2)
        image_check(f"cameras_{case}128_{accel}", img, z["img"], *IILE_TOL)
        line(f"cameras_{case}128_{accel}_stats", wall_seconds=secs, launches=n,
             jax_rays=int(z["rays"]), **st)
        others = lambda *ks: all(n[k] == 0 for k in ks)
        if case == "motion":
            check(n["bvh_traverse_motion"] > 0 and others(
                "cluster_traverse", "bvh_traverse", "kd_traverse"),
                f"motion: {n}: K2-motion alone must carry it")
        elif accel == "kdtree":
            check(n["kd_traverse"] > 0 and others(
                "cluster_traverse", "bvh_traverse", "bvh_traverse_motion"),
                f"kdtree: {n}: K3 alone must carry it")
        elif accel == "clusters":
            check(n["cluster_traverse"] > 0 and others("kd_traverse",
                                                       "bvh_traverse_motion")
                  and n["bvh_traverse"] <= n["cluster_traverse"],
                  f"{case} clusters: {n}")
        else:
            check(n["bvh_traverse"] > 0 and others(
                "cluster_traverse", "kd_traverse", "bvh_traverse_motion"),
                f"{case} bvh: {n}")
        launches_128[f"{case}_{accel}"] = n

    # the CLI's --accel kdtree on a scene without an Accelerator line
    cli_out = os.path.join(OUT_DIR, "atrium_kdtree_quick.pfm")
    check(apilib.load_scene(os.path.join(scenes, "atrium.pbrt")).accelerator
          != "kdtree", "atrium.pbrt asks for the kd-tree")
    rc, secs, n = run_counted(lambda: climain.main(
        [os.path.join(scenes, "atrium.pbrt"), cli_out, "--accel", "kdtree",
         "--quick", "--quiet"]), K1, K2)
    cli_img = imglib.read_pfm(cli_out)
    line("cameras_cli_kdtree_quick", rc=rc, shape=list(cli_img.shape),
         mean=float(cli_img.mean()), wall_seconds=secs, launches=n)
    check(rc == 0 and np.isfinite(cli_img).all() and cli_img.mean() > 0.01,
          f"the CLI's --accel kdtree render is black: {cli_img.mean()}")
    check(n["kd_traverse"] > 0, "the CLI's --accel kdtree never launched K3")

    # (c) measured: the 512^2 passes at the file's depth, uncompacted
    key = threefry.prng_key(0)
    sd_l.film.x_resolution = sd_l.film.y_resolution = CAMERA_FILM
    per_pass = {}
    for name, sd, scene, cam, accel in (
            ("motion_bvh", sd_m, scene_m, cam_m, "bvh"),
            ("atrium_kdtree", sd_a, scene_a, cam_a, "kdtree"),
            ("lens_clusters", sd_l, scene_l,
             camlib.make_camera(sd_l.camera, sd_l.film, dev), "clusters")):
        cfg = renderlib.make_integrator_config(sd, accel=accel, device=dev)
        check(cfg.accel == accel, f"{name}: accel {cfg.accel}")
        run = renderlib.render_pass_fn(sd, cfg, dev)
        float(run(scene, cam, key, 0)[0].sum())   # warmup pass
        times, rays = [], []
        a = launch_counts(K1, K2, K3)
        for p in range(1, 4):
            torch.cuda.synchronize()
            t0 = time.time()
            L, _, aux = run(scene, cam, key, p)
            checksum = float(L.sum())                  # data-dependent sync
            times.append(time.time() - t0)
            rays.append(int(aux["rays"]))
            check(np.isfinite(checksum), f"non-finite 512^2 {name} pass")
        b = launch_counts(K1, K2, K3)
        per_pass[name] = {k: (b[k] - a[k]) / 3 for k in a}
        line(f"cameras512_{name}", pass_ms=[t * 1e3 for t in times], rays=rays,
             mrays_per_s=[r / t / 1e6 for r, t in zip(rays, times)],
             launches_per_pass=per_pass[name], power=smi)
    check(per_pass["motion_bvh"]["bvh_traverse_motion"] > 0,
          "K2-motion never launched in a 512^2 motion pass")
    check(per_pass["atrium_kdtree"]["kd_traverse"] > 0,
          "K3 never launched in a 512^2 kdtree pass")
    line("cameras_phase", wall_seconds=time.time() - t_phase)
    return dict(launches_128=launches_128, per_pass=per_pass, k2m_err=k2m_err,
                k3_err=k3_err, plain_ms=plain_ms, motion_work=wm,
                motion=(scene_m, mwaves["bounce"], k2m))


def camera_kernel_timing(cams, scene, waves, K2, K3, isect, kdtree, smi):
    """Phase 8's timing of K3 and K2-motion on the 65,536-ray bounce waves
    (atrium's for K3, atrium_motion's for K2-motion): ms by CUDA events
    over 20 wrapper calls, the plain versions' ms on phase 12's comparison
    calls, and each bound from the work these rays need (K3: its plain
    version's node visits and triangle tests; K2-motion: the
    keyframe-lerping binary walker's, counted in phase 12, as K2's bound
    keeps the binary walker's yardstick) against the bytes of the tree,
    the triangles and the rays.  The launches are not counted."""
    saved = (K2.LAUNCHES_MOTION, K3.LAUNCHES)
    o, d, tm = waves["bounce"]
    scene_m, (om, dm, tmm), k2m = cams["motion"]
    out = dict(
        kd_ms=cuda_ms(lambda: K3.kd_traverse_cuda(scene, o, d, tm), 20),
        kd_anyhit_ms=cuda_ms(lambda: K3.kd_traverse_cuda(scene, o, d, tm,
                                                         any_hit=True), 20),
        kd_plain_ms=cams["plain_ms"]["kd_bounce"],
        motion_ms=cuda_ms(lambda: k2m(om, dm, tmm), 20),
        motion_anyhit_ms=cuda_ms(lambda: k2m(om, dm, tmm, True), 20),
        motion_plain_ms=cams["plain_ms"]["motion_bounce"])
    work, wm = {}, cams["motion_work"]
    kdtree.intersect_kd_plain(scene, o, d, tm, work=work)
    kd_ops = work["nodes"] * KD_NODE_OPS + work["tris"] * MOLLER_OPS
    kd_bytes = (scene.kd_split.nbytes + scene.kd_meta.nbytes
                + scene.kd_offset.nbytes + scene.kd_prims.nbytes
                + scene.tris_packed.nbytes + o.shape[0] * (28 + 16))
    out["kd_bound_ms"], out["kd_bound_by"] = bound(kd_ops, kd_bytes)
    m_ops = wm["nodes"] * NODE_OPS + wm["tris"] * (MOLLER_OPS + LERP_OPS)
    m_bytes = (scene_m.nodes_packed.nbytes + scene_m.tris_steps_packed.nbytes
               + om.shape[0] * (28 + 16 + 4))
    out["motion_bound_ms"], out["motion_bound_by"] = bound(m_ops, m_bytes)
    line("camera_kernels_bounce_wave_65536", **out, kd_node_visits=work["nodes"],
         kd_triangle_tests=work["tris"], kd_gflop=kd_ops / 1e9,
         kd_mbytes=kd_bytes / 1e6, motion_node_visits=wm["nodes"],
         motion_triangle_tests=wm["tris"], motion_gflop=m_ops / 1e9,
         motion_mbytes=m_bytes / 1e6, plain_ms_by_wave=cams["plain_ms"],
         power=smi)
    K2.LAUNCHES_MOTION, K3.LAUNCHES = saved
    return out


def main():
    import sys

    t_start = time.time()
    cameras_only = "--cameras-only" in sys.argv[1:]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "unavailable"
    kind = torch.cuda.get_device_name(0)
    line("device", torch_name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch import _build
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import clusters as cllib
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as K1
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2
    from pbrt_v3_iile_tpu_torch.ops import kd_kernel as K3
    from pbrt_v3_iile_tpu_torch.ops import kdtree
    from pbrt_v3_iile_tpu_torch.ops import sampling as smp
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    # ---- 2. build the kernels ----
    t0 = time.time()
    sources = ("bvh_traverse", "cluster_traverse", "kd_traverse")
    with ThreadPoolExecutor(len(sources)) as ex:   # one nvcc per source, together
        list(ex.map(lambda n: _build.load(n, verbose=True), sources))
    line("build", seconds=time.time() - t0, dir=_build.BUILD_DIR)

    # ---- 3. the device scene ----
    scene_path = os.path.join(REPO, "scenes", "atrium.pbrt")
    t0 = time.time()
    sd = apilib.load_scene(scene_path)
    sd.film.x_resolution = sd.film.y_resolution = 512
    scene, cam = renderlib.build(sd, dev, with_clusters=True, with_kdtree=True)
    torch.cuda.synchronize()
    kd_leaf = (scene.kd_meta & 3) == 3
    line("scene", seconds=time.time() - t0, triangles=scene.tri_p0.shape[0],
         nodes=scene.nodes_packed.shape[0],
         wide_nodes=scene.bvh4_nodes.shape[0], stack_bound=scene.bvh4_stack,
         clusters=scene.clusters.feat.shape[0],
         kd_nodes=scene.kd_meta.shape[0], kd_prim_refs=scene.kd_prims.shape[0],
         kd_leaves_over_8=int((kd_leaf & (scene.kd_meta >> 2 > kdtree.MAX_PRIMS)
                               ).sum()))

    # ---- 4. K2 vs the plain walker ----
    prep = renderlib.make_wave_prep(sd, dev, chunk_rows=128)
    o_p, d_p, *_ = prep(cam, threefry.prng_key(0), 0, 0)  # 65,536 rays
    N = o_p.shape[0]
    big = torch.full((N,), 1e30, device=dev)
    hp = isect.intersect_bvh(scene, o_p, d_p, big)
    it = isect.make_interaction(scene, o_p, d_p, hp)
    ng_f = vm.face_forward(it.ng, -d_p)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.random((N, 2), dtype=np.float32), device=dev)
    loc = smp.cosine_sample_hemisphere(u)
    tf, bf = vm.coordinate_system(ng_f)
    d_b = vm.to_world(loc, tf, bf, ng_f)
    o_b = vm.offset_ray_origin(it.p, ng_f, d_b)
    tm_b = torch.where(hp.valid, 1e30, -1.0)
    lamp = torch.tensor([2.8, 1.62, -1.9], device=dev)
    to_l = lamp[None, :] - it.p
    d_s = vm.normalize(to_l)
    o_s = vm.offset_ray_origin(it.p, ng_f, d_s)
    tm_s = torch.where(hp.valid, vm.length(lamp[None, :] - o_s) * 0.999, -1.0)
    waves = {"primary": (o_p, d_p, big), "bounce": (o_b, d_b, tm_b)}

    def k2(o, d, tm, any_hit=False):
        return K2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                                    scene.tris_packed, o, d, tm, any_hit=any_hit)

    def k2_plain(o, d, tm, any_hit=False):
        return K2.bvh_traverse_wide_plain(scene.bvh4_nodes, scene.tris_packed,
                                          o, d, tm, any_hit=any_hit)

    k2_err = 0.0
    k2_mismatch = {}
    plain_ms = {}   # the plain versions' ms on their comparison calls
    for wname, (o, d, tm), any_hit in (
            ("primary", waves["primary"], False),
            ("bounce", waves["bounce"], False),
            ("bounce", waves["bounce"], True),
            ("shadow", (o_s, d_s, tm_s), True)):
        tag = f"{wname}{'_anyhit' if any_hit else ''}"
        got = k2(o, d, tm, any_hit)
        torch.cuda.synchronize()
        # the kernel and its plain version do the same rounded operations
        # in the same order: every output must agree bit for bit
        want, plain_ms[f"bvh_wide_plain_{tag}"] = timed_once(
            lambda: k2_plain(o, d, tm, any_hit))
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        t_abs = float((got[0] - want[0]).abs().max())
        line(f"K2_vs_wide_plain_{tag}", t_prim_b1_b2_identical=same,
             t_max_abs=t_abs, hits=int((got[1] >= 0).sum()))
        check(all(same), f"K2 {tag}: differs from bvh_traverse_wide_plain")
        k2_err = max(k2_err, t_abs)
        # against the binary walker of the CPU path: the same hits but for
        # exact ties in t (the kernel keeps the smaller prim id) and a t
        # that rounds below its box's tnear (the cull then depends on the
        # visiting order)
        ref, plain_ms[f"bvh_walker_{tag}"] = timed_once(
            lambda: isect.intersect_bvh(scene, o, d, tm, any_hit=any_hit))
        if any_hit:
            va, vb = (got[1] >= 0).cpu().numpy(), ref.valid.cpu().numpy()
            frac = float((va == vb).mean())
            line(f"K2_anyhit_vs_walker_{wname}", agree=frac,
                 validity_differs=int((va != vb).sum()), occluded=int(vb.sum()))
            check(frac >= PRIM_AGREE, f"K2 any-hit {wname}: agreement {frac}")
            continue
        compare_hits(f"K2_vs_walker_{wname}", got[0], got[1], ref.t, ref.prim,
                     got[2], got[3], ref.b1, ref.b2)
        dp = got[1] != ref.prim
        dt = got[0] != ref.t
        k2_mismatch[wname] = dict(
            rays=int(o.shape[0]), prim_differs=int(dp.sum()),
            t_differs=int(dt.sum()), tie_in_t=int((dp & ~dt).sum()),
            smaller_prim_on_tie=int((dp & ~dt & (got[1] < ref.prim)).sum()))
        line(f"K2_vs_walker_{wname}_differing", **k2_mismatch[wname])

    # ---- 5. K1 vs its plain version, and vs K2 ----
    cp = scene.clusters
    maxc = K1.maxc_for(cp.feat.shape[0])
    k1_err = 0.0
    sorted_waves = {}
    for wname, (o, d, tm) in waves.items():
        key = cllib.sort_key6(o, d, scene.world_min, scene.world_max)
        key = torch.where(tm > 0, key, 0x7FFFFFFF)
        perm = torch.sort(key, stable=True).indices
        os_, ds_, ts_ = (x[perm].contiguous() for x in (o, d, tm))
        sorted_waves[wname] = (os_, ds_, ts_)
        t, prim, n_cand = K1.cluster_traverse_cuda(cp, os_, ds_, ts_, maxc)
        (tp, pp, n_plain), plain_ms[f"cluster_plain_{wname}"] = timed_once(
            lambda: K1.cluster_traverse_plain(cp, os_, ds_, ts_, maxc))
        # the kernel does the plain version's rounded operations in the
        # same order (--fmad=false): everything must agree bit for bit
        same_n = bool(torch.equal(n_cand, n_plain))
        prim_agree = float((prim == pp).float().mean())
        t_abs = float((t - tp).abs().max())
        line(f"K1_vs_plain_{wname}", groups=int(n_cand.shape[0]),
             mean_candidates=float(n_cand.float().mean()),
             max_candidates=int(n_cand.max()),
             overflow_groups=int((n_cand > maxc).sum()),
             n_cand_identical=same_n, prim_agree=prim_agree,
             t_identical=bool(torch.equal(t, tp)), t_max_abs=t_abs,
             hits=int((prim >= 0).sum()))
        check(same_n, f"K1 {wname}: n_cand differs from the plain version")
        check(prim_agree == 1.0, f"K1 {wname}: prim agreement {prim_agree}")
        check(torch.equal(t, tp), f"K1 {wname}: t differs by up to {t_abs}")
        k1_err = max(k1_err, t_abs)
        _, pa, _ = K1.cluster_traverse_cuda(cp, os_, ds_, ts_, maxc,
                                            any_hit=True)
        torch.cuda.synchronize()
        same_valid = bool(torch.equal(pa >= 0, pp >= 0))
        line(f"K1_anyhit_vs_plain_{wname}", validity_identical=same_valid,
             occluded=int((pa >= 0).sum()))
        check(same_valid, f"K1 any-hit {wname}: validity differs")
        # whole cluster traversal (K1 + overflow through K2) vs K2 alone
        h1 = isect.intersect(scene, o, d, tm, accel="clusters")
        h2 = isect.intersect(scene, o, d, tm, accel="bvh")
        compare_hits(f"clusters_vs_K2_{wname}", h1.t, h1.prim, h2.t, h2.prim,
                     agree_min=XALG_AGREE)
    # K1 with 8-candidate lists: the overflow groups are left as misses
    os_, ds_, ts_ = sorted_waves["bounce"]
    t, prim, n_cand = K1.cluster_traverse_cuda(cp, os_, ds_, ts_, 8)
    tp, pp, n_plain = K1.cluster_traverse_plain(cp, os_, ds_, ts_, 8)
    torch.cuda.synchronize()
    same8 = bool(torch.equal(n_cand, n_plain) and torch.equal(prim, pp)
                 and torch.equal(t, tp))
    line("K1_vs_plain_bounce_maxc8", identical=same8,
         overflow_groups=int((n_cand > 8).sum()))
    check(same8, "K1 with maxc=8 differs from its plain version")
    n2 = K2.LAUNCHES
    o, d, tm = waves["bounce"]
    h8 = isect.intersect(scene, o, d, tm, accel="clusters", cluster_maxc=8)
    h2 = isect.intersect(scene, o, d, tm, accel="bvh")
    compare_hits("clusters_maxc8_vs_K2_bounce", h8.t, h8.prim, h2.t, h2.prim,
                 agree_min=XALG_AGREE)
    check(K2.LAUNCHES > n2 + 1, "cluster_maxc=8 did not route overflow to K2")

    if cameras_only:   # phases 1-5 and 12 and their kernels' timing
        cams = cameras_phase(dev, smi, K1, K2, K3, (sd, scene, cam), waves)
        timing = camera_kernel_timing(cams, scene, waves, K2, K3, isect,
                                      kdtree, smi)
        line("cameras_only", launches_128=cams["launches_128"],
             per_pass=cams["per_pass"], **timing)
        return

    # ---- 6. the main path through render(), with launch counts ----
    sd128 = apilib.load_scene(scene_path)
    sd128.film.x_resolution = sd128.film.y_resolution = 128
    K1.LAUNCHES = 0
    K2.LAUNCHES = 0
    cllib.CALLS = 0
    t0 = time.time()
    for compact in (False, True):
        img, st = renderlib.render(sd128, spp=64, seed=3, compact=compact,
                                   device=dev)
        oracle_check(f"render128_{'compact' if compact else 'scan'}", img)
        line(f"render128_{'compact' if compact else 'scan'}_stats", **st)
    img8, _ = renderlib.render(sd128, spp=1, seed=3, compact=True, device=dev,
                               cluster_maxc=8)
    check(np.isfinite(img8).all() and img8.mean() > 0, "maxc=8 pass image")
    torch.cuda.synchronize()
    launches = {"cluster_traverse": K1.LAUNCHES, "bvh_traverse": K2.LAUNCHES}
    cull_calls = cllib.CALLS
    line("main_path", seconds=time.time() - t0, launches=launches,
         per_ray_cull_calls=cull_calls)
    check(launches["cluster_traverse"] > 0, "K1 never launched on the main path")
    check(launches["bvh_traverse"] > 0, "K2 never launched on the main path")
    check(cull_calls == 0, f"the main path called the torch cull {cull_calls} times")

    # the bvh accel's path: K2 carries every traversal
    K1.LAUNCHES = 0
    K2.LAUNCHES = 0
    cllib.CALLS = 0
    t0 = time.time()
    img, st = renderlib.render(sd128, spp=64, seed=3, compact=True, device=dev,
                               accel="bvh")
    torch.cuda.synchronize()
    launches_bvh = {"cluster_traverse": K1.LAUNCHES,
                    "bvh_traverse": K2.LAUNCHES}
    oracle_check("render128_compact_bvh", img)
    line("render128_compact_bvh_stats", **st)
    line("main_path_bvh", seconds=time.time() - t0, launches=launches_bvh,
         per_ray_cull_calls=cllib.CALLS)
    check(launches_bvh["bvh_traverse"] > 0, "K2 never launched on the bvh path")
    check(launches_bvh["cluster_traverse"] == 0, "K1 launched on the bvh path")
    check(cllib.CALLS == 0, "the bvh path called the torch cull")

    # ---- 7. IILE, before any profiler session ----
    iile = iile_phase(dev, scene_path, smi, K1, K2)

    # ---- 9. training, before any profiler session ----
    train = train_phase(dev, smi, K1, K2, (sd, scene, cam), iile["bvh_combined"])

    # ---- 10. scenes as pbrt-v3 writes them, before any profiler session ----
    scenes_pp = scenes_phase(dev, smi, K1, K2)

    # ---- 11. materials and transport, profiled after phase 8's timing ----
    transport = transport_phase(dev, smi, K1, K2)

    # ---- 12. cameras and aggregates, before any profiler session ----
    cams = cameras_phase(dev, smi, K1, K2, K3, (sd, scene, cam), waves)

    # ---- 8. timing, bounds ----
    t_timing = time.time()
    # the timed passes come first: a profiler session leaves tracing
    # overhead on the launches that follow it
    def pass_fn(accel):
        cfg = renderlib.make_integrator_config(sd, accel=accel, device=dev)
        cfg = cfg.replace(max_depth=5, compact_schedule=renderlib.COMPACT_SCHEDULE)
        return renderlib.render_pass_fn(sd, cfg, dev)

    key = threefry.prng_key(0)
    runs = {"clusters": pass_fn("clusters"), "bvh": pass_fn("bvh")}
    for run in runs.values():
        L, _, _ = run(scene, cam, key, 0)
        float(L.sum())                                 # warmup pass

    # the pass with each accel, in turns
    n_pass = 4
    res = {a: dict(times=[], rays=[], checksums=[], k1=0, k2=0) for a in runs}
    for p in range(1, n_pass + 1):
        for accel, run in runs.items():
            a1, a2 = K1.LAUNCHES, K2.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.time()
            L, _, aux = run(scene, cam, key, p)
            checksum = float(L.sum())                  # data-dependent sync
            r = res[accel]
            r["times"].append(time.time() - t0)
            r["rays"].append(int(aux["rays"]))
            r["checksums"].append(checksum)
            r["k1"] += K1.LAUNCHES - a1
            r["k2"] += K2.LAUNCHES - a2
            check(np.isfinite(checksum), f"non-finite 512^2 {accel} pass")
    per_pass = {a: {"cluster_traverse": r["k1"] / n_pass,
                    "bvh_traverse": r["k2"] / n_pass} for a, r in res.items()}
    for accel, r in res.items():
        mrays = [n / t / 1e6 for n, t in zip(r["rays"], r["times"])]
        line(f"atrium512_depth5_compact_{accel}", pass_seconds=r["times"],
             rays=r["rays"], mrays_per_s=mrays,
             mrays_per_s_total=sum(r["rays"]) / sum(r["times"]) / 1e6,
             launches_per_pass=per_pass[accel], checksums=r["checksums"],
             power=smi)
    check(per_pass["bvh"]["cluster_traverse"] == 0, "K1 launched in a bvh pass")
    check(per_pass["bvh"]["bvh_traverse"] > 0, "K2 never launched in a bvh pass")

    os_, ds_, ts_ = sorted_waves["bounce"]
    o, d, tm = waves["bounce"]
    l1, l2 = K1.LAUNCHES, K2.LAUNCHES
    ms = {
        "cluster_traverse": cuda_ms(lambda: K1.cluster_traverse_cuda(
            cp, os_, ds_, ts_, maxc), 20),
        "cluster_traverse_anyhit": cuda_ms(lambda: K1.cluster_traverse_cuda(
            cp, os_, ds_, ts_, maxc, any_hit=True), 20),
        "cluster_plain": plain_ms["cluster_plain_bounce"],
        "candidate_tables": cuda_ms(lambda: K1.candidate_tables(
            cp, os_, ds_, ts_, maxc), 5),
        "bvh_traverse": cuda_ms(lambda: k2(o, d, tm), 20),
        "bvh_wide_plain": plain_ms["bvh_wide_plain_bounce"],
        "bvh_walker": plain_ms["bvh_walker_bounce"],
    }
    line("kernel_ms_bounce_wave_65536", **ms, plain_ms_by_wave=plain_ms)
    k_cams = camera_kernel_timing(cams, scene, waves, K2, K3, isect, kdtree, smi)

    # K1's bound: the slab tests of every live group against every box, and
    # the Pluecker tests of the candidates the exact break cannot skip (the
    # first, and those whose tnear is below the group's largest final t)
    t_k, _, _ = K1.cluster_traverse_cuda(cp, os_, ds_, ts_, maxc)
    cand, cpk, ctn, ncand, n_cand = K1.candidate_tables(cp, os_, ds_, ts_, maxc)
    G, K = K1.G_DEFAULT, cp.feat.shape[0]
    live = (ts_ > 0).reshape(-1, G)
    gmax = torch.where(live, t_k.reshape(-1, G), -3e38).amax(1)
    slot = torch.arange(cand.shape[1], device=dev)[None, :]
    need = ((slot < ncand[:, None]) & (n_cand <= maxc)[:, None]
            & ((ctn < gmax[:, None]) | (slot == 0)))
    k1_tris = int(((cpk & 255) * need).sum())
    k1_slabs = int(live.any(1).sum()) * G * K
    k1_ops = k1_slabs * CULL_OPS + k1_tris * G * PLUCKER_OPS
    k1_bytes = (int(torch.unique(cand[need]).numel()) * 22 * K1.C * 4  # live rows
                + K * (24 + 8) + ts_.shape[0] * (28 + 8) + cand.shape[0] * 4)
    k1_bound, k1_by = bound(k1_ops, k1_bytes)
    line("K1_bound_bounce", slab_tests=k1_slabs,
         candidates_needed=int(need.sum()), candidates_listed=int(ncand.sum()),
         triangles_needed=k1_tris, gflop=k1_ops / 1e9, mbytes=k1_bytes / 1e6,
         bound_ms=k1_bound, bound_by=k1_by)
    # K2's bound keeps the binary walker's yardstick (its node visits and
    # triangle tests, the binary BVH's bytes), whatever the kernel walks
    work, wide_work = {}, {}
    isect.intersect_bvh(scene, o, d, tm, work=work)
    K2.bvh_traverse_wide_plain(scene.bvh4_nodes, scene.tris_packed, o, d, tm,
                               work=wide_work)
    k2_ops = work["nodes"] * NODE_OPS + work["tris"] * MOLLER_OPS
    k2_bytes = (scene.nodes_packed.nbytes + scene.tris_packed.nbytes
                + o.shape[0] * (28 + 16))
    k2_bound, k2_by = bound(k2_ops, k2_bytes)
    line("K2_bound_bounce", node_visits=work["nodes"], triangle_tests=work["tris"],
         gflop=k2_ops / 1e9, mbytes=k2_bytes / 1e6, bound_ms=k2_bound,
         bound_by=k2_by, wide_node_visits=wide_work["nodes"],
         wide_triangle_tests=wide_work["tris"], wide_stack_max=wide_work["stack"])

    # K2 at every wave of one bvh pass: its inputs recorded, then timed
    recorded = []
    direct = K2.intersect_bvh_kernel

    def recording(scene_, o_, d_, tm_, any_hit=False):
        recorded.append((o_.clone(), d_.clone(), tm_.clone(), any_hit))
        return direct(scene_, o_, d_, tm_, any_hit=any_hit)

    K2.intersect_bvh_kernel = recording
    try:
        L, _, _ = runs["bvh"](scene, cam, key, 0)
        float(L.sum())
    finally:
        K2.intersect_bvh_kernel = direct
    per_wave = [dict(rays=int(w[0].shape[0]), live=int((w[2] > 0).sum()),
                     any_hit=w[3],
                     ms=cuda_ms(lambda w=w: k2(*w), 10))
                for w in recorded]
    line("K2_per_wave_bvh_pass", waves=per_wave,
         sum_ms=sum(w["ms"] for w in per_wave), power=smi)
    K1.LAUNCHES, K2.LAUNCHES = l1, l2  # timing launches are not main-path ones

    def profiled(name, fn, unprofiled_s, table_file, keys, spans=()):
        """Device-busy ms of one run of fn under torch.profiler (the rows
        of device events only: an operator's row repeats the time of the
        kernels it launched, and the device rows of the record_function
        spans named in ``spans`` are ranges, not kernels) and the idle
        share against unprofiled_s; the profiled and unprofiled ms are
        printed under the names in keys, the profiler's table goes to
        OUT_DIR/table_file.  Returns the profile."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            prof_s = time.time() - t0
        averages = prof.key_averages()
        with open(os.path.join(OUT_DIR, table_file), "w") as f:
            f.write(averages.table(sort_by="cuda_time_total", row_limit=40))
        evs = [e for e in averages
               if e.device_type == DeviceType.CUDA and e.key not in spans]
        dev_us = sum(e.self_device_time_total for e in evs)
        check(dev_us > 0, "the profiler saw no device time")
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
        line(name, device_busy_ms=dev_us / 1e3,
             device_events=sum(e.count for e in evs),
             **{keys[0]: prof_s * 1e3, keys[1]: unprofiled_s * 1e3},
             idle_share=1.0 - dev_us / 1e6 / unprofiled_s,
             idle_share_profiled=1.0 - dev_us / 1e6 / prof_s,
             top=[(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
                  for e in top], power=smi)
        return prof

    t_profiles = time.time()
    for accel, run in runs.items():
        profiled(f"profile_atrium512_pass_{accel}",
                 lambda: float(run(scene, cam, key, n_pass + 1)[0].sum()),
                 float(np.median(res[accel]["times"])),
                 f"profile_atrium512_{accel}.txt",
                 ("profiled_pass_ms", "median_pass_ms"))

    transport["profile"](profiled)

    # the first task of the full-width IILE render (4 chunks of 65,536
    # pixels), timed unprofiled and then profiled
    from pbrt_v3_iile_tpu_torch.integrators import iispt, schedule
    from pbrt_v3_iile_tpu_torch.models import weights

    net = weights.load_iisptnet(device=dev)
    task = schedule.compute_schedule(512, 512, 1)[0]
    tkey = threefry.fold_in(threefry.prng_key(0), 1000)
    first_task = lambda: iispt.run_task(scene, cam, sd, net, tkey, task,
                                        accel="clusters")
    torch.cuda.synchronize()
    t0 = time.time()
    first_task()
    torch.cuda.synchronize()
    profiled("profile_iile512_task0", first_task, time.time() - t0,
             "profile_iile512_task0.txt",
             ("profiled_task_ms", "unprofiled_task_ms"))

    # 10 full-width train steps of phase 9 (batch 32), unprofiled and then
    # profiled
    ten_steps = lambda: [train["train_step"]() for _ in range(10)]
    torch.cuda.synchronize()
    t0 = time.time()
    ten_steps()
    torch.cuda.synchronize()
    profiled("profile_train_10_steps", ten_steps, time.time() - t0,
             "profile_train_10_steps.txt",
             ("profiled_10_steps_ms", "unprofiled_10_steps_ms"))

    kernels = [
        dict(name="cluster_traverse", route="cuda",
             source="pbrt_v3_iile_tpu_torch/csrc/cluster_traverse.cu",
             replaces="pbrt_v3_iile_tpu/ops/clusters_pallas.py:365",
             launches=launches["cluster_traverse"], max_abs_err=k1_err,
             ms=ms["cluster_traverse"], plain_ms=ms["cluster_plain"],
             bound_ms=k1_bound, bound_by=k1_by, library_ms=None,
             launches_per_pass=per_pass["clusters"]["cluster_traverse"],
             launches_per_pass_bvh=per_pass["bvh"]["cluster_traverse"],
             launches_iile=iile["clusters"]["cluster_traverse"],
             launches_iile_per_task=iile["per_task"]["cluster_traverse"],
             launches_train_generation_rep=train["generation"]["cluster_traverse"],
             **{f"launches_per_pass_{k}": v["cluster_traverse"]
                for k, v in scenes_pp.items()},
             **{f"launches_per_pass_transport512_{k}": v["cluster_traverse"]
                for k, v in transport["per_pass"].items()},
             launches_transport128_clusters=sum(
                 v["cluster_traverse"] for k, v in
                 transport["launches_128"].items() if k.endswith("_clusters"))),
        dict(name="bvh_traverse", route="cuda",
             source="pbrt_v3_iile_tpu_torch/csrc/bvh_traverse.cu",
             replaces="pbrt_v3_iile_tpu/ops/intersect_pallas.py:301",
             launches=launches_bvh["bvh_traverse"], max_abs_err=k2_err,
             ms=ms["bvh_traverse"], plain_ms=ms["bvh_wide_plain"],
             bound_ms=k2_bound, bound_by=k2_by, library_ms=None,
             launches_per_pass=per_pass["clusters"]["bvh_traverse"],
             launches_per_pass_bvh=per_pass["bvh"]["bvh_traverse"],
             launches_clusters_path=launches["bvh_traverse"],
             launches_iile_bvh=iile["bvh"]["bvh_traverse"],
             launches_train_dataset_bvh=train["gate_bvh"]["bvh_traverse"],
             **{f"launches_per_pass_{k}": v["bvh_traverse"]
                for k, v in scenes_pp.items()},
             **{f"launches_per_pass_transport512_{k}": v["bvh_traverse"]
                for k, v in transport["per_pass"].items()},
             launches_transport128_bvh=sum(
                 v["bvh_traverse"] for k, v in
                 transport["launches_128"].items() if k.endswith("_bvh")),
             launches_camera128=cams["launches_128"]["realistic_bvh"][
                 "bvh_traverse"]),
        dict(name="bvh_traverse_motion", route="cuda",
             source="pbrt_v3_iile_tpu_torch/csrc/bvh_traverse.cu",
             replaces="pbrt_v3_iile_tpu/ops/intersect.py:56",
             replaces_note=("intersect_bvh with time (keyframe lerp at "
                            ":111-124): an XLA while_loop, no pallas_call"),
             launches=cams["launches_128"]["motion_bvh"]["bvh_traverse_motion"],
             max_abs_err=cams["k2m_err"], ms=k_cams["motion_ms"],
             plain_ms=k_cams["motion_plain_ms"], bound_ms=k_cams["motion_bound_ms"],
             bound_by=k_cams["motion_bound_by"], library_ms=None,
             launches_per_pass_motion512=cams["per_pass"]["motion_bvh"][
                 "bvh_traverse_motion"]),
        dict(name="kd_traverse", route="cuda",
             source="pbrt_v3_iile_tpu_torch/csrc/kd_traverse.cu",
             replaces="pbrt_v3_iile_tpu/ops/kdtree.py:150",
             replaces_note="intersect_kd: an XLA while_loop, no pallas_call",
             launches=cams["launches_128"]["kdtree_kdtree"]["kd_traverse"],
             max_abs_err=cams["k3_err"], ms=k_cams["kd_ms"],
             plain_ms=k_cams["kd_plain_ms"], bound_ms=k_cams["kd_bound_ms"],
             bound_by=k_cams["kd_bound_by"], library_ms=None,
             launches_per_pass_kdtree512=cams["per_pass"]["atrium_kdtree"][
                 "kd_traverse"]),
    ]
    line("timing_phase", wall_seconds=time.time() - t_timing,
         profiles_seconds=time.time() - t_profiles)
    line("total", wall_seconds=time.time() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
