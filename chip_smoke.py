"""End-to-end smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (one line each):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build both CUDA kernels from pbrt_v3_iile_tpu_torch/csrc;
  3. build the device scene of scenes/atrium.pbrt on the GPU;
  4. the BVH kernel (K2) against its plain version, the vectorized BVH
     walker, on two 65,536-ray waves of the 512^2 film (primary rays and
     one diffuse bounce from their hits), closest-hit and any-hit;
  5. the cluster kernel (K1) against its plain version, and the whole
     cluster traversal against K2, on the same waves; then once with
     cluster_maxc=8 so that the overflow groups go through K2;
  6. the main path through render(): atrium 128^2, 64 spp, seed 3, the
     default CUDA config (clusters), plain and compacted, each held
     against the reference C++ renderer's image with the atrium-path
     tolerances of tests/test_oracle_parity.py; then one pass with
     cluster_maxc=8 (the forced overflow path).  Kernel launch counts are
     read around exactly this phase;
  7. timing (printed, no threshold): each kernel and its plain version at
     the main-path shapes, and the atrium 512^2 depth-5 compacted pass as
     bench.py configures it, in Mrays/s counted as path.py counts rays.
Prints the kernel JSON line, the device line, and as its last line
{"ok": true, "device": {...}}.  Any failure exits non-zero with no result.
Long output (the profiler table) goes to chiprun_out/.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

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


def oracle_check(name, img):
    fixture, gtol, rtols, btol = ORACLE
    ref = np.load(os.path.join(REPO, "tests", "golden", fixture))
    g = abs(img.mean() - ref.mean()) / ref.mean()
    res = img.shape[0]
    h = res // 3
    regions = []
    for (lo, hi), tol in zip(((0, h), (h, 2 * h), (2 * h, res)), rtols):
        m, r = img[lo:hi].mean(), ref[lo:hi].mean()
        regions.append(float(abs(m - r) / max(r, 1e-3)))
        check(abs(m - r) < tol * max(r, 1e-3),
              f"{name}: rows {lo}:{hi} mean {m} vs reference {r}")
    n = res // 4 * 4
    blur = lambda x: x[:n, :n].reshape(n // 4, 4, n // 4, 4, 3).mean((1, 3))
    bm, br = blur(img), blur(ref)
    rel = float(np.abs(bm - br).mean() / br.mean())
    line(name, mean=float(img.mean()), ref_mean=float(ref.mean()),
         global_rel=float(g), region_rel=regions, blur_rel_l1=rel,
         finite=bool(np.isfinite(img).all()))
    check(np.isfinite(img).all(), f"{name}: non-finite pixels")
    check(g < gtol, f"{name}: global mean off by {g}")
    check(rel < btol, f"{name}: blurred rel L1 {rel}")


def main():
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

    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu_torch import _build
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import clusters as cllib
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as K1
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2
    from pbrt_v3_iile_tpu_torch.ops import sampling as smp
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    # ---- 2. build the kernels ----
    t0 = time.time()
    for name in ("bvh_traverse", "cluster_traverse"):
        _build.load(name, verbose=True)
    line("build", seconds=time.time() - t0, dir=_build.BUILD_DIR)

    # ---- 3. the device scene ----
    scene_path = os.path.join(REPO, "scenes", "atrium.pbrt")
    t0 = time.time()
    sd = apilib.load_scene(scene_path)
    sd.film.x_resolution = sd.film.y_resolution = 512
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    torch.cuda.synchronize()
    line("scene", seconds=time.time() - t0, triangles=scene.tri_p0.shape[0],
         nodes=scene.nodes_packed.shape[0],
         clusters=scene.clusters.feat.shape[0])

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

    k2_err = 0.0
    for wname, (o, d, tm) in waves.items():
        ref = isect.intersect_bvh(scene, o, d, tm)
        t, prim, b1, b2 = K2.bvh_traverse_cuda(scene.nodes_packed,
                                               scene.tris_packed, o, d, tm)
        torch.cuda.synchronize()
        r = compare_hits(f"K2_vs_plain_{wname}", t, prim, ref.t, ref.prim,
                         b1, b2, ref.b1, ref.b2)
        k2_err = max(k2_err, r["t_max_abs"])
    for wname, (o, d, tm) in (("bounce", waves["bounce"]),
                              ("shadow", (o_s, d_s, tm_s))):
        ref = isect.intersect_bvh(scene, o, d, tm, any_hit=True)
        _, prim, _, _ = K2.bvh_traverse_cuda(scene.nodes_packed,
                                             scene.tris_packed, o, d, tm,
                                             any_hit=True)
        va, vb = (prim >= 0).cpu().numpy(), ref.valid.cpu().numpy()
        frac = float((va == vb).mean())
        line(f"K2_anyhit_vs_plain_{wname}", agree=frac, occluded=int(vb.sum()))
        check(frac >= PRIM_AGREE, f"K2 any-hit {wname}: agreement {frac}")

    # ---- 5. K1 vs its plain version, and vs K2 ----
    cp = scene.clusters
    k1_err = 0.0
    tables = {}
    for wname, (o, d, tm) in waves.items():
        key = cllib.sort_key6(o, d, scene.world_min,
                                              scene.world_max)
        key = torch.where(tm > 0, key, 0x7FFFFFFF)
        perm = torch.sort(key, stable=True).indices
        os_, ds_, ts_ = o[perm].contiguous(), d[perm].contiguous(), tm[perm].contiguous()
        cand, cpk, ctn, ncand, n_cand = K1.candidate_tables(cp, os_, ds_, ts_)
        rays = K1.ray_table(os_, ds_)
        tables[wname] = (cand, cpk, ctn, ncand, rays, ts_)
        line(f"K1_tables_{wname}", groups=int(cand.shape[0]),
             mean_candidates=float(n_cand.float().mean()),
             max_candidates=int(n_cand.max()),
             overflow_groups=int((n_cand > cand.shape[1]).sum()))
        t, prim = K1.traverse_groups_cuda(cp.feat, cand, cpk, ctn, ncand, rays, ts_)
        tp, pp = K1.traverse_groups_plain(cp.feat, cand, cpk, ctn, ncand, rays, ts_)
        torch.cuda.synchronize()
        r = compare_hits(f"K1_vs_plain_{wname}", t, prim, tp, pp)
        k1_err = max(k1_err, r["t_max_abs"])
        _, pa = K1.traverse_groups_cuda(cp.feat, cand, cpk, ctn, ncand, rays,
                                        ts_, any_hit=True)
        va, vb = (pa >= 0).cpu().numpy(), (pp >= 0).cpu().numpy()
        frac = float((va == vb).mean())
        line(f"K1_anyhit_vs_plain_{wname}", agree=frac)
        check(frac >= PRIM_AGREE, f"K1 any-hit {wname}: agreement {frac}")
        # whole cluster traversal (K1 + overflow through K2) vs K2 alone
        h1 = isect.intersect(scene, o, d, tm, accel="clusters")
        h2 = isect.intersect(scene, o, d, tm, accel="bvh")
        compare_hits(f"clusters_vs_K2_{wname}", h1.t, h1.prim, h2.t, h2.prim,
                     agree_min=XALG_AGREE)
    n2 = K2.LAUNCHES
    o, d, tm = waves["bounce"]
    h8 = isect.intersect(scene, o, d, tm, accel="clusters", cluster_maxc=8)
    h2 = isect.intersect(scene, o, d, tm, accel="bvh")
    compare_hits("clusters_maxc8_vs_K2_bounce", h8.t, h8.prim, h2.t, h2.prim,
                 agree_min=XALG_AGREE)
    check(K2.LAUNCHES > n2 + 1, "cluster_maxc=8 did not route overflow to K2")

    # ---- 6. the main path through render(), with launch counts ----
    sd128 = apilib.load_scene(scene_path)
    sd128.film.x_resolution = sd128.film.y_resolution = 128
    K1.LAUNCHES = 0
    K2.LAUNCHES = 0
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
    line("main_path", seconds=time.time() - t0, launches=launches)
    check(launches["cluster_traverse"] > 0, "K1 never launched on the main path")
    check(launches["bvh_traverse"] > 0, "K2 never launched on the main path")

    # ---- 7. timing ----
    cand, cpk, ctn, ncand, rays, ts_ = tables["bounce"]
    o, d, tm = waves["bounce"]
    l1, l2 = K1.LAUNCHES, K2.LAUNCHES
    ms = {
        "cluster_traverse": cuda_ms(lambda: K1.traverse_groups_cuda(
            cp.feat, cand, cpk, ctn, ncand, rays, ts_), 20),
        "cluster_plain": cuda_ms(lambda: K1.traverse_groups_plain(
            cp.feat, cand, cpk, ctn, ncand, rays, ts_), 2),
        "bvh_traverse": cuda_ms(lambda: K2.bvh_traverse_cuda(
            scene.nodes_packed, scene.tris_packed, o, d, tm), 20),
        "bvh_plain": cuda_ms(lambda: isect.intersect_bvh(scene, o, d, tm), 2),
    }
    K1.LAUNCHES, K2.LAUNCHES = l1, l2  # timing launches are not main-path ones
    line("kernel_ms_bounce_wave_65536", **ms)

    cfg = renderlib.make_integrator_config(sd, device=dev)
    cfg = cfg.replace(max_depth=5, compact_schedule=renderlib.COMPACT_SCHEDULE)
    run = renderlib.render_pass_fn(sd, cfg, dev)
    key = threefry.prng_key(0)
    L, _, aux = run(scene, cam, key, 0)
    float(L.sum())                                     # warmup pass
    times, rays_n = [], []
    for p in range(1, 5):
        torch.cuda.synchronize()
        t0 = time.time()
        L, _, aux = run(scene, cam, key, p)
        checksum = float(L.sum())                      # data-dependent sync
        times.append(time.time() - t0)
        rays_n.append(int(aux["rays"]))
        check(np.isfinite(checksum), "non-finite 512^2 pass")
    mrays = [r / t / 1e6 for r, t in zip(rays_n, times)]
    line("atrium512_depth5_compact", pass_seconds=times, rays=rays_n,
         mrays_per_s=mrays, mrays_per_s_total=sum(rays_n) / sum(times) / 1e6,
         power=smi)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        L, _, _ = run(scene, cam, key, 5)
        float(L.sum())
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(OUT_DIR, "profile_atrium512.txt"), "w") as f:
        f.write(table)
    evs = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in evs)
    top = sorted(evs, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    line("profile_atrium512_pass", device_ms=dev_us / 1e3,
         top=[(e.key[:60], round(getattr(e, "self_device_time_total", 0.0) / 1e3, 3))
              for e in top])

    kernels = [
        dict(name="cluster_traverse", route="cuda",
             source="pbrt_v3_iile_tpu_torch/csrc/cluster_traverse.cu",
             replaces="pbrt_v3_iile_tpu/ops/clusters_pallas.py:365",
             launches=launches["cluster_traverse"], max_abs_err=k1_err,
             ms=ms["cluster_traverse"], plain_ms=ms["cluster_plain"]),
        dict(name="bvh_traverse", route="cuda",
             source="pbrt_v3_iile_tpu_torch/csrc/bvh_traverse.cu",
             replaces="pbrt_v3_iile_tpu/ops/intersect_pallas.py:301",
             launches=launches["bvh_traverse"], max_abs_err=k2_err,
             ms=ms["bvh_traverse"], plain_ms=ms["bvh_plain"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
