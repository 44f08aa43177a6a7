"""Driver of the frame cells of the ``path`` integrator.

Set-up builds the scene once (the cell's accel only) and renders one pass
at the cell's shapes.  The window renders whole frames of the traffic's
pixel samples back to back through ``integrators/render.py::render`` on
that prebuilt scene, each frame with a key of its own drawn from the run's
seed.  A frame is started only while the frames so far say it will end
within the window's seconds; the first always runs.  Rates are taken over
whole frames, from the window's start to the end of the last one.

With ``trace``, one more frame of the same traffic runs under
torch.profiler after the window, and the calls of K1 in its first pass
are kept for their roofline.  Once every frame has run, the program's
state is freed and the reference renders two independent images of the
same scene and estimator; each frame is compared with them
(``benchmark/compare.py``).
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import os
import sys
import time

import numpy as np
import torch

from benchmark import compare, roofline, tracing

K1_KERNEL = "cluster_traverse_kernel"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def derive_seed(seed: int, *tags) -> int:
    """A 31-bit seed for one use of the run's seed (a frame, the reference)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


class Cell:
    """The program set up for one cell: the scene built, the shapes warm."""

    def __init__(self, root, config, traffic, device="cuda"):
        from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
        from pbrt_v3_iile_tpu_torch.scene import api

        self.renderlib = renderlib
        self.root = root
        self.config, self.traffic = config, traffic
        self.dev = torch.device(device)
        self.scene_path = os.path.join(root, config["scene"])
        sd = api.load_scene(self.scene_path)
        sd.film.x_resolution, sd.film.y_resolution = traffic["film"]
        sd.integrator.max_depth = config["max_depth"]
        self.sd = sd
        self.accel = traffic["accel"]
        self.prebuilt = renderlib.build(sd, self.dev,
                                        with_clusters=self.accel == "clusters",
                                        with_kdtree=self.accel == "kdtree")

    def frame(self, seed, spp=None, report=None):
        """One frame -> (image (H, W, 3) float32 numpy, rays traced)."""
        img, st = self.renderlib.render(
            self.sd, spp=spp or self.traffic["spp"], seed=seed,
            max_wave=self.traffic["max_wave"], accel=self.accel,
            compact=self.config["compact"], device=self.dev,
            prebuilt=self.prebuilt, report=report)
        return img, st["rays"]

    def free(self):
        self.prebuilt = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_image(root, config, traffic, seed, spp, device, dtype=torch.float32):
    """The reference's image of the cell's scene and estimator."""
    ref = importlib.import_module(f"benchmark.reference.{config['reference']}")
    W, H = traffic["film"]
    rsd = ref.load_scene(os.path.join(root, config["scene"]), W, H,
                         config["max_depth"])
    return ref.render(rsd, spp, seed, device, dtype=dtype)


def reference_halves(root, config, traffic, seed, device):
    """The reference's two independent images, of the traffic's
    ``reference_half_spp`` samples each, from two seeds drawn from seed."""
    return tuple(reference_image(root, config, traffic, derive_seed(seed, "half", i),
                                 traffic["reference_half_spp"], device)
                 for i in range(2))


def _window(cell, seed, seconds):
    frames, rays, times = [], 0, []
    _sync(cell.dev)
    t0 = time.perf_counter()
    while True:
        n = len(frames)
        el = time.perf_counter() - t0
        if n and el + el / n > seconds:
            break
        img, r = cell.frame(derive_seed(seed, "frame", n))
        frames.append(img)
        rays += r
        times.append(time.perf_counter() - t0)
    _sync(cell.dev)
    return frames, rays, time.perf_counter() - t0, times


def _traced_frame(cell, seed, n, trace_dir):
    """One more frame under the profiler -> (image, trace summary, the
    recorded K1 calls of its first pass)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    k1mod = importlib.import_module("pbrt_v3_iile_tpu_torch.ops.clusters_kernel")
    direct = k1mod.cluster_traverse_cuda
    calls, on = [], [True]

    def recording(cp, o, d, t_max, maxc, any_hit=False):
        out = direct(cp, o, d, t_max, maxc, any_hit)
        if on[0]:
            calls.append((cp, o, d, t_max, out[0], maxc))
        return out

    def report(done, spp, film):
        on[0] = False

    k1mod.cluster_traverse_cuda = recording
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                img, rays = cell.frame(derive_seed(seed, "frame", n), report=report)
                torch.cuda.synchronize()
    finally:
        k1mod.cluster_traverse_cuda = direct
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        summary = tracing.summarize(tracing.load_events(path), (K1_KERNEL,))
    finally:
        os.remove(path)
    return img, rays, summary, calls


def run(ctx) -> dict:
    """One run of the cell -> the record the metric readers read."""
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cell = Cell(ctx.root, cfg, tr, dev)
    cell.frame(derive_seed(ctx.seed, "warmup"), spp=1)   # the cell's shapes
    _sync(dev)
    setup_s = time.time() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    frames, rays, window_s, times = _window(cell, ctx.seed, ctx.seconds)
    print(f"[window] {len(frames)} frames, ends at "
          f"{' '.join(f'{t:.3f}' for t in times)} s", file=sys.stderr)
    rec = dict(setup_s=setup_s, window_s=window_s, frames=len(frames),
               frame_ends_s=times, rays=rays,
               samples=len(frames) * tr["spp"] * tr["film"][0] * tr["film"][1],
               passes=len(frames) * tr["spp"],
               window_peak_bytes=_peak(dev))
    if ctx.trace:
        img, t_rays, summary, calls = _traced_frame(
            cell, ctx.seed, len(frames), os.path.join(ctx.root, "build", "bench_trace"))
        frames.append(img)
        rec["trace"] = summary
        rec["trace_passes"] = tr["spp"]
        k1_dev = summary["kernels"][K1_KERNEL][:len(calls)]
        if calls and len(k1_dev) == len(calls):
            ops = nbytes = 0
            for cp, o, d, t_max, t_out, maxc in calls:
                w = roofline.k1_work(cp.aabb_min, cp.aabb_max, cp.tri_cnt, o, d,
                                     t_max, t_out, maxc)
                ops += w["ops"]
                nbytes += w["bytes"]
            least, by = roofline.bound(ops, nbytes)
            rec["k1"] = dict(calls=len(calls), least_s=least, bound_by=by,
                             device_s=sum(k1_dev), ops=ops, bytes=nbytes)
        del calls
    rec["memory_peak_bytes"] = _peak(dev)
    cell.free()
    del cell
    # the reference, with the program's state freed
    t_ref = time.perf_counter()
    ref_a, ref_b = reference_halves(ctx.root, cfg, tr,
                                    derive_seed(ctx.seed, "reference"), dev)
    per_frame = [compare.frame_numbers(torch.from_numpy(np.ascontiguousarray(f)).to(dev),
                                       ref_a, ref_b, tr["tiles"]) for f in frames]
    rec["reference_s"] = time.perf_counter() - t_ref
    worst, failed = compare.judge(per_frame, tr["limits"])
    rec.update(attempted=len(frames), failed=failed, checks=worst,
               limits=tr["limits"], per_frame=per_frame)
    print(f"[reference] {rec['reference_s']:.3f} s, two halves of "
          f"{tr['reference_half_spp']} spp", file=sys.stderr)
    return rec
