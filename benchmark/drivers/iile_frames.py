"""Driver of the IILE frame cells: ``render_iile`` frames back to back.

Set-up builds the scene once (the cell's accel only), loads the
configuration's IISPTNet, and renders one frame of the traffic's warm-up
schedule at the cell's shapes.  The window renders whole frames of the
traffic's indirect tasks and direct passes through
``integrators/iispt.py::render_iile`` on that prebuilt scene and net, as
the CLI's ``--integrator iispt`` renders, each frame with a key of its
own drawn from the run's seed; a frame is started only while the frames
so far say it will end within the window's seconds, and the first always
runs.  A frame's samples are its pixels times its tasks and passes: each
task of the cell's schedule covers the whole image.

``iispt.probe_radiance`` is wrapped for the run: the G-buffers, validity
and radiance maps of each frame's first task are kept.  With ``trace``,
a frame of the traffic's ``traced`` schedule (fewer tasks and passes than
a window's frame, so that its trace stays small) runs after the window,
first untraced for its wall time, then with the port's tracer on under
torch.profiler; its ``iile/`` spans give the per-task kernels and device
time (``benchmark/spans.py::by_span``), the device time inside
``iile/cnn`` gives IISPTNet's roofline (``benchmark/roofline_iile.py``),
and its device busy time over the untraced wall the device's idle share.

Once every frame has run, the program's state is freed.  The reference
(``benchmark/reference/pbrt_iile.py``) renders two independent frames of
the same traffic, and each frame is judged by two checks, both on every
frame: its numbers against the two reference frames
(``benchmark/compare.py``), and ``cnn_map_rel``, the relative L2
difference of the kept maps of its valid probes from the maps the
reference's transforms and U-Net compute from the same G-buffers.
"""

from __future__ import annotations

import gc
import importlib
import inspect
import os
import sys
import time

import numpy as np
import torch

from benchmark import compare, harness, roofline, roofline_iile, spans, tracing
from benchmark.drivers.path_frames import derive_seed

PREFIXES = ("iile/",)
CNN_SPAN = "iile/cnn"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


class Cell:
    """The program set up for one cell: the scene built, the net loaded,
    ``probe_radiance`` wrapped to keep each frame's first maps."""

    def __init__(self, root, config, traffic, device="cuda"):
        from pbrt_v3_iile_tpu_torch.integrators import iispt
        from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
        from pbrt_v3_iile_tpu_torch.models import weights as weightlib
        from pbrt_v3_iile_tpu_torch.scene import api

        if "prebuilt" not in inspect.signature(iispt.render_iile).parameters:
            raise harness.RunFailed("render_iile takes no prebuilt scene")
        self.iispt = iispt
        self.config, self.traffic = config, traffic
        self.dev = torch.device(device)
        sd = api.load_scene(os.path.join(root, config["scene"]))
        sd.film.x_resolution, sd.film.y_resolution = traffic["film"]
        sd.integrator.kind = config["integrator"]
        sd.integrator.max_depth = config["max_depth"]
        self.sd = sd
        self.accel = traffic["accel"]
        self.prebuilt = renderlib.build(sd, self.dev,
                                        with_clusters=self.accel == "clusters",
                                        with_kdtree=self.accel == "kdtree")
        self.net = weightlib.load_iisptnet(os.path.join(root, config["weights"]), self.dev)
        self.maps, self._keep = [], False
        self._probe_radiance = iispt.probe_radiance
        iispt.probe_radiance = self._recording

    def _recording(self, net, gb, valid):
        R = self._probe_radiance(net, gb, valid)
        if self._keep:
            self._keep = False
            self.maps.append(dict(intensity=gb.intensity, normals=gb.normals,
                                  distance=gb.distance, valid=valid, R=R))
        return R

    def frame(self, seed, tasks=None, direct=None):
        """One frame -> its combined image (H, W, 3) float32 numpy; its
        first task's maps join ``maps``."""
        tr = self.traffic
        self._keep = True
        img, _, _, _ = self.iispt.render_iile(
            self.sd, net=self.net, seed=seed,
            indirect_tasks=tr["indirect_tasks"] if tasks is None else tasks,
            direct_samples=tr["direct_samples"] if direct is None else direct,
            hemi_size=tr["hemi_size"], accel=self.accel, device=self.dev,
            prebuilt=self.prebuilt)
        return img

    def free(self):
        self.iispt.probe_radiance = self._probe_radiance
        self.prebuilt = self.net = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


class Reference:
    """The reference renderer of the cell's scene and net."""

    def __init__(self, root, config, traffic, device, dtype=torch.float32):
        self.mod = importlib.import_module(f"benchmark.reference.{config['reference']}")
        W, H = traffic["film"]
        sd = self.mod.load_scene(os.path.join(root, config["scene"]), W, H,
                                 config["max_depth"])
        self.traffic = traffic
        self.r = self.mod.Iile(sd, self.mod.load_weights(os.path.join(root, config["weights"])),
                               device, dtype)

    def frame(self, seed):
        tr = self.traffic
        return self.r.frame(seed, tr["indirect_tasks"], tr["direct_samples"],
                            tr["hemi_size"])[0]

    def pair(self, seed):
        """Two independent frames from seeds drawn from seed."""
        return tuple(self.frame(derive_seed(seed, "reference", i)) for i in range(2))

    def map_rel(self, m):
        """cnn_map_rel of kept maps: ||R - R_ref|| / ||R_ref|| over the valid
        probes, R_ref from the same G-buffers."""
        dt = self.r.sc.dt
        ref = self.mod.radiance_maps(m["intensity"].to(dt), m["normals"].to(dt),
                                     m["distance"].to(dt), m["valid"], self.r.w)
        v = m["valid"]
        a, b = m["R"][v].double(), ref[v].double()
        den = float(torch.linalg.vector_norm(b))
        return float(torch.linalg.vector_norm(a - b)) / den if den > 0 else float("inf")


def judge_frames(frames, maps, ref_a, ref_b, ref: Reference, traffic):
    """Each frame's numbers (compare.frame_numbers and cnn_map_rel) ->
    (per-frame numbers, worst of each, frames failed)."""
    dev = ref_a.device
    per_frame = []
    for i, img in enumerate(frames):
        n = compare.frame_numbers(torch.from_numpy(np.ascontiguousarray(img)).to(dev),
                                  ref_a, ref_b, traffic["tiles"])
        # a frame that kept no maps fails the check
        n["cnn_map_rel"] = ref.map_rel(maps[i]) if i < len(maps) else float("inf")
        per_frame.append(n)
    worst, failed = compare.judge(per_frame, traffic["limits"])
    return per_frame, worst, failed


def _window(cell, seed, seconds):
    frames, times = [], []
    _sync(cell.dev)
    t0 = time.perf_counter()
    while True:
        n = len(frames)
        el = time.perf_counter() - t0
        if n and el + el / n > seconds:
            break
        frames.append(cell.frame(derive_seed(seed, "frame", n)))
        times.append(time.perf_counter() - t0)
    _sync(cell.dev)
    return frames, time.perf_counter() - t0, times


def traced_frame(cell, seed, trace_dir, tasks, direct):
    """One more frame of ``tasks`` tasks and ``direct`` passes with the
    tracer on under the profiler -> (tracing.summarize of it, spans.by_span
    of its ``iile/`` spans, the tracer's counters, the trace's bytes and
    its load seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pbrt_v3_iile_tpu_torch.utils import stats

    stats.reset()
    stats.enable(True)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                cell.frame(seed, tasks=tasks, direct=direct)
                torch.cuda.synchronize()
    finally:
        stats.enable(False)
    counters = stats.counters()
    stats.reset()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        events = tracing.load_events(path)
        load_s = time.perf_counter() - t0
    finally:
        os.remove(path)
    summary = tracing.summarize(events)
    by = spans.by_span(events, prefixes=PREFIXES)
    del events
    return summary, by, counters, nbytes, load_s


def run(ctx) -> dict:
    """One run of the cell -> the record the metric readers read."""
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cell = Cell(ctx.root, cfg, tr, dev)
    warm = tr["warmup"]
    cell.frame(derive_seed(ctx.seed, "warmup"), tasks=warm["indirect_tasks"],
               direct=warm["direct_samples"])
    cell.maps.clear()
    _sync(dev)
    setup_s = time.time() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    frames, window_s, times = _window(cell, ctx.seed, ctx.seconds)
    W, H = tr["film"]
    print(f"[window] {len(frames)} frames, ends at "
          f"{' '.join(f'{t:.3f}' for t in times)} s", file=sys.stderr)
    rec = dict(setup_s=setup_s, window_s=window_s, frames=len(frames),
               frame_ends_s=times,
               samples=len(frames) * W * H * (tr["indirect_tasks"] + tr["direct_samples"]),
               window_peak_bytes=_peak(dev))
    if ctx.trace:
        t0 = time.perf_counter()
        seed_t, sched = derive_seed(ctx.seed, "traced"), tr["traced"]
        # the same frame untraced first: the wall its device time is set against
        _sync(dev)
        t1 = time.perf_counter()
        cell.frame(seed_t, tasks=sched["indirect_tasks"], direct=sched["direct_samples"])
        _sync(dev)
        untraced_wall_s = time.perf_counter() - t1
        summary, by, counters, nbytes, load_s = traced_frame(
            cell, seed_t, os.path.join(ctx.root, "build", "bench_trace"),
            sched["indirect_tasks"], sched["direct_samples"])
        del cell.maps[len(frames):]
        tasks = counters.get("iile/tasks", 0)
        rec.update(trace=summary, iile_spans=by, iile_counters=counters,
                   iile_trace_tasks=tasks, untraced_wall_s=untraced_wall_s,
                   trace_bytes=nbytes, trace_load_s=load_s)
        cnn = by.get(CNN_SPAN)
        if cnn and cnn["device_s"] > 0 and counters.get("iile/cnn_probes"):
            w = roofline_iile.iisptnet_work(counters["iile/cnn_probes"], tr["hemi_size"])
            least, bound_by = roofline.bound(w["flops"], w["bytes"])
            rec["iisptnet"] = dict(least_s=least, bound_by=bound_by,
                                   device_s=cnn["device_s"], **w)
        print(f"[trace] {nbytes / 1e6:.1f} MB, loaded in {load_s:.1f} s; traced frame and "
              f"its reading {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        for k, r in sorted(by.items(), key=lambda kv: -kv[1]["device_s"]):
            print(f"[spans] {k} a task: calls {r['calls'] / max(tasks, 1):.2f} host_ms "
                  f"{1e3 * r['host_s'] / max(tasks, 1):.3f} kernels {r['kernels'] / max(tasks, 1):.1f} "
                  f"device_ms {1e3 * r['device_s'] / max(tasks, 1):.3f} idle_ms "
                  f"{1e3 * r['idle_s'] / max(tasks, 1):.3f}", file=sys.stderr)
    rec["memory_peak_bytes"] = _peak(dev)
    maps = cell.maps
    cell.free()
    del cell
    # the reference, with the program's state freed
    t_ref = time.perf_counter()
    ref = Reference(ctx.root, cfg, tr, dev)
    ref_a, ref_b = ref.pair(derive_seed(ctx.seed, "reference"))
    per_frame, worst, failed = judge_frames(frames, maps, ref_a, ref_b, ref, tr)
    rec["reference_s"] = time.perf_counter() - t_ref
    rec.update(attempted=len(frames), failed=failed, checks=worst,
               limits=tr["limits"], per_frame=per_frame)
    print(f"[reference] {rec['reference_s']:.3f} s, two frames of "
          f"{tr['indirect_tasks']} tasks and {tr['direct_samples']} direct passes",
          file=sys.stderr)
    return rec

