"""The program's spans, per pass of a frame: calls, host time, the kernels
launched inside each span, their device time, and the device's idle time
that opened inside it.

The port's tracer (``pbrt_v3_iile_tpu_torch/utils/stats.py``) marks the
phases of the path pass as spans (``render/``, ``path/``, ``samples/``)
and every host-device sync as a ``sync/<name>`` span.  With the tracer on
and no profiler, ``host_record`` reads the host's own record of them;
under torch.profiler each span is a ``user_annotation`` on the trace's
clock, and ``by_span`` joins every device operation to its launch by the
trace's ``correlation`` id and gives it to the innermost program span
open at the launch.

``READERS`` computes five per-pass values from a record that holds
``spans_host`` (``host_record`` of a frame with the spans on and no
profiler) and ``spans_trace`` (``trace_record`` of a frame with the spans
on under the profiler); each returns None on a record without them.

On a machine with a CUDA card, from the root of a checkout:

    python3 -m benchmark.spans --seed N [--sync-debug]

sets the cell ``CELL`` up as ``drivers/path_frames.py`` does, renders 3
frames with the tracer off (their mean frame is the yardstick of the
tracer's cost), one with the spans on and no profiler, and one with the
spans on under the profiler, and prints to standard error the
``[spans]`` table a pass (host and self ms from the frame without the
profiler; kernels, device and idle ms from the traced one), the share of
device time launched inside named spans, and the spans outside every
``render/pass``.  ``--sync-debug`` renders one more frame under
``torch.cuda.set_sync_debug_mode("warn")`` and counts the synchronising
calls inside and outside ``sync/`` spans.  Every frame is then judged
against the reference's two halves as ``path_frames.run`` judges its own
(``benchmark/compare.py``); the exit code is 1 when one fails.  The last
line of standard output is one JSON object with the values.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

from benchmark import tracing
from pbrt_v3_iile_tpu_torch.utils.stats import self_times

CELL = "atrium-path-1440sq"
YARDSTICK_FRAMES = 3         # untraced frames, the yardstick of the tracer's cost
TOP_OPS = 3                  # device operations kept a span, by device time
PREFIXES = ("render/", "path/", "samples/", "sync/")
OUTSIDE = "outside"          # launched, or a gap opened, outside every span
UNLAUNCHED = "unlaunched"    # a device operation with no launch in the trace
HOST_CATS = ("cuda_runtime", "cuda_driver")


def _open_at(spans, points):
    """spans: [(t0, t1, name)] properly nested; points: times -> the name
    of the innermost span open at each point (None outside every span)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out = [None] * len(points)
    stack, i = [], 0
    for k in order:
        t = points[k]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def by_span(events, prefixes=PREFIXES) -> dict:
    """Chrome trace events of a window (``tracing.WINDOW``) -> {span name:
    {"calls", "host_s", "self_s", "kernels", "device_s", "idle_s", "ops"}}.

    Spans are the ``user_annotation`` events whose name starts with one
    of ``prefixes``; host and self seconds are their durations in the
    trace.  A device operation (``tracing.DEVICE_CATS``, clipped to the
    window) is joined to its launch by ``args.correlation`` and counted
    in the innermost span open when the launch began (``kernels`` counts
    the kernels, ``device_s`` every operation's time, ``ops`` the
    ``TOP_OPS`` operations by device time, [[name, seconds], ...]), or under
    ``outside``, or under ``unlaunched`` when the trace holds no launch of
    that id.  Each gap between the window's device intervals is idle
    time of the innermost span open when it opens, or of ``outside``."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == tracing.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {tracing.WINDOW!r} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans, launch, dev = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, s = e.get("cat"), float(e["ts"])
        t = s + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name", "").startswith(tuple(prefixes)):
            spans.append((s, t, e["name"]))
        elif cat in HOST_CATS and corr is not None:
            launch[corr] = s
        elif cat in tracing.DEVICE_CATS and t > w0 and s < w1:
            dev.append((max(s, w0), min(t, w1), cat, corr, e.get("name", "?")))
    out: dict = {}

    def row(name):
        return out.setdefault(name, dict(calls=0, host_s=0.0, self_s=0.0, kernels=0,
                                          device_s=0.0, idle_s=0.0, ops={}))

    def add(name, d):
        r = row(name)
        r["kernels"] += d[2] == "kernel"
        r["device_s"] += (d[1] - d[0]) * 1e-6
        r["ops"][d[4]] = r["ops"].get(d[4], 0.0) + (d[1] - d[0]) * 1e-6

    for (s, t, name), own in zip(spans, self_times([s[:2] for s in spans])):
        r = row(name)
        r["calls"] += 1
        r["host_s"] += (t - s) * 1e-6
        r["self_s"] += own * 1e-6
    launched = [d for d in dev if d[3] in launch]
    for d in dev:
        if d[3] not in launch:
            add(UNLAUNCHED, d)
    for d, name in zip(launched, _open_at(spans, [launch[d[3]] for d in launched])):
        add(name or OUTSIDE, d)
    busy = tracing._union([(d[0], d[1]) for d in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    for (s, t), name in zip(gaps, _open_at(spans, [g[0] for g in gaps])):
        row(name or OUTSIDE)["idle_s"] += (t - s) * 1e-6
    for r in out.values():
        r["ops"] = [[k, v] for k, v in sorted(r["ops"].items(), key=lambda kv: -kv[1])[:TOP_OPS]]
    return out


def outside_outer(events) -> int:
    """The ``path/`` and ``samples/`` spans that lie inside no
    ``render/pass`` span."""
    ann = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    outs = sorted((s, t) for s, t, n in ann if n == "render/pass")
    inner = [(s, t) for s, t, n in ann if n.startswith(("path/", "samples/"))]
    starts = [s for s, _ in outs]
    n = 0
    for s, t in inner:
        j = bisect.bisect_right(starts, s) - 1
        n += not (j >= 0 and outs[j][1] >= t)
    return n


def host_record(passes: int, wall_s: float) -> dict:
    """The tracer's record of the frame just rendered with the spans on:
    its summary, counters, the sync time inside ``render/pass`` spans,
    its passes and wall seconds."""
    from pbrt_v3_iile_tpu_torch.utils import stats

    spans = stats.spans()
    passes_iv = sorted((t0, t1) for n, _, t0, t1 in spans if n == "render/pass")
    sync_in = 0
    for n, _, t0, t1 in spans:
        if n.startswith("sync/") and any(a <= t0 and t1 <= b for a, b in passes_iv):
            sync_in += t1 - t0
    return dict(summary=stats.summary(), counters=stats.counters(),
                sync_in_pass_s=sync_in * 1e-9, passes=passes, wall_s=wall_s)


def trace_record(events, passes: int) -> dict:
    """``by_span`` of a traced frame, its passes, the share of its device
    time launched inside named spans, and its spans outside every pass."""
    spans = by_span(events)
    total = sum(r["device_s"] for r in spans.values())
    named = sum(r["device_s"] for k, r in spans.items() if k not in (OUTSIDE, UNLAUNCHED))
    return dict(spans=spans, passes=passes,
                named_device_share=named / total if total > 0 else None,
                outside_pass=outside_outer(events))


def _host(rec):
    h = rec.get("spans_host")
    return h if h and h.get("summary") and h.get("passes") else None


def _trace(rec):
    t = rec.get("spans_trace")
    return t if t and t.get("spans") and t.get("passes") else None


def host_syncs_per_pass(rec):
    """Syncs counted under ``syncs/*`` in the frame without the profiler."""
    h = _host(rec)
    if h is None:
        return None
    return sum(v for k, v in h["counters"].items() if k.startswith("syncs/")) / h["passes"]


def sync_wait_ms(rec):
    """Host ms inside ``sync/*`` spans, the frame without the profiler."""
    h = _host(rec)
    if h is None:
        return None
    return 1e3 * sum(s["inclusive_s"] for k, s in h["summary"].items()
                     if k.startswith("sync/")) / h["passes"]


def enqueue_ms(rec):
    """Host ms inside ``render/pass`` less its ``sync/*`` spans: the host's
    launch pace."""
    h = _host(rec)
    if h is None or "render/pass" not in h["summary"]:
        return None
    return 1e3 * (h["summary"]["render/pass"]["inclusive_s"] - h["sync_in_pass_s"]) / h["passes"]


def _span_value(rec, span, key, scale=1.0):
    t = _trace(rec)
    if t is None or span not in t["spans"]:
        return None
    return scale * t["spans"][span][key] / t["passes"]


READERS = {
    "host_syncs_per_pass.path": host_syncs_per_pass,
    "sync_wait_ms.path": sync_wait_ms,
    "enqueue_ms.path": enqueue_ms,
    "bsdf_device_ms.path": lambda rec: _span_value(rec, "path/bsdf", "device_s", 1e3),
    "sampler_kernels_per_pass.path": lambda rec: _span_value(rec, "samples/draw", "kernels"),
}


def table(rec) -> list:
    """The ``[spans]`` lines a pass: host and self ms from ``spans_host``,
    kernels, device and idle ms from ``spans_trace``."""
    h, t = _host(rec), _trace(rec)
    hs, ts = h["summary"], t["spans"]
    hp, tp = h["passes"], t["passes"]
    lines = [f"[spans] {'name':<22s} {'calls':>7s} {'host_ms':>9s} {'self_ms':>9s} "
             f"{'kernels':>9s} {'device_ms':>9s} {'idle_ms':>9s}"]
    for k in sorted(set(hs) | set(ts), key=lambda k: -ts.get(k, {}).get("device_s", 0.0)):
        a, b = hs.get(k, {}), ts.get(k, {})
        calls = a.get("calls", b.get("calls", 0))
        lines.append(f"[spans] {k:<22s} {calls / hp:7.2f} "
                     f"{1e3 * a.get('inclusive_s', 0.0) / hp:9.3f} "
                     f"{1e3 * a.get('self_s', 0.0) / hp:9.3f} "
                     f"{b.get('kernels', 0) / tp:9.1f} {1e3 * b.get('device_s', 0.0) / tp:9.3f} "
                     f"{1e3 * b.get('idle_s', 0.0) / tp:9.3f}")
    return lines


def spans_on_frame(cell, seed):
    """A frame with the spans on and no profiler -> (image, host_record)."""
    import torch

    from pbrt_v3_iile_tpu_torch.utils import stats

    stats.reset()
    stats.enable(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, _ = cell.frame(seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stats.enable(False)
    return img, host_record(cell.traffic["spp"], wall)


def traced_frame(cell, seed, trace_dir):
    """A frame with the spans on under torch.profiler -> (image,
    trace_record, tracing.summarize of the same trace).

    A stand-in until ``drivers/path_frames.py`` records the spans: then
    its own traced frame, run with the tracer on, feeds both
    ``tracing.summarize`` and ``trace_record``, and this goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pbrt_v3_iile_tpu_torch.utils import stats

    stats.reset()
    stats.enable(True)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                img, _ = cell.frame(seed)
                torch.cuda.synchronize()
    finally:
        stats.enable(False)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "spans_trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        events = tracing.load_events(path)
    finally:
        os.remove(path)
    return img, trace_record(events, cell.traffic["spp"]), tracing.summarize(events)


def sync_debug_frame(cell, seed):
    """A frame with the spans on under ``set_sync_debug_mode("warn")`` ->
    (image, the synchronising calls warned, by the innermost span open at
    each (``outside`` when none is))."""
    import warnings

    import torch

    from pbrt_v3_iile_tpu_torch.utils import stats

    seen: dict = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            k = stats.current() or OUTSIDE
            seen[k] = seen.get(k, 0) + 1

    stats.reset()
    stats.enable(True)
    show = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        try:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            img, _ = cell.frame(seed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = show
            stats.enable(False)
    torch.cuda.synchronize()
    counted = sum(v for k, v in stats.counters().items() if k.startswith("syncs/"))
    stats.reset()
    return img, dict(by_span=seen, counted=counted,
                in_sync_spans=sum(v for k, v in seen.items() if k.startswith("sync/")),
                elsewhere=sum(v for k, v in seen.items() if not k.startswith("sync/")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sync-debug", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from benchmark import compare, harness
    from benchmark.drivers import path_frames as pf

    if not torch.cuda.is_available():
        print("spans: no CUDA card", file=sys.stderr)
        return 2
    _, _, traffic, config = harness.load_cell(CELL)
    cell = pf.Cell(harness.ROOT, config, traffic, "cuda")
    cell.frame(pf.derive_seed(args.seed, "warmup"), spp=1)
    torch.cuda.synchronize()
    frames, walls = {}, []
    for i in range(YARDSTICK_FRAMES):
        t0 = time.perf_counter()
        frames[f"untraced_{i}"], _ = cell.frame(pf.derive_seed(args.seed, "frame", i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n = YARDSTICK_FRAMES
    frames["spans_on"], host = spans_on_frame(cell, pf.derive_seed(args.seed, "frame", n))
    frames["traced"], trace, summ = traced_frame(
        cell, pf.derive_seed(args.seed, "frame", n + 1),
        os.path.join(harness.ROOT, "build", "bench_trace"))
    rec = dict(spans_host=host, spans_trace=trace)
    mean = sum(walls) / n
    for line in table(rec):
        print(line, file=sys.stderr)
    for k, r in sorted(trace["spans"].items(), key=lambda kv: -kv[1]["device_s"])[:8]:
        ops = ", ".join(f"{o[:48]} {1e3 * v / traffic['spp']:.3f}" for o, v in r["ops"])
        print(f"[spans] top ops ms a pass, {k}: {ops}", file=sys.stderr)
    out = {k: f(rec) for k, f in READERS.items()}
    out.update(frames_s=walls, spans_on_frame_s=host["wall_s"],
               tracing_cost_pct=100.0 * (host["wall_s"] / mean - 1.0),
               named_device_share=trace["named_device_share"],
               spans_outside_pass=trace["outside_pass"],
               traced_busy_s=summ["busy_s"], traced_window_s=summ["window_s"],
               traced_kernels_per_pass=summ["n_kernels"] / traffic["spp"],
               host=host, trace=trace["spans"], card=harness.power_limit())
    print(f"[spans] tracing's cost when on: {out['tracing_cost_pct']:.2f}% "
          f"({host['wall_s']:.3f} s against the mean frame {mean:.3f} s); device time "
          f"launched inside named spans {100 * trace['named_device_share']:.2f}%; "
          f"spans outside every render/pass {trace['outside_pass']}", file=sys.stderr)
    if args.sync_debug:
        frames["sync_debug"], out["sync_debug"] = sync_debug_frame(
            cell, pf.derive_seed(args.seed, "frame", n + 2))
        print(f"[spans] sync debug: {out['sync_debug']}", file=sys.stderr)
    cell.free()
    del cell
    # every frame judged against the reference, as path_frames.run judges its own
    dev = torch.device("cuda")
    ref_a, ref_b = pf.reference_halves(harness.ROOT, config, traffic,
                                       pf.derive_seed(args.seed, "reference"), dev)
    per_frame = {k: compare.frame_numbers(torch.from_numpy(np.ascontiguousarray(f)).to(dev),
                                          ref_a, ref_b, traffic["tiles"])
                 for k, f in frames.items()}
    worst, failed = compare.judge(list(per_frame.values()), traffic["limits"])
    out.update(per_frame=per_frame, checks=worst, limits=traffic["limits"],
               failed=failed, correct=failed == 0)
    for k, v in per_frame.items():
        print(f"[reference] {k}: " + " ".join(f"{m} {v[m]:.6g}" for m in traffic["limits"]),
              file=sys.stderr)
    print(f"[reference] {len(per_frame) - failed} of {len(per_frame)} frames correct "
          f"(limits {traffic['limits']})", file=sys.stderr)
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
