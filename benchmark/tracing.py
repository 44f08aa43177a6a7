"""Reading a torch.profiler trace: the device's busy time and idle gaps,
the device operations that took most time, and one kernel's calls.

The trace is the Chrome trace that ``torch.profiler`` exports.  The
traced window is the host span of the user annotation ``WINDOW``, which
the driver opens around the traced work and closes after a device
synchronise.  Device intervals are the events of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``, clipped to the window.
"""

from __future__ import annotations

import bisect
import json

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Sorted (start, end) pairs -> their union as disjoint sorted pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, kernel_names=(), top: int = 10) -> dict:
    """Chrome trace events (the list under ``traceEvents``) -> dict with

    - ``window_s``: the length of the ``WINDOW`` annotation;
    - ``busy_s``: the union of device intervals inside it;
    - ``n_kernels``: device kernels launched inside it;
    - ``device_ops``: the ``top`` device operations by total time,
      [[name, seconds], ...];
    - ``idle_gaps``: the ``top`` longest gaps between device intervals
      inside the window, each named by the innermost host operation
      running when it opened, [[name, seconds], ...];
    - ``kernels``: for each name in kernel_names, the durations (s) of the
      kernels whose name contains it, in launch order.
    """
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    per_name: dict = {}
    n_kernels = 0
    kernels = {k: [] for k in kernel_names}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            if t <= w0 or s >= w1:
                continue
            s, t = max(s, w0), min(t, w1)
            dev.append((s, t))
            name = e.get("name", "?")
            per_name[name] = per_name.get(name, 0.0) + (t - s)
            if cat == "kernel":
                n_kernels += 1
                for k in kernel_names:
                    if k in name:
                        kernels[k].append((float(e["ts"]), float(e["dur"]) * 1e-6))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime") and t > w0 and s < w1:
            host.append((s, t, e.get("name", "?")))
    busy = _union(dev)
    busy_us = sum(e - s for s, e in busy)
    # gaps: between the window's start, the busy intervals and its end
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps[:top]:
        # the innermost host operation open at the gap's start: among those
        # begun before it and still running, the one begun last
        name = "idle"
        i = bisect.bisect_right(starts, at)
        for j in range(i - 1, max(-1, i - 2000), -1):
            if host[j][1] > at:
                name = host[j][2]
                break
        named.append([name, length * 1e-6])
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                n_kernels=n_kernels,
                device_ops=[[n, v * 1e-6] for n, v in ops],
                idle_gaps=named,
                kernels={k: [d for _, d in sorted(v)] for k, v in kernels.items()})


def load_events(path: str):
    with open(path) as f:
        return json.load(f)["traceEvents"]
