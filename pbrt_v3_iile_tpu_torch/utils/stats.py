"""Render statistics and the port's tracer (port of ``utils/stats.py``;
the stats.h:279 counters and the stats.cpp:207 profiler role).

A process-global registry, filled when enabled (the CLI's ``--stats``):

- spans: ``with stage(name):`` records ``(name, parent, t0_ns, t1_ns)``
  on the host's ``time.perf_counter_ns`` and enters
  ``torch.profiler.record_function(name)``, so that under a profiler
  every span is a ``user_annotation`` in the same trace as the kernels
  it launched, on the trace's clock;
- sync points: ``with sync_point(name):`` around a call that makes the
  host wait for the device, a span ``sync/<name>`` counted under
  ``syncs/<name>``;
- counters: ``add_counter``.

Spans never wait for the device: a span's time is the host's time in it
(enqueueing work, and waiting only inside its sync points), and an
enabled registry leaves the pipeline as it is.  The device time of a
span's work comes from a profiler trace, joined by span name.  Off (the
default), ``stage`` and ``sync_point`` return one shared no-op context.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_ENABLED = False
_SPANS: list = []      # (name, parent name or None, t0_ns, t1_ns), as they close
_OPEN: list = []       # the names of the open spans, innermost last
_COUNTERS: dict = defaultdict(int)
_OFF = contextlib.nullcontext()


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset():
    _SPANS.clear()
    _OPEN.clear()
    _COUNTERS.clear()


def add_counter(name: str, n):
    _COUNTERS[name] += int(n)


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        _OPEN.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _OPEN.pop()
        _SPANS.append((self.name, _OPEN[-1] if _OPEN else None, self.t0, t1))
        self.rf.__exit__(*exc)
        return False


def stage(name: str):
    """A span around a phase of the host's work (a no-op when disabled)."""
    return _Span(name) if _ENABLED else _OFF


def sync_point(name: str):
    """A span ``sync/<name>`` around a call that makes the host wait for
    the device, counted under ``syncs/<name>`` (a no-op when disabled)."""
    if not _ENABLED:
        return _OFF
    _COUNTERS["syncs/" + name] += 1
    return _Span("sync/" + name)


def spans() -> list:
    """The closed spans, (name, parent, t0_ns, t1_ns) in closing order."""
    return list(_SPANS)


def current():
    """The name of the innermost open span, or None."""
    return _OPEN[-1] if _OPEN else None


def counters() -> dict:
    return dict(_COUNTERS)


def self_times(intervals) -> list:
    """[(t0, t1)] of properly nested spans -> each span's duration less
    the time its child spans cover, in the same order."""
    order = sorted(range(len(intervals)), key=lambda i: (intervals[i][0], -intervals[i][1]))
    own = [t1 - t0 for t0, t1 in intervals]
    stack = []
    for i in order:
        t0, t1 = intervals[i]
        while stack and intervals[stack[-1]][1] <= t0:
            stack.pop()
        if stack:
            own[stack[-1]] -= t1 - t0
        stack.append(i)
    return own


def summary() -> dict:
    """-> {span name: {"calls", "inclusive_s", "self_s"}}; a span's self
    time is its duration less the time its child spans cover."""
    out: dict = {}
    own = self_times([(t0, t1) for _, _, t0, t1 in _SPANS])
    for (name, _, t0, t1), own_ns in zip(_SPANS, own):
        s = out.setdefault(name, {"calls": 0, "inclusive_s": 0.0, "self_s": 0.0})
        s["calls"] += 1
        s["inclusive_s"] += (t1 - t0) * 1e-9
        s["self_s"] += own_ns * 1e-9
    return out


def report() -> str:
    """The stats table (stats.cpp PrintStats layout)."""
    lines = ["Statistics:"]
    summ = summary()
    if summ:
        lines.append("  Host time per stage (no device sync: a stage's device "
                     "work may run after it; waits are the sync/ stages)")
        lines.append(f"    {'stage':<28s} {'inclusive':>11s} {'self':>11s}  calls")
        for k in sorted(summ, key=lambda k: -summ[k]["inclusive_s"]):
            s = summ[k]
            lines.append(f"    {k:<28s} {s['inclusive_s']:9.3f} s {s['self_s']:9.3f} s"
                         f"  {s['calls']}")
    if _COUNTERS:
        lines.append("  Counters")
        for k in sorted(_COUNTERS):
            lines.append(f"    {k:<36s} {_COUNTERS[k]:>14,d}")
    return "\n".join(lines)
