"""Per-stage render statistics (port of ``utils/stats.py``; the
stats.h:279 counters and the stats.cpp:207 profiler role).

A process-global registry of stage wall times and counters, filled by
the drivers when enabled (the CLI's ``--stats``).  Timing a stage waits
for the device work behind it (``torch.cuda.synchronize`` on the CUDA
device of the tensors named), so it is off by default: unsynced passes
pipeline.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import fields, is_dataclass

import torch

_ENABLED = False
_STAGES: dict = defaultdict(float)
_STAGE_CALLS: dict = defaultdict(int)
_COUNTERS: dict = defaultdict(int)


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset():
    _STAGES.clear()
    _STAGE_CALLS.clear()
    _COUNTERS.clear()


def add_counter(name: str, n):
    _COUNTERS[name] += int(n)


def _first_tensor(x):
    """The first tensor in x (a tensor, a sequence, dict or dataclass)."""
    if isinstance(x, torch.Tensor):
        return x
    if is_dataclass(x):
        x = [getattr(x, f.name) for f in fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def block(out):
    """Wait for all work queued on the card that holds out (nothing when
    out is on the CPU)."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def stage(name: str, sync=None):
    """Time a host-side stage when enabled; sync: tensors to wait for at
    its end, so that the time covers their device work."""
    if not _ENABLED:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        if sync is not None:
            block(sync)
        _STAGES[name] += time.time() - t0
        _STAGE_CALLS[name] += 1


def timed(name: str, fn, *args, **kw):
    """fn(*args, **kw); when enabled, waits for its output's device work
    and adds the wall time to the stage."""
    if not _ENABLED:
        return fn(*args, **kw)
    t0 = time.time()
    out = fn(*args, **kw)
    block(out)
    _STAGES[name] += time.time() - t0
    _STAGE_CALLS[name] += 1
    return out


def report() -> str:
    """The stats table (stats.cpp PrintStats layout)."""
    lines = ["Statistics:"]
    if _STAGES:
        total = sum(_STAGES.values())
        lines.append("  Stage wall time")
        for k in sorted(_STAGES, key=lambda k: -_STAGES[k]):
            dt = _STAGES[k]
            lines.append(
                f"    {k:<28s} {dt:9.3f} s  {100 * dt / max(total, 1e-12):5.1f} %"
                f"  ({_STAGE_CALLS[k]} calls)")
        lines.append(f"    {'TOTAL':<28s} {total:9.3f} s")
    if _COUNTERS:
        lines.append("  Counters")
        for k in sorted(_COUNTERS):
            lines.append(f"    {k:<36s} {_COUNTERS[k]:>14,d}")
    return "\n".join(lines)
