"""CUDA-event timing shared by the kernel timing tools of this directory."""

from __future__ import annotations

import time

import torch


def events_ms(fn, queued, reps=20):
    """Mean ms per call of fn() over reps calls by CUDA events, and the
    host's us per call; queued: behind a device sleep."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    a.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - h0) / reps * 1e6
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host_us
