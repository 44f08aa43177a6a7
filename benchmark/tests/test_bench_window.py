"""The window runs whole frames only, and the rates count whole frames
over the time to the end of the last one."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import path_frames


class Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class FakeCell:
    """A cell whose frames take the given seconds on a fake clock."""

    def __init__(self, clock, durations):
        self.clock, self.durations = clock, list(durations)
        self.dev = torch.device("cpu")
        self.seeds = []

    def frame(self, seed, spp=None, report=None):
        self.seeds.append(seed)
        self.clock.now += self.durations.pop(0)
        return np.zeros((2, 2, 3), np.float32), 1000


def _window(monkeypatch, durations, seconds):
    clock = Clock()
    monkeypatch.setattr(path_frames, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter, time=clock.perf_counter))
    cell = FakeCell(clock, durations)
    frames, rays, window_s, ends = path_frames._window(cell, 2**31 + 11, seconds)
    return cell, frames, rays, window_s, ends


@pytest.mark.parametrize("durations, seconds, n, window", [
    ([3.0] * 10, 10.0, 3, 9.0),     # a fourth frame would end at 12 s
    ([3.0] * 10, 12.0, 4, 12.0),    # ... and fits exactly here
    ([25.0] * 3, 10.0, 1, 25.0),    # the first frame always runs, whole
    ([2.0, 4.0, 9.0] + [1.0] * 5, 10.0, 3, 15.0),  # the mean so far decides; a
    # frame that runs long still ends whole
])
def test_window_runs_whole_frames(monkeypatch, durations, seconds, n, window):
    cell, frames, rays, window_s, ends = _window(monkeypatch, durations, seconds)
    assert len(frames) == n and rays == 1000 * n
    assert window_s == pytest.approx(window) and ends[-1] == pytest.approx(window)
    assert len(set(cell.seeds)) == n       # a key of its own for every frame


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(harness.BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rates_count_whole_frames_over_the_window():
    rec = dict(frames=3, samples=3 * 16 * 1920 * 1080, rays=4.3 * 3 * 16 * 1920 * 1080,
               window_s=9.0, setup_s=20.0)
    assert _reader("path_msamples_s")(rec) == pytest.approx(3 * 16 * 1920 * 1080 / 9.0 / 1e6)
    assert _reader("path_mrays_s")(rec) == pytest.approx(4.3 * 3 * 16 * 1920 * 1080 / 9.0 / 1e6)
    assert _reader("setup_s")(rec) == 20.0


def test_readers_with_nothing_to_read_return_nothing():
    rec = dict(frames=0, samples=0, rays=0, window_s=0.0, setup_s=1.0)
    for name in ("path_msamples_s", "path_mrays_s", "kernels_per_pass", "k1_roofline",
                 "device_idle_pct.path", "peak_mem_gb.path"):
        assert _reader(name)(rec) is None


def test_seeds_derive_to_31_bits_and_differ():
    s = [path_frames.derive_seed(2**33 + 1, "frame", i) for i in range(4)]
    s.append(path_frames.derive_seed(2**33 + 1, "reference"))
    assert len(set(s)) == 5 and all(0 <= x < 2**31 for x in s)
    assert path_frames.derive_seed(5, "frame", 0) == path_frames.derive_seed(5, "frame", 0)
