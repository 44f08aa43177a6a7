"""The IILE driver's checks: a run with the timed path broken underneath
comes out not correct, and so do the controls; a sound run at the same
size comes out correct.

The runs skip the harness's look for a card and drive the rest of a run on
the CPU (the program's plain versions, accel ``bvh``) on
``scenes/iile_room.pbrt`` at 64x64 with 8x8 hemispheres, 2 tasks and 2
direct passes, with limits for that size (the cell's own limits are set
from chip runs at the cell's size, PERF.md).  At this size the program's
frames read ``global_rel`` 0.035-0.042, ``tile_dev`` 0.22-0.68 (the lamp
is in view), ``noise_ratio`` 0.80-1.16 and ``cnn_map_rel`` at most 1e-6
over five seeds; half the traffic reads ``noise_ratio`` 1.95-2.10 and the
bfloat16 reference ``global_rel`` 0.40-0.49."""

import functools
import json
import os
import time
import types

import pytest
import torch

from benchmark import compare, harness
from benchmark.drivers import iile_frames

CELL = "atrium-iile-512-t4d4"
TINY = dict(driver="iile_frames", film=[64, 64], indirect_tasks=2, direct_samples=2,
            hemi_size=8, accel="bvh", warmup=dict(indirect_tasks=1, direct_samples=1),
            traced=dict(indirect_tasks=1, direct_samples=1),
            tiles=[4, 4],
            limits={"global_rel": 0.07, "tile_dev": 1.0, "noise_ratio": 1.5,
                    "nonfinite_px": 0, "cnn_map_rel": 1e-4})
SEED = 2**31 + 321


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(harness.BENCH, "configs", "atrium-iile.json")) as f:
        cfg = json.load(f)
    return dict(cfg, scene="scenes/iile_room.pbrt")


@pytest.fixture(scope="module", autouse=True)
def one_reference():
    """The reference's pair of frames once for every run of this module (the
    same seed and sizes give the same frames)."""
    orig = iile_frames.Reference.pair
    cached = functools.lru_cache(maxsize=4)(lambda ref, seed: orig(ref, seed))
    iile_frames.Reference.pair = lambda self, seed: cached(_Key(self), seed)
    torch.set_num_threads(4)
    yield
    iile_frames.Reference.pair = orig


class _Key:
    """A reference keyed by its traffic, so that the cache outlives it."""

    def __init__(self, ref):
        self.ref = ref
        self.k = json.dumps(ref.traffic, sort_keys=True)

    def __hash__(self):
        return hash(self.k)

    def __eq__(self, other):
        return self.k == other.k

    def __getattr__(self, name):
        return getattr(self.ref, name)


def _run(config):
    ctx = types.SimpleNamespace(root=harness.ROOT, seed=SEED, seconds=0.1, trace=False,
                                config=config, traffic=dict(TINY), t_start=time.time(),
                                device="cpu")
    rec = iile_frames.run(ctx)
    info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return harness.result(harness.load_manifest(), CELL, rec, False, info)


def _over(out, name):
    c = out["checks"][name]
    return c["value"] > c["limit"]


def test_sound_run_is_correct(config):
    out = _run(config)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and "path_msamples_s" in out["metrics"]


def test_indirect_maps_zeroed_is_not_correct(config, monkeypatch):
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    mis = iispt._mis_stage
    monkeypatch.setattr(iispt, "_mis_stage",
                        lambda scene, cam, R, *a, **k: mis(scene, cam, torch.zeros_like(R),
                                                           *a, **k))
    out = _run(config)
    assert not out["correct"] and _over(out, "global_rel")
    assert not _over(out, "cnn_map_rel")      # the maps themselves are sound


def test_half_the_tasks_and_passes_is_not_correct(config, monkeypatch):
    """Half the tasks and direct passes keep the image's expectation: only
    its noise shows."""
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    direct = iispt.render_iile

    @functools.wraps(direct)
    def halved(sd, indirect_tasks, direct_samples, **k):
        return direct(sd, indirect_tasks=max(1, indirect_tasks // 2),
                      direct_samples=max(1, direct_samples // 2), **k)

    monkeypatch.setattr(iispt, "render_iile", halved)
    out = _run(config)
    assert not out["correct"] and _over(out, "noise_ratio")


def test_maps_off_by_tf32_sized_noise_are_not_correct(config, monkeypatch):
    """Radiance maps off by 1e-3 relative, TF32's size, move the frame by
    far less than its noise: only ``cnn_map_rel`` sees them."""
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    direct = iispt.probe_radiance
    g = torch.Generator().manual_seed(9)

    def noisy(net, gb, valid):
        R = direct(net, gb, valid)
        return R * (1 + 1e-3 * torch.randn(R.shape, generator=g))

    monkeypatch.setattr(iispt, "probe_radiance", noisy)
    out = _run(config)
    assert not out["correct"] and _over(out, "cnn_map_rel")


def test_control_is_not_correct(config):
    """The reference in the configuration's control precision, in the
    program's place, fails the frame's limits."""
    dt = getattr(torch, config["control"])
    ref = iile_frames.Reference(harness.ROOT, config, TINY, "cpu")
    a, b = ref.pair(iile_frames.derive_seed(SEED, "reference"))
    ctrl = iile_frames.Reference(harness.ROOT, config, TINY, "cpu", dtype=dt).frame(
        iile_frames.derive_seed(SEED, "control")).float()
    limits = {k: v for k, v in TINY["limits"].items() if k != "cnn_map_rel"}
    worst, failed = compare.judge([compare.frame_numbers(ctrl, a, b, TINY["tiles"])], limits)
    assert failed == 1, worst


READERS = ["chase_kernels_per_task.iile", "probes_device_ms.iile", "iisptnet_roofline",
           "device_idle_pct.iile", "peak_mem_gb.iile"]


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_its_fields(name):
    assert harness.read_metric(name, {}) is None
    assert harness.read_metric(name, {"frames": 2, "window_s": 30.0}) is None


def test_readers_read_a_traced_record():
    rec = dict(frames=2, window_s=40.0, window_peak_bytes=3.1e9, iile_trace_tasks=4,
               trace=dict(busy_s=4.0), untraced_wall_s=20.0,
               iile_spans={"iile/chase": dict(kernels=4000, device_s=0.4),
                           "iile/probes": dict(kernels=900, device_s=2.0)},
               iisptnet=dict(least_s=0.0018 * 4, device_s=0.0048 * 4))
    got = {n: harness.read_metric(n, rec) for n in READERS}
    assert got["chase_kernels_per_task.iile"] == 1000
    assert got["probes_device_ms.iile"] == pytest.approx(500.0)
    assert got["iisptnet_roofline"] == pytest.approx(37.5)
    assert got["device_idle_pct.iile"] == pytest.approx(80.0)
    assert got["peak_mem_gb.iile"] == pytest.approx(3.1)
