"""A run with the timed path broken underneath comes out not correct, and
so does the control; a sound run at the same size comes out correct.

The runs skip the harness's look for a card and drive the rest of a run on
the CPU (the program's plain versions, accel ``bvh``) at a film small
enough for a test, with limits for that size: the cell's own limits are
set from chip runs at the cell's size (PERF.md)."""

import functools
import json
import os
import time
import types

import pytest
import torch

from benchmark import compare, harness
from benchmark.drivers import path_frames

TINY = dict(driver="path_frames", film=[96, 48], spp=4, max_wave=4608, accel="bvh",
            reference_half_spp=4, tiles=[4, 4],
            limits={"global_rel": 0.25, "tile_dev": 0.5, "noise_ratio": 0.85,
                    "nonfinite_px": 0})
SEED = 2**31 + 123


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(harness.BENCH, "configs", "atrium-path.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def one_reference():
    """The reference's image once for every run of this module (the same
    seed and sizes give the same image)."""
    orig = path_frames.reference_image
    path_frames.reference_image = functools.lru_cache(maxsize=4)(
        lambda root, config_json, traffic_json, seed, spp, device, dtype=torch.float32:
        orig(root, json.loads(config_json), json.loads(traffic_json), seed, spp,
             device, dtype))
    cached = path_frames.reference_image
    path_frames.reference_image = lambda root, config, traffic, seed, spp, device, dtype=torch.float32: \
        cached(root, json.dumps(config, sort_keys=True), json.dumps(traffic, sort_keys=True),
               seed, spp, str(device), dtype)
    torch.set_num_threads(4)
    yield
    path_frames.reference_image = orig


def _run(config):
    ctx = types.SimpleNamespace(root=harness.ROOT, seed=SEED, seconds=0.1, trace=False,
                                config=config, traffic=dict(TINY), t_start=time.time(),
                                device="cpu")
    rec = path_frames.run(ctx)
    info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    man = harness.load_manifest()
    return harness.result(man, "atrium-path-1440sq", rec, False, info)


def test_sound_run_is_correct(config):
    out = _run(config)
    assert out["correct"], out["checks"]


def test_state_left_unchanged_is_not_correct(config, monkeypatch):
    from pbrt_v3_iile_tpu_torch.ops import film as filmlib
    monkeypatch.setattr(filmlib, "add_sample_image", lambda film, *a, **k: film)
    assert not _run(config)["correct"]


def test_half_the_batch_left_out_is_not_correct(config, monkeypatch):
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    direct = renderlib.render_pass_fn

    def halved(*a, **k):
        run = direct(*a, **k)

        def inner(*b, **kw):
            L, jitter, aux = run(*b, **kw)
            flat = L.reshape(-1, 3)
            n = flat.shape[0] // 2
            flat = torch.cat([flat[:n], flat[:n].mean(0).expand(flat.shape[0] - n, 3)])
            return flat.reshape(L.shape), jitter, aux
        return inner

    monkeypatch.setattr(renderlib, "render_pass_fn", halved)
    assert not _run(config)["correct"]


def test_half_the_samples_is_not_correct(config, monkeypatch):
    """A frame of half the traffic's pixel samples, normalised by its own
    weight, keeps the image's expectation: only its noise shows."""
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    direct = renderlib.render

    def halved(sd, spp, **k):
        return direct(sd, spp=max(1, spp // 2), **k)

    monkeypatch.setattr(renderlib, "render", halved)
    out = _run(config)
    assert not out["correct"]
    assert out["checks"]["noise_ratio"]["value"] > TINY["limits"]["noise_ratio"]


def test_answer_altered_is_not_correct(config, monkeypatch):
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    direct = renderlib.render

    def altered(*a, **k):
        img, st = direct(*a, **k)
        img = img.copy()
        img[:img.shape[0] // 2, :img.shape[1] // 2] *= 2.0   # a quarter of the frame
        return img, st

    monkeypatch.setattr(renderlib, "render", altered)
    assert not _run(config)["correct"]


def test_control_is_not_correct(config):
    """The reference in the configuration's control precision, in the
    program's place, fails the limits."""
    dt = getattr(torch, config["control"])
    ref_a, ref_b = path_frames.reference_halves(
        harness.ROOT, config, TINY, path_frames.derive_seed(SEED, "reference"), "cpu")
    ctrl = path_frames.reference_image(harness.ROOT, config, TINY,
                                       path_frames.derive_seed(SEED, "control"),
                                       TINY["spp"], "cpu", dtype=dt)
    worst, failed = compare.judge(
        [compare.frame_numbers(ctrl, ref_a, ref_b, TINY["tiles"])], TINY["limits"])
    assert failed == 1, worst
