"""The port's tracer, ``utils/stats.py``: spans and sync points that cost a
shared no-op when off, never synchronise the card when on, nest with
their parents (self time = inclusive less the children's), and reach a
torch.profiler trace as ``user_annotation`` events with the path pass's
nesting; a render with the spans on is the render with them off."""

import ast
import inspect
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.utils import stats as statslib

SCENE = """LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "sobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
WorldBegin
LightSource "point" "rgb I" [30 30 30]
AttributeBegin
  Material "matte" "rgb Kd" [0.7 0.7 0.7]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
AttributeEnd
WorldEnd
"""


@pytest.fixture
def stats_on():
    statslib.reset()
    statslib.enable(True)
    yield
    statslib.enable(False)
    statslib.reset()


@pytest.fixture(scope="module")
def sd(tmp_path_factory):
    path = tmp_path_factory.mktemp("stats") / "quad.pbrt"
    path.write_text(SCENE)
    return tapi.load_scene(str(path))


def _render(sd):
    img, _ = trender.render(sd, spp=2, seed=3, accel="bvh", compact=True,
                            device="cpu")
    return img


def test_off_is_one_shared_noop():
    statslib.reset()
    assert not statslib.enabled()
    ctxs = [statslib.stage("render/pass"), statslib.stage("path/nee"),
            statslib.sync_point("k1_overflow"), statslib.sync_point("rays_total")]
    assert all(c is ctxs[0] for c in ctxs)
    with ctxs[0], statslib.sync_point("x"):
        pass
    assert statslib.spans() == [] and statslib.counters() == {}
    assert statslib.summary() == {}


def test_spans_nest_and_self_time(stats_on, monkeypatch):
    clock = iter([0, 10, 20, 30, 50, 60, 100, 170])
    monkeypatch.setattr(statslib.time, "perf_counter_ns", lambda: next(clock))
    with statslib.stage("outer"):               # 0 .. 60
        with statslib.stage("inner"):           # 10 .. 20
            pass
        with statslib.sync_point("wait"):       # 30 .. 50
            pass
    with statslib.stage("inner"):               # 100 .. 170, a root span
        pass
    assert statslib.spans() == [("inner", "outer", 10, 20),
                                ("sync/wait", "outer", 30, 50),
                                ("outer", None, 0, 60),
                                ("inner", None, 100, 170)]
    s = statslib.summary()
    assert s["outer"]["calls"] == 1
    assert s["outer"]["inclusive_s"] == pytest.approx(60e-9)
    assert s["outer"]["self_s"] == pytest.approx(30e-9)
    assert s["inner"]["calls"] == 2
    assert s["inner"]["inclusive_s"] == pytest.approx(80e-9)
    assert s["inner"]["self_s"] == pytest.approx(80e-9)
    assert s["sync/wait"]["self_s"] == pytest.approx(20e-9)
    assert statslib.counters() == {"syncs/wait": 1}
    rep = statslib.report()
    assert "Host time" in rep and "no device sync" in rep
    assert "sync/wait" in rep and "syncs/wait" in rep


# Calls that make the host wait for the device (or copy from it).
WAITS = {"synchronize", "item", "cpu", "tolist", "numpy", "to", "cuda", "wait",
         "query", "elapsed_time", "record"}


def test_tracer_source_never_waits_for_the_device():
    """No call in ``utils/stats.py`` can wait for the card: a span, a sync
    point or a summary calls none of ``WAITS`` on anything."""
    tree = ast.parse(inspect.getsource(statslib))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert called, "the scan found no calls"
    assert "record_function" in called and "perf_counter_ns" in called
    assert not called & WAITS, sorted(called & WAITS)
    assert "cuda" not in {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}


def test_on_never_synchronizes(stats_on, sd, monkeypatch):
    # On the CPU this checks that a render with the spans on calls no
    # torch.cuda.synchronize and records every span of the path pass; that
    # the tracer's own code never waits is the source scan above.
    def forbidden(*a, **k):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    _render(sd)
    names = {s[0] for s in statslib.spans()}
    assert {"render/pass", "render/camera", "render/film_add", "path/resort",
            "path/flush", "path/intersect", "path/emitted", "path/material",
            "path/nee", "path/bsdf", "path/roulette", "samples/draw",
            "sync/rays_total"} <= names
    c = statslib.counters()
    assert c["syncs/rays_total"] == 1 and c["rays/total"] > 0


def test_render_unchanged_by_spans(sd):
    statslib.enable(False)
    off = _render(sd)
    statslib.enable(True)
    try:
        on = _render(sd)
    finally:
        statslib.enable(False)
        statslib.reset()
    np.testing.assert_array_equal(on, off)


def test_spans_in_the_profiler_trace(stats_on, sd, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(sd)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def spans(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ev
                if e["name"] == name]

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    passes, bounce0, nee = spans("render/pass"), spans("path/bounce[0]"), spans("path/nee")
    assert len(passes) == 2 and len(bounce0) == 2 and len(nee) == 2 * 3
    chains = [(p, b, n) for p in passes for b in bounce0 for n in nee
              if inside(b, p) and inside(n, b)]
    assert len(chains) == 2       # one path/nee of bounce 0 in each pass
    for name in ("path/bsdf", "samples/draw", "path/resort"):
        for s in spans(name):
            assert any(inside(s, p) for p in passes), name
    # the host record holds the same spans as the trace
    host = statslib.summary()
    assert host["render/pass"]["self_s"] < host["render/pass"]["inclusive_s"]
    assert host["path/nee"]["calls"] == len(nee)
    assert host["render/pass"]["calls"] == len(passes)


@pytest.mark.parametrize("intervals, own", [
    ([], []),
    ([(0, 10)], [10]),
    ([(0, 60), (10, 20), (30, 50), (100, 170)], [30, 10, 20, 70]),
    ([(10, 20), (0, 60), (20, 25)], [10, 45, 5]),                 # touching siblings
    ([(0, 100), (0, 40), (5, 10), (40, 100)], [0, 35, 5, 60]),    # a child from the start
])
def test_self_times(intervals, own):
    assert statslib.self_times(intervals) == own
