"""IILE's spans and counters in the port's tracer (``utils/stats.py``): a
task opens ``iile/task`` around ``iile/probes``, ``iile/cnn``, then
``iile/chase`` and ``iile/mis`` of each pixel chunk, in that order; each
direct pass is an ``iile/direct`` and the merges ``iile/merge``; the
counters equal their closed forms; and a render with the tracer off
records nothing and gives the same images."""

import numpy as np
import pytest

from pbrt_v3_iile_tpu_torch.integrators import iispt as tiispt
from pbrt_v3_iile_tpu_torch.integrators import probes as tprobes
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.utils import stats as statslib

SCENE = """LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "random" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3 4 5 6 4 6 7]
    "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4
               -6 -0.5 -6  6 -0.5 -6  6 -0.5 4  -6 -0.5 4]
WorldEnd
"""
HEMI, DIRECT = 8, 2


def _render(sd):
    return tiispt.render_iile(sd, seed=4, indirect_tasks=1, direct_samples=DIRECT,
                              hemi_size=HEMI, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("iile_stats") / "room.pbrt"
    path.write_text(SCENE)
    sd = tapi.load_scene(str(path))
    statslib.reset()
    off = _render(sd)
    recorded_off = (statslib.spans(), statslib.counters())
    statslib.enable(True)
    try:
        on = _render(sd)
        spans, counters = statslib.spans(), statslib.counters()
    finally:
        statslib.enable(False)
        statslib.reset()
    return dict(off=off, on=on, recorded_off=recorded_off, spans=spans, counters=counters)


def test_off_records_nothing_and_on_changes_nothing(runs):
    assert runs["recorded_off"] == ([], {})
    for a, b in zip(runs["off"][:3], runs["on"][:3]):
        np.testing.assert_array_equal(a, b)


def test_spans_nest_in_order(runs):
    spans = runs["spans"]          # (name, parent, t0, t1) in closing order
    iile = sorted((s for s in spans if s[0].startswith("iile/")), key=lambda s: s[2])
    task = [s for s in iile if s[0] == "iile/task"]
    assert len(task) == 1
    t0, t1 = task[0][2:]
    inner = [s[0] for s in iile if t0 <= s[2] and s[3] <= t1 and s[0] != "iile/task"]
    assert inner == ["iile/probes", "iile/cnn", "iile/chase", "iile/mis"]
    assert all(s[1] == "iile/task" for s in iile if s[0] in inner)
    names = [s[0] for s in iile]
    assert names.count("iile/direct") == DIRECT
    assert names.count("iile/merge") == 3      # the task's scatter, each image's resolve
    # the probes' trace and the direct passes run the path pass's spans
    assert any(s[1] == "iile/probes" and s[0].startswith("path/") for s in spans)
    assert {"sync/iile_indirect_image", "sync/iile_direct_image"} <= {s[0] for s in spans}


def test_counters_equal_their_closed_forms(runs):
    c = runs["counters"]
    P = 121
    chunk = tiispt.CHUNK_LADDER[0]             # an 8x8 task is one chunk of the ladder's least
    assert c["iile/tasks"] == 1
    assert c["iile/probes"] == c["iile/cnn_probes"] == P
    assert c["iile/probe_rays"] == P * HEMI * HEMI
    assert c["iile/pixel_chunks"] == 1
    assert c["iile/chase_steps"] == tprobes.MAX_CHASE == 24
    assert c["iile/mis_slots"] == chunk * 4 * tiispt.HEMISPHERIC_IMPORTANCE_SAMPLES
    assert c["syncs/iile_indirect_image"] == c["syncs/iile_direct_image"] == 1
    # at the cell's hemisphere size a task traces 123,904 probe rays
    assert P * 32 * 32 == 123904
