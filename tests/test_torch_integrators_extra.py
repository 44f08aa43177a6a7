"""The integrators and samplers of scenes as pbrt-v3 writes them, port vs
JAX: ``ambientocclusion`` (cossample true and false), ``whitted``, and
atrium under ``halton`` (its Sampler line removed: pbrt's default),
``halton-global`` and ``maxmindist``, each at 16^2 on the BVH walker,
against the JAX package's render of the same settings
(tests/golden/scenes16_*.npz, made by tools/make_scenes_golden.py; JAX
is not compiled here).  Criterion: tests/test_golden.py's, the mean
within 2% and >= 99% of the pixels within 5% relative (+1e-2), as
tests/test_torch_slice.py uses.

The renders share one parse and one device scene of atrium (the
scene's tables do not depend on its sampler or integrator) and run
render()'s pass loop over it.

Also the film checkpoint: a render checkpointed after 4 passes and
resumed to 8 equals the unbroken 8-pass render exactly, and either
package loads the other's checkpoint; and the CLI's flags: --quick,
--verbose, --quiet, --stats (the per-stage report), --filmCheckpoint
with --checkpointEvery, and the long aliases of the IILE counts.
"""

import copy
import glob
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_v3_iile_tpu.integrators import render as jrender
from pbrt_v3_iile_tpu.ops import film as jfilm
from pbrt_v3_iile_tpu_torch.cli import main as tcli
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import film as tfilm
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.utils import image as imglib
from pbrt_v3_iile_tpu_torch.utils import stats as statslib

from torch_parity import REPO, golden_criterion

GOLDEN = os.path.join(REPO, "tests", "golden")
CASES = ["ao_cos", "ao_uniform", "halton", "halton_global", "maxmindist",
         "whitted"]


def configure(sd, z):
    """Apply a golden's overrides (attribute paths) to a parsed scene."""
    for path, value in json.loads(str(z["overrides"])).items():
        obj = sd
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return sd


@pytest.fixture(scope="module")
def atrium():
    """Atrium parsed once with its Sampler line and once without it, and
    its device scene and camera at 16^2 (neither depends on the sampler
    or the integrator), shared by the renders of every case."""
    text = open(os.path.join(REPO, "scenes", "atrium.pbrt")).read()
    base = os.path.join(REPO, "scenes")
    parsed = {strip: tapi.load_scene_string(
        re.sub(r"(?m)^Sampler .*\n", "", text) if strip else text, base)
        for strip in (False, True)}
    sd = copy.deepcopy(parsed[False])
    sd.film.x_resolution = sd.film.y_resolution = 16
    return parsed, trender.build(sd, "cpu", with_clusters=False)


def test_every_case_has_a_golden():
    have = sorted(os.path.basename(p)[len("scenes16_"):-len(".npz")]
                  for p in glob.glob(os.path.join(GOLDEN, "scenes16_*.npz")))
    assert have == CASES


@pytest.mark.parametrize("case", CASES)
def test_render_matches_jax_golden(atrium, case):
    """render()'s pass loop over the shared scene: the golden's spp passes
    of render_pass_fn, each film-added, keyed by the golden's seed."""
    z = np.load(os.path.join(GOLDEN, f"scenes16_{case}.npz"))
    assert str(z["scene"]) == "atrium.pbrt" and str(z["accel"]) == "bvh"
    parsed, (scene, cam) = atrium
    sd = configure(copy.deepcopy(parsed[bool(z["strip_sampler"])]), z)
    if case == "halton":
        assert sd.sampler.kind == "halton"   # no Sampler line: the default
    cfg = trender.make_integrator_config(sd, accel="bvh", device="cpu")
    run = trender.render_pass_fn(sd, cfg, "cpu")
    key = threefry.prng_key(int(z["seed"]))
    film = tfilm.new_film(16, 16, "cpu")
    rays = 0
    for p in range(int(z["spp"])):
        L, jitter, aux = run(scene, cam, key, p)
        film = tfilm.add_sample_image(film, L, jitter)
        rays += int(aux["rays"])
    img = tfilm.resolve(film).numpy()
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert np.isfinite(img).all() and img.mean() > 0
    if case.startswith("ao"):   # one closest-hit and one any-hit wave a pass
        assert rays == 2 * 16 * 16 * int(z["spp"])


SMALL = """
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3 4 5 6 4 6 7]
    "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4
               -6 -0.5 -6  6 -0.5 -6  6 -0.5 4  -6 -0.5 4]
WorldEnd
"""


def test_film_checkpoint_resumes_exactly(tmp_path):
    sd = tapi.load_scene_string(SMALL)   # no Sampler line: halton
    full, _ = trender.render(sd, spp=8, seed=3, device="cpu")
    ck = str(tmp_path / "film.npz")
    seen = []
    half, _ = trender.render(sd, spp=4, seed=3, device="cpu", checkpoint=ck,
                             checkpoint_every=4,
                             report=lambda p, n, f: seen.append((p, n)))
    assert seen == [(p, 4) for p in range(1, 5)]
    z = np.load(ck)
    assert int(z["passes"]) == 4 and int(z["seed"]) == 3
    resumed, st = trender.render(sd, spp=8, seed=3, device="cpu",
                                 checkpoint=ck, checkpoint_every=4)
    np.testing.assert_array_equal(resumed, full)
    assert int(np.load(ck)["passes"]) == 8
    with pytest.raises(ValueError, match="different seed"):
        trender.render(sd, spp=9, seed=4, device="cpu", checkpoint=ck)


def test_film_checkpoints_interchange_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 2, (6, 5, 3)).astype(np.float32)
    w = rng.uniform(1, 3, (6, 5)).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jrender.save_film_checkpoint(jpath, jfilm.Film(rgb=jnp.asarray(rgb),
                                                   weight=jnp.asarray(w)), 7, 11)
    film, passes, seed = trender.load_film_checkpoint(jpath, "cpu")
    assert (passes, seed) == (7, 11)
    np.testing.assert_array_equal(film.rgb.numpy(), rgb)
    np.testing.assert_array_equal(film.weight.numpy(), w)
    trender.save_film_checkpoint(tpath, film, 9, 12)
    jf, jp, js = jrender.load_film_checkpoint(tpath)
    assert (jp, js) == (9, 12)
    np.testing.assert_array_equal(np.asarray(jf.rgb), rgb)
    np.testing.assert_array_equal(np.asarray(jf.weight), w)
    np.testing.assert_array_equal(tfilm.resolve(film).numpy(),
                                  np.asarray(jfilm.resolve(jf)))


@pytest.fixture
def small_scene(tmp_path):
    path = tmp_path / "small.pbrt"
    path.write_text(SMALL.replace('Integrator', 'Sampler "halton" '
                                  '"integer pixelsamples" [4]\nIntegrator'))
    return path


def test_cli_quick_verbose_quiet(small_scene, tmp_path, capsys):
    out = tmp_path / "q.pfm"
    assert tcli.main([str(small_scene), str(out), "--quick", "--verbose",
                      "--device", "cpu"]) == 0
    img = imglib.read_pfm(str(out))
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()   # max(64, 8/4)
    assert "bvh.py" in capsys.readouterr().err     # verbose: info lines
    assert tcli.main([str(small_scene), str(out), "--quiet", "--integrator",
                      "whitted", "--device", "cpu"]) == 0
    assert capsys.readouterr().err == ""           # quiet: errors only
    assert tcli.main([str(small_scene), str(out), "--integrator",
                      "ambientocclusion", "--spp", "2", "--quiet",
                      "--device", "cpu"]) == 0
    assert imglib.read_pfm(str(out)).shape == (8, 8, 3)


def test_cli_stats_and_film_checkpoint(small_scene, tmp_path, capsys):
    out, ck = tmp_path / "s.pfm", tmp_path / "film.npz"
    try:
        assert tcli.main([str(small_scene), str(out), "--stats", "--spp", "4",
                          "--filmCheckpoint", str(ck), "--checkpointEvery",
                          "2", "--device", "cpu"]) == 0
    finally:
        statslib.enable(False)
    err = capsys.readouterr().err
    assert "render/pass" in err and "render/film_add" in err
    assert "path/bounce[0]" in err and "rays/total" in err
    assert "pixels x passes" in err
    stats = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][0])
    assert stats["rays"] > 0
    assert int(np.load(str(ck))["passes"]) == 4
    statslib.reset()
    # resumed from the file: every pass is done, the image is the same
    assert tcli.main([str(small_scene), str(tmp_path / "r.pfm"), "--spp", "4",
                      "--filmCheckpoint", str(ck), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(imglib.read_pfm(str(tmp_path / "r.pfm")),
                                  imglib.read_pfm(str(out)))


def test_cli_iile_long_aliases(small_scene, tmp_path, monkeypatch):
    """--iileIndirectTasks and --iileDirectSamples reach render_iile as
    the task and direct-pass counts (the IILE CLI itself renders in
    tests/test_torch_iile.py::test_cli_iispt_writes_images)."""
    from pbrt_v3_iile_tpu_torch.integrators import iispt

    seen = {}

    def fake_render_iile(sd, **kw):
        seen.update(kw)
        img = np.zeros((8, 8, 3), np.float32)
        return img, img, img, {}

    monkeypatch.setattr(iispt, "render_iile", fake_render_iile)
    assert tcli.main([str(small_scene), str(tmp_path / "i.pfm"),
                      "--integrator", "iispt", "--iileIndirectTasks", "3",
                      "--iileDirectSamples", "5", "--quiet",
                      "--device", "cpu"]) == 0
    assert seen["indirect_tasks"] == 3 and seen["direct_samples"] == 5
