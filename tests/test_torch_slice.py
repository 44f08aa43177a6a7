"""The slice end to end: the port's render() of atrium against the JAX render().

Same scene, seed and sampler streams on both sides (the port reproduces
the threefry and Owen-sobol bits), accel "bvh" on both sides (the BVH
walker on the CPU).  Criterion: tests/test_golden.py's, mean within 2%
and >= 99% of pixels within 5% relative (+1e-2); f32 rounding can flip
a rare discrete decision (a Russian-roulette or lobe draw at its
threshold), which moves one path.
"""

import os

import jax
import numpy as np
import pytest

from pbrt_v3_iile_tpu.integrators import render as jrender
from pbrt_v3_iile_tpu.ops import film as jfilm
from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.utils import image as imglib
from pbrt_v3_iile_tpu_torch.cli import main as tcli
from pbrt_v3_iile_tpu_torch.integrators import render as trender

from torch_parity import ATRIUM, REPO, golden_criterion

COMPACT = (1.0, 1.0, 0.5, 0.25, 0.25, 0.125)


def _atrium(w, h, depth=3):
    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution, sd.film.y_resolution = w, h
    sd.integrator.max_depth = depth
    return sd


def _jax_render_compact(sd, spp, seed):
    """The JAX package's render loop with the compacted wavefront on the
    bvh accel (its render() compacts only the cluster accel)."""
    cfg = jrender.make_integrator_config(sd, accel="bvh")._replace(
        compact_schedule=COMPACT)
    scene, cam = jrender.build(sd)
    run = jax.jit(jrender.render_pass_fn(sd, cfg), static_argnums=(4,))
    key = jax.random.PRNGKey(seed)
    film = jfilm.new_film(sd.film.y_resolution, sd.film.x_resolution)
    for p in range(spp):
        L, jit_, _ = run(scene, cam, key, p, 0)
        film = jfilm.add_sample_image(film, L, jit_)
    return np.asarray(jfilm.resolve(film))


def test_scan_render_matches_jax():
    sd = _atrium(16, 16)
    ref, jst = jrender.render(sd, spp=2, seed=7)
    img, tst = trender.render(sd, spp=2, seed=7, accel="bvh", device="cpu")
    ok, info = golden_criterion(img, ref)
    assert ok, info
    # same paths: the traced ray count agrees to a few rays
    assert abs(tst["rays"] - jst["rays"]) <= max(4, jst["rays"] // 500)


def test_compacted_render_matches_jax():
    # 48x32 = 1536 lanes: above the 1024-lane floor of the per-bounce
    # budget, so the budget roulette and the slice run from bounce 2
    sd = _atrium(48, 32)
    ref = _jax_render_compact(sd, 2, 7)
    img, _ = trender.render(sd, spp=2, seed=7, accel="bvh", compact=True,
                            device="cpu")
    ok, info = golden_criterion(img, ref)
    assert ok, info


def test_cli_writes_finite_pfm(tmp_path):
    scene = tmp_path / "tiny.pbrt"
    scene.write_text("""
        LookAt 0 1 -4  0 0.5 0  0 1 0
        Camera "perspective" "float fov" [55]
        Film "image" "integer xresolution" [8] "integer yresolution" [8]
        Sampler "sobol" "integer pixelsamples" [2]
        Integrator "path" "integer maxdepth" [2]
        WorldBegin
        LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
        Material "matte" "rgb Kd" [0.7 0.7 0.7]
        Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
            "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
        WorldEnd""")
    out = tmp_path / "out.pfm"
    assert tcli.main([str(scene), str(out), "--spp", "2", "--device", "cpu"]) == 0
    img = imglib.read_pfm(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0


@pytest.mark.slow
def test_atrium_matches_golden():
    """The JAX package's golden atrium render (64^2, 8 spp, depth 3,
    seed 7) reproduced by the port."""
    ref = np.load(os.path.join(REPO, "tests", "golden", "atrium64_8spp_seed7.npy"))
    img, _ = trender.render(_atrium(64, 64), spp=8, seed=7, device="cpu")
    ok, info = golden_criterion(img, ref)
    assert ok, info
