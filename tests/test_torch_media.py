"""Participating media, port vs JAX: the Henyey-Greenstein phase function
and its sampler, the trilinear grid density, the media leaves of the
device scene, and volpath renders.

- ``_hg_p``, ``_hg_sample`` and ``_grid_density`` on the same seeded
  inputs through both packages (1e-6 relative, 1e-7 absolute near 0);
- the port's HG integrates to 1 over the sphere, samples forward for
  g > 0 with its own pdf (tests/test_media.py's samples and tolerances:
  0.02 on the integral, 0.03 on the mean cosine, 1e-3 relative on the
  pdf);
- the media leaves of tests/test_media.py's grid scene and of a scene
  with two media (a camera in fog, a smoke box inside it) against the
  JAX package's build: ints exact, floats within 1e-6 relative, the
  per-triangle medium interfaces in BVH order;
- 16^2 volpath renders of scenes/atrium_transport.pbrt with only its fog,
  with only its smoke, and with every feature, and the compacted pass
  loop at 48x32 for the same three, against the JAX package's renders of
  the same settings (tests/golden/transport16_*.npz, made by
  tools/make_transport_golden.py; JAX is not compiled here) by
  tests/test_golden.py's criterion, the traced ray counts within
  max(4, 0.2%);
- the CLI's ``--integrator volpath`` on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.integrators import path as jpath
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.integrators import path as tpath
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import device as tdev

import test_media
from torch_parity import (assert_close, golden_criterion,
                          render_transport_golden, run_both, tt)

TWO_MEDIA = """
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "volpath" "integer maxdepth" [3]
MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [0.01 0.02 0.03] "rgb sigma_s" [0.1 0.1 0.12] "float g" [0.3]
MediumInterface "" "fog"
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
AttributeBegin
  Translate 0.2 0.1 0.3
  MakeNamedMedium "smoke" "string type" "heterogeneous"
    "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [2 2 2] "float g" [-0.2]
    "integer nx" [3] "integer ny" [2] "integer nz" [4]
    "float density" [0 .1 .2 .3 .4 .5 .6 .7 .8 .9 1 .9 .8 .7 .6 .5 .4 .3 .2 .1
                     0 .5 .25 .75]
    "point p0" [-0.5 0 -0.5] "point p1" [0.5 1 0.5]
  Material ""
  MediumInterface "smoke" "fog"
  Shape "trianglemesh" "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 1 -0.5
      -0.5 1 -0.5  -0.5 0 0.5  0.5 0 0.5  0.5 1 0.5  -0.5 1 0.5]
    "integer indices" [0 2 1 0 3 2 4 5 6 4 6 7 0 1 5 0 5 4 3 6 2 3 7 6
      0 7 3 0 4 7 1 2 6 1 6 5]
AttributeEnd
WorldEnd
"""


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_hg_p_matches_jax():
    rng = np.random.default_rng(0)
    cos_t = rng.uniform(-1, 1, 4096).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, 4096).astype(np.float32)
    g[:64] = 0.0
    a, b = run_both(jpath._hg_p, tpath._hg_p, cos_t, g)
    assert_close(b, a, rtol=1e-6, atol=1e-7, name="hg_p")


def test_hg_sample_matches_jax():
    rng = np.random.default_rng(1)
    n = 4096
    d = _dirs(rng, n)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    g[:64] = 0.0                  # the isotropic branch
    g[64:128] = 5e-4
    u = rng.random((n, 2), dtype=np.float32)
    (wi_j, pdf_j), (wi_t, pdf_t) = run_both(jpath._hg_sample, tpath._hg_sample,
                                            d, g, u)
    assert_close(wi_t, wi_j, rtol=1e-6, atol=1e-6, name="wi")
    assert_close(pdf_t, pdf_j, rtol=1e-6, atol=1e-7, name="pdf")


@pytest.mark.parametrize("g", [-0.5, 0.0, 0.3, 0.8])
def test_hg_normalization(g):
    """tests/test_media.py::test_hg_normalization on the port, on its
    samples (the port's threefry is jax.random's, bit for bit)."""
    u = threefry.uniform(threefry.prng_key(0), (1 << 14,))
    cos_t = 1.0 - 2.0 * u
    p = tpath._hg_p(cos_t, torch.full_like(cos_t, g)).numpy()
    assert abs(p.mean() * 4 * math.pi - 1.0) < 0.02


def test_hg_sample_pdf_consistency():
    """tests/test_media.py::test_hg_sample_pdf_consistency on the port, on
    its samples."""
    N = 1 << 13
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(N, 1)
    g = torch.full((N,), 0.6)
    u = threefry.uniform(threefry.prng_key(1), (N, 2))
    wi, pdf = tpath._hg_sample(d, g, u)
    assert np.allclose(np.linalg.norm(wi.numpy(), axis=-1), 1.0, atol=1e-4)
    assert abs(float(wi[:, 2].mean()) - 0.6) < 0.03
    p = tpath._hg_p(-wi[:, 2], g).numpy()
    assert np.allclose(p, pdf.numpy(), rtol=1e-3)


@pytest.fixture(scope="module")
def two_media():
    """TWO_MEDIA built by both packages: (JAX DeviceScene, port leaves)."""
    jsd = japi.load_scene_string(TWO_MEDIA)
    tsd = tapi.load_scene_string(TWO_MEDIA)
    return (jdev.build_device_scene(jsd),
            tdev.build_leaves(tsd))


MEDIA_LEAVES = ("med_sigma_a", "med_sigma_s", "med_g", "med_grid_id", "med_w2m",
                "med_density", "med_grid_dims", "med_max_density", "tri_med_in",
                "tri_med_out", "camera_medium")


@pytest.mark.parametrize("scene", ["grid_absorb", "two_media"])
def test_media_leaves_match_jax(scene, two_media):
    if scene == "two_media":
        jds, leaves = two_media
    else:
        text = test_media.GRID_ABSORB_SCENE
        jds = jdev.build_device_scene(japi.load_scene_string(text))
        leaves = tdev.build_leaves(tapi.load_scene_string(text))
    for name in MEDIA_LEAVES:
        want = np.asarray(getattr(jds, name))
        got = np.asarray(leaves[name])
        assert got.shape == want.shape, name
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert_close(got, want, rtol=1e-6, name=name)
    # the interfaces follow the triangles into BVH order
    np.testing.assert_array_equal(leaves["tri_p0"], np.asarray(jds.tri_p0))
    if scene == "two_media":
        assert int(leaves["camera_medium"]) == 0 and len(leaves["med_g"]) == 2
        box = leaves["tri_med_in"] == 1
        assert box.sum() == 12 and (leaves["tri_med_out"][box] == 0).all()


@pytest.mark.parametrize("scene", ["grid_absorb", "two_media"])
def test_grid_density_matches_jax(scene, two_media):
    """The trilinear density at seeded points in and around each grid, on
    the scene as each package built it."""
    if scene == "two_media":
        jds, leaves = two_media
        mid, lo, hi = 1, np.array([-0.5, 0.0, -0.3]), np.array([0.8, 1.2, 0.9])
    else:
        text = test_media.GRID_ABSORB_SCENE
        jds = jdev.build_device_scene(japi.load_scene_string(text))
        leaves = tdev.build_leaves(tapi.load_scene_string(text))
        mid, lo, hi = 0, np.array([-20, -20, -3.0]), np.array([20, 20, 7.0])
    tds = tdev.scene_from_numpy(leaves, "cpu")
    rng = np.random.default_rng(2)
    p = rng.uniform(lo, hi, (4096, 3)).astype(np.float32)
    m = np.full(4096, mid, np.int32)
    want = np.asarray(jpath._grid_density(jds, jnp.asarray(m), jnp.asarray(p)))
    got = tpath._grid_density(tds, tt(m), tt(p)).numpy()
    assert (want > 0).mean() > 0.3 and (want == 0).mean() > 0.05
    assert_close(got, want, rtol=1e-6, atol=1e-7, name="density")


@pytest.mark.parametrize("name", ["fog", "smoke", "all", "fog_compact",
                                  "smoke_compact", "all_compact"])
def test_volpath_render_matches_jax_golden(name):
    img, z, st = render_transport_golden(name)
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert np.isfinite(img).all() and img.mean() > 0
    # the same paths: the traced ray count agrees to a few rays, as in
    # tests/test_torch_slice.py (a rounding can move one grazing decision)
    jrays = int(z["rays"])
    assert abs(st["rays"] - jrays) <= max(4, jrays // 500)


def test_volpath_config_from_the_scene():
    """volpath and a path scene with media are volumetric; a grid medium
    switches on the tracking; a scene without media is not volumetric."""
    sd = tapi.load_scene_string(TWO_MEDIA)
    cfg = trender.make_integrator_config(sd, device="cpu")
    assert cfg.volumetric and cfg.grid_media and cfg.track_steps == 64
    sd.integrator.kind = "path"
    assert trender.make_integrator_config(sd, device="cpu").volumetric
    sd = tapi.load_scene_string(test_media.ABSORB_SCENE)
    cfg = trender.make_integrator_config(sd, device="cpu")
    assert cfg.volumetric and not cfg.grid_media
    sd.media, sd.integrator.kind = [], "path"
    assert not trender.make_integrator_config(sd, device="cpu").volumetric


def test_cli_renders_volpath(tmp_path):
    """python -m pbrt_v3_iile_tpu_torch.cli.main --integrator volpath on
    the CPU: a finite image of the film's size."""
    from pbrt_v3_iile_tpu_torch.cli import main as tcli
    from pbrt_v3_iile_tpu_torch.utils import image as imglib

    scene = tmp_path / "two_media.pbrt"
    scene.write_text(TWO_MEDIA.replace('"volpath"', '"path"'))
    out = tmp_path / "out.pfm"
    assert tcli.main([str(scene), str(out), "--integrator", "volpath",
                      "--spp", "2", "--device", "cpu", "--quiet"]) == 0
    img = imglib.read_pfm(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
