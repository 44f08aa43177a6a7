"""Bidirectional transport, port vs JAX: the light-emission and
camera-importance functions, Metropolis' random pieces, BDPT and MLT.

- ``sample_le``, ``pdf_le_dir`` and ``pdf_light_origin`` for every light
  kind (point, spot, goniometric and projection with their maps, distant,
  infinite with an env map and constant, one- and two-sided triangle and
  sphere area lights), and the pinhole's ``pdf_we_dir``,
  ``project_to_raster`` and ``sample_wi``, against the JAX functions on
  the same numpy inputs: within 1e-6 relative (+1e-6 absolute), on >=
  99.9% of the lanes for the values that pass through a map's bilinear
  tap or a near-grazing cosine, where one ulp of a direction is
  amplified, and within 1e-3 on all; masks and flags equal;
- Metropolis' draws bit for bit: ``erfinv`` as XLA computes it on the
  CPU over a dense grid of (-1, 1), ``_mutate`` for one key, the
  ``categorical`` chain starts;
- the 16^2 atrium goldens of ``tools/make_bidir_golden.py`` (the JAX
  package's renders) by tests/test_golden.py's criterion: ``bdpt`` (the
  image and, apart, the light-tracing splat film), ``mlt`` against the
  JAX package's own spread between two seeds, and PSSMLT's ``u_prim``
  tracing of explicit primary samples;
- analytic scenes, port only: ``bdpt`` on tests/test_analytic_scenes.py's
  GI sphere, and BDPT-MLT against PSSMLT on tests/test_mlt_sppm.py's
  sealed glass bulb.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.integrators import mlt as jmlt
from pbrt_v3_iile_tpu.ops import camera as jcam
from pbrt_v3_iile_tpu.ops import lights as jlights
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu.utils import image as imglib
from pbrt_v3_iile_tpu_torch.integrators import mlt as tmlt
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import lights as tlights
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from torch_parity import (REPO, assert_close, assert_mostly_close,
                          jax_scene_leaves, to_np, tt)

RTOL, ATOL = 1e-6, 1e-6
N = 4096

EMIT_SCENE = """
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [24] "integer yresolution" [16]
Integrator "bdpt" "integer maxdepth" [3]
WorldBegin
LightSource "point" "point from" [0 2 0] "rgb I" [3 3 3]
LightSource "spot" "point from" [1 2 0] "point to" [0 0 0] "rgb I" [5 4 3]
    "float coneangle" [30] "float conedeltaangle" [5]
LightSource "distant" "point from" [-3 4 -6] "point to" [0 0 0] "rgb L" [2 2 1.8]
LightSource "infinite" "rgb L" [0.4 0.5 0.6]{envmap}
AttributeBegin
  Translate 0 2 0
  Rotate 30 1 0 0
  LightSource "goniometric" "rgb I" [6 5 4] "string mapname" "gonio.pfm"
AttributeEnd
AttributeBegin
  Translate 1 2.5 -1
  Rotate 80 1 0 0
  LightSource "projection" "rgb I" [9 9 9] "float fov" [50] "string mapname" "proj.pfm"
AttributeEnd
AttributeBegin
  AreaLightSource "area" "rgb L" [8 7 6]
  Translate 0 2.5 0
  Shape "trianglemesh" "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
      "integer indices" [0 2 1 0 3 2]
AttributeEnd
AttributeBegin
  AreaLightSource "area" "rgb L" [2 3 2] "bool twosided" "true"
  Translate -1.5 1.2 1
  Shape "trianglemesh" "point P" [-0.3 0 -0.3  0.3 0 -0.3  0.3 0.4 0.3]
      "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
  AreaLightSource "area" "rgb L" [4 4 4] "bool twosided" "true"
  Translate 1.5 1 1
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
    "integer indices" [0 1 2 0 2 3]
WorldEnd
"""


@pytest.fixture(scope="module", params=["envmap", "constant"])
def emit_scenes(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("emit")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:16, 0:32]
    imglib.write_pfm(str(d / "gonio.pfm"), (0.2 + np.stack(
        [np.sin(xx / 5.0) ** 2, yy / 16.0, np.full_like(xx, 0.5, float)],
        -1)).astype(np.float32))
    imglib.write_pfm(str(d / "proj.pfm"),
                     rng.uniform(0.0, 2.0, (12, 20, 3)).astype(np.float32))
    imglib.write_pfm(str(d / "env.pfm"),
                     rng.uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32))
    env = ' "string mapname" "env.pfm"' if request.param == "envmap" else ""
    sd = japi.load_scene_string(EMIT_SCENE.format(envmap=env), base_dir=str(d))
    js = jdev.build_device_scene(sd, with_clusters=False)
    return js, scene_from_numpy(jax_scene_leaves(js), "cpu"), sd


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_sample_le_matches_jax(emit_scenes):
    js, ts, _ = emit_scenes
    rng = np.random.default_rng(1)
    nl = int(js.n_lights)
    assert nl == 9
    lid = (np.arange(N) % nl).astype(np.int32)
    u6 = rng.random((N, 6), dtype=np.float32)
    je = to_np(jlights.sample_le(js, jnp.asarray(lid), jnp.asarray(u6)))
    te = to_np(tlights.sample_le(ts, tt(lid), tt(u6)))
    for k in ("valid", "delta_pos", "delta_dir"):
        np.testing.assert_array_equal(te[k], je[k], err_msg=k)
    for k in ("o", "d", "n_l", "pdf_pos", "pdf_dir"):
        assert_close(te[k], je[k], RTOL, ATOL, f"sample_le {k}")
    for k in ("beta", "le"):
        assert_mostly_close(te[k], je[k], RTOL, ATOL, f"sample_le {k}")
    # every kind emits somewhere
    lum = te["beta"].max(-1)
    assert all((lum[lid == i] > 0).any() for i in range(nl))


def test_pdf_le_dir_and_origin_match_jax(emit_scenes):
    js, ts, _ = emit_scenes
    rng = np.random.default_rng(2)
    nl = int(js.n_lights)
    lid = (np.arange(N) % nl).astype(np.int32)
    n_l, w = _dirs(rng, N), _dirs(rng, N)
    a = np.asarray(jlights.pdf_le_dir(js, jnp.asarray(lid), jnp.asarray(n_l),
                                      jnp.asarray(w)))
    b = to_np(tlights.pdf_le_dir(ts, tt(lid), tt(n_l), tt(w)))
    assert_close(b, a, RTOL, ATOL, "pdf_le_dir")
    assert (b > 0).any() and (b == 0).any()
    a = np.asarray(jlights.pdf_light_origin(js, jnp.asarray(lid)))
    assert_close(to_np(tlights.pdf_light_origin(ts, tt(lid))), a, RTOL, ATOL,
                 "pdf_light_origin")


def test_camera_importance_matches_jax(emit_scenes):
    _, _, sd = emit_scenes
    jc = jcam.make_camera(sd.camera, sd.film)
    tc = tcam.make_camera(sd.camera, sd.film, "cpu")
    rng = np.random.default_rng(3)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-6, 4, N)
    d = _dirs(rng, N)
    d[: N // 2, 2] = np.abs(d[: N // 2, 2])   # half of them ahead of the camera
    a = np.asarray(jcam.pdf_we_dir(jc, jnp.asarray(d)))
    b = to_np(tcam.pdf_we_dir(tc, tt(d)))
    assert_mostly_close(b, a, RTOL, ATOL, "pdf_we_dir")
    assert (b > 0).any() and (b == 0).any()
    ra, oa = jcam.project_to_raster(jc, jnp.asarray(p))
    rb, ob = tcam.project_to_raster(tc, tt(p))
    np.testing.assert_array_equal(to_np(ob), np.asarray(oa))
    on = np.asarray(oa)
    assert_close(to_np(rb)[on], np.asarray(ra)[on], RTOL, 1e-4, "raster")
    sa = to_np(jcam.sample_wi(jc, jnp.asarray(p)))
    sb = to_np(tcam.sample_wi(tc, tt(p)))
    np.testing.assert_array_equal(sb["valid"], sa["valid"])
    for k in ("wi", "dist"):
        assert_close(sb[k], sa[k], RTOL, ATOL, f"sample_wi {k}")
    assert_mostly_close(sb["we_over_pdf"], sa["we_over_pdf"], RTOL, ATOL,
                        "sample_wi we_over_pdf")
    assert_close(float(tcam._persp_film_area(tc)),
                 float(jcam._persp_film_area(jc)), RTOL, 0.0, "film area")


# ---------------------------------------------------------------------------
# Metropolis' draws, bit for bit
# ---------------------------------------------------------------------------

def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_erfinv_matches_xla_bit_for_bit():
    """XLA's float32 erfinv on the CPU (Giles' polynomials over its Cephes
    log1p, the multiply-adds fused) over a dense grid of [-1, 1] and
    random points."""
    x = np.concatenate([np.linspace(-1, 1, 2_000_001, dtype=np.float32),
                        (2 * np.random.default_rng(0).random(500_000, dtype=np.float32)
                         - 1).astype(np.float32),
                        np.float32([1e-7, -1e-7, 1 - 1e-7, -1 + 1e-7, 0.0])])
    want = np.asarray(jax.jit(jax.scipy.special.erfinv)(jnp.asarray(x)))
    got = tmlt.erfinv(torch.from_numpy(x)).numpy()
    bad = _bits(got) != _bits(want)
    assert not bad.any(), (int(bad.sum()), x[bad][:5], got[bad][:5], want[bad][:5])


def test_ranged_uniform_split_and_log_match_jax():
    k = jax.random.PRNGKey(7)
    kt = threefry.prng_key(7)
    want = np.asarray(jax.random.uniform(k, (256, 80), minval=1e-7,
                                         maxval=1.0 - 1e-7))
    got = threefry.uniform(kt, (256, 80), minval=1e-7, maxval=1.0 - 1e-7)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(np.asarray(threefry.split(kt, 300), np.uint32),
                                  np.asarray(jax.random.split(k, 300)))
    v = np.random.default_rng(1).random(200_000, dtype=np.float32) * 8 + 1e-30
    np.testing.assert_array_equal(
        _bits(threefry.xla_log(torch.from_numpy(v))),
        _bits(jax.jit(jnp.log)(jnp.asarray(v))))


@pytest.mark.parametrize("seed", [0, 11])
def test_mutate_matches_jax_bit_for_bit(seed):
    """Kelemen's mutation as the reference's chain scan compiles it."""
    u = np.random.default_rng(seed).random((1024, 80), dtype=np.float32)
    mutate = jax.jit(jmlt._mutate, static_argnums=(2, 3))
    uj, lj = mutate(jnp.asarray(u), jax.random.PRNGKey(seed), 0.01, 0.3)
    ut, lt = tmlt._mutate(torch.from_numpy(u), threefry.prng_key(seed), 0.01, 0.3)
    np.testing.assert_array_equal(_bits(ut), _bits(uj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert 0 < int(lt.sum()) < 1024


def test_categorical_chain_starts_match_jax():
    """The chains' starts: categorical over log(max(I, 1e-20)) of the
    bootstrap's luminances, zeros among them."""
    rng = np.random.default_rng(2)
    I = rng.exponential(0.2, 4096).astype(np.float32)
    I[rng.random(4096) < 0.4] = 0.0
    k = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda k, i: jax.random.categorical(
        k, jnp.log(jnp.maximum(i, 1e-20)), shape=(1024,)))(k, jnp.asarray(I)))
    got = threefry.categorical(
        threefry.prng_key(3),
        threefry.xla_log(torch.clamp(torch.from_numpy(I), min=1e-20)), (1024,))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (I[want] > 0).all()


# ---------------------------------------------------------------------------
# the 16^2 atrium goldens of tools/make_bidir_golden.py
# ---------------------------------------------------------------------------

def bidir_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_bidir_golden", os.path.join(REPO, "tools", "make_bidir_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bidir_golden(name):
    """tests/golden/<name>.npz, its case and the port's parse of its scene."""
    from pbrt_v3_iile_tpu_torch.scene import api as tapi

    tool = bidir_tool()
    z = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
    case = tool.case_of(z)
    return z, case, tool.load_case(tapi, case), tool


def test_bdpt_golden16():
    """The image and, apart, the light-tracing splat film of a BDPT render
    by tests/test_golden.py's criterion, with every traversal on the BVH."""
    from pbrt_v3_iile_tpu_torch.integrators import render as trender
    from torch_parity import golden_criterion

    z, case, sd, _ = bidir_golden("bidir16_bdpt")
    img, st = trender.render(sd, spp=case["spp"], seed=case["seed"], device="cpu")
    ok, info = golden_criterion(st["splat"], z["splat"])
    assert ok, ("splat", info)
    assert st["splat"].mean() > 0
    ok, info = golden_criterion(img, z["img"])
    assert ok, ("image", info)
    assert st["rays"] == int(z["rays"])


def test_mlt_golden16_within_seed_spread():
    """BDPT-MLT: the port's seed-3 render is no further from the reference's
    than the reference's own seed 4 is, by each of chip_smoke.py's three
    image measures; the bootstrap's b within 1e-5; and at least 99% of the
    chains end on the reference's final primary samples, bit for bit (a
    wrong mutation or acceptance step sends every chain its own way)."""
    from pbrt_v3_iile_tpu_torch.integrators import render as trender

    z, case, sd, tool = bidir_golden("bidir16_mlt")
    img, st = trender.render(sd, spp=case["mpp"], seed=case["seed"], device="cpu")
    assert np.isfinite(img).all()
    dist = tool.image_distances(img, z["img"])
    spread = json.loads(str(z["spread"]))
    for k, v in dist.items():
        assert v <= spread[k], (k, dist, spread)
    assert abs(st["b"] - float(z["b"])) <= 1e-5 * float(z["b"])
    assert st["mutations"] == int(z["mutations"])
    same = int((tool.chain_digest(st["u"].numpy()) == z["u_digest"]).sum())
    assert same >= 0.99 * st["chains"], (same, st["chains"])


def test_pssmlt_u_prim_tracing_matches_jax():
    """PSSMLT's f(u): 1,024 paths traced from explicit primary samples (the
    uncompacted loop's u_prim) against the reference's, by
    tests/test_golden.py's criterion over the paths (a glossy lobe at a
    sampled direction amplifies one ulp of the compiled reference's ray
    directions on a few paths)."""
    from pbrt_v3_iile_tpu_torch.integrators import render as trender
    from pbrt_v3_iile_tpu_torch.ops import camera as tc
    from torch_parity import golden_criterion

    z, case, sd, tool = bidir_golden("bidir16_pssmlt_eval")
    md = sd.integrator.max_depth
    cfg = trender.make_integrator_config(sd, accel="bvh", device="cpu").replace(
        max_depth=md)
    scene, cam = trender.build(sd, "cpu", with_clusters=False)
    u = torch.from_numpy(tool.pssmlt_u(case, md))
    L, xy = tmlt._eval(scene, cam, 0, False, u, cfg)
    ok, info = golden_criterion(L.numpy(), z["L"])
    assert ok, info
    np.testing.assert_array_equal(xy.numpy(), u[:, :2].numpy())
    # the same paths keyed from u alone: a second evaluation is identical
    L2, _ = tmlt._eval(scene, cam, 0, False, u, cfg)
    assert torch.equal(L, L2)


# ---------------------------------------------------------------------------
# analytic scenes, port only
# ---------------------------------------------------------------------------

SPHERE_GI = """
LookAt 0 0 0  1 0 0  0 0 1
Camera "perspective" "float fov" [90]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Integrator "bdpt" "integer maxdepth" [3]
Sampler "random" "integer pixelsamples" [8]
WorldBegin
LightSource "point" "color I" [3.14159265 3.14159265 3.14159265]
AttributeBegin
  ReverseOrientation
  Material "matte" "color Kd" [0.5 0.5 0.5]
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def test_bdpt_gi_sphere_analytic():
    """tests/test_analytic_scenes.py's GI sphere (albedo 0.5, a point light
    of I = pi at its centre): bdpt at depth 3 gives rho + rho^2 + rho^3 =
    0.875, within 0.04, the t = 1 splats included."""
    from pbrt_v3_iile_tpu_torch.integrators import render as trender
    from pbrt_v3_iile_tpu_torch.scene import api as tapi

    img, _ = trender.render(tapi.load_scene_string(SPHERE_GI), spp=6,
                            device="cpu")
    assert abs(float(img.mean()) - 0.875) < 0.04, img.mean()


@pytest.mark.slow
def test_mlt_bdpt_beats_pssmlt_on_sealed_light():
    """tests/test_mlt_sppm.py's glass bulb: a point light sealed in glass,
    which NEE and BSDF sampling cannot reach; Metropolis over BDPT
    proposals finds more than 4x the transport of PSSMLT."""
    from pbrt_v3_iile_tpu_torch.scene import api as tapi
    from test_mlt_sppm import GLASS_BULB

    sd = tapi.load_scene_string(GLASS_BULB)
    cfg_b = tmlt.MLTConfig(max_depth=6, n_chains=384, n_bootstrap=2048, bdpt=True)
    img_b, _ = tmlt.render_mlt(sd, mutations_per_pixel=48, seed=3, cfg=cfg_b,
                               device="cpu")
    img_p, _ = tmlt.render_mlt(sd, mutations_per_pixel=48, seed=3,
                               cfg=cfg_b.replace(bdpt=False), device="cpu")
    assert np.isfinite(img_b).all() and np.isfinite(img_p).all()
    mb, mp = float(img_b.mean()), float(img_p.mean())
    assert mb > 0.02, mb
    assert mb > 4.0 * max(mp, 1e-9), (mb, mp)
