"""Shading parity: BSDFs, lights, camera rays and the film, port vs JAX.

Shared random inputs from numpy go through both packages.  Tolerance:
1e-5 relative (+1e-6 absolute near zero); the two libraries' pow, log,
sqrt and atan2 differ in the last ulp.  Unit direction vectors are held
to 1e-5 of their norm per component (a small component of a sampled
direction carries the rounding of the whole vector).  BSDF and light
values are ill-conditioned in places (a sharp glossy lobe evaluated at
a sampled direction, a light pdf at a grazing cosine), so there the
1e-5 bound holds on >= 99.9% of the samples (99.5% for f and pdf at a
sampled direction, a longer chain of rounded ops) and 1e-3 on all.
Discrete outcomes (lobe flags, validity, delta flags, light ids) agree
exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.ops import bsdf as jbsdf
from pbrt_v3_iile_tpu.ops import camera as jcam
from pbrt_v3_iile_tpu.ops import film as jfilm
from pbrt_v3_iile_tpu.ops import lights as jlights
from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu.utils import image as imglib
from pbrt_v3_iile_tpu_torch.ops import bsdf as tbsdf
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import film as tfilm
from pbrt_v3_iile_tpu_torch.ops import lights as tlights
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from torch_parity import assert_close, assert_mostly_close, jax_scene_leaves, to_np, tt

RTOL, ATOL = 1e-5, 1e-6
DIR_ATOL = 1e-5  # unit vectors: each component within 1e-5 of the unit norm
N = 4096
MATERIALS = {
    "matte": apilib.MAT_MATTE, "plastic": apilib.MAT_PLASTIC,
    "mirror": apilib.MAT_MIRROR, "glass": apilib.MAT_GLASS,
    "metal": apilib.MAT_METAL, "uber": apilib.MAT_UBER,
    "substrate": apilib.MAT_SUBSTRATE, "translucent": apilib.MAT_TRANSLUCENT,
    "disney": apilib.MAT_DISNEY,
}


def _dirs(rng, n, upper=None):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) * (1 if upper else -1)
    return v


def _params(rng, kind):
    f = lambda *s: rng.uniform(0.05, 0.95, s).astype(np.float32)
    p = dict(kind=np.full(N, kind, np.int32), kd=f(N, 3), ks=f(N, 3),
             kr=f(N, 3), kt=f(N, 3), alpha=rng.uniform(0.1, 0.8, N).astype(np.float32),
             eta=rng.uniform(1.2, 2.0, N).astype(np.float32),
             metal_eta=rng.uniform(0.2, 2.0, (N, 3)).astype(np.float32),
             metal_k=rng.uniform(1.0, 4.0, (N, 3)).astype(np.float32),
             sigma=np.where(np.arange(N) % 2 == 0, 0.0,
                            rng.uniform(5, 40, N)).astype(np.float32),
             aux=f(N, 8))
    jp = jbsdf.BsdfParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tbsdf.BsdfParams(**{k: tt(v) for k, v in p.items()})
    return jp, tp


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_bsdf_evaluate_and_sample_match(name):
    rng = np.random.default_rng(sorted(MATERIALS).index(name))
    jp, tp = _params(rng, MATERIALS[name])
    wo = _dirs(rng, N)
    wi = _dirs(rng, N)
    jf, jpdf = jbsdf.evaluate(jp, jnp.asarray(wo), jnp.asarray(wi),
                              enable_hair=False)
    tf, tpdf = tbsdf.evaluate(tp, tt(wo), tt(wi))
    assert_mostly_close(to_np(tf), np.asarray(jf), RTOL, ATOL, f"{name} f")
    assert_mostly_close(to_np(tpdf), np.asarray(jpdf), RTOL, ATOL, f"{name} pdf")
    ul = rng.random(N, dtype=np.float32)
    u2 = rng.random((N, 2), dtype=np.float32)
    js = to_np(jbsdf.sample(jp, jnp.asarray(wo), jnp.asarray(ul),
                            jnp.asarray(u2), enable_hair=False))
    ts = to_np(tbsdf.sample(tp, tt(wo), tt(ul), tt(u2)))
    for k in ("is_specular", "is_transmission", "valid"):
        np.testing.assert_array_equal(ts[k], js[k], err_msg=f"{name} {k}")
    v = js["valid"]
    assert_close(ts["wi"][v], js["wi"][v], RTOL, DIR_ATOL, f"{name} sample wi")
    for k in ("f", "pdf"):
        assert_mostly_close(ts[k][v], js[k][v], RTOL, ATOL, f"{name} sample {k}",
                            frac=0.995)
    np.testing.assert_array_equal(to_np(tbsdf.is_black(tp)),
                                  np.asarray(jbsdf.is_black(jp)))
    np.testing.assert_array_equal(to_np(tbsdf.has_nonspecular(tp)),
                                  np.asarray(jbsdf.has_nonspecular(jp)))


LIGHT_SCENE = """
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "sobol" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [3]{strategy}
WorldBegin
LightSource "point" "point from" [0 2 0] "rgb I" [3 3 3]
LightSource "spot" "point from" [1 2 0] "point to" [0 0 0] "rgb I" [5 4 3]
    "float coneangle" [30] "float conedeltaangle" [5]
LightSource "distant" "point from" [-3 4 -6] "point to" [0 0 0] "rgb L" [2 2 1.8]
LightSource "infinite" "rgb L" [0.4 0.5 0.6]{envmap}
AttributeBegin
  AreaLightSource "area" "rgb L" [8 7 6]
  Translate 0 2.5 0
  Shape "trianglemesh" "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
      "integer indices" [0 2 1 0 3 2]
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


@pytest.fixture(scope="module", params=["uniform-const", "spatial-envmap"])
def light_scenes(request, tmp_path_factory):
    if request.param == "spatial-envmap":
        d = tmp_path_factory.mktemp("env")
        rng = np.random.default_rng(0)
        imglib.write_pfm(str(d / "env.pfm"),
                         rng.uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32))
        text = LIGHT_SCENE.format(strategy="", envmap=' "string mapname" "env.pfm"')
        sd = apilib.load_scene_string(text, base_dir=str(d))
    else:
        text = LIGHT_SCENE.format(
            strategy=' "string lightsamplestrategy" "uniform"', envmap="")
        sd = apilib.load_scene_string(text)
    js = jdev.build_device_scene(sd, with_clusters=False)
    return js, scene_from_numpy(jax_scene_leaves(js), "cpu")


def test_light_sampling_and_pdfs_match(light_scenes):
    js, ts = light_scenes
    rng = np.random.default_rng(3)
    nl = int(js.n_lights)
    lid = (np.arange(N) % nl).astype(np.int32)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    p[:, 1] = rng.uniform(0.05, 1.5, N)
    u3 = rng.random((N, 3), dtype=np.float32)
    jl = to_np(jlights.sample_li(js, jnp.asarray(lid), jnp.asarray(p),
                                 jnp.asarray(u3)))
    tl = to_np(tlights.sample_li(ts, tt(lid), tt(p), tt(u3)))
    np.testing.assert_array_equal(tl["is_delta"], jl["is_delta"])
    for k in ("wi", "n_l"):
        assert_close(tl[k], jl[k], RTOL, DIR_ATOL, f"sample_li {k}")
    for k in ("li", "pdf", "dist"):
        assert_mostly_close(tl[k], jl[k], RTOL, ATOL, f"sample_li {k}")
    wi = _dirs(rng, N)
    hit_t = rng.uniform(0.1, 5.0, N).astype(np.float32)
    hit_cos = rng.uniform(0.05, 1.0, N).astype(np.float32)
    a = np.asarray(jlights.pdf_li(js, jnp.asarray(lid), jnp.asarray(p),
                                  jnp.asarray(wi), jnp.asarray(hit_t),
                                  jnp.asarray(hit_cos)))
    b = to_np(tlights.pdf_li(ts, tt(lid), tt(p), tt(wi), tt(hit_t), tt(hit_cos)))
    assert_mostly_close(b, a, RTOL, ATOL, "pdf_li")
    n = _dirs(rng, N)
    a = np.asarray(jlights.area_light_le(js, jnp.asarray(lid), jnp.asarray(n),
                                         jnp.asarray(wi)))
    assert_close(to_np(tlights.area_light_le(ts, tt(lid), tt(n), tt(wi))), a,
                 RTOL, ATOL, "area_light_le")
    a = np.asarray(jlights.environment_le(js, jnp.asarray(wi)))
    assert_close(to_np(tlights.environment_le(ts, tt(wi))), a, RTOL, ATOL,
                 "environment_le")
    a = np.asarray(jlights._env_dir_pdf(js, jnp.asarray(wi)))
    assert_close(to_np(tlights._env_dir_pdf(ts, tt(wi))), a, RTOL, ATOL,
                 "env_dir_pdf")


def test_light_selection_matches(light_scenes):
    js, ts = light_scenes
    rng = np.random.default_rng(4)
    u = rng.random(N, dtype=np.float32)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    for jf, tf, args in (
            (jlights.choose_light, tlights.choose_light, (u,)),
            (jlights.choose_light_spatial, tlights.choose_light_spatial, (u, p))):
        jid, jpdf = jf(js, *(jnp.asarray(a) for a in args))
        tid, tpdf = tf(ts, *(tt(a) for a in args))
        np.testing.assert_array_equal(to_np(tid), np.asarray(jid))
        assert_close(to_np(tpdf), np.asarray(jpdf), RTOL, ATOL, "select pdf")
    lid = (np.arange(N) % int(js.n_lights)).astype(np.int32)
    assert_close(to_np(tlights.light_select_pdf_spatial(ts, tt(p), tt(lid))),
                 np.asarray(jlights.light_select_pdf_spatial(
                     js, jnp.asarray(p), jnp.asarray(lid))), RTOL, ATOL, "sel")
    assert_close(to_np(tlights.infinite_select_pdf_spatial(ts, tt(p))),
                 np.asarray(jlights.infinite_select_pdf_spatial(js, jnp.asarray(p))),
                 RTOL, ATOL, "inf sel")
    jpdf, jcdf = jlights.finite_light_distribution(js)
    tpdf, tcdf = tlights.finite_light_distribution(ts)
    assert_close(to_np(tpdf), np.asarray(jpdf), RTOL, ATOL, "finite pdf")
    assert tlights.has_infinite(ts) == bool(jlights.has_infinite(js))


@pytest.mark.parametrize("kind,lens", [("perspective", 0.0), ("perspective", 0.05),
                                       ("orthographic", 0.0), ("environment", 0.0)])
def test_generate_rays_match(kind, lens):
    sd = apilib.load_scene_string(f"""
        LookAt 0.3 1 -4  0 0.5 0  0 1 0
        Camera "{kind}" "float fov" [50] "float lensradius" [{lens}]
            "float focaldistance" [3]
        Film "image" "integer xresolution" [24] "integer yresolution" [16]
        WorldBegin
        WorldEnd""")
    rng = np.random.default_rng(5)
    pf = (rng.random((N, 2)) * [24, 16]).astype(np.float32)
    ul = rng.random((N, 2), dtype=np.float32)
    k = jcam.KIND[kind]
    jo, jd = jcam.generate_rays(jcam.make_camera(sd.camera, sd.film),
                                jnp.asarray(pf), jnp.asarray(ul), kind=k)
    to, td = tcam.generate_rays(tcam.make_camera(sd.camera, sd.film, "cpu"),
                                tt(pf), tt(ul), kind=k)
    assert_close(to_np(to), np.asarray(jo), RTOL, ATOL, "o")
    assert_close(to_np(td), np.asarray(jd), RTOL, DIR_ATOL, "d")


@pytest.mark.parametrize("filt,w", [("box", 0.5), ("box", 1.0), ("triangle", 1.5),
                                    ("gaussian", 1.5), ("mitchell", 2.0),
                                    ("sinc", 2.0)])
def test_film_matches(filt, w):
    rng = np.random.default_rng(6)
    L = rng.uniform(0, 2, (12, 10, 3)).astype(np.float32)
    jit = rng.random((12, 10, 2), dtype=np.float32)
    jf = jfilm.add_sample_image(jfilm.new_film(12, 10), jnp.asarray(L),
                                jnp.asarray(jit), filter_name=filt, xw=w, yw=w)
    jf = jfilm.add_sample_image(jf, jnp.asarray(L[::-1].copy()),
                                jnp.asarray(jit), filter_name=filt, xw=w, yw=w)
    tf = tfilm.add_sample_image(tfilm.new_film(12, 10, "cpu"), tt(L), tt(jit),
                                filter_name=filt, xw=w, yw=w)
    tf = tfilm.add_sample_image(tf, tt(L[::-1].copy()), tt(jit),
                                filter_name=filt, xw=w, yw=w)
    assert_close(to_np(tf.weight), np.asarray(jf.weight), RTOL, ATOL, "weight")
    assert_close(to_np(tfilm.resolve(tf)), np.asarray(jfilm.resolve(jf)),
                 RTOL, ATOL, "resolve")
