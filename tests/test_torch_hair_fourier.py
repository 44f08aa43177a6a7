"""The hair fiber BSDF and the Fourier BSDF, port vs JAX.

- ``ops/hair.py``: evaluate, pdf and sample on seeded fibers and
  directions (1e-5 relative on >= 99.9% of the values, 1e-3 on all:
  the lobes are steep in their inputs; a sampled direction's error is
  relative to its unit length), the white furnace (unsampled and
  sampled) on the port at tests/test_hair.py's samples and tolerances,
  and the absorption helpers;
- ``ops/fourierbsdf.py``: the .bsdf file written by either package reads
  back identically in the other, the host evaluation and the lobe fit
  equal, ``densify`` equal, ``evaluate_device`` within 1e-5 relative (1e-6
  absolute) on a multi-order 3-channel table and on
  scenes/atrium_transport.bsdf;
- ``ops/bsdf.py``: evaluate and sample on lanes of hair, reflective and
  transmissive Fourier and matte materials of one scene, gathered by each
  package from its own build of it (f and pdf as for hair, the flags on
  >= 99.9% of lanes);
- 16^2 renders of scenes/atrium_transport.pbrt with only its hair and with
  only its Fourier bowl, each seen from close by, against the JAX
  package's renders (tests/golden/transport16_{hair,fourier}.npz) by
  tests/test_golden.py's criterion.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.ops import bsdf as jbsdf
from pbrt_v3_iile_tpu.ops import fourierbsdf as jfb
from pbrt_v3_iile_tpu.ops import hair as jhair
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.ops import bsdf as tbsdf
from pbrt_v3_iile_tpu_torch.ops import fourierbsdf as tfb
from pbrt_v3_iile_tpu_torch.ops import hair as thair
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

import test_fourier
from torch_parity import (REPO, assert_close, assert_mostly_close,
                          golden_criterion, jax_scene_leaves,
                          render_transport_golden, to_np, tt)

TRANSPORT_BSDF = os.path.join(REPO, "scenes", "atrium_transport.bsdf")


def _sphere(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _fibers(seed, n=8192):
    rng = np.random.default_rng(seed)
    return dict(wo=_sphere(rng, n), wi=_sphere(rng, n),
                h=rng.uniform(-0.95, 0.95, n).astype(np.float32),
                sigma_a=rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32),
                beta_m=rng.uniform(0.15, 0.9, n).astype(np.float32),
                beta_n=rng.uniform(0.15, 0.9, n).astype(np.float32),
                alpha=rng.uniform(0.0, 4.0, n).astype(np.float32),
                eta=rng.uniform(1.3, 1.7, n).astype(np.float32),
                u4=rng.random((n, 4), dtype=np.float32))


HAIR_ARGS = ("h", "sigma_a", "beta_m", "beta_n", "alpha", "eta")


@pytest.mark.parametrize("fn", ["evaluate", "pdf"])
def test_hair_evaluate_and_pdf_match_jax(fn):
    x = _fibers(0)
    a = np.asarray(getattr(jhair, fn)(
        jnp.asarray(x["wo"]), jnp.asarray(x["wi"]),
        *(jnp.asarray(x[k]) for k in HAIR_ARGS)))
    b = getattr(thair, fn)(tt(x["wo"]), tt(x["wi"]),
                           *(tt(x[k]) for k in HAIR_ARGS)).numpy()
    assert np.isfinite(b).all() and (b > 0).mean() > 0.9
    assert_mostly_close(b, a, rtol=1e-5, atol=1e-7, name=fn, rtol_all=1e-3,
                        atol_all=1e-6)


def test_hair_sample_matches_jax():
    """The sampled direction within 1e-5 of its unit length on >= 99.9% of
    lanes; f and pdf within 1e-3 of JAX's sample, and within 1e-5 on >=
    99.9% of lanes of JAX's evaluate and pdf at the port's direction (the
    lobes amplify the directions' rounding differences)."""
    x = _fibers(1)
    hj = [jnp.asarray(x[k]) for k in HAIR_ARGS]
    wo_j = jnp.asarray(x["wo"])
    wi_j, f_j, pdf_j = to_np(jhair.sample(wo_j, jnp.asarray(x["u4"]), *hj))
    wi_t, f_t, pdf_t = to_np(thair.sample(tt(x["wo"]), tt(x["u4"]),
                                          *(tt(x[k]) for k in HAIR_ARGS)))
    assert np.isfinite(wi_t).all() and np.isfinite(f_t).all()
    assert_mostly_close(wi_t, wi_j, rtol=0.0, atol=1e-5, name="wi",
                        rtol_all=0.0, atol_all=1e-3)
    assert_close(f_t, f_j, rtol=1e-3, atol=1e-5, name="f")
    assert_close(pdf_t, pdf_j, rtol=1e-3, atol=1e-5, name="pdf")
    at = jnp.asarray(wi_t)
    assert_mostly_close(f_t, np.asarray(jhair.evaluate(wo_j, at, *hj)),
                        rtol=1e-5, atol=1e-7, name="f at wi", rtol_all=1e-3,
                        atol_all=1e-5)
    assert_mostly_close(pdf_t, np.asarray(jhair.pdf(wo_j, at, *hj)),
                        rtol=1e-5, atol=1e-7, name="pdf at wi", rtol_all=1e-3,
                        atol_all=1e-5)


def test_hair_absorption_helpers_match_jax():
    c = np.array([0.8, 0.3, 0.05], np.float32)
    a = np.asarray(jhair.sigma_a_from_reflectance(jnp.asarray(c), 0.3))
    b = thair.sigma_a_from_reflectance(tt(c), 0.3).numpy()
    assert_close(b, a, rtol=1e-6, name="from_reflectance")
    a = np.asarray(jhair.sigma_a_from_concentration(1.3, 0.2))
    b = thair.sigma_a_from_concentration(1.3, 0.2).numpy()
    assert_close(b, a, rtol=1e-6, name="from_concentration")


def _uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


@pytest.mark.parametrize("beta", [(0.6, 0.6), (0.4, 0.4)])
def test_hair_white_furnace(beta):
    """tests/test_hair.py::test_white_furnace on the port, on its samples
    (the port's threefry is jax.random's, bit for bit)."""
    N = 200_000
    k1, k2 = threefry.split(threefry.prng_key(7))
    wo = _uniform_sphere(threefry.uniform(k1, (1, 2))).expand(N, 3)
    wi = _uniform_sphere(threefry.uniform(k2, (N, 2)))
    f = thair.evaluate(wo, wi, torch.full((N,), 0.33), torch.zeros(N, 3),
                       torch.full((N,), beta[0]), torch.full((N,), beta[1]))
    est = (f * wi[:, 2:3].abs()).mean(0) * 4.0 * np.pi
    np.testing.assert_allclose(est.numpy(), 1.0, atol=0.06)


def test_hair_white_furnace_sampled():
    """tests/test_hair.py::test_white_furnace_sampled on the port, on its
    samples."""
    N = 100_000
    ko, ku = threefry.split(threefry.prng_key(3))
    wo = _uniform_sphere(threefry.uniform(ko, (1, 2))).expand(N, 3)
    u4 = threefry.uniform(ku, (N, 4))
    wi, f, pdf = thair.sample(wo, u4, torch.full((N,), -0.25), torch.zeros(N, 3),
                              torch.full((N,), 0.5), torch.full((N,), 0.4))
    w = torch.where((pdf > 0)[:, None],
                    f * wi[:, 2:3].abs() / torch.clamp(pdf, min=1e-9)[:, None],
                    torch.zeros_like(f))
    np.testing.assert_allclose(w.mean(0).numpy(), 1.0, atol=0.08)


# ---------------------------------------------------------------------------
# Fourier
# ---------------------------------------------------------------------------

def _tables():
    return {"glossy": test_fourier._glossy_test_table(),
            "transport": jfb.read_bsdf(TRANSPORT_BSDF),
            "lambert": jfb.make_lambertian_table(0.4, 12)}


def _same_table(a, b):
    assert (a.eta, a.m_max, a.n_channels) == (b.eta, b.m_max, b.n_channels)
    for k in ("mu", "cdf", "m", "a_offset", "a"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("name", ["glossy", "transport", "lambert"])
def test_fourier_file_round_trips_between_packages(name, tmp_path):
    t = _tables()[name]
    jpath_, tpath_ = str(tmp_path / "j.bsdf"), str(tmp_path / "t.bsdf")
    jfb.write_bsdf(jpath_, t)
    tfb.write_bsdf(tpath_, tfb.read_bsdf(jpath_))
    assert open(jpath_, "rb").read() == open(tpath_, "rb").read()
    _same_table(tfb.read_bsdf(jpath_), jfb.read_bsdf(tpath_))


def test_fourier_host_evaluation_and_fit_match_jax():
    t = jfb.read_bsdf(TRANSPORT_BSDF)
    rng = np.random.default_rng(4)
    for _ in range(64):
        mi, mo, cp = rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-1, 1)
        np.testing.assert_array_equal(tfb.evaluate(t, mi, mo, cp),
                                      jfb.evaluate(t, mi, mo, cp))
    for a, b in zip(tfb.fit_lobes(t), jfb.fit_lobes(t)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_densify_matches_jax():
    tabs = list(_tables().values())
    want = jfb.densify(tabs, m_cap=6)._asdict()
    got = tfb.densify_np(tabs, m_cap=6)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", ["glossy", "transport"])
def test_evaluate_device_matches_jax(name):
    t = _tables()[name]
    rng = np.random.default_rng(5)
    n = 4096
    wo = _sphere(rng, n)
    wo[:, 2] = np.abs(wo[:, 2])
    wi = _sphere(rng, n)
    fid = np.zeros(n, np.int32)
    want = np.asarray(jfb.evaluate_device(jfb.densify([t]), jnp.asarray(fid),
                                          jnp.asarray(wo), jnp.asarray(wi)))
    got = tfb.evaluate_device(tfb.densify([t], device="cpu"), tt(fid), tt(wo),
                              tt(wi)).numpy()
    assert (want > 0).mean() > 0.3
    assert_close(got, want, rtol=1e-5, atol=1e-6, name="f")


# ---------------------------------------------------------------------------
# the BSDF module's hair and Fourier lanes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def material_scene(tmp_path_factory):
    """One scene with hair, reflective and transmissive Fourier and matte
    materials, built by the JAX package; the port's scene from its
    leaves."""
    d = tmp_path_factory.mktemp("bsdf")
    glossy, trans = str(d / "glossy.bsdf"), str(d / "trans.bsdf")
    jfb.write_bsdf(glossy, jfb.read_bsdf(TRANSPORT_BSDF))
    t = jfb.make_lambertian_table(0.4, 12)
    t.eta = 1.33
    jfb.write_bsdf(trans, t)
    text = f"""
        Camera "perspective"
        Film "image" "integer xresolution" [8] "integer yresolution" [8]
        WorldBegin
        LightSource "point" "rgb I" [1 1 1]
        Material "hair" "float beta_m" [0.3] "float beta_n" [0.35]
            "float eumelanin" [0.8] "float alpha" [3]
        Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 1 1 0 1 0 1 1]
        Material "fourier" "string bsdffile" "{glossy}"
        Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 2 1 0 2 0 1 2]
        Material "fourier" "string bsdffile" "{trans}"
        Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 3 1 0 3 0 1 3]
        Material "matte" "rgb Kd" [0.6 0.5 0.4]
        Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 4 1 0 4 0 1 4]
        WorldEnd"""
    jsd = japi.load_scene_string(text)
    kinds = [m.kind for m in jsd.materials]
    assert kinds.count(japi.MAT_FOURIER) == 2 and japi.MAT_HAIR in kinds
    assert [m.kind for m in tapi.load_scene_string(text).materials] == kinds
    jds = jdev.build_device_scene(jsd)
    tds = scene_from_numpy(jax_scene_leaves(jds), "cpu")
    assert tds.has_hair and tds.fourier is not None
    return jds, tds, [i for i, k in enumerate(kinds) if k in (
        japi.MAT_HAIR, japi.MAT_FOURIER, japi.MAT_MATTE)]


def _lanes(mats, seed, n=8192):
    rng = np.random.default_rng(seed)
    wo = _sphere(rng, n)
    wo[:, 2] = np.abs(wo[:, 2]) + 1e-3
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    return dict(mat=np.asarray(mats, np.int32)[np.arange(n) % len(mats)],
                uv=rng.random((n, 2), dtype=np.float32), wo=wo,
                wi=_sphere(rng, n), u_lobe=rng.random(n, dtype=np.float32),
                u2=rng.random((n, 2), dtype=np.float32))


def _params(jds, tds, x):
    return (jbsdf.gather_params(jds, jnp.asarray(x["mat"]), uv=jnp.asarray(x["uv"])),
            tbsdf.gather_params(tds, tt(x["mat"]), uv=tt(x["uv"])))


def test_bsdf_evaluate_hair_and_fourier_lanes_match_jax(material_scene):
    jds, tds, mats = material_scene
    x = _lanes(mats, 6)
    pj, pt = _params(jds, tds, x)
    fj, pdfj = jbsdf.evaluate(pj, jnp.asarray(x["wo"]), jnp.asarray(x["wi"]))
    ft, pdft = tbsdf.evaluate(pt, tt(x["wo"]), tt(x["wi"]))
    assert (np.asarray(fj).max(-1) > 0).mean() > 0.5
    assert_mostly_close(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-7,
                        name="f", rtol_all=1e-3, atol_all=1e-5)
    assert_mostly_close(pdft.numpy(), np.asarray(pdfj), rtol=1e-5, atol=1e-7,
                        name="pdf", rtol_all=1e-3, atol_all=1e-5)


def test_bsdf_sample_hair_and_fourier_lanes_match_jax(material_scene):
    jds, tds, mats = material_scene
    x = _lanes(mats, 7)
    pj, pt = _params(jds, tds, x)
    bj = to_np(jbsdf.sample(pj, jnp.asarray(x["wo"]), jnp.asarray(x["u_lobe"]),
                            jnp.asarray(x["u2"])))
    bt = to_np(tbsdf.sample(pt, tt(x["wo"]), tt(x["u_lobe"]), tt(x["u2"])))
    for k in ("is_specular", "is_transmission", "valid"):
        assert (bt[k] == bj[k]).mean() >= 0.999, k
    ok = bt["valid"] & bj["valid"]
    assert ok.mean() > 0.5 and (bt["is_transmission"] & ok).any()
    for k in ("wi", "f", "pdf"):
        assert_mostly_close(bt[k][ok], bj[k][ok], rtol=1e-5,
                            atol=1e-5 if k == "wi" else 1e-7, name=k,
                            rtol_all=1e-3, atol_all=1e-5)


@pytest.mark.parametrize("name", ["hair", "fourier"])
def test_render_matches_jax_golden(name):
    img, z, st = render_transport_golden(name)
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert np.isfinite(img).all() and img.mean() > 0
    # the same paths: the traced ray count agrees to a few rays, as in
    # tests/test_torch_slice.py (a rounding can move one grazing decision)
    jrays = int(z["rays"])
    assert abs(st["rays"] - jrays) <= max(4, jrays // 500)
