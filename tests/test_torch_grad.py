"""Differentiable rendering (detached sampling), port vs JAX.

- ``make_image_and_grad_fn`` on tests/test_grad.py's scene (16^2, depth 2,
  4 spp, seed 0) against the JAX package's (tests/golden/bidir16_grad.npz,
  made by tools/make_bidir_golden.py): the image and the gradient of its
  mean with respect to each DIFF_FIELDS tensor within 1e-5 of that
  tensor's largest magnitude;
- the same on tools/make_bidir_golden.py's GRAD_MATS_SCENE
  (tests/golden/bidir16_grad_mats.npz), whose image depends on every
  DIFF_FIELDS tensor: Oren-Nayar, plastic, glass, rough metal and mirror
  materials, a point and an area light;
- port only, as tests/test_grad.py checks the JAX package: the gradient
  with respect to the albedo against a central finite difference on the
  same key (within 15%), and a positive gradient with respect to the only
  light's intensity.
"""

import os

import numpy as np
import torch

from pbrt_v3_iile_tpu_torch.integrators import grad as tgrad
from pbrt_v3_iile_tpu_torch.integrators import path as tpath
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import samplers as smplr
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi

from test_grad import SCENE
from torch_parity import REPO

SPP = 16


def _scene():
    sd = tapi.load_scene_string(SCENE)
    scene, cam = trender.build(sd, "cpu")
    return sd, scene, cam


def test_image_and_grads_match_jax_golden():
    z = np.load(os.path.join(REPO, "tests", "golden", "bidir16_grad.npz"))
    sd, scene, cam = _scene()
    img, grads = tgrad.make_image_and_grad_fn(sd, spp=4, device="cpu")(
        scene, cam, threefry.prng_key(0))
    img = img.numpy()
    assert np.abs(img - z["img"]).max() <= 1e-5 * np.abs(z["img"]).max()
    for f in tgrad.DIFF_FIELDS:
        want, got = z[f"grad_{f}"], grads[f].numpy()
        assert got.shape == want.shape, f
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30), (
            f, np.abs(got - want).max(), np.abs(want).max())
    assert np.abs(z["grad_mat_kd"]).max() > 0 and np.abs(z["grad_light_L"]).max() > 0


def test_material_grads_match_jax_golden():
    """Every DIFF_FIELDS tensor within 1e-5 of its largest finite magnitude
    wherever the reference's entry is finite.  The reference's gradient with
    respect to mat_rough is NaN on the two materials whose microfacet lobe
    is sampled (plastic, metal: bs.f stays attached, and its derivative
    through the half-vector sampled from alpha is NaN), so there is no
    value to hold mat_rough to on them; every other tensor is finite and
    nonzero on the materials that use it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_bidir_golden", os.path.join(REPO, "tools", "make_bidir_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    z = np.load(os.path.join(REPO, "tests", "golden", "bidir16_grad_mats.npz"))
    sd = tool.load_case(tapi, tool.case_of(z))
    scene, cam = trender.build(sd, "cpu")
    img, grads = tgrad.make_image_and_grad_fn(sd, spp=4, device="cpu")(
        scene, cam, threefry.prng_key(0))
    img = img.numpy()
    assert np.abs(img - z["img"]).max() <= 1e-5 * np.abs(z["img"]).max()
    # materials in file order: matte (sigma 20), plastic, glass, metal,
    # mirror; the area light's diffuse material comes first
    kinds = scene.mat_kind.numpy()
    plastic, glass, metal, mirror = (int(np.flatnonzero(kinds == k)[0]) for k in (
        tapi.MAT_PLASTIC, tapi.MAT_GLASS, tapi.MAT_METAL, tapi.MAT_MIRROR))
    matte = int(np.flatnonzero(scene.mat_sigma.numpy() > 0)[0])
    used = {"mat_kd": (matte, plastic), "mat_ks": (plastic,),
            "mat_kr": (glass, mirror), "mat_kt": (glass,), "mat_sigma": (matte,)}
    for f in tgrad.DIFF_FIELDS:
        want, got = z[f"grad_{f}"], grads[f].numpy()
        assert got.shape == want.shape, f
        fin = np.isfinite(want)
        if f == "mat_rough":
            assert sorted(np.flatnonzero(~fin)) == sorted((plastic, metal))
        else:
            assert fin.all(), f
        scale = max(np.abs(want[fin]).max(), 1e-30)
        assert np.isfinite(got[fin]).all(), f
        assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * scale, (
            f, np.abs(got[fin] - want[fin]).max(), scale)
        for m in used.get(f, ()):
            assert np.abs(want[m]).max() > 0, (f, m)
    assert (z["grad_light_L"] > 0).all()


def _mean_image(sd, cam, differentiable):
    cfg = trender.make_integrator_config(sd, device="cpu").replace(
        differentiable=differentiable)
    H, W = sd.film.y_resolution, sd.film.x_resolution
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    pix = torch.stack([px, py], -1).reshape(-1, 2)

    def f(scene, key):
        acc = 0.0
        for p in range(SPP):
            k = threefry.fold_in(key, p)
            jitter = smplr.uniform(smplr.wave_key(k, 0, 0, smplr.DIM_PIXEL_JITTER),
                                   (H * W, 2))
            o, d = tcam.generate_rays(cam, pix + jitter, kind=0)
            L, _ = tpath.trace_paths(scene, o, d, k, cfg)
            acc = acc + torch.mean(L)
        return acc / SPP

    return f


def test_ad_matches_finite_difference():
    sd, scene, cam = _scene()
    key = threefry.prng_key(0)
    kd = scene.mat_kd.detach().clone().requires_grad_(True)
    g_kd, = torch.autograd.grad(
        _mean_image(sd, cam, True)(tgrad._merge(scene, {"mat_kd": kd}), key), kd)
    f_prim = _mean_image(sd, cam, False)
    eps = 2e-2
    # the same keys on both sides: a correlated difference, low noise
    for ci in range(3):
        up, dn = scene.mat_kd.clone(), scene.mat_kd.clone()
        up[1, ci] += eps
        dn[1, ci] -= eps
        fd = (float(f_prim(tgrad._merge(scene, {"mat_kd": up}), key))
              - float(f_prim(tgrad._merge(scene, {"mat_kd": dn}), key))) / (2 * eps)
        ad = float(g_kd[1, ci])
        assert fd != 0.0
        assert abs(ad - fd) < 0.15 * max(abs(fd), 1e-3), (ci, ad, fd)


def test_light_gradient_positive():
    sd, scene, cam = _scene()
    L = scene.light_L.detach().clone().requires_grad_(True)
    g, = torch.autograd.grad(
        _mean_image(sd, cam, True)(tgrad._merge(scene, {"light_L": L}),
                                   threefry.prng_key(0)), L)
    # brightening the only light brightens the image
    assert (g[0] > 0).all()
