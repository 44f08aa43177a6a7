"""The exact spatial BSSRDF, port vs JAX.

- ``bsdf.fresnel_moment1`` on seeded indices of refraction on both sides
  of 1 (1e-6 relative, 1e-7 absolute);
- the subsurface materials as each package builds them (``subsurface``
  with its sigmas and ``kdsubsurface``): kind, albedo, Kr, eta and the
  diffusion lengths ``sss_d`` of the device scene (1e-6 relative), and
  the config's ``has_subsurface``;
- 16^2 renders against the JAX package's renders of the same settings
  (tests/golden/transport16_{bssrdf,sss}.npz, made by
  tools/make_transport_golden.py) by tests/test_golden.py's criterion,
  the traced ray counts (the probe and exit-shadow rays among them)
  within max(4, 0.2%): tests/test_bssrdf.py's scene with its shadowing
  wall (a kdsubsurface floor), and scenes/atrium_transport.pbrt with
  only its kdsubsurface vase, seen from close by.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_v3_iile_tpu.ops import bsdf as jbsdf
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import bsdf as tbsdf
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import device as tdev

import test_bssrdf
from torch_parity import (assert_close, golden_criterion,
                          render_transport_golden, run_both)

SIGMA_SSS = ('Material "subsurface" "rgb sigma_a" [0.002 0.005 0.02] '
             '"rgb sigma_s" [2.2 2.9 3.6] "float scale" [3] "float eta" [1.4]')


def test_fresnel_moment1_matches_jax():
    eta = np.random.default_rng(0).uniform(0.4, 2.5, 4096).astype(np.float32)
    eta[:3] = (1.0, 1.33, 1 / 1.33)
    a, b = run_both(jbsdf.fresnel_moment1, tbsdf.fresnel_moment1, eta)
    assert_close(b, a, rtol=1e-6, atol=1e-7, name="fresnel_moment1")


@pytest.mark.parametrize("mat", ["kdsubsurface", "subsurface"])
def test_subsurface_material_build_matches_jax(mat):
    text = test_bssrdf._scene(test_bssrdf._SSS if mat == "kdsubsurface"
                              else SIGMA_SSS)
    jsd, tsd = japi.load_scene_string(text), tapi.load_scene_string(text)
    jm, tm = jsd.materials[-1], tsd.materials[-1]
    assert tm.kind == jm.kind == tapi.MAT_SUBSURFACE
    for k in ("kd", "kr", "sss_d"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, k)),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert tm.eta == jm.eta
    jds, leaves = jdev.build_device_scene(jsd), tdev.build_leaves(tsd)
    for k in ("mat_sss_d", "mat_kd", "mat_kr", "mat_eta", "mat_kind"):
        assert_close(leaves[k], np.asarray(getattr(jds, k)), rtol=1e-6, name=k)
    assert (leaves["mat_sss_d"][-1] > 0).all()
    assert trender.make_integrator_config(tsd, device="cpu").has_subsurface


@pytest.mark.parametrize("name", ["bssrdf", "sss"])
def test_bssrdf_render_matches_jax_golden(name):
    img, z, st = render_transport_golden(name)
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert np.isfinite(img).all() and img.mean() > 0
    # the same paths: the traced ray count agrees to a few rays, as in
    # tests/test_torch_slice.py (a rounding can move one grazing decision)
    jrays = int(z["rays"])
    assert abs(st["rays"] - jrays) <= max(4, jrays // 500)
