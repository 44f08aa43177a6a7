"""The realistic lens camera, port vs JAX.

- ``load_lens_file`` and ``focus_lens`` equal to the JAX package's in
  float64 (the same host code), on tests/test_realistic_camera.py's
  biconvex lens and on the repository's lens table
  (scenes/lens_wide22.dat), focused at 1 m and 4.29 m;
- ``realistic_generate_rays`` against JAX on 4,096 seeded film points and
  lens samples through the lens of scenes/atrium_lens.pbrt: origins and
  directions within 1e-6 (relative on the origins), the vignetting mask
  equal and the cos^4 weights within 1e-6;
- the 16^2 render of scenes/atrium_lens.pbrt against the JAX package's
  (tests/golden/camera16_realistic.npz, made by
  tools/make_camera_golden.py) by tests/test_golden.py's criterion, the
  traced ray counts within max(4, 0.2%).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_v3_iile_tpu.ops import camera as jcam
from pbrt_v3_iile_tpu_torch.ops import camera as tcam

from test_realistic_camera import LENS_DAT
from torch_parity import (REPO, assert_close, camera_golden,
                          golden_criterion, render_camera_golden, tt)

LENS_TABLE = os.path.join(REPO, "scenes", "lens_wide22.dat")


@pytest.fixture()
def biconvex(tmp_path):
    path = tmp_path / "biconvex.dat"
    path.write_text(LENS_DAT)
    return str(path)


@pytest.mark.parametrize("which,focus", [("biconvex", 1.0),
                                         ("table", 1.0), ("table", 4.29)])
def test_lens_file_and_focus_equal_jax(biconvex, which, focus):
    path = biconvex if which == "biconvex" else LENS_TABLE
    got = tcam.load_lens_file(path)
    want = jcam.load_lens_file(path)
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcam.focus_lens(*got, focus),
                                  jcam.focus_lens(*want, focus))
    if which == "table":
        assert len(got[0]) == 5 and (got[0] == 0).sum() == 1


def test_realistic_rays_match_jax():
    from pbrt_v3_iile_tpu.scene import api as japi

    _, tsd = camera_golden("camera16_realistic")
    _, jsd = camera_golden("camera16_realistic", api=japi)
    tc = tcam.make_camera(tsd.camera, tsd.film, "cpu")
    jc = jcam.make_camera(jsd.camera, jsd.film)
    for f in ("lens_curv", "lens_thick", "lens_eta", "lens_ap", "film_half"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    rng = np.random.default_rng(6)
    pf = (rng.uniform(0, 1, (4096, 2)) * 16).astype(np.float32)
    u = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    jo, jd, jw = (np.asarray(x) for x in jcam.realistic_generate_rays(
        jc, jnp.asarray(pf), jnp.asarray(u)))
    to, td, tw = (x.numpy() for x in tcam.realistic_generate_rays(
        tc, tt(pf), tt(u)))
    ok = jw > 0
    assert 0.05 < ok.mean() < 0.9
    np.testing.assert_array_equal(tw > 0, ok)
    assert_close(tw, jw, rtol=0.0, atol=1e-6, name="w")
    assert_close(to[ok], jo[ok], rtol=1e-6, atol=1e-6, name="o")
    assert_close(td[ok], jd[ok], rtol=0.0, atol=1e-6, name="d")


def test_realistic_render_16_matches_golden():
    img, z, st = render_camera_golden("camera16_realistic")
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert abs(st["rays"] - int(z["rays"])) <= max(4, 0.002 * int(z["rays"]))
