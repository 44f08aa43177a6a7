"""The kd-tree aggregate, port vs JAX.

- ``build_kdtree`` on tests/test_kdtree.py's random soups (and its
  200-triangle build): every array bit-equal to the JAX package's (the
  same numpy code); the kd leaves of the device scene of a soup with
  ``Accelerator "kdtree"`` equal to the JAX build's;
- ``intersect_kd_plain`` (the plain version of the kd-tree kernel, K3)
  against JAX ``intersect_kd`` on the same scene and rays (a soup whose
  leaves hold at most 8 triangles), closest-hit and any-hit: prim and
  validity equal on every ray, t within 1e-5
  relative (+1e-6) and the barycentrics within 1e-5 (XLA on the CPU
  rounds the triangle test's products and sums its own way; the kernel
  and the plain version agree bit for bit, tests/test_torch_cuda.py);
- a second fault of the reference that the port does not copy: its
  walker tests only the first 8 triangles of a leaf, and the build makes
  longer leaves; the port tests them all, as the BVH finds them;
- the 16^2 render of atrium with ``Accelerator "kdtree"`` against the JAX
  package's render of the same scene with its BVH walker
  (tests/golden/camera16_kdtree.npz, made by tools/make_camera_golden.py:
  the JAX kd walker's leaf cap leaks light through atrium's walls) by
  tests/test_golden.py's criterion, the traced ray counts within
  max(4, 0.2%);
- a fault of the reference that the port does not copy: the JAX package
  builds the kd-tree only when the scene file asks for it, so
  ``render(sd, accel="kdtree")`` of a scene without the statement
  traverses its placeholder (one empty leaf with zero bounds), every ray
  misses and the image is black.  The port builds the tree whenever the
  resolved accel is ``kdtree``: that render equals the same scene's
  ``bvh`` render by tests/test_golden.py's criterion.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_v3_iile_tpu.ops import kdtree as jkd
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import intersect as tis
from pbrt_v3_iile_tpu_torch.ops import kdtree as tkd
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import device as tdev
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from test_kdtree import _random_soup_scene
from torch_parity import (golden_criterion, jax_scene_leaves,
                          render_camera_golden, to_np, tt)

KD_FIELDS = ("split", "meta", "offset", "prims", "bounds")


def _soup_triangles(n_tris, seed):
    """The BVH-ordered triangles of tests/test_kdtree.py's soup scene."""
    leaves = tdev.build_leaves(
        tapi.load_scene_string(_random_soup_scene(n_tris, seed) % ""))
    return leaves["tri_p0"], leaves["tri_e1"], leaves["tri_e2"]


@pytest.mark.parametrize("soup", ["soup120_s0", "soup120_s7", "soup40_s0",
                                  "uniform200_s5"])
def test_build_kdtree_bit_equal_to_jax(soup):
    if soup.startswith("uniform"):
        rng = np.random.default_rng(5)
        p0 = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        e1 = rng.uniform(-0.2, 0.2, (200, 3)).astype(np.float32)
        e2 = rng.uniform(-0.2, 0.2, (200, 3)).astype(np.float32)
    else:
        n, s = soup[4:].split("_s")
        p0, e1, e2 = _soup_triangles(int(n), int(s))
    want = jkd.build_kdtree(p0, e1, e2)
    got = tkd.build_kdtree(p0, e1, e2)
    for f in KD_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int((got.meta & 3 == 3).sum()) > 1


@pytest.fixture(scope="module")
def soup_scenes():
    text = _random_soup_scene() % 'Accelerator "kdtree"'
    js = jdev.build_device_scene(japi.load_scene_string(text), with_clusters=False)
    leaves = tdev.build_leaves(tapi.load_scene_string(text))
    return js, leaves


def test_kd_leaves_match_jax(soup_scenes):
    js, leaves = soup_scenes
    for f in ("tri_p0", "tri_e1", "tri_e2") + tuple(f"kd_{k}" for k in KD_FIELDS):
        want = np.asarray(getattr(js, f))
        np.testing.assert_array_equal(np.asarray(leaves[f], want.dtype), want,
                                      err_msg=f)


@pytest.mark.parametrize("any_hit", [False, True])
def test_intersect_kd_plain_matches_jax(soup_scenes, any_hit):
    js, _ = soup_scenes
    meta = np.asarray(js.kd_meta)
    assert (meta[meta & 3 == 3] >> 2).max() <= tkd.MAX_PRIMS
    ts = scene_from_numpy(jax_scene_leaves(js), "cpu")
    rng = np.random.default_rng(3 if not any_hit else 11)
    N = 4096
    o = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.where(np.arange(N) % 3 == 0, 6.0, 1e30).astype(np.float32)
    jh = jax.jit(lambda s, a, b, c: jkd.intersect_kd(s, a, b, c, any_hit=any_hit))(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    th = tkd.intersect_kd_plain(ts, tt(o), tt(d), tt(tmax), any_hit=any_hit)
    j, t = to_np(jh), to_np(th)
    assert 0.01 < t["valid"].mean() < 0.99
    np.testing.assert_array_equal(t["prim"], j["prim"])
    np.testing.assert_array_equal(t["valid"], j["valid"])
    # XLA on the CPU rounds the triangle test's products and sums its own
    # way (contracted multiply-adds): t and the barycentrics within an ulp
    # or two, where the port's kernel and plain version agree bit for bit
    np.testing.assert_allclose(t["t"], j["t"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["b1"], j["b1"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["b2"], j["b2"], rtol=0, atol=1e-5)


def test_kd_render_16_matches_golden():
    img, z, st = render_camera_golden("camera16_kdtree")
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert abs(st["rays"] - int(z["rays"])) <= max(4, 0.002 * int(z["rays"]))


def test_kdtree_accel_without_the_statement_renders_like_bvh():
    """JAX's render of this scene with accel="kdtree" is black: its kd
    leaves stay the placeholder when the file has no Accelerator line."""
    text = _random_soup_scene(n_tris=40) % ""
    sd = tapi.load_scene_string(text)
    sd.film.x_resolution = sd.film.y_resolution = 16
    assert sd.accelerator != "kdtree"
    img_k, _ = trender.render(sd, spp=2, accel="kdtree", device="cpu")
    img_b, _ = trender.render(sd, spp=2, accel="bvh", device="cpu")
    assert img_b.mean() > 1e-3
    ok, info = golden_criterion(img_k, img_b)
    assert ok, info
    # a scene built without its kd-tree refuses the accel rather than miss
    scene, cam = trender.build(sd, "cpu")
    o = tt(np.zeros((4, 3), np.float32))
    d = tt(np.tile(np.array([[0, 0, 1.0]], np.float32), (4, 1)))
    with pytest.raises(ValueError, match="without its kd-tree"):
        tis.intersect(scene, o, d, tt(np.full(4, 1e30, np.float32)),
                      accel="kdtree")
    # and render() refuses it prebuilt, as it refuses one without the
    # cluster pack for accel clusters (intersect would run K2 in K1's place)
    for accel in ("kdtree", "clusters"):
        with pytest.raises(ValueError, match="prebuilt scene has no"):
            trender.render(sd, spp=1, accel=accel, device="cpu",
                           prebuilt=(scene, cam))


def test_every_triangle_of_a_leaf_is_tested():
    """Nine triangles with one bounding box (no split plane separates
    them) make one leaf of 9; a ray down z meets the 9th first.  The
    port's walker finds it, as the BVH walker does; the JAX package's
    walker stops at the 8th."""
    k = np.arange(9, dtype=np.float32)
    p0 = np.tile(np.array([[-1.0, -1.0, 0.0]], np.float32), (9, 1))
    e1 = np.tile(np.array([[2.0, 0.0, 0.08]], np.float32), (9, 1))
    e2 = np.stack([np.zeros(9), np.full(9, 2.0), 0.08 - 0.01 * k], 1
                  ).astype(np.float32)
    kd = tkd.build_kdtree(p0, e1, e2)
    assert kd.meta.tolist() == [3 | 9 << 2]
    tris = np.zeros((9, 12), np.float32)
    tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = p0, e1, e2
    leaves = {f"kd_{f}": getattr(kd, f) for f in KD_FIELDS}
    leaves["tris_packed"] = tris
    o = np.array([[-0.5, -0.5, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    tm = np.array([1e30], np.float32)
    port = tkd.intersect_kd_plain(SimpleNamespace(**{k: tt(v) for k, v in leaves.items()}),
                                  tt(o), tt(d), tt(tm))
    ref = jkd.intersect_kd(SimpleNamespace(**{k: jnp.asarray(v) for k, v in leaves.items()}),
                           jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    assert int(port.prim[0]) == 8 and int(ref.prim[0]) == 7
