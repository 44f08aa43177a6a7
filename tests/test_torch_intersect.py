"""Traversal parity: the port's plain kernel versions against the JAX package.

- BVH: the port's vectorized walker (the plain version of the BVH kernel)
  against ``intersect_bvh`` on atrium primary rays (32^2) and on random
  rays leaving atrium hit points, closest-hit and any-hit.
- Clusters: the port's cluster traversal on CPU (the plain version of the
  cluster kernel) against ``intersect_clusters_fused`` in interpret mode
  on random soups (T=300, T=2000): closest-hit, any-hit, dead rays and
  forced overflow through each side's BVH walker.

Tolerance: prim ids equal on >= 99.9% of rays (the two libraries round
three-term sums differently, which can flip a ray that grazes a shared
edge); where they agree, t within 1e-5 relative (+1e-6 absolute for
short segments), and barycentrics within 1e-4 (or the hit points they
define within 1e-5 t, for ill-conditioned hits; see check_hits).
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_v3_iile_tpu.ops import bvh as bvhlib
from pbrt_v3_iile_tpu.ops import clusters_pallas as jcl
from pbrt_v3_iile_tpu.ops import intersect as jis
from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as tcl
from pbrt_v3_iile_tpu_torch.ops import intersect as tis
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from test_clusters import _random_soup
from torch_parity import ATRIUM, jax_scene_leaves, to_np, tt

PRIM_AGREE = 0.999
T_RTOL, T_ATOL, B_ATOL = 1e-5, 1e-6, 1e-4


def check_hits(jhit, thit, edges, any_hit=False, agree=PRIM_AGREE):
    j, t = to_np(jhit), to_np(thit)
    if any_hit:
        frac = (j["valid"] == t["valid"]).mean()
        assert frac >= agree, f"any-hit validity agreement {frac}"
        return
    same = j["prim"] == t["prim"]
    assert same.mean() >= agree, f"prim agreement {same.mean()}"
    both = same & (j["prim"] >= 0)
    dt = np.abs(t["t"] - j["t"])[both]
    assert (dt <= T_RTOL * np.abs(j["t"][both]) + T_ATOL).all(), dt.max()
    if edges is not None:
        # barycentrics within 1e-4, or, where a small triangle far from the
        # origin makes f32 Moller-Trumbore ill-conditioned (both sides then
        # sit ~1e-4 from the float64 value, on opposite sides), the hit
        # points they define within 1e-5 t
        e1, e2 = (np.asarray(e)[j["prim"][both]] for e in edges)
        db1 = np.abs(t["b1"] - j["b1"])[both]
        db2 = np.abs(t["b2"] - j["b2"])[both]
        dp = (db1 * np.linalg.norm(e1, axis=1) + db2 * np.linalg.norm(e2, axis=1))
        ok = ((db1 <= B_ATOL) & (db2 <= B_ATOL)) | (dp <= 1e-5 * j["t"][both])
        assert ok.all(), (db1.max(), db2.max(), dp.max())


@pytest.fixture(scope="module")
def atrium():
    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 32
    js = jdev.build_device_scene(sd, with_clusters=False)
    ts = scene_from_numpy(jax_scene_leaves(js), "cpu")
    cam = tcam.make_camera(sd.camera, sd.film, "cpu")
    yy, xx = np.mgrid[0:32, 0:32]
    pf = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32) + 0.5
    o, d = tcam.generate_rays(cam, tt(pf))
    return js, ts, o.numpy(), d.numpy()


def _both_walkers(js, ts, o, d, tmax, any_hit):
    jf = jax.jit(partial(jis.intersect_bvh, any_hit=any_hit))
    jh = jf(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    th = tis.intersect_bvh(ts, tt(o), tt(d), tt(tmax), any_hit=any_hit)
    return jh, th


def test_walker_matches_jax_on_atrium_primary(atrium):
    js, ts, o, d = atrium
    tmax = np.full(o.shape[0], 1e30, np.float32)
    jh, th = _both_walkers(js, ts, o, d, tmax, False)
    assert to_np(th)["valid"].mean() > 0.9
    check_hits(jh, th, (js.tri_e1, js.tri_e2))


@pytest.mark.parametrize("any_hit", [False, True])
def test_walker_matches_jax_on_atrium_random_rays(atrium, any_hit):
    js, ts, o, d = atrium
    tmax = np.full(o.shape[0], 1e30, np.float32)
    h = to_np(tis.intersect_bvh(ts, tt(o), tt(d), tt(tmax)))
    rng = np.random.default_rng(5)
    keep = h["valid"]
    p = o[keep] + h["t"][keep, None] * d[keep]
    ng = np.asarray(js.tri_ng)[h["prim"][keep]]
    dirs = rng.normal(size=p.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    side = np.sign(np.sum(dirs * ng, 1, keepdims=True))
    o2 = (p + side * 1e-4 * np.maximum(1, np.abs(p).max(1, keepdims=True)) * ng
          ).astype(np.float32)
    t2 = np.where(np.arange(len(o2)) % 3 == 0, 0.5, 1e30).astype(np.float32)
    jh, th = _both_walkers(js, ts, o2, dirs, t2, any_hit)
    check_hits(jh, th, (js.tri_e1, js.tri_e2), any_hit=any_hit)


def _soup(T, seed):
    rng = np.random.default_rng(seed)
    p0, e1, e2 = _random_soup(rng, T)
    tri = np.stack([p0, p0 + e1, p0 + e2], axis=1)
    flat = bvhlib.build_bvh(tri, use_native=False)
    op0, oe1, oe2 = (x[flat.prim_order] for x in (p0, e1, e2))
    nodes = np.zeros((flat.node_min.shape[0], 8), np.int32)
    nodes[:, 0:3] = flat.node_min.astype(np.float32).view(np.int32)
    nodes[:, 3:6] = flat.node_max.astype(np.float32).view(np.int32)
    nodes[:, 6] = flat.node_right
    nodes[:, 7] = (flat.node_count << 2) | flat.node_axis
    tris = np.zeros((T, 12), np.float32)
    tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = op0, oe1, oe2
    jcp = jcl.build_cluster_pack(flat, op0, oe1, oe2)
    tcp = tcl.build_cluster_pack_np(flat, op0, oe1, oe2)
    for k, v in tcp.items():  # the port's pack is the reference's pack
        np.testing.assert_array_equal(v, np.asarray(getattr(jcp, k)), err_msg=k)
    port_cp = SimpleNamespace(**{k: tt(v) for k, v in tcp.items()})
    jscene = SimpleNamespace(nodes_packed=jnp.asarray(nodes),
                             tris_packed=jnp.asarray(tris))
    tscene = SimpleNamespace(nodes_packed=tt(nodes), tris_packed=tt(tris))
    return rng, jcp, port_cp, (op0, oe1, oe2), jscene, tscene


def _rays(rng, N):
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("T,N", [(300, 640), (2000, 1280)])
def test_cluster_traversal_matches_jax_interpret(T, N):
    rng, jcp, tcp, tris, _, _ = _soup(T, T + N)
    o, d = _rays(rng, N)
    tmax = np.full(N, 1e30, np.float32)
    jt = [jnp.asarray(x) for x in tris]
    jh = jcl.intersect_clusters_fused(
        jcp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), group=64,
        max_candidates=64, interpret=True, tri_p0=jt[0], tri_e1=jt[1],
        tri_e2=jt[2])
    th = tcl.intersect_clusters_fused(
        tcp, tt(o), tt(d), tt(tmax), max_candidates=64,
        tri_p0=tt(tris[0]), tri_e1=tt(tris[1]), tri_e2=tt(tris[2]))
    assert to_np(th)["valid"].mean() > 0.1
    check_hits(jh, th, tris[1:])


def test_cluster_dead_rays_and_anyhit_match_jax():
    rng, jcp, tcp, _, _, _ = _soup(400, 11)
    o, d = _rays(rng, 512)
    tmax = np.where(np.arange(512) % 2 == 0, 1e30, -1.0).astype(np.float32)
    for any_hit in (False, True):
        jh = jcl.intersect_clusters_fused(
            jcp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), group=64,
            max_candidates=64, any_hit=any_hit, interpret=True)
        th = tcl.intersect_clusters_fused(tcp, tt(o), tt(d), tt(tmax),
                                          max_candidates=64,
                                          any_hit=any_hit)
        assert not to_np(th)["valid"][tmax < 0].any(), "dead rays must miss"
        check_hits(jh, th, None, any_hit=any_hit)


def test_cluster_overflow_goes_to_the_walker_like_jax():
    rng, jcp, tcp, tris, jscene, tscene = _soup(1500, 9)
    o, d = _rays(rng, 256)
    tmax = np.full(256, 1e30, np.float32)
    jt = [jnp.asarray(x) for x in tris]
    jh = jcl.intersect_clusters_fused(
        jcp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), group=64,
        max_candidates=4, interpret=True, tri_p0=jt[0], tri_e1=jt[1],
        tri_e2=jt[2],
        fallback=lambda a, b, c: jis.intersect_bvh(jscene, a, b, c))
    th = tcl.intersect_clusters_fused(
        tcp, tt(o), tt(d), tt(tmax), max_candidates=4,
        tri_p0=tt(tris[0]), tri_e1=tt(tris[1]), tri_e2=tt(tris[2]),
        fallback=lambda a, b, c: tis.intersect_bvh(tscene, a, b, c))
    check_hits(jh, th, tris[1:])


def test_plain_kernel_step_matches_brute_force_order():
    """The plain K1 step alone: candidate tables built by the port, the
    dense evaluation against a float64 brute force over the soup."""
    from test_clusters import _brute_force

    rng, _, tcp, tris, _, _ = _soup(300, 4)
    o, d = _rays(rng, 256)
    tmax = np.full(256, 1e30, np.float32)
    h = to_np(tcl.intersect_clusters_fused(tcp, tt(o), tt(d), tt(tmax)))
    t_ref, prim_ref = _brute_force(*tris, o, d, tmax)
    assert np.isclose(h["t"], t_ref, rtol=2e-3, atol=1e-4).mean() > 0.995
    assert ((h["prim"] >= 0) == (prim_ref >= 0)).mean() > 0.995
