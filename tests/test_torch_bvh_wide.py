"""The BVH kernel's 4-wide BVH and its plain version, on the CPU.

- The collapse of atrium's binary BVH (``build_bvh4_np``): every triangle
  is reached exactly once, through the binary leaves' own ranges; every
  child box is bit-equal to its binary node's box; the breadth-first
  numbering; the stack bound, within the kernel's limit and above the
  deepest stack a traversal reaches; the host's layout constants are the
  kernel source's.
- ``bvh_traverse_wide_plain`` (the kernel's own order) against the JAX
  package's binary walker ``pbrt_v3_iile_tpu/ops/intersect.py::
  intersect_bvh`` on random triangle soups (T=300, T=2000) and on atrium
  primary and bounce rays (16^2 film), with tests/test_torch_intersect.py's
  tolerances (the same prim on >= 99.9% of rays, t within 1e-5 relative
  + 1e-6 absolute and barycentrics within 1e-4 where they agree; any-hit
  validity on >= 99.9%); and against the port's own binary walker, which
  rounds as the wide version does: the same prim on >= 99.9% of rays, t
  and barycentrics bit-equal where they agree, the smaller prim id where
  they differ at an equal t.  (The binary walker keeps the first of two
  triangles at an exactly equal t, the wide order the smaller prim id,
  and a t that rounds below its box's tnear can be culled in one order and
  not the other.)
- Binary leaves of more than 4 triangles (6 and 10, which the builders
  make at coincident centroids): the collapse keeps the first 4 of each,
  as the walker tests them, and matches the JAX walker as above.
- On the soups, against the JAX package's K2 itself,
  ``intersect_bvh_pallas(..., interpret=True)``, with
  tests/test_intersect.py's criterion: hit/miss on every ray, and t
  within 1e-5 relative + 1e-4 absolute where both hit.
"""

import os
import re
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.ops import bvh as jbvh
from pbrt_v3_iile_tpu.ops import intersect as jis
from pbrt_v3_iile_tpu.ops import intersect_pallas as jipl
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
from pbrt_v3_iile_tpu_torch.ops import intersect as tis
from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as apilib
from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

from test_clusters import _random_soup
from test_torch_intersect import check_hits
from torch_parity import (ATRIUM, REPO, coincident_soup, pack_bvh,
                          rays_at, to_np, tt)

PRIM_AGREE = 0.999
SOUP_NODES, SOUP_TRIS = 4096, 2000  # the soups' arrays, padded


def _padded(p0, e1, e2):
    """The JAX package's numpy BVH of the triangles, packed, with rows no
    traversal reaches, so that every soup has the same shapes and the JAX
    walker compiles once for all of them."""
    flat = jbvh.build_bvh(np.stack([p0, p0 + e1, p0 + e2], axis=1),
                          use_native=False)
    order = flat.prim_order
    nodes, tris = pack_bvh(flat.node_min, flat.node_max, flat.node_right,
                           flat.node_count, flat.node_axis, p0[order],
                           e1[order], e2[order])
    pad = lambda x, rows: np.concatenate(
        [x, np.zeros((rows - x.shape[0], x.shape[1]), x.dtype)])
    return pad(nodes, SOUP_NODES), pad(tris, SOUP_TRIS)


def _soup(T, seed):
    rng = np.random.default_rng(seed)
    return (rng, *_padded(*_random_soup(rng, T)))


def _rays(rng, N):
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(N) % 5 == 0, 0.7, 1e30).astype(np.float32)
    tmax[7::61] = -1.0  # dead rays
    return o, d, tmax


@pytest.fixture(scope="module")
def atrium():
    """The port's atrium scene (16^2 film), its 4-wide BVH, and primary and
    bounce rays as numpy."""
    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 16
    scene, cam = renderlib.build(sd, "cpu", with_clusters=False)
    o, d, *_ = renderlib.make_wave_prep(sd, "cpu")(cam, threefry.prng_key(2), 0, 0)
    big = torch.full_like(o[:, 0], 1e30)
    hit = tis.intersect_bvh(scene, o, d, big)
    it = tis.make_interaction(scene, o, d, hit)
    ng = vm.face_forward(it.ng, -d)
    rng = np.random.default_rng(8)
    db = vm.normalize(torch.as_tensor(rng.normal(size=tuple(o.shape)),
                                      dtype=torch.float32))
    db = torch.where((vm.dot(db, ng) < 0)[:, None], -db, db)
    ob = vm.offset_ray_origin(it.p, ng, db)
    tb = torch.where(hit.valid, 1e30, -1.0)
    waves = {"primary": (o, d, big), "bounce": (ob, db, tb)}
    return scene, {k: tuple(x.numpy() for x in v) for k, v in waves.items()}


def _walk_leaves(wide, w, out):
    """Binary leaves (their (first, count)) under wide node w, in order."""
    for c in wide[w, 6 * k2.WIDTH:7 * k2.WIDTH]:
        if c >= 0:
            _walk_leaves(wide, c, out)
        elif c != -1:
            out.append((int(~c) >> 3, int(~c) & 7))
    return out


def test_collapse_of_atrium(atrium):
    scene, _ = atrium
    nodes = scene.nodes_packed.numpy()
    wide, depth = k2.build_bvh4_np(nodes)
    np.testing.assert_array_equal(wide, scene.bvh4_nodes.numpy())
    assert depth == scene.bvh4_stack
    T = scene.tris_packed.shape[0]
    # every triangle once, through the binary leaves' own ranges
    leaves = _walk_leaves(wide, 0, [])
    cover = np.zeros(T, np.int64)
    for first, cnt in leaves:
        assert 1 <= cnt <= 4
        cover[first:first + cnt] += 1
    assert (cover == 1).all()
    bin_leaves = {(int(r[6]), int(r[7] >> 2)) for r in nodes if r[7] >> 2 > 0}
    assert set(leaves) == bin_leaves and len(leaves) == len(bin_leaves)
    # each used slot: its box is its binary node's box, bit for bit; a leaf
    # slot carries that node's range, an inner slot a later wide node
    W = k2.WIDTH
    src = wide[:, 7 * W:8 * W]
    used = src >= 0
    assert used.any(1).all()
    for a in range(6):
        np.testing.assert_array_equal(wide[:, W * a:W * (a + 1)][used],
                                      nodes[src[used], a])
    child = wide[:, 6 * W:7 * W]
    is_leaf = nodes[np.maximum(src, 0), 7] >> 2 > 0
    np.testing.assert_array_equal(
        child[used & is_leaf],
        ~((nodes[src[used & is_leaf], 6] << 3) | (nodes[src[used & is_leaf], 7] >> 2)))
    rows = np.nonzero(used & ~is_leaf)
    assert (child[rows] > rows[0]).all()          # breadth first
    assert len(set(child[rows].tolist())) == wide.shape[0] - 1
    assert (child[~used] == -1).all()
    # the stack bound, within the kernel's limit (the atrium traversals
    # below check that they stay under it)
    assert 0 < depth <= k2.STACK_MAX


def test_kernel_constants_match_the_host():
    """The node width that the host lays out is the kernel source's
    kWidth."""
    with open(os.path.join(REPO, "pbrt_v3_iile_tpu_torch", "csrc",
                           "bvh_traverse.cu")) as f:
        const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", f.read()))
    assert int(const["kWidth"]) == k2.WIDTH
    assert k2.NODE_INTS == 8 * k2.WIDTH


def test_collapse_of_a_single_leaf():
    """A binary root that is a leaf: one wide node with that one leaf."""
    nodes, tris = pack_bvh(np.zeros((1, 3)), np.ones((1, 3)), [0], np.array([2]),
                          np.array([0]), np.zeros((2, 3), np.float32),
                          np.eye(3, dtype=np.float32)[:2],
                          np.eye(3, dtype=np.float32)[1:])
    wide, depth = k2.build_bvh4_np(nodes)
    W = k2.WIDTH
    assert wide.shape == (1, 8 * W) and depth == 0
    assert list(wide[0, 6 * W:7 * W]) == [~((0 << 3) | 2)] + [-1] * (W - 1)
    o = torch.tensor([[0.2, 0.2, -1.0], [0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, prim, _, _ = k2.bvh_traverse_wide_plain(
        torch.from_numpy(wide), torch.from_numpy(tris), o, d,
        torch.full((2,), 1e30))
    assert prim.tolist() == [0, -1] and t[0].item() == 1.0


class _Bvh(NamedTuple):
    """What the JAX walker reads of a scene (a pytree, so jit traces it)."""
    nodes_packed: jnp.ndarray
    tris_packed: jnp.ndarray


_jax_intersect = jax.jit(jis.intersect_bvh, static_argnames=("any_hit",))


def _jax_walker(nodes, tris, o, d, tmax, any_hit):
    return to_np(_jax_intersect(_Bvh(jnp.asarray(nodes), jnp.asarray(tris)),
                                jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax), any_hit=any_hit))


def _check_against_walker(nodes, tris, wide, o, d, tmax, depth):
    """The wide plain version against the JAX package's walker (its
    parity tolerance: XLA rounds some products and sums otherwise, see
    tests/test_torch_intersect.py) and against the port's binary walker,
    which rounds as the wide plain version does (t and barycentrics
    bit-equal where the prims agree); its stack stays within the
    collapse's bound ``depth``."""
    tscene = SimpleNamespace(nodes_packed=tt(nodes), tris_packed=tt(tris))
    for any_hit in (False, True):
        work = {}
        t, prim, b1, b2 = (x.numpy() for x in k2.bvh_traverse_wide_plain(
            torch.from_numpy(wide), tt(tris), tt(o), tt(d), tt(tmax),
            any_hit=any_hit, work=work))
        assert work["stack"] <= depth
        assert not (prim[tmax <= 0] >= 0).any(), "dead rays must miss"
        mine = dict(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
        check_hits(_jax_walker(nodes, tris, o, d, tmax, any_hit), mine,
                   (tris[:, 3:6], tris[:, 6:9]), any_hit=any_hit)
        w = to_np(tis.intersect_bvh(tscene, tt(o), tt(d), tt(tmax),
                                    any_hit=any_hit))
        if any_hit:
            assert ((prim >= 0) == w["valid"]).mean() >= PRIM_AGREE
            continue
        same = prim == w["prim"]
        assert same.mean() >= PRIM_AGREE, same.mean()
        for a, b in ((t, w["t"]), (b1, w["b1"]), (b2, w["b2"])):
            np.testing.assert_array_equal(a[same], b[same])
        # where they differ at an equal t, the smaller prim id won
        tie = ~same & (t == w["t"])
        assert (prim[tie] < w["prim"][tie]).all()


@pytest.mark.parametrize("T,N", [(300, 640), (2000, 640)])
def test_wide_plain_matches_jax_walker_on_soup(T, N):
    rng, nodes, tris = _soup(T, T + N)
    wide, depth = k2.build_bvh4_np(nodes)
    o, d, tmax = _rays(rng, N)
    _check_against_walker(nodes, tris, wide, o, d, tmax, depth)


def test_wide_plain_matches_jax_walker_on_coincident_leaves():
    """Binary leaves of 6 and 10 triangles (coincident centroids): the
    collapse keeps each one's first MAX_LEAF, the ones the walker tests."""
    rng = np.random.default_rng(11)
    p0, e1, e2, centres = coincident_soup(rng, 300, (6, 10))
    nodes, tris = _padded(p0, e1, e2)
    counts = (nodes[:, 7] >> 2).tolist()
    assert 6 in counts and 10 in counts
    wide, depth = k2.build_bvh4_np(nodes)
    leaves = _walk_leaves(wide, 0, [])
    assert max(c for _, c in leaves) == tis.MAX_LEAF
    o, d, tmax = rays_at(rng, centres, 640)
    _check_against_walker(nodes, tris, wide, o, d, tmax, depth)


@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_wide_plain_matches_jax_walker_on_atrium(atrium, wave):
    scene, waves = atrium
    o, d, tmax = waves[wave]
    _check_against_walker(scene.nodes_packed.numpy(), scene.tris_packed.numpy(),
                          scene.bvh4_nodes.numpy(), o, d, tmax,
                          scene.bvh4_stack)


@pytest.mark.parametrize("T,N", [(300, 1024), (2000, 1024)])
def test_wide_plain_matches_jax_pallas_kernel(T, N):
    rng = np.random.default_rng(7 * T + N)
    p0, e1, e2 = _random_soup(rng, T)
    sd = japi.SceneDesc()
    sd.add_triangles(np.stack([p0, p0 + e1, p0 + e2], axis=1), None, None, 0)
    js = jdev.build_device_scene(sd)
    tris = np.asarray(js.tris_packed)
    wide, _ = k2.build_bvh4_np(np.asarray(js.nodes_packed))
    o, d, _ = _rays(rng, N)
    tmax = np.full(N, 1e30, np.float32)
    got = to_np(jipl.intersect_bvh_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(tmax), interpret=True))
    t, prim, _, _ = (x.numpy() for x in k2.bvh_traverse_wide_plain(
        torch.from_numpy(wide), tt(tris), tt(o), tt(d), tt(tmax)))
    assert (prim >= 0).mean() > 0.1
    assert ((prim >= 0) == (got["prim"] >= 0)).all()
    both = (prim >= 0) & got["valid"]
    assert np.allclose(t[both], got["t"][both], atol=1e-4, rtol=1e-5)
