"""The BVH kernel's motion tables (``build_motion_split_np``) and their
plain version (``bvh_traverse_motion_plain``), on the CPU.

- every moving triangle's lerped vertices, lerped as the kernel lerps
  (a + tl (b - a) per float, each operation rounded in float32) at
  tl in {0, 0.5, 1, the largest float below 1} in each keyframe segment,
  lie inside the box of its leaf slot in that segment's BVH (the padded
  segment box of ``_segment_boxes``, copied into the wide nodes);
- the plain version equals the keyframe-lerping binary walker over the
  union BVH (``ops/intersect.py::intersect_bvh`` with time, the CPU path
  and the reference's semantics) on a moving-triangle soup and on a small
  wave of ``scenes/atrium_motion.pbrt``: t, prim, b1 and b2 identical on
  closest hit, and whether a ray hits on any-hit (the two any-hit walks
  may return different hits);
- ``tests/torch_parity.py::jax_scene_leaves`` builds the same motion
  tables from a JAX-built motion scene as the port's own build.

The atrium_motion wave walks tables built from its sub-keyframes over a
union BVH of the native builder (the device scene builds that BVH with
the numpy builder, to follow the reference's prim order, in ~16 s): the
two walks are held to each other, not to the JAX package's order.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.ops import bvh as bvhlib
from pbrt_v3_iile_tpu_torch.ops import intersect as tis
from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import device as tdev

from torch_parity import ATRIUM, jax_scene_leaves, motion_soup, pack_steps

ATRIUM_MOTION = ATRIUM.replace("atrium.pbrt", "atrium_motion.pbrt")
TLS = (0.0, 0.5, 1.0, float(np.nextafter(np.float32(1), np.float32(0))))


def _tables(steps, nodes_packed):
    """What the walker and the plain version read: the union BVH and the
    sub-keyframes, and the motion tables split from them."""
    return SimpleNamespace(
        nodes_packed=torch.as_tensor(nodes_packed),
        tris_packed=torch.as_tensor(np.ascontiguousarray(steps[0])),
        tris_steps_packed=torch.as_tensor(steps),
        **vars(K2.motion_split(K2.build_motion_split_np(steps, nodes_packed),
                               "cpu")))


@pytest.fixture(scope="module")
def soup():
    steps, nodes = motion_soup(np.random.default_rng(4))
    return _tables(steps, nodes)


@pytest.fixture(scope="module")
def atrium_motion():
    """atrium_motion's sub-keyframes, its union BVH (native builder, over
    each triangle's box of all sub-keyframes), the tables, and a 24^2
    wave: primary rays with their shutter times and a bounce from each
    hit in a random direction."""
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import threefry

    sd = tapi.load_scene(ATRIUM_MOTION)
    sd.film.x_resolution = sd.film.y_resolution = 24
    p_steps, _ = tdev._motion_stacks(sd, tdev._motion_steps(sd))
    lo, hi = p_steps.min(axis=(0, 2)), p_steps.max(axis=(0, 2))
    flat = bvhlib.build_bvh(np.stack([lo, hi, hi], axis=1))
    tab = _tables(pack_steps(p_steps[:, flat.prim_order]),
                  K2.pack_nodes_np(flat))
    cam = camlib.make_camera(sd.camera, sd.film, "cpu")
    o, d, _, _, _, _, time = renderlib.make_wave_prep(sd, "cpu")(
        cam, threefry.prng_key(2), 0, 0)
    big = torch.full_like(time, 1e30)
    hit = tis.intersect_bvh(tab, o, d, big, time=time)
    rng = np.random.default_rng(6)
    db = torch.as_tensor(rng.normal(size=tuple(d.shape)), dtype=torch.float32)
    db = db / db.norm(dim=1, keepdim=True)
    ob = o + (hit.t * 0.999)[:, None] * d
    return tab, time, {"primary": (o, d, big),
                       "bounce": (ob, db, torch.where(hit.valid, 1e30, -1.0))}


def _leaf_boxes(tab, s):
    """Per moving triangle (its index in segment s's part of the moving
    table), the (lo, hi) of the leaf slot that holds it in segment s's
    wide BVH."""
    nodes = tab.mot_nodes.numpy()
    W = K2.WIDTH
    roots = tab.mot_roots.numpy().tolist() + [nodes.shape[0]]
    rows = nodes[roots[s]:roots[s + 1]]
    kid = rows[:, 6 * W:7 * W]
    box = rows[:, 0:6 * W].view(np.float32).reshape(-1, 6, W)
    V = tab.mot_moving_tris.shape[1]
    lo = np.full((V, 3), np.nan, np.float32)
    hi = np.full((V, 3), np.nan, np.float32)
    for w, k in zip(*np.nonzero(kid < -1)):
        code = ~int(kid[w, k])
        for j in range(code & 7):
            lo[(code >> 3) + j] = box[w, 0:3, k]
            hi[(code >> 3) + j] = box[w, 3:6, k]
    assert not np.isnan(lo).any()
    return lo, hi


@pytest.mark.parametrize("which", ["soup", "atrium_motion"])
def test_lerped_triangles_lie_in_their_segment_boxes(which, request):
    tab = request.getfixturevalue(which)
    if which == "atrium_motion":
        tab = tab[0]
    moving = tab.mot_moving_tris
    M = moving.shape[0] + 1
    assert M >= 4 and moving.shape[1] > 0
    for s in range(M - 1):
        lo, hi = _leaf_boxes(tab, s)
        a, b = moving[s, :, 0:9], moving[s, :, 12:21]
        for tl in TLS:
            x = (a + torch.tensor(tl, dtype=torch.float32) * (b - a)).double()
            p0 = x[:, 0:3]
            for v in (p0, p0 + x[:, 3:6], p0 + x[:, 6:9]):
                v = v.numpy()
                assert (v >= lo).all() and (v <= hi).all(), (which, s, tl)


def _times(rng, n):
    time = rng.uniform(0, 1, n).astype(np.float32)
    time[:4] = [0.0, 1.0, 0.5, TLS[3]]
    return torch.as_tensor(time)


def _plain_vs_walker(tab, o, d, tm, time, any_hit):
    got = K2.bvh_traverse_motion_plain(tab, o, d, tm, time, any_hit=any_hit)
    want = tis.intersect_bvh(tab, o, d, tm, any_hit=any_hit, time=time)
    assert 0.05 < float((got[1] >= 0).float().mean()) < 1.0
    if any_hit:
        assert torch.equal(got[1] >= 0, want.valid)
    else:
        for a, b in zip(got, (want.t, want.prim, want.b1, want.b2)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_plain_matches_walker_on_soup(soup, any_hit):
    rng = np.random.default_rng(9 + any_hit)
    N = 2048
    o = torch.as_tensor(rng.uniform(-4, 4, (N, 3)), dtype=torch.float32)
    d = rng.normal(size=(N, 3))
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=torch.float32)
    tm = torch.as_tensor(np.where(np.arange(N) % 3 == 0, 6.0, 1e30),
                         dtype=torch.float32)
    _plain_vs_walker(soup, o, d, tm, _times(rng, N), any_hit)


@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_plain_matches_walker_on_atrium_motion(atrium_motion, wave,
                                                      any_hit):
    tab, time, waves = atrium_motion
    _plain_vs_walker(tab, *waves[wave], time, any_hit)


def _soup_rays(rng, N):
    o = torch.as_tensor(rng.uniform(-4, 4, (N, 3)), dtype=torch.float32)
    d = rng.normal(size=(N, 3))
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=torch.float32)
    return o, d, torch.full((N,), 1e30)


def test_motion_plain_counts_its_work(soup):
    """The plain version's work: on the soup some but not all tests are
    of moving (lerped) triangles; on the soup's first keyframe given
    twice, nothing moves, so its walk is the static plain version's on
    the scene's own collapsed BVH, test for test, and visit for visit
    but for one visit a ray of the segment's empty moving BVH."""
    rng = np.random.default_rng(13)
    o, d, tm = _soup_rays(rng, 1024)
    work = {}
    K2.bvh_traverse_motion_plain(soup, o, d, tm, _times(rng, 1024), work=work)
    assert 0 < work["moving_tris"] < work["tris"]
    steps = soup.tris_steps_packed.numpy()
    nodes = soup.nodes_packed.numpy()
    two = K2.motion_split(K2.build_motion_split_np(steps[[0, 0]], nodes), "cpu")
    got, want = {}, {}
    a = K2.bvh_traverse_motion_plain(two, o, d, tm, _times(rng, 1024),
                                     work=got)
    b = K2.bvh_traverse_wide_plain(torch.as_tensor(K2.build_bvh4_np(nodes)[0]),
                                   torch.as_tensor(steps[0]), o, d, tm,
                                   work=want)
    assert got.pop("moving_tris") == 0
    got["nodes"] -= 1024
    assert got == want
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_static_scene_tables_are_refused(soup):
    """A scene with fewer than 2 keyframes gets placeholder tables with
    no segment: the plain version and the launch refuse them (the launch
    before it looks at the device)."""
    steps = soup.tris_steps_packed.numpy()[:1]
    one = K2.motion_split(K2.build_motion_split_np(
        steps, soup.nodes_packed.numpy()), "cpu")
    assert one.mot_roots.shape == (0,)
    o, d, tm = _soup_rays(np.random.default_rng(14), 8)
    time = torch.zeros(8)
    for fn in (K2.bvh_traverse_motion_plain, K2.bvh_traverse_motion_cuda):
        with pytest.raises(ValueError, match="at least 2 keyframes"):
            fn(one, o, d, tm, time)


def test_jax_scene_leaves_build_the_same_motion_tables():
    """A JAX-built motion scene (a soup whose second half turns and moves
    over the shutter): the motion tables that jax_scene_leaves derives
    from it equal the port's build, bit for bit."""
    rng = np.random.default_rng(12)
    c = rng.uniform(-2, 2, (240, 1, 3))
    v = (c + rng.uniform(-0.4, 0.4, (240, 3, 3))).reshape(2, -1)

    def shape(p):
        idx = " ".join(str(i) for i in range(p.size // 3))
        pts = " ".join(f"{x:.6g}" for x in p)
        return f'Shape "trianglemesh" "point P" [{pts}] "integer indices" [{idx}]'

    text = f"""TransformTimes 0 1
LookAt 0 0 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Material "matte" "rgb Kd" [0.6 0.5 0.4]
{shape(v[0])}
AttributeBegin
ActiveTransform EndTime
Rotate 40 0 1 0
Translate 0.3 0 0
ActiveTransform All
{shape(v[1])}
AttributeEnd
WorldEnd
"""
    js = jdev.build_device_scene(japi.load_scene_string(text),
                                 with_clusters=False)
    got = jax_scene_leaves(js)
    want = tdev.build_leaves(tapi.load_scene_string(text))
    assert got["tris_steps_packed"].shape[0] >= 3
    assert want["mot_moving_tris"].shape[1] == 120
    for k in ("mot_nodes", "mot_roots", "mot_static_tris", "mot_moving_tris",
              "mot_stack"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                      else a, b.view(np.int32)
                                      if b.dtype == np.float32 else b, err_msg=k)
