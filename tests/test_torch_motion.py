"""Object and camera motion blur, port vs JAX.

- the motion leaves of the device scene (``tris_steps_packed``,
  ``tri_ng_steps``, ``tri_ns_steps``), the BVH over the union of the
  sub-keyframes and the prim order, on tests/test_motion_blur.py's
  rotating blade (7 sub-keyframes) and its translating quad, against the
  JAX package's build: ints exact, floats within 1e-6 relative;
- ``intersect(..., time=...)`` (the BVH walker's keyframe lerp, the plain
  version of the BVH kernel's motion variant) and
  ``make_interaction(..., time=...)`` on the blade against JAX at seeded
  rays and times: hits and prims equal, t within 1e-6 relative, the
  barycentrics and normals within 1e-6, the points within 1e-6 of t;
- camera motion: ``generate_rays(..., time=shutter_time(...))`` on
  tests/test_motion_blur.py's translating camera and on a turning one,
  within 1e-6 of JAX's ``generate_rays(..., u_time=...)`` at the same
  shutter samples;
- the time of each ray rides the compacted loop's sort with it;
- the 16^2 atrium_motion render (the camera moves and turns, the seat
  turns 90 degrees, the bowl moves) and its compacted pass loop at 48x32
  against the JAX package's (tests/golden/camera16_motion*.npz, made by
  tools/make_camera_golden.py) by tests/test_golden.py's criterion, the
  traced ray counts within max(4, 0.2%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.ops import camera as jcam
from pbrt_v3_iile_tpu.ops import intersect as jis
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.integrators import path as tpath
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import intersect as tis
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import device as tdev
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from torch_parity import (assert_close, camera_golden, golden_criterion,
                          jax_scene_leaves, render_camera_golden, to_np, tt)

# tests/test_motion_blur.py's scenes: the rotating blade, the quad that
# translates under a static camera, and the translating camera
BLADE = """
TransformTimes 0 1
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
  "float shutteropen" [0] "float shutterclose" [1]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "point" "rgb I" [10 10 10]
Material "matte" "rgb Kd" [0.5 0.5 0.5]
AttributeBegin
  ActiveTransform EndTime
  Rotate 90 0 1 0
  ActiveTransform All
  Shape "trianglemesh" "point P" [0.2 -0.05 0  2.0 -0.05 0  2.0 0.05 0  0.2 0.05 0]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
Shape "trianglemesh" "point P" [-3 -1 2  3 -1 2  3 1 2  -3 1 2]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""
QUAD = """
TransformTimes 0 1
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
  "float shutteropen" [0] "float shutterclose" [1]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [5 5 5]
  Material "matte" "color Kd" [0 0 0]
  ActiveTransform EndTime
  Translate 1.5 0 0
  ActiveTransform All
  Shape "trianglemesh" "point P" [-0.3 -2 0 0.3 -2 0 0.3 2 0 -0.3 2 0]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
WorldEnd
"""
CAMERA = """
TransformTimes 0 1
LookAt 0 0 -5  0 0 0  0 1 0
ActiveTransform EndTime
ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  -3 0 0 1]
%s
ActiveTransform All
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
WorldEnd
"""
MOTION_LEAVES = ("tris_steps_packed", "tri_ng_steps", "tri_ns_steps",
                 "tri_p0", "tri_e1", "tri_e2", "tri_ng", "tri_ns",
                 "nodes_packed", "tri_mat", "tri_light")


@pytest.mark.parametrize("text,steps", [(BLADE, 7), (QUAD, 2)],
                         ids=["blade", "quad"])
def test_motion_leaves_match_jax(text, steps):
    js = jdev.build_device_scene(japi.load_scene_string(text),
                                 with_clusters=False)
    leaves = tdev.build_leaves(tapi.load_scene_string(text))
    assert leaves["tris_steps_packed"].shape[0] == steps
    for name in MOTION_LEAVES:
        want = np.asarray(getattr(js, name))
        got = np.asarray(leaves[name])
        assert got.shape == want.shape, name
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert_close(got, want, rtol=1e-6, atol=0.0, name=name)


@pytest.fixture(scope="module")
def blade():
    js = jdev.build_device_scene(japi.load_scene_string(BLADE),
                                 with_clusters=False)
    return js, scene_from_numpy(jax_scene_leaves(js), "cpu")


def test_intersect_and_interaction_with_time_match_jax(blade):
    js, ts = blade
    rng = np.random.default_rng(4)
    N = 4096
    # rays from the camera side aimed at the blade's swept disc
    aim = np.stack([rng.uniform(-2.1, 2.1, N), rng.uniform(-0.08, 0.08, N),
                    rng.uniform(-2.1, 2.1, N)], -1)
    o = np.stack([rng.uniform(-0.5, 0.5, N), rng.uniform(-0.3, 0.3, N),
                  np.full(N, -5.0)], -1)
    d = aim - o
    o, d = o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)
                                  ).astype(np.float32)
    tmax = np.where(np.arange(N) % 4 == 0, 4.0, 1e30).astype(np.float32)
    time = rng.uniform(0, 1, N).astype(np.float32)
    time[:8] = [0, 1, 0.5, 1 / 6, 2 / 6, 5 / 6, 1 - 1e-7, 1e-7]

    def jax_fn(s, o_, d_, tm_, time_):
        h = jis.intersect(s, o_, d_, tm_, time=time_)
        return h, jis.make_interaction(s, o_, d_, h, time=time_)

    jh, jit_ = to_np(jax.jit(jax_fn)(js, *(jnp.asarray(x)
                                           for x in (o, d, tmax, time))))
    th = tis.intersect(ts, tt(o), tt(d), tt(tmax), time=tt(time))
    tit = to_np(tis.make_interaction(ts, tt(o), tt(d), th, time=tt(time)))
    th = to_np(th)
    assert 0.05 < th["valid"].mean() < 0.95
    np.testing.assert_array_equal(th["valid"], jh["valid"])
    np.testing.assert_array_equal(th["prim"], jh["prim"])
    v = th["valid"]
    assert_close(th["t"], jh["t"], rtol=1e-6, atol=0.0, name="t")
    for k in ("b1", "b2"):
        assert_close(th[k][v], jh[k][v], rtol=0.0, atol=1e-6, name=k)
    for k in ("ng", "ns"):
        assert_close(tit[k][v], jit_[k][v], rtol=0.0, atol=1e-6, name=k)
    # the points o + t d: within 1e-6 of the hit distance (an ulp of t)
    dp = np.abs(tit["p"] - jit_["p"])[v].max(1)
    assert (dp <= 1e-6 * th["t"][v]).all(), dp.max()
    # the blade lies along -45 degrees mid-shutter and along -z at the end
    # (tests/test_motion_blur.py): the times move the hits
    hit_z = (o[:, 2] + th["t"] * d[:, 2])[v & (th["prim"] < 2)]
    assert hit_z.min() < -1.0


@pytest.mark.parametrize("turn", ["", "Rotate 4 0 1 0"],
                         ids=["translating", "turning"])
def test_camera_motion_rays_match_jax(turn):
    text = CAMERA % turn
    jsd, tsd = japi.load_scene_string(text), tapi.load_scene_string(text)
    assert tsd.camera.cam_to_world_end is not None
    jc = jcam.make_camera(jsd.camera, jsd.film)
    tc = tcam.make_camera(tsd.camera, tsd.film, "cpu")
    rng = np.random.default_rng(9)
    pf = rng.uniform(0, 8, (4096, 2)).astype(np.float32)
    ut = rng.uniform(0, 1, 4096).astype(np.float32)
    jo, jd = jcam.generate_rays(jc, jnp.asarray(pf), kind=0,
                                u_time=jnp.asarray(ut))
    to, td = tcam.generate_rays(tc, tt(pf), kind=0,
                                time=tcam.shutter_time(tsd.camera, tt(ut)))
    assert_close(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6, name="o")
    assert_close(td.numpy(), np.asarray(jd), rtol=0.0, atol=1e-6, name="d")
    if not turn:  # the origins sweep the 3 m translation over the shutter
        span = np.linalg.norm(to.numpy()[ut.argmax()] - to.numpy()[ut.argmin()])
        assert 2.9 < span < 3.1


def test_time_rides_the_compacted_sort(blade, monkeypatch):
    """Every traversal of the compacted loop sees each ray with its own
    time: the primary wave's lanes are sorted before bounce 0, and its
    directions name the rays."""
    _, ts = blade
    rng = np.random.default_rng(2)
    N = 2048
    o = np.tile(np.array([[0.0, 0.0, -5.0]], np.float32), (N, 1))
    d = rng.normal(size=(N, 3)) * [0.3, 0.02, 0.3] + [0, 0, 1]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    time = rng.uniform(0, 1, N).astype(np.float32)
    seen = []
    real = tis.intersect

    def recording(scene, o_, d_, t_max, **kw):
        seen.append((d_.clone(), kw["time"].clone(), kw.get("presorted")))
        return real(scene, o_, d_, t_max, **kw)

    monkeypatch.setattr(tpath.isect, "intersect", recording)
    cfg = tpath.PathConfig(max_depth=3, compact_schedule=trender.COMPACT_SCHEDULE)
    L, aux = tpath.trace_paths(ts, tt(o), tt(d), threefry.prng_key(0),
                               cfg, time=tt(time))
    assert torch.isfinite(L).all()
    d0, t0, presorted = seen[0]
    assert presorted and not torch.equal(d0, tt(d))  # the lanes were sorted
    lane = {tuple(v): i for i, v in enumerate(d.tolist())}
    idx = np.array([lane[tuple(v)] for v in d0.numpy().tolist()])
    np.testing.assert_array_equal(t0.numpy(), time[idx])
    # later bounces: fewer lanes, each time one of the wave's
    for _, tb, _ in seen[1:]:
        assert np.isin(tb.numpy(), time).all()


@pytest.fixture(scope="module")
def atrium_motion():
    """atrium_motion's device scene, built once (the numpy BVH over the
    union of 7 sub-keyframes takes most of the time)."""
    _, sd = camera_golden("camera16_motion")
    return trender.build(sd, "cpu")[0]


@pytest.mark.parametrize("name", ["camera16_motion", "camera16_motion_compact"])
def test_motion_render_16_matches_golden(atrium_motion, name):
    img, z, st = render_camera_golden(name, scene=atrium_motion)
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    assert abs(st["rays"] - int(z["rays"])) <= max(4, 0.002 * int(z["rays"]))


@pytest.mark.parametrize("steps,refused", [(10, False), (11, True)])
def test_motion_kernel_refuses_offsets_past_32_bits(steps, refused):
    """K2's motion variant reads row seg * T + pid of its (M, T, 12) steps
    as 3 float4s at a 32-bit offset: the wrapper refuses 3 M T > 2**31
    before anything is launched (M = 11 at the 2**26 triangles the kernel
    allows; a stride-0 view stands in for the steps)."""
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2

    tris_steps = torch.zeros(1, 1, 12).expand(steps, 1 << 26, 12)
    z3, z1 = torch.zeros(1, 3), torch.zeros(1)
    with pytest.raises(ValueError) as err:
        K2.bvh_traverse_cuda(torch.zeros(1, K2.NODE_INTS, dtype=torch.int32),
                             0, None, z3, z3, z1, time=z1,
                             tris_steps=tris_steps)
    assert ("32 bits" in str(err.value)) == refused, err.value
