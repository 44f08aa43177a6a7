"""CUDA kernels against their plain PyTorch versions, on the GPU.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one.  They import no jax, so on a machine without it they run
with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Each kernel and its own plain version (the BVH kernel's is
``bvh_traverse_wide_plain``) do the same rounded operations in the same
order, so they must agree exactly: every output of the BVH kernel, and
the cluster kernel's n_cand, prim, t and any-hit validity.  The BVH kernel
against the binary walker of the CPU path: prim ids equal on >= 99.9% of
rays, t bit-equal where they agree, any-hit validity on >= 99.9%; the
same on a soup with leaves of 6 and 10 triangles.  The kd-tree kernel
(K3) against intersect_kd_plain and the BVH kernel's motion variant
against bvh_traverse_wide_plain with times: t, prim, barycentrics
identical on a soup and on atrium (scenes/atrium_motion.pbrt for the
motion variant; at time 0 it equals the static kernel).  GPU
renders against the CPU render: test_golden's criterion.  The train step on
the card against the CPU step: see its docstring.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATRIUM = os.path.join(REPO, "scenes", "atrium.pbrt")
PRIM_AGREE = 0.999


@pytest.fixture(scope="module")
def gpu_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    dev = torch.device("cuda")
    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 64
    scene, cam = renderlib.build(sd, dev, with_clusters=True, with_kdtree=True)
    o, d, *_ = renderlib.make_wave_prep(sd, dev)(cam, threefry.prng_key(1), 0, 0)
    hit = isect.intersect_bvh(scene, o, d, torch.full_like(o[:, 0], 1e30))
    rng = np.random.default_rng(0)
    db = vm.normalize(torch.as_tensor(rng.normal(size=tuple(o.shape)),
                                      dtype=torch.float32, device=dev))
    it = isect.make_interaction(scene, o, d, hit)
    ng = vm.face_forward(it.ng, -d)
    db = torch.where((vm.dot(db, ng) < 0)[:, None], -db, db)
    ob = vm.offset_ray_origin(it.p, ng, db)
    tb = torch.where(hit.valid, 1e30, -1.0)
    return scene, sd, {"primary": (o, d, torch.full_like(tb, 1e30)),
                       "bounce": (ob, db, tb)}


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_matches_walker(gpu_scene, wave, any_hit):
    """K2 (4-wide) against the binary walker: the same hits but for exact
    ties in t and a t that rounds below its box's tnear."""
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    scene, _, waves = gpu_scene
    o, d, tm = waves[wave]
    n0 = k2.LAUNCHES
    t, prim, _, _ = k2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                                         scene.tris_packed, o, d, tm,
                                         any_hit=any_hit)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == n0 + 1
    ref = isect.intersect_bvh(scene, o, d, tm, any_hit=any_hit)
    if any_hit:
        assert ((prim >= 0) == ref.valid).float().mean().item() >= PRIM_AGREE
    else:
        same = prim == ref.prim
        assert same.float().mean().item() >= PRIM_AGREE
        assert torch.equal(t[same], ref.t[same])


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_matches_wide_plain(gpu_scene, wave, any_hit):
    """K2 against its plain version in its own order: t, prim and the
    barycentrics identical on every ray."""
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    scene, _, waves = gpu_scene
    o, d, tm = waves[wave]
    got = k2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                               scene.tris_packed, o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    want = k2.bvh_traverse_wide_plain(scene.bvh4_nodes, scene.tris_packed,
                                      o, d, tm, any_hit=any_hit)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_on_coincident_leaves(gpu_scene, any_hit):
    """Binary leaves of 6 and 10 triangles (coincident centroids): K2
    against its plain version, identical on every ray, and against the
    binary walker, which tests the first 4 of a leaf as the collapse
    keeps them."""
    from pbrt_v3_iile_tpu_torch.ops import bvh
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2
    from torch_parity import coincident_soup, pack_bvh, rays_at

    rng = np.random.default_rng(11)
    p0, e1, e2, centres = coincident_soup(rng, 300, (6, 10))
    flat = bvh.build_bvh(np.stack([p0, p0 + e1, p0 + e2], 1), use_native=False)
    order = flat.prim_order
    nodes, tris = pack_bvh(flat.node_min, flat.node_max, flat.node_right,
                           flat.node_count, flat.node_axis, p0[order],
                           e1[order], e2[order])
    assert {6, 10} <= set((nodes[:, 7] >> 2).tolist())
    wide, depth = k2.build_bvh4_np(nodes)
    dev = torch.device("cuda")
    scene = SimpleNamespace(nodes_packed=torch.as_tensor(nodes, device=dev),
                            tris_packed=torch.as_tensor(tris, device=dev))
    wide = torch.as_tensor(wide, device=dev)
    o, d, tm = (torch.as_tensor(x, device=dev) for x in rays_at(rng, centres, 4096))
    got = k2.bvh_traverse_cuda(wide, depth, scene.tris_packed, o, d, tm,
                               any_hit=any_hit)
    torch.cuda.synchronize()
    want = k2.bvh_traverse_wide_plain(wide, scene.tris_packed, o, d, tm,
                                      any_hit=any_hit)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = isect.intersect_bvh(scene, o, d, tm, any_hit=any_hit)
    assert ((got[1] >= 0) == ref.valid).float().mean().item() >= PRIM_AGREE
    if not any_hit:
        assert (got[1] == ref.prim).float().mean().item() >= PRIM_AGREE


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize("maxc", [192, 8])
def test_cluster_kernel_matches_plain(gpu_scene, wave, maxc):
    """K1 (cull, order and traversal in one kernel) against its plain
    version on the card: n_cand per group identical, prim identical on
    every ray, t bit-identical; any-hit validity identical."""
    from pbrt_v3_iile_tpu_torch.ops import clusters as cl
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as k1

    scene, _, waves = gpu_scene
    o, d, tm = waves[wave]
    key = torch.where(tm > 0, cl.sort_key6(o, d, scene.world_min,
                                           scene.world_max), 0x7FFFFFFF)
    perm = torch.sort(key, stable=True).indices
    os_, ds_, ts_ = (x[perm].contiguous() for x in (o, d, tm))
    maxc = k1.maxc_for(scene.clusters.feat.shape[0], maxc)
    n0 = k1.LAUNCHES
    t, prim, n_cand = k1.cluster_traverse_cuda(scene.clusters, os_, ds_, ts_, maxc)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == n0 + 1
    tp, pp, np_ = k1.cluster_traverse_plain(scene.clusters, os_, ds_, ts_, maxc)
    assert torch.equal(n_cand, np_)
    assert torch.equal(prim, pp)
    assert torch.equal(t, tp)
    _, pa, _ = k1.cluster_traverse_cuda(scene.clusters, os_, ds_, ts_, maxc,
                                        any_hit=True)
    assert torch.equal(pa >= 0, pp >= 0)


@pytest.mark.cuda
def test_cuda_render_matches_cpu_render(gpu_scene):
    """render() on the GPU (cluster kernel, BVH kernel on overflow) and on
    the CPU (plain walker) give the same image by test_golden's criterion."""
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib

    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 24
    sd.integrator.max_depth = 3
    gpu, _ = renderlib.render(sd, spp=2, seed=7, device="cuda", compact=True,
                              cluster_maxc=8)
    cpu, _ = renderlib.render(sd, spp=2, seed=7, device="cpu", compact=True)
    assert abs(gpu.mean() - cpu.mean()) < 0.02 * cpu.mean()
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-2)
    assert (rel < 0.05).mean() > 0.99


@pytest.mark.cuda
def test_cuda_bvh_render_matches_cpu_render(gpu_scene):
    """render(..., accel="bvh") on the GPU (the BVH kernel for every
    traversal) and on the CPU (plain walker) give the same image by
    test_golden's criterion."""
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 24
    sd.integrator.max_depth = 3
    n0 = k2.LAUNCHES
    gpu, _ = renderlib.render(sd, spp=2, seed=7, device="cuda", compact=True,
                              accel="bvh")
    assert k2.LAUNCHES > n0
    cpu, _ = renderlib.render(sd, spp=2, seed=7, device="cpu", compact=True)
    assert abs(gpu.mean() - cpu.mean()) < 0.02 * cpu.mean()
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-2)
    assert (rel < 0.05).mean() > 0.99


def _golden_close(a, b):
    """tests/test_golden.py's criterion."""
    rel = np.abs(a - b) / (np.abs(b) + 1e-2)
    return abs(a.mean() - b.mean()) < 0.02 * b.mean() and (rel < 0.05).mean() > 0.99


@pytest.mark.cuda
def test_cuda_iile_matches_cpu_iile(gpu_scene):
    """render_iile with accel="bvh" on the GPU (the BVH kernel for every
    traversal) and on the CPU (the walker) give the same combined, direct
    and indirect images by test_golden's criterion; with the default
    clusters accel on the GPU, the indirect image is the bvh one's (the
    same hits but for grazing rays) and the combined mean within 2%."""
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as k1
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 24
    kw = dict(indirect_tasks=1, direct_samples=2, hemi_size=8)
    n1, n2 = k1.LAUNCHES, k2.LAUNCHES
    gpu = iispt.render_iile(sd, accel="bvh", device="cuda", **kw)
    assert k2.LAUNCHES > n2 and k1.LAUNCHES == n1
    cpu = iispt.render_iile(sd, accel="bvh", device="cpu", **kw)
    for g, c in zip(gpu[:3], cpu[:3]):
        assert np.isfinite(g).all() and _golden_close(g, c)
    clu = iispt.render_iile(sd, device="cuda", **kw)
    assert clu[3]["accel"] == "clusters" and k1.LAUNCHES > n1
    assert _golden_close(clu[2], gpu[2])
    assert abs(clu[0].mean() - gpu[0].mean()) < 0.02 * gpu[0].mean()


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu_step():
    """The train step on the card against the same code on the CPU, from
    the pretrained weights, 3 Adam steps of batch 4 on 8^2 hemispheres:
    losses within 1e-4 relative, the first step's gradients and the
    BatchNorm running statistics within 1e-3 of each tensor's max
    |value|; in float64 every parameter too (in float32 Adam's normalized
    update turns a near-zero gradient's rounding noise into a whole
    step of lr)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pbrt_v3_iile_tpu_torch.ml import train as trainlib
    from pbrt_v3_iile_tpu_torch.models import weights

    rng = np.random.default_rng(0)
    data = [(torch.from_numpy(rng.normal(size=(4, 8, 8, 7))),
             torch.from_numpy(np.abs(rng.normal(size=(4, 8, 8, 3)))))
            for _ in range(3)]
    for dtype in (torch.float32, torch.float64):
        runs = []
        for dev in ("cuda", "cpu"):
            net = weights.load_iisptnet(device=dev).to(dtype)
            step = trainlib.make_train_step(net, torch.optim.Adam(net.parameters(), lr=6e-5))
            losses, grads = [], None
            for x, y in data:
                losses.append(float(step(x.to(dev, dtype), y.to(dev, dtype))))
                if grads is None:
                    grads = {k: p.grad.to("cpu", torch.float64)
                             for k, p in net.named_parameters()}
            runs.append((losses, grads, {k: v.to("cpu", torch.float64)
                                         for k, v in net.state_dict().items()
                                         if v.is_floating_point()}))
        (lg, gg, sg), (lc, gc, sc) = runs
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lg, lc)), (lg, lc)
        assert max(rel(gg[k], gc[k]) for k in gc) <= 1e-3
        held = sc if dtype == torch.float64 else {k: v for k, v in sc.items()
                                                   if ".running_" in k}
        errs = {k: rel(sg[k], sc[k]) for k in held}
        assert max(errs.values()) <= 1e-3, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


def _transport_scene(features, lookat=""):
    """scenes/atrium_transport.pbrt with the named features, at 24^2 and
    depth 3 (tools/make_transport_golden.py's variant())."""
    import importlib.util
    import re

    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    spec = importlib.util.spec_from_file_location(
        "make_transport_golden",
        os.path.join(REPO, "tools", "make_transport_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    scenes = os.path.join(REPO, "scenes")
    text = tool.variant(open(os.path.join(scenes, tool.TRANSPORT)).read(),
                        features)
    if lookat:
        text = re.sub(r"(?m)^LookAt .*$", "LookAt " + lookat, text, count=1)
    sd = apilib.load_scene_string(text, scenes)
    sd.film.x_resolution = sd.film.y_resolution = 24
    sd.integrator.max_depth = 3
    return sd


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["media", "bssrdf", "hair_fourier"])
def test_cuda_transport_render_matches_cpu_render(path):
    """The materials-and-transport paths on the card: volpath through fog
    and the smoke grid, the exact BSSRDF (the vase from close by), hair
    and the Fourier bowl; render(..., accel="bvh") compacted on the GPU
    (the BVH kernel for every traversal, the BSSRDF's probe and exit
    shadow rays among them) against the CPU (the walker) by test_golden's
    criterion; the clusters accel on the GPU launches the cluster
    kernel and gives a finite image."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as k1
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    table = "-0.95 1.0 1.0  -1.45 0.78 0.3  0 1 0"
    sd = {"media": lambda: _transport_scene(["fog", "smoke"]),
          "bssrdf": lambda: _transport_scene(["sss"], table),
          "hair_fourier": lambda: _transport_scene(["hair", "fourier"])}[path]()
    n1, n2 = k1.LAUNCHES, k2.LAUNCHES
    gpu, _ = renderlib.render(sd, spp=2, seed=7, device="cuda", compact=True,
                              accel="bvh")
    assert k2.LAUNCHES > n2 and k1.LAUNCHES == n1
    cpu, _ = renderlib.render(sd, spp=2, seed=7, device="cpu", compact=True)
    assert np.isfinite(gpu).all() and _golden_close(gpu, cpu)
    clu, _ = renderlib.render(sd, spp=2, seed=7, device="cuda", compact=True)
    assert k1.LAUNCHES > n1 and np.isfinite(clu).all() and clu.mean() > 0


def _soup_text(rng, n=400, moving=True):
    """A random triangle soup (tests/test_kdtree.py's kind) in which, with
    moving, the second half turns 40 degrees and moves over the shutter."""
    c = rng.uniform(-2, 2, (n, 1, 3))
    v = (c + rng.uniform(-0.4, 0.4, (n, 3, 3))).reshape(2, -1)

    def shape(p):
        idx = " ".join(str(i) for i in range(p.size // 3))
        pts = " ".join(f"{x:.6g}" for x in p)
        return f'Shape "trianglemesh" "point P" [{pts}] "integer indices" [{idx}]'

    anim = ("ActiveTransform EndTime\nRotate 40 0 1 0\nTranslate 0.3 0 0\n"
            "ActiveTransform All\n") if moving else ""
    return f"""TransformTimes 0 1
LookAt 0 0 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
Material "matte" "rgb Kd" [0.6 0.5 0.4]
{shape(v[0])}
AttributeBegin
{anim}{shape(v[1])}
AttributeEnd
WorldEnd
"""


def _random_rays(rng, N, dev):
    o = torch.as_tensor(rng.uniform(-4, 4, (N, 3)), dtype=torch.float32,
                        device=dev)
    d = rng.normal(size=(N, 3))
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=torch.float32, device=dev)
    tm = torch.as_tensor(np.where(np.arange(N) % 3 == 0, 6.0, 1e30),
                         dtype=torch.float32, device=dev)
    return o, d, tm


@pytest.fixture(scope="module")
def soup_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    rng = np.random.default_rng(21)
    sd = apilib.load_scene_string(_soup_text(rng))
    assert sd.has_motion
    scene, _ = renderlib.build(sd, torch.device("cuda"), with_kdtree=True)
    assert scene.tris_steps_packed.shape[0] == 4
    return scene, _random_rays(rng, 8192, torch.device("cuda"))


def _kd_check(scene, o, d, tm, any_hit):
    from pbrt_v3_iile_tpu_torch.ops import kd_kernel as k3
    from pbrt_v3_iile_tpu_torch.ops import kdtree

    n0 = k3.LAUNCHES
    got = k3.kd_traverse_cuda(scene, o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == n0 + 1
    want = kdtree.intersect_kd_plain(scene, o, d, tm, any_hit=any_hit)
    for a, b in zip(got, (want.t, want.prim, want.b1, want.b2)):
        assert torch.equal(a, b)
    assert (got[1] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_kd_kernel_matches_plain_on_soup(soup_scene, any_hit):
    """K3 against intersect_kd_plain: t, prim and barycentrics identical."""
    scene, (o, d, tm) = soup_scene
    _kd_check(scene, o, d, tm, any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kd_kernel_matches_plain_on_atrium(gpu_scene, wave, any_hit):
    scene, _, waves = gpu_scene
    _kd_check(scene, *waves[wave], any_hit)


def _motion_check(scene, o, d, tm, time, any_hit):
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    n0 = k2.LAUNCHES_MOTION
    got = k2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                               scene.tris_packed, o, d, tm, any_hit=any_hit,
                               time=time, tris_steps=scene.tris_steps_packed)
    torch.cuda.synchronize()
    assert k2.LAUNCHES_MOTION == n0 + 1
    want = k2.bvh_traverse_wide_plain(scene.bvh4_nodes, scene.tris_packed, o, d,
                                      tm, any_hit=any_hit, time=time,
                                      tris_steps=scene.tris_steps_packed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_kernel_matches_plain_on_soup(soup_scene, any_hit):
    """K2's motion variant against bvh_traverse_wide_plain with the same
    times: t, prim and barycentrics identical."""
    scene, (o, d, tm) = soup_scene
    rng = np.random.default_rng(5)
    time = torch.as_tensor(rng.uniform(0, 1, o.shape[0]), dtype=torch.float32,
                           device=o.device)
    time[:4] = torch.tensor([0.0, 1.0, 1.0 / 3, 2.0 / 3])
    _motion_check(scene, o, d, tm, time, any_hit)


@pytest.fixture(scope="module")
def motion_atrium():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    dev = torch.device("cuda")
    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium_motion.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = 64
    scene, cam = renderlib.build(sd, dev)
    o, d, _, _, _, _, time = renderlib.make_wave_prep(sd, dev)(
        cam, threefry.prng_key(1), 0, 0)
    return scene, o, d, time


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_kernel_matches_plain_on_atrium(motion_atrium, any_hit):
    scene, o, d, time = motion_atrium
    _motion_check(scene, o, d, torch.full_like(time, 1e30), time, any_hit)


@pytest.mark.cuda
def test_motion_kernel_at_time_0_equals_static_kernel(gpu_scene):
    """On a static scene (atrium's triangles as two equal keyframes) the
    motion variant at time 0 is the static kernel."""
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    scene, _, waves = gpu_scene
    o, d, tm = waves["bounce"]
    steps = scene.tris_packed[None].expand(2, -1, -1).contiguous()
    got = k2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                               scene.tris_packed, o, d, tm,
                               time=torch.zeros_like(tm), tris_steps=steps)
    want = k2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                                scene.tris_packed, o, d, tm)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
