"""CUDA kernels against their plain PyTorch versions, on the GPU.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one.  They import no jax, so on a machine without it they run
with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Tolerances are those of tests/test_torch_intersect.py: prim ids equal on
>= 99.9% of rays, t within 1e-5 relative + 1e-6 absolute where they agree.
"""

import os

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
    from pbrt_v3_iile_tpu.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    dev = torch.device("cuda")
    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 64
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
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


def _agree(ta, pa, tb, pb):
    pa, pb = pa.cpu().numpy(), pb.cpu().numpy()
    ta, tb = ta.cpu().numpy(), tb.cpu().numpy()
    same = pa == pb
    both = same & (pa >= 0)
    assert same.mean() >= PRIM_AGREE, same.mean()
    assert (np.abs(ta - tb)[both] <= 1e-5 * np.abs(tb[both]) + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_matches_walker(gpu_scene, wave, any_hit):
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as k2

    scene, _, waves = gpu_scene
    o, d, tm = waves[wave]
    n0 = k2.LAUNCHES
    t, prim, _, _ = k2.bvh_traverse_cuda(scene.nodes_packed, scene.tris_packed,
                                         o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == n0 + 1
    ref = isect.intersect_bvh(scene, o, d, tm, any_hit=any_hit)
    if any_hit:
        assert ((prim >= 0) == ref.valid).float().mean().item() >= PRIM_AGREE
    else:
        _agree(t, prim, ref.t, ref.prim)


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_cluster_kernel_matches_plain(gpu_scene, wave):
    from pbrt_v3_iile_tpu_torch.ops import clusters as cl
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as k1

    scene, _, waves = gpu_scene
    o, d, tm = waves[wave]
    key = torch.where(tm > 0, cl.sort_key6(o, d, scene.world_min,
                                           scene.world_max), 0x7FFFFFFF)
    perm = torch.sort(key, stable=True).indices
    os_, ds_, ts_ = o[perm], d[perm], tm[perm].contiguous()
    cand, cpk, ctn, ncand, _ = k1.candidate_tables(scene.clusters, os_, ds_, ts_)
    rays = k1.ray_table(os_, ds_)
    args = (scene.clusters.feat, cand, cpk, ctn, ncand, rays, ts_)
    t, prim = k1.traverse_groups_cuda(*args)
    tp, pp = k1.traverse_groups_plain(*args)
    _agree(t, prim, tp, pp)


@pytest.mark.cuda
def test_cuda_render_matches_cpu_render(gpu_scene):
    """render() on the GPU (cluster kernel, BVH kernel on overflow) and on
    the CPU (plain walker) give the same image by test_golden's criterion."""
    from pbrt_v3_iile_tpu.scene import api as apilib
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
