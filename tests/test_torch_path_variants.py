"""The path integrator's variants that IILE brings, port vs JAX, on
atrium with the BVH walker: the ``directlighting`` integrator
(``nee_all`` and ``direct_only``, the ghost segment) through render(),
IILE's compacted direct pass, and the probe G-buffer (``collect_aux``) of
the compacted loop against the plain loop's.

The JAX side's images are tests/golden/parity_*.npz and
tests/golden/direct_atrium48x32_d6_compact_p4.npz, made on the same
settings by tools/make_parity_golden.py and tools/make_direct_golden.py
(so no JAX program compiles here).

Criterion for images: tests/test_golden.py's, mean within 2% and >= 99%
of the pixels within 5% relative (+1e-2), as tests/test_torch_slice.py
uses.  The G-buffer of the two loops is the same primary segment, so it
must agree exactly.
"""

import os

import numpy as np
import torch

from pbrt_v3_iile_tpu_torch.integrators import iispt as tiispt
from pbrt_v3_iile_tpu_torch.integrators import path as tpath
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import film as tfilm
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi

from torch_parity import ATRIUM, REPO, golden_criterion

GOLDEN = os.path.join(REPO, "tests", "golden")


def _atrium(api, w, h, kind="path"):
    sd = api.load_scene(ATRIUM)
    sd.film.x_resolution, sd.film.y_resolution = w, h
    sd.integrator.kind = kind
    return sd


def test_directlighting_render_matches_jax():
    ref = np.load(os.path.join(GOLDEN, "parity_directlighting16.npz"))["img"]
    sd = _atrium(tapi, 16, 16, "directlighting")
    cfg = trender.make_integrator_config(sd, device="cpu")
    assert cfg.nee_all and cfg.direct_only and cfg.accel == "bvh"
    img, _ = trender.render(sd, spp=2, seed=7, device="cpu")
    ok, info = golden_criterion(img, ref)
    assert ok, info


def test_compacted_direct_pass_matches_jax():
    """IILE's direct pass on the clusters accel: nee_all, direct_only and
    the compact schedule (1, .5, .25, .25), here on the BVH walker at
    depth 1 (direct-only paths past one non-specular bounce are ghosts).
    48x32 = 1536 lanes: above the 1024-lane floor of the budget, so the
    budget roulette runs from bounce 1."""
    ref = np.load(os.path.join(GOLDEN, "parity_direct_compact_d1.npz"))["img"]
    sched = tiispt.DIRECT_COMPACT_SCHEDULE
    sd = _atrium(tapi, 48, 32)
    sd.integrator.max_depth = 1
    cfg = tpath.PathConfig(max_depth=sd.integrator.max_depth, nee_all=True,
                           direct_only=True, accel="bvh",
                           compact_schedule=sched)
    tscene, tcam = trender.build(sd, "cpu")
    trun = trender.render_pass_fn(sd, cfg, "cpu")
    tkey = threefry.fold_in(threefry.prng_key(0), 5000)
    tf = tfilm.new_film(32, 48, "cpu")
    for p in range(2):
        L, jit_, aux = trun(tscene, tcam, tkey, p)
        tf = tfilm.add_sample_image(tf, L, jit_)
        assert int(aux["compact_overflow"]) == 0
    ok, info = golden_criterion(tfilm.resolve(tf).numpy(), ref)
    assert ok, info


def test_compacted_direct_pass_depth6_matches_jax():
    """iispt.direct_passes at the file's depth 6, compacted (its clusters
    configuration; the scene is built without the cluster pack, so the
    traversals take the BVH walker the golden took), against the JAX
    package's direct pass of the same settings and key
    (tools/make_direct_golden.py)."""
    z = np.load(os.path.join(GOLDEN, "direct_atrium48x32_d6_compact_p4.npz"))
    w, h, passes = int(z["width"]), int(z["height"]), int(z["passes"])
    sd = _atrium(tapi, w, h)
    assert sd.integrator.max_depth == int(z["max_depth"]) == 6
    assert tiispt.DIRECT_COMPACT_SCHEDULE == tuple(z["schedule"])
    scene, cam = trender.build(sd, "cpu", with_clusters=False)
    key = threefry.fold_in(threefry.prng_key(int(z["seed"])), int(z["key_fold"]))
    img = tiispt.direct_passes(sd, scene, cam, key, passes, "clusters", "cpu")
    ok, info = golden_criterion(img, z["img"])
    assert ok, info


def test_compacted_loop_collects_the_same_gbuffer():
    sd = _atrium(tapi, 48, 32)
    scene, cam = trender.build(sd, "cpu")
    o, d, _, _, k, *_ = trender.make_wave_prep(sd, "cpu")(
        cam, threefry.prng_key(1), 0, 0)
    # depth 1: the G-buffer is the primary segment's; the compaction runs
    # before bounce 1
    cfg = tpath.PathConfig(max_depth=1, skip_bounce0_le=True, accel="bvh")
    L0, plain = tpath.trace_paths(scene, o, d, k, cfg, collect_aux=True)
    L1, comp = tpath.trace_paths(
        scene, o, d, k, cfg.replace(compact_schedule=(1.0, 0.5)),
        collect_aux=True)
    assert torch.equal(comp["distance"], plain["distance"])
    assert torch.equal(comp["normal"], plain["normal"])
    hit = plain["distance"] > 0
    assert 0.5 < float(hit.float().mean()) and bool((plain["distance"][~hit] == -1).all())
    assert torch.allclose(plain["normal"][hit].norm(dim=-1), torch.ones(()), atol=1e-5)
    assert np.isfinite(L1.numpy()).all() and float(L1.mean()) > 0.0
