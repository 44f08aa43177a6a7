"""The path integrator's variants that IILE brings, port vs JAX, on
atrium with the BVH walker: the ``directlighting`` integrator
(``nee_all`` and ``direct_only``, the ghost segment) through render(),
IILE's compacted direct pass, and the probe G-buffer (``collect_aux``) of
the compacted loop against the plain loop's.

Criterion for images: tests/test_golden.py's, mean within 2% and >= 99%
of the pixels within 5% relative (+1e-2), as tests/test_torch_slice.py
uses.  The G-buffer of the two loops is the same primary segment, so it
must agree exactly.
"""

import jax
import numpy as np
import torch

from pbrt_v3_iile_tpu.integrators import path as jpath
from pbrt_v3_iile_tpu.integrators import render as jrender
from pbrt_v3_iile_tpu.ops import film as jfilm
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu_torch.integrators import iispt as tiispt
from pbrt_v3_iile_tpu_torch.integrators import path as tpath
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import film as tfilm
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi

from torch_parity import ATRIUM, golden_criterion


def _atrium(api, w, h, kind="path"):
    sd = api.load_scene(ATRIUM)
    sd.film.x_resolution, sd.film.y_resolution = w, h
    sd.integrator.kind = kind
    return sd


def test_directlighting_render_matches_jax():
    ref, _ = jrender.render(_atrium(japi, 16, 16, "directlighting"), spp=2,
                            seed=7)
    sd = _atrium(tapi, 16, 16, "directlighting")
    cfg = trender.make_integrator_config(sd, device="cpu")
    assert cfg.nee_all and cfg.direct_only and cfg.accel == "bvh"
    img, _ = trender.render(sd, spp=2, seed=7, device="cpu")
    ok, info = golden_criterion(img, np.asarray(ref))
    assert ok, info


def test_compacted_direct_pass_matches_jax():
    """IILE's direct pass on the clusters accel: nee_all, direct_only and
    the compact schedule (1, .5, .25, .25), here on the BVH walker at
    depth 1 (the file's 6 unrolls into a JAX program that takes minutes to
    compile on a CPU; direct-only paths past one non-specular bounce are
    ghosts).  48x32 = 1536 lanes: above the 1024-lane floor of the
    budget, so the budget roulette runs from bounce 1."""
    sched = tiispt.DIRECT_COMPACT_SCHEDULE
    jsd = _atrium(japi, 48, 32)
    jsd.integrator.max_depth = 1
    jcfg = jpath.PathConfig(max_depth=jsd.integrator.max_depth, nee=True,
                            nee_all=True, direct_only=True, accel="bvh",
                            compact_schedule=sched)
    scene, cam = jrender.build(jsd)
    run = jax.jit(jrender.render_pass_fn(jsd, jcfg), static_argnums=(4,))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5000)
    film = jfilm.new_film(32, 48)
    for p in range(2):
        L, jit_, _ = run(scene, cam, key, p, 0)
        film = jfilm.add_sample_image(film, L, jit_)
    ref = np.asarray(jfilm.resolve(film))

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


def test_compacted_loop_collects_the_same_gbuffer():
    sd = _atrium(tapi, 48, 32)
    scene, cam = trender.build(sd, "cpu")
    o, d, _, k, _ = trender.make_wave_prep(sd, "cpu")(cam, threefry.prng_key(1),
                                                       0, 0)
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
