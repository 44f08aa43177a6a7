"""The CUDA cluster kernel's own candidate lists, modelled on the CPU.

The kernel (``csrc/cluster_traverse.cu``) culls every cluster box against
its 64-ray group, compacts the hits into a shared list, ranks the list by
(entry distance, cluster id) and sends a group with more than MAXC
candidates to the BVH kernel.  ``candidate_lists_model`` is a per-group
model of those steps.  On the random soups of tests/test_clusters_fused.py
(T=300, T=2000) and on atrium bounce rays (16^2 film) it must give:

- exactly ``per_ray_cull``'s need and tnear (the torch cull the kernel
  absorbs);
- the stable sort's candidate order of ``candidate_tables``;
- the same overflow groups as the JAX package's
  ``intersect_clusters_fused`` (interpret mode), seen through a fallback
  that marks the rays it is given.

All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.ops import clusters_pallas as jcl
from pbrt_v3_iile_tpu.ops.intersect import Hit as JHit
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ops import clusters as tcllib
from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as tcl
from pbrt_v3_iile_tpu_torch.ops import intersect as tis
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

from test_torch_intersect import _rays, _soup
from torch_parity import ATRIUM, tt

MARK = 1 << 29   # prim id the marking fallback reports


def _sorted(o, d, t, wmin, wmax):
    """The wave's coherence sort, as intersect_clusters_fused does it."""
    key = tcllib.sort_key6(o, d, wmin, wmax)
    key = torch.where(t > 0, key, 0x7FFFFFFF)
    perm = torch.sort(key, stable=True).indices
    return o[perm].contiguous(), d[perm].contiguous(), t[perm].contiguous()


def _check_model(cp, os_, ds_, ts_, maxc):
    need, tnear, lists, n_cand = tcl.candidate_lists_model(cp, os_, ds_, ts_,
                                                           maxc)
    rneed, rtnear = tcllib.per_ray_cull(os_, ds_, ts_, cp.aabb_min,
                                        cp.aabb_max, tcl.G_DEFAULT)
    assert torch.equal(need, rneed)
    assert torch.equal(tnear[need], rtnear[need])
    cand, _, ctn, ncand, rn = tcl.candidate_tables(cp, os_, ds_, ts_, maxc)
    assert torch.equal(n_cand, rn.to(torch.int32))
    for g, lst in enumerate(lists):
        if lst is None:
            assert rn[g] > cand.shape[1]
            continue
        n = int(ncand[g])
        assert torch.equal(lst[1].to(torch.int32), cand[g, :n])
        assert torch.equal(lst[0], ctn[g, :n])
    return n_cand


def _marking_fallbacks():
    def jfb(o, d, t):
        live = t > 0
        return JHit(t=t, prim=jnp.where(live, MARK, -1).astype(jnp.int32),
                    b1=jnp.zeros_like(t), b2=jnp.zeros_like(t), valid=live)

    def tfb(o, d, t):
        live = t > 0
        return tis.Hit(t=t, prim=torch.where(live, MARK, -1).to(torch.int32),
                       b1=torch.zeros_like(t), b2=torch.zeros_like(t),
                       valid=live)
    return jfb, tfb


def _check_overflow_like_jax(jcp, tcp, o, d, tmax, maxc, wmin=None, wmax=None):
    jfb, tfb = _marking_fallbacks()
    jw = {} if wmin is None else dict(world_min=jnp.asarray(wmin),
                                      world_max=jnp.asarray(wmax))
    tw = {} if wmin is None else dict(world_min=tt(wmin), world_max=tt(wmax))
    jh = jcl.intersect_clusters_fused(
        jcp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), group=64,
        max_candidates=maxc, interpret=True, fallback=jfb, **jw)
    th = tcl.intersect_clusters_fused(tcp, tt(o), tt(d), tt(tmax),
                                      max_candidates=maxc, fallback=tfb, **tw)
    jm = np.asarray(jh.prim) == MARK
    tm = th.prim.numpy() == MARK
    np.testing.assert_array_equal(jm, tm)
    return int(jm.sum())


@pytest.mark.parametrize("T,N", [(300, 640), (2000, 1280)])
def test_model_lists_on_random_soups(T, N):
    rng, jcp, tcp, _, _, _ = _soup(T, T + N)
    o, d = _rays(rng, N)
    tmax = np.where(np.arange(N) % 7 == 3, -1.0, 1e30).astype(np.float32)
    K = tcp.aabb_min.shape[0]
    maxc = 4 if K > 8 else tcl.maxc_for(K)
    wmin, wmax = torch.amin(tcp.aabb_min, 0), torch.amax(tcp.aabb_max, 0)
    os_, ds_, ts_ = _sorted(tt(o), tt(d), tt(tmax), wmin, wmax)
    n_cand = _check_model(tcp, os_, ds_, ts_, maxc)
    assert int(n_cand.max()) > 0
    marked = _check_overflow_like_jax(jcp, tcp, o, d, tmax, maxc)
    assert marked == int(((n_cand > maxc).repeat_interleave(64)
                          & (ts_ > 0)).sum())


@pytest.fixture(scope="module")
def atrium_bounce():
    sd = tapi.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 16
    scene, cam = trender.build(sd, "cpu", with_clusters=True)
    o, d, *_ = trender.make_wave_prep(sd, "cpu")(cam, threefry.prng_key(2), 0, 0)
    hit = tis.intersect_bvh(scene, o, d, torch.full_like(o[:, 0], 1e30))
    it = tis.make_interaction(scene, o, d, hit)
    rng = np.random.default_rng(4)
    db = vm.normalize(tt(rng.normal(size=tuple(o.shape))))
    ng = vm.face_forward(it.ng, -d)
    db = torch.where((vm.dot(db, ng) < 0)[:, None], -db, db)
    ob = vm.offset_ray_origin(it.p, ng, db)
    tb = torch.where(hit.valid, 1e30, -1.0)
    return scene, ob, db, tb


def test_model_lists_on_atrium_bounce_rays(atrium_bounce):
    scene, ob, db, tb = atrium_bounce
    cp = scene.clusters
    maxc = 36    # the 4 groups hold 35-43 candidates: some overflow
    os_, ds_, ts_ = _sorted(ob, db, tb, scene.world_min, scene.world_max)
    n_cand = _check_model(cp, os_, ds_, ts_, maxc)
    assert (n_cand > maxc).any() and (n_cand <= maxc).any()
    jcp = jcl.ClusterPack(*(jnp.asarray(getattr(cp, f).numpy())
                            for f in jcl.ClusterPack._fields))
    marked = _check_overflow_like_jax(
        jcp, cp, ob.numpy(), db.numpy(), tb.numpy(), maxc,
        scene.world_min.numpy(), scene.world_max.numpy())
    assert marked > 0


def test_plain_kernel_step_reports_overflow_groups_as_misses(atrium_bounce):
    """cluster_traverse_plain: the kernel's result, n_cand in full and
    t = t_max, prim = -1 on the groups it leaves to the BVH kernel."""
    scene, ob, db, tb = atrium_bounce
    os_, ds_, ts_ = _sorted(ob, db, tb, scene.world_min, scene.world_max)
    t, prim, n_cand = tcl.cluster_traverse(scene.clusters, os_, ds_, ts_, 36)
    over = (n_cand > 36).repeat_interleave(64)
    assert over.any() and not over.all()
    assert torch.equal(t[over], ts_[over]) and (prim[over] == -1).all()
    t2, prim2, n2 = tcl.cluster_traverse(scene.clusters, os_, ds_, ts_, 192)
    assert torch.equal(n2, n_cand) and (n2 <= 192).all()
    assert torch.equal(prim2[~over], prim[~over])
    assert torch.equal(t2[~over], t[~over])
    assert (prim2[over & (ts_ > 0)] >= 0).float().mean() > 0.5
