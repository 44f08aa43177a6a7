"""Ray-scene intersection front end (port of ``ops/intersect.py``).

``intersect``/``occluded`` dispatch to the aggregate: the fused cluster
kernel (``clusters_kernel``, K1) or the BVH kernel (``intersect_kernel``,
K2), then merge the analytic spheres.  On CPU tensors both kernels run
their plain PyTorch versions; the plain version of K2 is the vectorized
BVH walker below (``intersect_bvh``), the torch form of the reference's
``lax.while_loop`` walker with the same per-step semantics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils import vecmath as vm

STACK_DEPTH = 64
MAX_LEAF = 4  # matches pbrt_v3_iile_tpu/ops/bvh.py MAX_LEAF
T_MIN = 0.0   # ray origins are pre-offset (vm.offset_ray_origin)


@dataclass
class Hit:
    t: torch.Tensor      # (N,) hit distance (= t_max on a miss)
    prim: torch.Tensor   # (N,) i32: -1 miss, [0,T) triangle, T+s sphere
    b1: torch.Tensor     # (N,) triangle barycentric u
    b2: torch.Tensor     # (N,)
    valid: torch.Tensor  # (N,) bool


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 in this order, each op rounded, as the BVH
    kernel computes it (a reduction kernel may sum in another order)."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross3(a, b):
    """a x b with each product rounded (a fused cross kernel may contract
    a1 b2 - a2 b1 into an FMA; the BVH kernel is built without)."""
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _moller(o, d, p0, e1, e2, t_cur):
    """Moller-Trumbore; returns (valid, t, u, v), all (N,)."""
    pv = _cross3(d, e2)
    det = _dot3(e1, pv)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(det == 0, torch.ones_like(det), det),
                      torch.zeros_like(det))
    tv = o - p0
    u = _dot3(tv, pv) * inv
    qv = _cross3(tv, e1)
    v = _dot3(d, qv) * inv
    t = _dot3(e2, qv) * inv
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN) & (t < t_cur)
    return valid, t, u, v


def intersect_bvh(scene, o, d, t_max, any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) against the triangle BVH: the plain
    PyTorch version of the BVH kernel.

    Every step, each live ray visits one node; only live rays are
    gathered, so the cost follows the live count (the per-ray results are
    those of the reference walker, which steps every ray each iteration)."""
    N = o.shape[0]
    dev = o.device
    inv_d = torch.where(torch.abs(d) > 1e-12,
                        1.0 / torch.where(d == 0, torch.ones_like(d), d),
                        torch.where(d >= 0, 1e30, -1e30))
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    stack = torch.zeros((N, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    t = t_max.clone()
    prim = torch.full((N,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(N, dtype=torch.float32, device=dev)
    b2 = torch.zeros(N, dtype=torch.float32, device=dev)
    nodes = scene.nodes_packed
    tris = scene.tris_packed
    idx = torch.arange(N, device=dev)
    while idx.numel() > 0:
        nid = node[idx]
        oo, dd, ii = o[idx], d[idx], inv_d[idx]
        tt = t[idx]
        pp = prim[idx]
        bb1, bb2 = b1[idx], b2[idx]
        nd = nodes[nid]
        nmin = nd[:, 0:3].contiguous().view(torch.float32)
        nmax = nd[:, 3:6].contiguous().view(torch.float32)
        nright = nd[:, 6].long()
        ncount = (nd[:, 7] >> 2).long()
        naxis = (nd[:, 7] & 3).long()
        tlo = (nmin - oo) * ii
        thi = (nmax - oo) * ii
        tnear = torch.amax(torch.minimum(tlo, thi), dim=-1)
        tfar = torch.amin(torch.maximum(tlo, thi), dim=-1) * 1.0000004
        box_hit = (tnear <= tfar) & (tnear < tt) & (tfar > 0.0)
        leaf_hit = box_hit & (ncount > 0)
        for k in range(MAX_LEAF):
            m = leaf_hit & (k < ncount)
            if not bool(m.any()):
                break
            pid = torch.clamp(nright + k, 0, tris.shape[0] - 1)  # jnp.take clamps
            tr = tris[pid]
            ok, tk, uk, vk = _moller(oo, dd, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9], tt)
            upd = m & ok
            tt = torch.where(upd, tk, tt)
            pp = torch.where(upd, nright + k, pp)
            bb1 = torch.where(upd, uk, bb1)
            bb2 = torch.where(upd, vk, bb2)
        go_in = box_hit & (ncount == 0)
        neg = torch.gather(dd < 0.0, 1, naxis[:, None])[:, 0]
        first = nid + 1
        near = torch.where(neg, nright, first)
        far = torch.where(neg, first, nright)
        s = sp[idx]
        push_sp = torch.clamp(s, max=STACK_DEPTH - 1)
        row = stack[idx]
        cur = torch.gather(row, 1, push_sp[:, None])[:, 0]
        row.scatter_(1, push_sp[:, None], torch.where(go_in, far, cur)[:, None])
        s = torch.where(go_in, push_sp + 1, s)
        can_pop = s > 0
        pop_sp = torch.clamp(s - 1, min=0)
        popped = torch.gather(row, 1, pop_sp[:, None])[:, 0]
        nxt = torch.where(go_in, near,
                          torch.where(can_pop, popped, torch.full_like(popped, -1)))
        s = torch.where(go_in, s, torch.where(can_pop, pop_sp, s))
        if any_hit:
            nxt = torch.where(pp >= 0, torch.full_like(nxt, -1), nxt)
        node[idx] = nxt
        stack[idx] = row
        sp[idx] = s
        t[idx] = tt
        prim[idx] = pp
        b1[idx] = bb1
        b2[idx] = bb2
        idx = idx[nxt >= 0]
    prim = prim.to(torch.int32)
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)


def intersect_spheres(scene, o, d, hit: Hit) -> Hit:
    """Brute-force analytic sphere pass merged with the triangle result
    (robust discriminant r^2 - |perpendicular|^2, as the reference)."""
    S = scene.sph_center.shape[0]
    T = scene.tri_p0.shape[0]
    oc = o[:, None, :] - scene.sph_center[None, :, :]
    b = torch.sum(oc * d[:, None, :], dim=-1)
    perp = oc - b[..., None] * d[:, None, :]
    disc = scene.sph_radius[None, :] ** 2 - torch.sum(perp * perp, dim=-1)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    tc = torch.where(t0 > T_MIN, t0, t1)
    sph_live = torch.arange(S, device=o.device)[None, :] < scene.n_spheres
    valid = (disc > 0.0) & (tc > T_MIN) & (tc < hit.t[:, None]) & sph_live
    tc = torch.where(valid, tc, torch.full_like(tc, math.inf))
    best_t, best = torch.min(tc, dim=-1)
    better = torch.isfinite(best_t)
    zero = torch.zeros_like(hit.b1)
    return Hit(t=torch.where(better, best_t, hit.t),
               prim=torch.where(better, T + best.to(torch.int32), hit.prim),
               b1=torch.where(better, zero, hit.b1),
               b2=torch.where(better, zero, hit.b2),
               valid=hit.valid | better)


def intersect(scene, o, d, t_max, any_hit: bool = False, accel: str = "bvh",
              cluster_maxc: int = 192, presorted: bool = False) -> Hit:
    """Full scene intersection: the triangle aggregate, then the analytic
    spheres (when the scene has any).

    accel "clusters" (with a cluster pack on the scene) runs the fused
    cluster kernel with the BVH kernel as its overflow fallback; "bvh"
    runs the BVH kernel.  On CPU tensors each runs its plain version."""
    from . import clusters_kernel, intersect_kernel

    if accel == "clusters" and scene.clusters is not None:
        hit = clusters_kernel.intersect_clusters_fused(
            scene.clusters, o, d, t_max, any_hit=any_hit,
            fallback=lambda os_, ds_, ts_: intersect_kernel.intersect_bvh_kernel(
                scene, os_, ds_, ts_, any_hit=any_hit),
            max_candidates=cluster_maxc,
            world_min=scene.world_min, world_max=scene.world_max,
            tri_p0=scene.tri_p0, tri_e1=scene.tri_e1, tri_e2=scene.tri_e2,
            presorted=presorted)
    elif accel in ("bvh", "clusters"):
        hit = intersect_kernel.intersect_bvh_kernel(scene, o, d, t_max,
                                                    any_hit=any_hit)
    else:
        raise NotImplementedError(f"accel {accel!r} is not ported yet")
    return intersect_spheres(scene, o, d, hit) if scene.n_spheres > 0 else hit


def occluded(scene, o, d, t_max, accel: str = "bvh", cluster_maxc: int = 192,
             presorted: bool = False):
    """Shadow-ray IntersectP."""
    return intersect(scene, o, d, t_max, any_hit=True, accel=accel,
                     cluster_maxc=cluster_maxc, presorted=presorted).valid


@dataclass
class Interaction:
    """SurfaceInteraction SoA."""
    p: torch.Tensor      # (N,3) hit position
    ng: torch.Tensor     # (N,3) geometric normal (unit)
    ns: torch.Tensor     # (N,3) shading normal (unit)
    uv: torch.Tensor     # (N,2)
    wo: torch.Tensor     # (N,3) towards the viewer
    mat: torch.Tensor    # (N,) i32
    light: torch.Tensor  # (N,) i32 area light id or -1
    valid: torch.Tensor  # (N,) bool


def make_interaction(scene, o, d, hit: Hit) -> Interaction:
    T = scene.tri_p0.shape[0]
    is_sph = hit.prim >= T
    tri_id = torch.clamp(hit.prim, 0, T - 1).long()
    sph_id = torch.clamp(hit.prim - T, 0, scene.sph_center.shape[0] - 1).long()
    p = o + hit.t[:, None] * d
    ng_t = scene.tri_ng[tri_id]
    ns_tri = scene.tri_ns[tri_id]
    b0 = 1.0 - hit.b1 - hit.b2
    ns_t = (b0[:, None] * ns_tri[:, 0] + hit.b1[:, None] * ns_tri[:, 1]
            + hit.b2[:, None] * ns_tri[:, 2])
    ns_len = vm.length(ns_t)
    ns_t = torch.where((ns_len > 1e-8)[:, None],
                       ns_t / torch.clamp(ns_len, min=1e-8)[:, None], ng_t)
    uv_tri = scene.tri_uv[tri_id]
    uv_t = (b0[:, None] * uv_tri[:, 0] + hit.b1[:, None] * uv_tri[:, 1]
            + hit.b2[:, None] * uv_tri[:, 2])
    mat_t = scene.tri_mat[tri_id]
    light_t = scene.tri_light[tri_id]

    ctr = scene.sph_center[sph_id]
    ng_s = vm.normalize(p - ctr)
    uv_s = torch.stack([vm.spherical_phi(ng_s) / (2 * math.pi),
                        vm.spherical_theta(ng_s) / math.pi], dim=-1)
    mat_s = scene.sph_mat[sph_id]
    light_s = scene.sph_light[sph_id]
    is3 = is_sph[:, None]
    return Interaction(
        p=p, ng=torch.where(is3, ng_s, ng_t), ns=torch.where(is3, ng_s, ns_t),
        uv=torch.where(is3, uv_s, uv_t), wo=-d,
        mat=torch.where(is_sph, mat_s, mat_t),
        light=torch.where(is_sph, light_s, light_t), valid=hit.valid)
