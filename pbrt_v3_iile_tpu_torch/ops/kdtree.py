"""kd-tree aggregate (port of ``ops/kdtree.py``): the host build and the
plain PyTorch walker.

``build_kdtree`` is the reference's host SAH build (kdtreeaccel.cpp's
cost model: isect 80, traversal 1, empty bonus 0.5, edge candidates on
the largest axis first, the bad-refine cutoff), a copy of the JAX
package's, so its arrays are bit-equal to the reference's.
``intersect_kd_plain`` is the torch form of the reference's
``intersect_kd`` walker with the same per-step semantics: the entry clip
against the world bounds (tmax * 1.0000004), the early out ``smin <= t``,
pbrt's ordered near/far test ("near only" wins when tplane <= 0), the
push of (second child, tplane, smax), the leaf's triangles through
``kd_prims`` in order, and any-hit stopping after the leaf that found a
hit.  It is the plain version of the kd-tree kernel (``ops/kd_kernel.py``,
K3), which must match it bit for bit.

One fault of the reference is not copied: its walker tests only the
first MAX_PRIMS (8) triangles of a leaf, but the build makes longer
leaves (at the depth limit and after three bad refines: on atrium 3,094
of 32,221 leaves, up to 115 triangles, 30,633 references never tested),
so 0.15% of atrium's primary rays miss the triangle they hit.  The port
tests every triangle of a leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .intersect import Hit, _moller

ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5
MAX_PRIMS = 8      # the build's leaf budget (and the reference walker's
                   # unroll width: it tests a longer leaf's first 8 only)
STACK_DEPTH = 48


@dataclass
class KdTree:
    split: np.ndarray    # (K,) f32 split plane (leaf: unused)
    meta: np.ndarray     # (K,) i32: low 2 bits axis, 3 = leaf; leaf: count << 2
    offset: np.ndarray   # (K,) i32: interior = above child; leaf = into prims
    prims: np.ndarray    # (P,) i32 triangle ids
    bounds: np.ndarray   # (2,3) f32 world bounds


def build_kdtree(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 max_prims: int = MAX_PRIMS) -> KdTree:
    """Host SAH build over the triangles (p0, p0 + e1, p0 + e2)."""
    T = p0.shape[0]
    v0, v1, v2 = p0, p0 + e1, p0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    wb_lo = lo.min(axis=0) if T else np.zeros(3)
    wb_hi = hi.max(axis=0) if T else np.ones(3)
    max_depth = int(round(8 + 1.3 * np.log2(max(T, 1)))) if T else 1

    split_l, meta_l, offset_l = [], [], []
    prim_out = []

    def make_leaf(idx):
        node = len(split_l)
        split_l.append(0.0)
        meta_l.append(3 | (len(idx) << 2))
        offset_l.append(len(prim_out))
        prim_out.extend(int(i) for i in idx)
        return node

    def rec(idx, nb_lo, nb_hi, depth, bad_refines):
        if len(idx) <= max_prims or depth == 0:
            return make_leaf(idx)
        d = nb_hi - nb_lo
        inv_sa = 1.0 / max(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]),
                           1e-30)
        old_cost = ISECT_COST * len(idx)
        best = (None, None, np.inf)  # (axis, split, cost)
        axes = np.argsort(-d)        # the largest extent first
        for axis in axes:
            elo = lo[idx, axis]
            ehi = hi[idx, axis]
            # edge events: (pos, is_start)
            pos = np.concatenate([elo, ehi])
            typ = np.concatenate([np.zeros(len(idx)), np.ones(len(idx))])
            order = np.lexsort((typ, pos))
            pos, typ = pos[order], typ[order]
            n_below = np.cumsum(typ == 0)
            n_above = len(idx) - np.cumsum(typ == 1)
            o1, o2 = (axis + 1) % 3, (axis + 2) % 3
            inside = (pos > nb_lo[axis]) & (pos < nb_hi[axis])
            below = np.where(typ == 0, n_below - 1, n_below)
            above = n_above
            pb = np.where(inside,
                          2.0 * (d[o1] * d[o2] + (pos - nb_lo[axis])
                                 * (d[o1] + d[o2])) * inv_sa, 0.0)
            pa = np.where(inside,
                          2.0 * (d[o1] * d[o2] + (nb_hi[axis] - pos)
                                 * (d[o1] + d[o2])) * inv_sa, 0.0)
            eb = np.where((below == 0) | (above == 0), EMPTY_BONUS, 0.0)
            cost = TRAV_COST + ISECT_COST * (1.0 - eb) * (pb * below
                                                          + pa * above)
            cost = np.where(inside, cost, np.inf)
            if cost.size:
                k = int(np.argmin(cost))
                if cost[k] < best[2]:
                    best = (int(axis), float(pos[k]), float(cost[k]))
            if best[0] is not None:
                break  # the largest-extent axis gave a candidate
        axis, split, cost = best
        if axis is None:
            return make_leaf(idx)
        if cost > old_cost:
            bad_refines += 1
        if (cost > 4.0 * old_cost and len(idx) < 16) or bad_refines == 3:
            return make_leaf(idx)
        lmask = lo[idx, axis] < split
        rmask = hi[idx, axis] > split
        li = idx[lmask | (~lmask & ~rmask)]  # flat prims on the plane: below
        ri = idx[rmask]
        node = len(split_l)
        split_l.append(split)
        meta_l.append(axis)
        offset_l.append(0)  # patched once the below subtree is built
        b_hi = nb_hi.copy()
        b_hi[axis] = split
        rec(li, nb_lo, b_hi, depth - 1, bad_refines)
        offset_l[node] = len(split_l)
        b_lo = nb_lo.copy()
        b_lo[axis] = split
        rec(ri, b_lo, nb_hi, depth - 1, bad_refines)
        return node

    if T:
        rec(np.arange(T), wb_lo.copy(), wb_hi.copy(), max_depth, 0)
    else:
        make_leaf(np.zeros(0, np.int64))

    return KdTree(
        split=np.asarray(split_l, np.float32),
        meta=np.asarray(meta_l, np.int32),
        offset=np.asarray(offset_l, np.int32),
        prims=np.asarray(prim_out if prim_out else [0], np.int32),
        bounds=np.stack([wb_lo, wb_hi]).astype(np.float32),
    )


def kd_leaves(p0, e1, e2) -> dict:
    """The kd-tree of the (BVH-ordered) triangles as device-scene leaves."""
    kd = build_kdtree(p0, e1, e2)
    return dict(kd_split=kd.split, kd_meta=kd.meta, kd_offset=kd.offset,
                kd_prims=kd.prims, kd_bounds=kd.bounds)


def kd_tris_np(prims, tris_packed) -> np.ndarray:
    """The kd-tree kernel's triangles in leaf order: row i is triangle
    prims[i] of ``tris_packed`` (p0, e1, e2), with its prim id in column 9
    as int32 bits, so that a leaf's tests read their rows contiguously and
    follow no index (``csrc/kd_traverse.cu``).  (P, 12) f32."""
    prims = np.asarray(prims, np.int32)
    rows = np.zeros((prims.shape[0], 12), np.float32)
    rows[:, 0:9] = np.asarray(tris_packed, np.float32)[prims, 0:9]
    rows.view(np.int32)[:, 9] = prims
    return rows


def placeholder_leaves() -> dict:
    """The reference's kd leaves of a scene built without a kd-tree: one
    empty leaf with zero bounds."""
    return dict(kd_split=np.zeros(1, np.float32),
                kd_meta=np.full(1, 3, np.int32),
                kd_offset=np.zeros(1, np.int32),
                kd_prims=np.zeros(1, np.int32),
                kd_bounds=np.zeros((2, 3), np.float32))


def _inv_dir(d):
    return torch.where(torch.abs(d) > 1e-12,
                       1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.where(d >= 0, 1e30, -1e30))


def intersect_kd_plain(scene, o, d, t_max, any_hit: bool = False,
                       work: dict = None) -> Hit:
    """Closest-hit (or any-hit) against the scene's kd-tree.  Every step,
    each live ray visits one node; only live rays are gathered (the
    per-ray results are the reference walker's, which steps every ray
    each iteration).  work: a dict to which the node visits ("nodes"), of
    them the leaf visits that test ("leaves") and the visits the early out
    culls ("culled"), and the triangle tests ("tris") are added."""
    N = o.shape[0]
    dev = o.device
    inv_d = _inv_dir(d)
    blo, bhi = scene.kd_bounds[0][None, :], scene.kd_bounds[1][None, :]
    tlo = (blo - o) * inv_d
    thi = (bhi - o) * inv_d
    tmin0 = torch.clamp(torch.amax(torch.minimum(tlo, thi), dim=-1), min=0.0)
    tmax0 = torch.minimum(torch.amin(torch.maximum(tlo, thi), dim=-1)
                          * 1.0000004, t_max)
    node = torch.where(tmin0 <= tmax0, 0, -1).to(torch.int64)
    smin, smax = tmin0, tmax0
    st_n = torch.zeros((N, STACK_DEPTH), dtype=torch.int64, device=dev)
    st_lo = torch.zeros((N, STACK_DEPTH), dtype=torch.float32, device=dev)
    st_hi = torch.zeros((N, STACK_DEPTH), dtype=torch.float32, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    t = t_max.clone()
    prim = torch.full((N,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(N, dtype=torch.float32, device=dev)
    b2 = torch.zeros(N, dtype=torch.float32, device=dev)
    P = scene.kd_prims.shape[0]
    tris = scene.tris_packed
    idx = torch.nonzero(node >= 0)[:, 0]
    while idx.numel() > 0:
        n = idx.numel()
        if work is not None:
            work["nodes"] = work.get("nodes", 0) + n
        nid = node[idx]
        meta = scene.kd_meta[nid].long()
        axis = meta & 3
        is_leaf = axis == 3
        count = meta >> 2
        off = scene.kd_offset[nid].long()
        split = scene.kd_split[nid]
        oo, dd, ii = o[idx], d[idx], inv_d[idx]
        tt, pp, bb1, bb2 = t[idx], prim[idx], b1[idx], b2[idx]
        lo_, hi_ = smin[idx], smax[idx]
        # the early out: the closest hit is already nearer than this node
        active = lo_ <= tt
        if work is not None:
            work["leaves"] = work.get("leaves", 0) + int((active & is_leaf).sum())
            work["culled"] = work.get("culled", 0) + int((~active).sum())
        # a leaf's triangles, all tested at once: the first of the least t
        # below the ray's t is the in-order tests' result (each test needs
        # t' < the t the earlier ones left)
        lr = torch.nonzero(active & is_leaf)[:, 0]
        if lr.numel():
            cnt = count[lr]
            ray = torch.repeat_interleave(lr, cnt)
            start = torch.cumsum(cnt, 0) - cnt
            k = (torch.arange(ray.numel(), device=dev)
                 - torch.repeat_interleave(start, cnt))
            if work is not None:
                work["tris"] = work.get("tris", 0) + ray.numel()
            pid = scene.kd_prims[torch.clamp(off[ray] + k, 0, P - 1)].long()
            tr = tris[pid]
            ok, tk, uk, vk = _moller(oo[ray], dd[ray], tr[:, 0:3], tr[:, 3:6],
                                     tr[:, 6:9], tt[ray])
            tk = torch.where(ok, tk, math.inf)
            t_best = torch.full_like(tt, math.inf).scatter_reduce(
                0, ray, tk, "amin")
            first = ok & (tk == t_best[ray])
            kmin = torch.full_like(nid, 1 << 30).scatter_reduce(
                0, ray[first], k[first], "amin")
            sel = torch.nonzero(first & (k == kmin[ray]))[:, 0]
            r = ray[sel]
            tt[r], pp[r], bb1[r], bb2[r] = tk[sel], pid[sel], uk[sel], vk[sel]
        # interior: the plane test picks the near child, pushes the far
        interior = active & ~is_leaf
        ax = torch.clamp(axis, 0, 2)[:, None]
        o_ax = oo.gather(1, ax)[:, 0]
        i_ax = ii.gather(1, ax)[:, 0]
        d_ax = dd.gather(1, ax)[:, 0]
        tplane = (split - o_ax) * i_ax
        below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0))
        first = torch.where(below_first, nid + 1, off)
        second = torch.where(below_first, off, nid + 1)
        # pbrt's ordered test: "near only" wins when tplane <= 0
        only_near = (tplane > hi_) | (tplane <= 0.0)
        only_far = (tplane < lo_) & ~only_near
        both = interior & ~only_near & ~only_far
        s_ = sp[idx]
        push = torch.clamp(s_, max=STACK_DEPTH - 1)[:, None]
        rn, rlo, rhi = st_n[idx], st_lo[idx], st_hi[idx]
        for rows, v in ((rn, second), (rlo, tplane), (rhi, hi_)):
            keep = rows.gather(1, push)[:, 0]
            rows.scatter_(1, push, torch.where(both, v, keep)[:, None])
        s_ = torch.where(both, push[:, 0] + 1, s_)
        # a leaf, or a node culled by the early out, pops
        pop = ~interior & (s_ > 0)
        pos = torch.clamp(s_ - 1, min=0)[:, None]
        pn = rn.gather(1, pos)[:, 0]
        plo = rlo.gather(1, pos)[:, 0]
        phi = rhi.gather(1, pos)[:, 0]
        nxt = torch.where(interior, torch.where(only_far, second, first),
                          torch.where(pop, pn, torch.full_like(pn, -1)))
        lo_ = torch.where(pop, plo, lo_)
        hi_ = torch.where(interior, torch.where(both, tplane, hi_),
                          torch.where(pop, phi, hi_))
        s_ = torch.where(pop, pos[:, 0], s_)
        if any_hit:
            nxt = torch.where(pp >= 0, torch.full_like(nxt, -1), nxt)
        node[idx], sp[idx], smin[idx], smax[idx] = nxt, s_, lo_, hi_
        st_n[idx], st_lo[idx], st_hi[idx] = rn, rlo, rhi
        t[idx], prim[idx], b1[idx], b2[idx] = tt, pp, bb1, bb2
        idx = idx[nxt >= 0]
    prim = prim.to(torch.int32)
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
