"""Binned-SAH BVH build (host-side) -> flat device arrays.

Reimplements the behavior of the reference's BVHAccel SAH build + flatten
(ref: src/accelerators/bvh.cpp:184-236 recursiveBuild, :640 flattenBVHTree)
with vectorized numpy binning.  Output layout mirrors LinearBVHNode
(bvh.cpp:95): depth-first order, first child at i+1, second child index
stored — the layout the wavefront traversal kernels consume.

A C++ builder (native/bvh_builder.cpp) accelerates this for large scenes;
it runs whenever ``g++`` is on the PATH, and this numpy path otherwise,
with identical output semantics.  The log says which one ran.  The
port's own copy of the JAX package's ``ops/bvh.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import log

N_BUCKETS = 12
MAX_LEAF = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray    # (M,3) f32
    node_max: np.ndarray    # (M,3) f32
    node_right: np.ndarray  # (M,) i32: interior -> 2nd child; leaf -> prim offset
    node_count: np.ndarray  # (M,) i32: 0 interior, else nprims
    node_axis: np.ndarray   # (M,) i32 split axis
    prim_order: np.ndarray  # (T,) permutation old->new ordering
    max_depth: int


def build_bvh(tri_p: np.ndarray, use_native: bool = True) -> FlatBVH:
    """tri_p: (T, 3, 3) triangle vertices (world space)."""
    T = tri_p.shape[0]
    if T == 0:
        return FlatBVH(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.int32), np.zeros(0, np.int64), 1,
        )
    if use_native:
        from ..native import bvh_native
        if bvh_native.available():
            log.info(f"BVH build of {T} triangles: native C++ builder")
            return bvh_native.build(tri_p)
        log.info(f"BVH build of {T} triangles: numpy builder (no g++ on "
                 "the PATH for the native one)")
    lo = tri_p.min(axis=1)  # (T,3)
    hi = tri_p.max(axis=1)
    centroid = 0.5 * (lo + hi)

    # preallocated output (2T-1 nodes worst case)
    cap = max(2 * T, 2)
    n_min = np.empty((cap, 3), np.float64)
    n_max = np.empty((cap, 3), np.float64)
    n_right = np.zeros(cap, np.int64)
    n_count = np.zeros(cap, np.int64)
    n_axis = np.zeros(cap, np.int64)
    order = np.arange(T)

    node_ptr = 0
    max_depth = 0

    # stack entries: (start, end, depth, parent_slot or -1)
    stack = [(0, T, 0, -1)]
    while stack:
        start, end, depth, parent_slot = stack.pop()
        idx = node_ptr
        node_ptr += 1
        if parent_slot >= 0:
            n_right[parent_slot] = idx
        max_depth = max(max_depth, depth)
        ids = order[start:end]
        b_lo = lo[ids].min(axis=0)
        b_hi = hi[ids].max(axis=0)
        n_min[idx] = b_lo
        n_max[idx] = b_hi
        n = end - start

        if n <= 1:
            n_right[idx] = start
            n_count[idx] = n
            continue

        c = centroid[ids]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        ext = c_hi - c_lo
        axis = int(np.argmax(ext))
        n_axis[idx] = axis
        if ext[axis] < 1e-12:
            # degenerate: all centroids equal -> leaf (or median split if huge)
            if n <= MAX_LEAF * 4:
                n_right[idx] = start
                n_count[idx] = n
                continue
            mid = start + n // 2
        else:
            # binned SAH (ref: bvh.cpp:268-334)
            rel = (c[:, axis] - c_lo[axis]) / ext[axis]
            b = np.minimum((rel * N_BUCKETS).astype(np.int64), N_BUCKETS - 1)
            # per-bucket bounds + counts
            cnt = np.bincount(b, minlength=N_BUCKETS)
            bl = np.full((N_BUCKETS, 3), np.inf)
            bh = np.full((N_BUCKETS, 3), -np.inf)
            for k in range(3):
                np.minimum.at(bl[:, k], b, lo[ids][:, k])
                np.maximum.at(bh[:, k], b, hi[ids][:, k])
            # prefix/suffix areas
            def _acc_area(lo_a, hi_a, counts, rev=False):
                sl = slice(None, None, -1) if rev else slice(None)
                l = np.minimum.accumulate(lo_a[sl], axis=0)
                h = np.maximum.accumulate(hi_a[sl], axis=0)
                cc = np.cumsum(counts[sl])
                d = np.maximum(h - l, 0.0)
                area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])
                if rev:
                    return area[::-1], cc[::-1]
                return area, cc

            a_fwd, c_fwd = _acc_area(bl, bh, cnt)
            a_bwd, c_bwd = _acc_area(bl, bh, cnt, rev=True)
            d0 = np.maximum(b_hi - b_lo, 0.0)
            total_area = 2.0 * (d0[0] * d0[1] + d0[1] * d0[2] + d0[2] * d0[0])
            total_area = max(total_area, 1e-20)
            # split after bucket i (i = 0..N_BUCKETS-2)
            cost = TRAVERSAL_COST + (
                a_fwd[:-1] * c_fwd[:-1] + a_bwd[1:] * c_bwd[1:]
            ) * (INTERSECT_COST / total_area)
            best = int(np.argmin(cost))
            leaf_cost = INTERSECT_COST * n
            if n <= MAX_LEAF and leaf_cost <= cost[best]:
                n_right[idx] = start
                n_count[idx] = n
                continue
            mask = b <= best
            if not mask.any() or mask.all():
                mid = start + n // 2
                sel = np.argsort(c[:, axis], kind="stable")
                order[start:end] = ids[sel]
            else:
                sel = np.argsort(~mask, kind="stable")  # left partition first
                order[start:end] = ids[sel]
                mid = start + int(mask.sum())

        # first child is emitted immediately after (depth-first): push right
        # first so left pops next; left is implicitly at idx+1 (no patch).
        n_count[idx] = 0
        stack.append((mid, end, depth + 1, idx))   # right — slot patched
        stack.append((start, mid, depth + 1, -1))  # left  — implicit i+1

    m = node_ptr
    return FlatBVH(
        node_min=n_min[:m].astype(np.float32),
        node_max=n_max[:m].astype(np.float32),
        node_right=n_right[:m].astype(np.int32),
        node_count=n_count[:m].astype(np.int32),
        node_axis=n_axis[:m].astype(np.int32),
        prim_order=order,
        max_depth=max_depth,
    )
