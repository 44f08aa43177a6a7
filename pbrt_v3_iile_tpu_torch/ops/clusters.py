"""Cluster cuts, coherence keys and the per-ray cull (port of the parts
of ``ops/clusters.py`` the fused kernel uses).

Triangles are grouped into clusters cut from BVH subtrees; a 64-ray
group is tested only against the clusters that some live member ray
enters (``per_ray_cull``), in entry-distance order.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

CLUSTER_SIZE = 64
CALLS = 0  # per_ray_cull calls since import (the CUDA main path makes none)


def _subtree_ranges(flat, max_tris=CLUSTER_SIZE):
    """Cut the binary BVH into disjoint subtrees of <= max_tris prims.
    Returns a list of (prim_offset, prim_count) in BVH prim order."""
    M = flat.node_min.shape[0]
    lo = np.full(M, np.iinfo(np.int32).max, np.int64)
    hi = np.full(M, -1, np.int64)
    first_child = np.arange(M) + 1
    for i in range(M - 1, -1, -1):  # children come after their parent
        if flat.node_count[i] > 0:
            lo[i] = flat.node_right[i]
            hi[i] = flat.node_right[i] + flat.node_count[i]
        else:
            l, r = first_child[i], flat.node_right[i]
            lo[i] = min(lo[l], lo[r])
            hi[i] = max(hi[l], hi[r])

    out = []

    def cut(i):
        if hi[i] - lo[i] <= max_tris or flat.node_count[i] > 0:
            out.append((int(lo[i]), int(hi[i] - lo[i])))
            return
        cut(first_child[i])
        cut(int(flat.node_right[i]))

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, int(flat.max_depth) * 4 + 100))
    try:
        cut(0)
    finally:
        sys.setrecursionlimit(old)
    return out


def sort_key6(o, d, world_min, world_max, obits: int = 8, dbits: int = 4,
              o_lead: int = 3):
    """6D coherence key: octant (3 bits), then o_lead origin Morton levels,
    then alternating direction / origin levels.  Stays below 2**31."""
    i32 = torch.int32
    oc = ((d[:, 0] < 0).to(i32) + 2 * (d[:, 1] < 0).to(i32)
          + 4 * (d[:, 2] < 0).to(i32))
    ext = torch.clamp(world_max - world_min, min=1e-9)
    qo = torch.clamp(((o - world_min[None]) / ext[None] * (1 << obits))
                     .to(i32), 0, (1 << obits) - 1)
    qd = torch.clamp((torch.abs(d) * (1 << dbits)).to(i32), 0,
                     (1 << dbits) - 1)
    key = oc
    oi, di = obits, dbits
    sched = ["o"] * o_lead
    for i in range(max(obits - o_lead, dbits)):
        if i < dbits:
            sched.append("d")
        if i < obits - o_lead:
            sched.append("o")
    for s in sched:
        if s == "o":
            oi -= 1
            q, sh = qo, oi
        else:
            di -= 1
            q, sh = qd, di
        b = (((q[:, 0] >> sh) & 1) | (((q[:, 1] >> sh) & 1) << 1)
             | (((q[:, 2] >> sh) & 1) << 2))
        key = (key << 3) | b
    return key


def per_ray_cull(o, d, t_alive, amin, amax, group, chunk_groups=64):
    """Exact per-ray slab cull, reduced per group.

    o, d: (N,3) sorted rays, N divisible by ``group``.  Returns
    (need (Gn,K) bool, tnear (Gn,K) f32): need[g,k] iff some live ray of
    group g enters cluster k's AABB within [0, t_max]; tnear is the least
    entry distance over those rays.  Chunked over groups so that the
    (B, G, K) intermediates stay bounded.  The plain version of the CUDA
    cluster kernel's cull; on CUDA the main path never calls it."""
    global CALLS
    CALLS += 1
    G = group
    N = o.shape[0]
    Gn = N // G
    K = amin.shape[0]
    B = min(chunk_groups, Gn)
    og = o.reshape(Gn, G, 3)
    dg = d.reshape(Gn, G, 3)
    tg = t_alive.reshape(Gn, G)
    big = 3.0e38
    needs, tnears = [], []
    for s in range(0, Gn, B):
        oo, dd, tt = og[s:s + B], dg[s:s + B], tg[s:s + B]
        inv = torch.where(torch.abs(dd) > 1e-12,
                          1.0 / torch.where(dd == 0, torch.ones_like(dd), dd),
                          torch.where(dd >= 0, 1e30, -1e30))
        live = tt > 0.0
        b = oo.shape[0]
        tn = torch.zeros((b, G, K), dtype=torch.float32, device=o.device)
        tf = torch.full((b, G, K), big, dtype=torch.float32, device=o.device)
        for ax in range(3):
            lo = (amin[None, None, :, ax] - oo[:, :, None, ax]) \
                * inv[:, :, None, ax]
            hi = (amax[None, None, :, ax] - oo[:, :, None, ax]) \
                * inv[:, :, None, ax]
            tn = torch.maximum(tn, torch.minimum(lo, hi))
            tf = torch.minimum(tf, torch.maximum(lo, hi))
        tf = tf * 1.0000004          # pbrt slab robustness (gamma(3))
        hit = ((tn <= tf) & (tf > 0.0) & (tn <= tt[:, :, None])
               & live[:, :, None])
        needs.append(torch.any(hit, dim=1))
        tnears.append(torch.amin(torch.where(hit, torch.clamp(tn, min=0.0),
                                             big), dim=1))
    return torch.cat(needs), torch.cat(tnears)
