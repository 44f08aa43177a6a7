"""The chip's peaks and the least time of a kernel's work.

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W (67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM).  A kernel's least
time is the larger of its operations over the FLOP peak and its bytes
over the bandwidth peak, counted from what its inputs need.

K1, the fused cluster traversal, is counted as the repository's check of
the kernel counts it (a frozen copy, in plain torch): every live 64-ray
group tests every cluster box (CULL_OPS each, per ray), and each ray of a
group tests every triangle of the group's candidate clusters that the
kernel's exact break cannot skip, the first candidate and those whose
entry distance is below the group's largest final t (PLUCKER_OPS each).
Its bytes are the candidate clusters' packed rows read once, the boxes,
the rays and their results, and a word a group.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12      # float32, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM

CULL_OPS = 28      # slab test: per axis 2 sub, 2 mul, min, max, max, min; 4 more
PLUCKER_OPS = 50   # triangle: 3 x (6 mul + 5 add), 4 mul + 3 add, 2 add, 8 more
K1_GROUP = 64      # rays a group (the kernel's block)
K1_TRIS = 128      # triangle columns a cluster
K1_ROWS = 22       # used feature rows a cluster
BIG_T = 3.0e38


def bound(ops: float, nbytes: float):
    """-> (least seconds, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cull(o, d, t_max, amin, amax, chunk_groups: int = 512):
    """Per group, which cluster boxes some live ray enters within
    [0, t_max], and the least entry distance -> (need (Gn,K), tnear)."""
    G = K1_GROUP
    Gn = o.shape[0] // G
    K = amin.shape[0]
    og, dg, tg = o.reshape(Gn, G, 3), d.reshape(Gn, G, 3), t_max.reshape(Gn, G)
    needs, tnears = [], []
    for s in range(0, Gn, chunk_groups):
        oo, dd, tt = og[s:s + chunk_groups], dg[s:s + chunk_groups], tg[s:s + chunk_groups]
        inv = torch.where(torch.abs(dd) > 1e-12,
                          1.0 / torch.where(dd == 0, torch.ones_like(dd), dd),
                          torch.where(dd >= 0, 1e30, -1e30))
        b = oo.shape[0]
        tn = torch.zeros((b, G, K), dtype=torch.float32, device=o.device)
        tf = torch.full((b, G, K), BIG_T, dtype=torch.float32, device=o.device)
        for ax in range(3):
            lo = (amin[None, None, :, ax] - oo[:, :, None, ax]) * inv[:, :, None, ax]
            hi = (amax[None, None, :, ax] - oo[:, :, None, ax]) * inv[:, :, None, ax]
            tn = torch.maximum(tn, torch.minimum(lo, hi))
            tf = torch.minimum(tf, torch.maximum(lo, hi))
        tf = tf * 1.0000004
        hit = ((tn <= tf) & (tf > 0.0) & (tn <= tt[:, :, None])
               & (tt > 0.0)[:, :, None])
        needs.append(hit.any(1))
        tnears.append(torch.where(hit, torch.clamp(tn, min=0.0), BIG_T).amin(1))
    return torch.cat(needs), torch.cat(tnears)


def k1_work(aabb_min, aabb_max, tri_cnt, o, d, t_max, t_out, maxc: int) -> dict:
    """The work one K1 call needs: o, d, t_max the rays as the kernel got
    them (coherence-sorted, a multiple of 64), t_out the t it returned,
    maxc its candidate capacity -> dict(ops, bytes, slab_tests,
    triangles)."""
    G = K1_GROUP
    Np = o.shape[0]
    Gn = Np // G
    K = aabb_min.shape[0]
    need_c, tnear = _cull(o, d, t_max, aabb_min, aabb_max)
    n_cand = need_c.sum(1)
    ctn, perm = torch.sort(torch.where(need_c, tnear, BIG_T), dim=1, stable=True)
    ctn, perm = ctn[:, :maxc], perm[:, :maxc]
    cnt = torch.where(ctn < BIG_T, tri_cnt.to(torch.int64)[perm], 0)
    live = (t_max > 0).reshape(Gn, G)
    gmax = torch.where(live, t_out.reshape(Gn, G), -BIG_T).amax(1)
    slot = torch.arange(perm.shape[1], device=o.device)[None, :]
    need = ((slot < torch.clamp(n_cand, max=maxc)[:, None])
            & (n_cand <= maxc)[:, None]
            & ((ctn < gmax[:, None]) | (slot == 0)))
    tris = int((cnt * need).sum())
    slabs = int(live.any(1).sum()) * G * K
    ops = slabs * CULL_OPS + tris * G * PLUCKER_OPS
    nbytes = (int(torch.unique(perm[need]).numel()) * K1_ROWS * K1_TRIS * 4
              + K * (24 + 8) + Np * (28 + 8) + Gn * 4)
    return dict(ops=ops, bytes=nbytes, slab_tests=slabs, triangles=tris)
