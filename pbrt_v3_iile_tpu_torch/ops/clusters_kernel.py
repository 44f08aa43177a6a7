"""Fused cluster traversal (K1): wrapper of ``csrc/cluster_traverse.cu``,
its plain PyTorch version, and the wave around it.

Replaces the TPU kernel ``pbrt_v3_iile_tpu/ops/clusters_pallas.py``
(``_traverse_group_kernel``, wrapper ``intersect_clusters_fused``) and the
XLA cull that fed it (``ops/clusters.py::per_ray_cull``); see the CUDA
source for the design and what bounds it on the H100.  Per wave:
coherence sort (dead rays last, skipped when presorted) -> the kernel,
which per 64-ray group culls every cluster box exactly, orders the
group's candidates by (entry distance, cluster id) and traverses them ->
barycentrics from a 2x2 solve -> the overflow groups (more than
max_candidates clusters) through the BVH kernel.  The overflow branch is
a Python ``if`` on ``overflow.any()``, one host sync per wave.

On CPU tensors the kernel step runs its plain version (``per_ray_cull``,
``candidate_tables`` and a dense per-group evaluation of the lists); on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import stats as statslib
from . import clusters as cluster_lib
from .intersect import Hit, _cross3

C = 128          # triangles per cluster
NF = 10          # ray feature floats [d, o x d, -o, 1]
NRS = 24         # packed feature rows per cluster (22 used)
NB = 4           # candidate lists are padded to a multiple of NB
G_DEFAULT = 64   # rays per group (the CUDA kernel's block size)
MAXC_DEFAULT = 192
BIG_T = 3.0e38

LAUNCHES = 0  # kernel launches (not plain-version calls) since import


def build_cluster_pack_np(flat, tri_p0, tri_e1, tri_e2,
                          max_tris: int = C) -> dict:
    """Host build of the cluster tables from the BVH and the BVH-ordered
    triangles (copy of the reference's ``build_cluster_pack``): returns
    numpy ``feat`` (K,24,128), ``tri_off``, ``tri_cnt``, ``aabb_min``,
    ``aabb_max``."""
    ranges = cluster_lib._subtree_ranges(flat, max_tris)
    K = len(ranges)
    off = np.asarray([r[0] for r in ranges], np.int32)
    cnt = np.asarray([r[1] for r in ranges], np.int32)
    order = np.argsort(off, kind="stable")
    off, cnt = off[order], cnt[order]
    T = int(cnt.sum())
    p0 = np.asarray(tri_p0, np.float64)[:T]
    e1 = np.asarray(tri_e1, np.float64)[:T]
    e2 = np.asarray(tri_e2, np.float64)[:T]
    p1 = p0 + e1
    p2 = p0 + e2
    n = np.cross(e1, e2)
    k_of = np.repeat(np.arange(K), cnt)
    j_of = np.arange(T) - off[k_of]
    feat = np.zeros((K, NRS, max_tris), np.float32)
    rows3 = np.arange(3)
    for q, (a, b) in enumerate(((p0, p1), (p1, p2), (p2, p0))):
        feat[k_of[:, None], q * 6 + rows3[None, :], j_of[:, None]] = \
            np.cross(a, b).astype(np.float32)
        feat[k_of[:, None], q * 6 + 3 + rows3[None, :], j_of[:, None]] = \
            (b - a).astype(np.float32)
    feat[k_of[:, None], 18 + rows3[None, :], j_of[:, None]] = n.astype(np.float32)
    feat[k_of, 21, j_of] = np.einsum("td,td->t", n, p0).astype(np.float32)
    v = np.stack([p0, p1, p2], 1)
    amin = np.minimum.reduceat(v.min(1), off)[:K].astype(np.float32)
    amax = np.maximum.reduceat(v.max(1), off)[:K].astype(np.float32)
    return dict(feat=feat, tri_off=off, tri_cnt=cnt, aabb_min=amin,
                aabb_max=amax)


# ---------------------------------------------------------------------------
# the kernel step: CUDA launch, plain version, and a model of its lists
# ---------------------------------------------------------------------------

def maxc_for(n_clusters: int, max_candidates: int = MAXC_DEFAULT) -> int:
    """Candidate-list capacity: min(max_candidates, K rounded up to NB),
    rounded up to NB.  A group with more candidates overflows."""
    maxc = min(max_candidates, ((n_clusters + NB - 1) // NB) * NB)
    return ((maxc + NB - 1) // NB) * NB


def _lib():
    from .. import _build

    fn = _build.load("cluster_traverse").cluster_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    return fn


def cluster_traverse_cuda(cp, o, d, t_max, maxc: int, any_hit: bool = False):
    """Launch K1: one block per 64-ray group culls, orders and traverses.

    cp: the ClusterPack; o, d (Np,3) and t_max (Np,) f32 coherence-sorted
    rays, Np a multiple of 64 -> (t (Np,) f32, prim (Np,) i32, n_cand
    (Gn,) i32).  n_cand is the group's full candidate count; a group with
    n_cand > maxc reports t = t_max, prim = -1 (the caller routes it to
    the BVH kernel)."""
    from .. import _build

    global LAUNCHES
    Np = o.shape[0]
    if Np % G_DEFAULT:
        raise ValueError(f"cluster_traverse: {Np} rays is not a multiple "
                         f"of the {G_DEFAULT}-ray group")
    Gn = Np // G_DEFAULT
    K = cp.feat.shape[0]
    dev = o.device
    _build.check_args(dev, (
        ("feat", cp.feat, torch.float32, (K, NRS, C)),
        ("aabb_min", cp.aabb_min, torch.float32, (K, 3)),
        ("aabb_max", cp.aabb_max, torch.float32, (K, 3)),
        ("tri_off", cp.tri_off, torch.int32, (K,)),
        ("tri_cnt", cp.tri_cnt, torch.int32, (K,)),
        ("o", o, torch.float32, (Np, 3)),
        ("d", d, torch.float32, (Np, 3)),
        ("t_max", t_max, torch.float32, (Np,))))
    if cp.feat.data_ptr() % 16:
        raise ValueError("feat: the kernel copies 16-byte runs; its data "
                         "must be 16-byte aligned")
    t = torch.empty(Np, dtype=torch.float32, device=dev)
    prim = torch.empty(Np, dtype=torch.int32, device=dev)
    n_cand = torch.empty(Gn, dtype=torch.int32, device=dev)
    if Gn == 0:
        return t, prim, n_cand
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cp.feat.data_ptr(), cp.aabb_min.data_ptr(),
                 cp.aabb_max.data_ptr(), cp.tri_off.data_ptr(),
                 cp.tri_cnt.data_ptr(), K, o.data_ptr(), d.data_ptr(),
                 t_max.data_ptr(), t.data_ptr(), prim.data_ptr(),
                 n_cand.data_ptr(), Gn, maxc, int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"cluster_traverse launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, prim, n_cand


def cluster_traverse_plain(cp, o, d, t_max, maxc: int, any_hit: bool = False):
    """Plain PyTorch version of K1 with the kernel's signature and result:
    the torch cull and candidate tables, then every ray against every
    triangle of its group's candidates, densely.  The kernel's early break
    is exact, so the closest hit is the same; for any-hit the kernel may
    stop at any hit, so only validity is shared."""
    cand, cpk, _, ncand, n_cand = candidate_tables(cp, o, d, t_max, maxc)
    t, prim = traverse_groups_plain(cp.feat, cand, cpk, ncand,
                                    ray_table(o, d), t_max)
    over = (n_cand > cand.shape[1]).repeat_interleave(G_DEFAULT)
    t = torch.where(over, t_max, t)
    prim = torch.where(over, -1, prim).to(torch.int32)
    return t, prim, n_cand.to(torch.int32)


def cluster_traverse(cp, o, d, t_max, maxc: int, any_hit: bool = False):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if o.device.type == "cuda":
        return cluster_traverse_cuda(cp, o, d, t_max, maxc, any_hit)
    return cluster_traverse_plain(cp, o, d, t_max, maxc, any_hit)


def traverse_groups_plain(feat, cand, cpk, ncand, rays, t_max,
                          chunk: int = 8):
    """Every ray against every triangle of its group's first ncand
    candidates (the tables of ``candidate_tables``), densely, in chunks
    of groups -> (t, prim)."""
    Gn, maxc = cand.shape
    G = G_DEFAULT
    r = rays.reshape(Gn, G, NF)
    tm = t_max.reshape(Gn, G)
    t_out, p_out = [], []
    lane = torch.arange(C, device=rays.device)
    slot = torch.arange(maxc, device=rays.device)
    for s in range(0, Gn, chunk):
        e = min(s + chunk, Gn)
        f = feat[cand[s:e].long()]                          # (b,maxc,24,C)
        rr = r[s:e]                                         # (b,G,16)
        cnt = torch.where(slot[None, :] < ncand[s:e, None], cpk[s:e] & 255, 0)
        off = cpk[s:e] >> 8

        def contract(row0, cols):
            acc = None
            for k, c in enumerate(cols):
                term = (rr[:, :, None, None, c]
                        * f[:, None, :, row0 + k, :])       # (b,G,maxc,C)
                acc = term if acc is None else acc + term
            return acc

        e6 = (0, 1, 2, 3, 4, 5)
        w0, w1, w2 = contract(0, e6), contract(6, e6), contract(12, e6)
        num = contract(18, (6, 7, 8, 9))
        sum_s = w0 + w1 + w2
        s_safe = torch.where(torch.abs(sum_s) > 1e-12, sum_s,
                             torch.where(sum_s >= 0, 1e-12, -1e-12))
        t = num / s_safe
        same = (w0 * w1 >= 0) & (w1 * w2 >= 0) & (w0 * w2 >= 0)
        tcap = torch.where(tm[s:e] > 0.0, tm[s:e], -BIG_T)  # dead rays: none
        ok = (same & (torch.abs(sum_s) > 1e-12) & (t > 1e-5)
              & (t < tcap[:, :, None, None])
              & (lane[None, None, None, :] < cnt[:, None, :, None]))
        tt = torch.where(ok, t, torch.full_like(t, BIG_T)).flatten(2)
        pid = (off[:, :, None] + lane[None, None, :]).flatten(1)  # (b,maxc*C)
        best = torch.amin(tt, dim=-1)                       # (b,G)
        hit = best < BIG_T * 0.5
        win = (tt == best[..., None]) & hit[..., None]
        pm = torch.amin(torch.where(win, pid[:, None, :], 1 << 30), dim=-1)
        t_out.append(torch.where(hit, best, tm[s:e]))
        p_out.append(torch.where(hit, pm, -1).to(torch.int32))
    return torch.cat(t_out).reshape(-1), torch.cat(p_out).reshape(-1)


def candidate_tables(cp, os_, ds_, ts_, max_candidates: int = MAXC_DEFAULT):
    """Per-group candidate lists in entry-distance order, built by torch
    ops (the plain version's; the kernel builds its own in shared memory).

    Returns (cand, cpk, ctn, ncand, n_cand): cand/cpk/ctn (Gn, MAXC) with
    cpk = tri_off*256 + tri_cnt (0 on empty slots), ncand = min(n_cand,
    MAXC), n_cand the full per-group candidate count."""
    group = G_DEFAULT
    Np = os_.shape[0]
    Gn = Np // group
    MAXC = maxc_for(cp.aabb_min.shape[0], max_candidates)
    chunk = 512 if os_.device.type == "cuda" else 64
    mask, tnear = cluster_lib.per_ray_cull(os_, ds_, ts_, cp.aabb_min,
                                           cp.aabb_max, group,
                                           chunk_groups=chunk)
    n_cand = mask.sum(dim=1)
    order_key = torch.where(mask, tnear, BIG_T)
    # lax.sort with payloads is stable: one stable sort + one gather each
    ctn, perm = torch.sort(order_key, dim=1, stable=True)
    packed_row = cp.tri_off * 256 + cp.tri_cnt                 # cnt <= C < 256
    cand = perm[:, :MAXC].to(torch.int32)
    packed = packed_row[perm[:, :MAXC]]
    ctn = ctn[:, :MAXC]
    padc = MAXC - ctn.shape[1]
    if padc > 0:
        cand = torch.cat([cand, cand.new_zeros((Gn, padc))], dim=1)
        ctn = torch.cat([ctn, ctn.new_full((Gn, padc), BIG_T)], dim=1)
        packed = torch.cat([packed, packed.new_zeros((Gn, padc))], dim=1)
    packed = torch.where(ctn < BIG_T, packed, 0).to(torch.int32)
    ncand = torch.clamp(n_cand, max=MAXC).to(torch.int32)
    return (cand.contiguous(), packed.contiguous(), ctn.contiguous(),
            ncand.contiguous(), n_cand)


def ray_table(os_, ds_):
    """(Np,3) rays -> (Np,10) features [d, o x d, -o, 1], the cross
    product with each product rounded, as the kernel computes it."""
    one = torch.ones((os_.shape[0], 1), dtype=torch.float32, device=os_.device)
    return torch.cat([ds_, _cross3(os_, ds_), -os_, one], dim=1)


def candidate_lists_model(cp, os_, ds_, ts_, maxc: int):
    """Per-group model of the kernel's list building, for the tests: the
    cull of each cluster box against the group's 64 rays with the
    kernel's arithmetic, compaction of the hits (the kernel appends them
    in an unspecified order; here in cluster order), truncation at maxc,
    and the rank of each entry by (tnear, cluster id).

    Returns (need (Gn,K) bool, tnear (Gn,K) f32 with 3e38 where not
    needed, lists: per group the ordered (tnear, cluster id) pairs or
    None for an overflowing group, n_cand (Gn,) i32)."""
    G = G_DEFAULT
    Gn = os_.shape[0] // G
    K = cp.aabb_min.shape[0]
    needs, tnears, lists, counts = [], [], [], []
    for g in range(Gn):
        o = os_[g * G:(g + 1) * G]
        d = ds_[g * G:(g + 1) * G]
        tm = ts_[g * G:(g + 1) * G]
        inv = torch.where(torch.abs(d) > 1e-12, torch.reciprocal(d),
                          torch.where(d >= 0, 1e30, -1e30))
        tm_eff = torch.where(tm > 0, tm, -BIG_T)
        tn = torch.zeros((G, K))
        tf = torch.full((G, K), BIG_T)
        for a in range(3):
            lo = (cp.aabb_min[None, :, a] - o[:, None, a]) * inv[:, None, a]
            hi = (cp.aabb_max[None, :, a] - o[:, None, a]) * inv[:, None, a]
            tn = torch.maximum(tn, torch.minimum(lo, hi))
            tf = torch.minimum(tf, torch.maximum(lo, hi))
        tf = tf * 1.0000004
        enter = (tn <= tf) & (tf > 0) & (tn <= tm_eff[:, None])
        need = enter.any(0)
        tnear = torch.where(enter, torch.clamp(tn, min=0.0), BIG_T).amin(0)
        needs.append(need)
        tnears.append(tnear)
        ids = torch.nonzero(need).flatten()              # compaction
        counts.append(int(ids.numel()))
        if ids.numel() > maxc:
            lists.append(None)                           # overflow
            continue
        tl = tnear[ids]
        before = ((tl[None, :] < tl[:, None])
                  | ((tl[None, :] == tl[:, None]) & (ids[None, :] < ids[:, None])))
        rank = before.sum(1)                             # rank sort
        order = torch.empty_like(ids)
        order[rank] = torch.arange(ids.numel())
        lists.append((tl[order], ids[order]))
    return (torch.stack(needs), torch.stack(tnears), lists,
            torch.tensor(counts, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the wave: sort, kernel, barycentrics, overflow
# ---------------------------------------------------------------------------

def _barycentrics(os_, ds_, t, prim, valid, tri_p0, tri_e1, tri_e2):
    """Post-hoc barycentrics: one row gather and a 2x2 solve."""
    pid = torch.clamp(prim, 0, tri_p0.shape[0] - 1).long()
    P0, E1, E2 = tri_p0[pid], tri_e1[pid], tri_e2[pid]
    q = os_ + t[:, None] * ds_ - P0
    a11 = torch.sum(E1 * E1, -1)
    a12 = torch.sum(E1 * E2, -1)
    a22 = torch.sum(E2 * E2, -1)
    q1 = torch.sum(E1 * q, -1)
    q2 = torch.sum(E2 * q, -1)
    det = a11 * a22 - a12 * a12
    inv = torch.where(torch.abs(det) > 1e-20,
                      1.0 / torch.where(det == 0, torch.ones_like(det), det),
                      torch.zeros_like(det))
    b1 = torch.clamp((a22 * q1 - a12 * q2) * inv, 0.0, 1.0)
    b2 = torch.clamp((a11 * q2 - a12 * q1) * inv, 0.0, 1.0)
    zero = torch.zeros_like(b1)
    return torch.where(valid, b1, zero), torch.where(valid, b2, zero)


def intersect_clusters_fused(cp, o, d, t_max, *, any_hit: bool = False,
                             max_candidates: int = MAXC_DEFAULT,
                             world_min=None, world_max=None, fallback=None,
                             tri_p0=None, tri_e1=None, tri_e2=None,
                             presorted: bool = False) -> Hit:
    """Full-scene closest-hit (or any-hit) through the fused cluster
    kernel.  Returns Hit in the original ray order with BVH-order
    triangle ids; groups with more than max_candidates candidates go to
    ``fallback(o, d, t_alive)`` (without one, such a group raises: the
    kernel leaves it unanswered).  presorted: rays already arrive
    coherence-sorted with dead rays last (no sort, no unsort).  Groups
    are 64 rays, the kernel's block."""
    N = o.shape[0]
    G = G_DEFAULT
    dev = o.device
    pad = (-N) % G
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=dev)])
        # a copy from pageable host memory: on the card the host waits for it
        with statslib.sync_point("k1_pad_direction"):
            d_pad = torch.tensor([[1.0, 0.0, 0.0]], dtype=d.dtype, device=dev)
        d = torch.cat([d, d_pad.expand(pad, 3)])
        t_max = torch.cat([t_max, torch.full((pad,), -1.0, dtype=t_max.dtype,
                                             device=dev)])
    Np = N + pad
    wmin = torch.amin(cp.aabb_min, 0) if world_min is None else world_min
    wmax = torch.amax(cp.aabb_max, 0) if world_max is None else world_max
    if presorted:
        os_, ds_, ts_ = o, d, t_max
        inv_perm = None
    else:
        key = cluster_lib.sort_key6(o, d, wmin, wmax)
        key = torch.where(t_max > 0.0, key, 0x7FFFFFFF)
        _, perm = torch.sort(key, stable=True)
        os_, ds_, ts_ = o[perm], d[perm], t_max[perm]
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(Np, device=dev)

    MAXC = maxc_for(cp.aabb_min.shape[0], max_candidates)
    t, prim, n_cand = cluster_traverse(cp, os_.contiguous(), ds_.contiguous(),
                                       ts_.contiguous(), MAXC, any_hit)
    valid = prim >= 0
    if tri_p0 is not None:
        b1, b2 = _barycentrics(os_, ds_, t, prim, valid, tri_p0, tri_e1,
                               tri_e2)
    else:
        b1 = torch.zeros(Np, device=dev)
        b2 = torch.zeros(Np, device=dev)

    overflow = n_cand > MAXC
    with statslib.sync_point("k1_overflow"):
        any_overflow = bool(overflow.any())
    if any_overflow:
        if fallback is None:
            raise ValueError("intersect_clusters_fused: groups overflow "
                             f"{MAXC} candidates and no fallback was given")
        ovr = overflow.repeat_interleave(G)
        t_fb = torch.where(ovr & (ts_ > 0), ts_, -1.0)
        fb = fallback(os_, ds_, t_fb)
        use = ovr & fb.valid
        miss_fb = ovr & ~fb.valid
        t = torch.where(use, fb.t, torch.where(miss_fb, ts_, t))
        prim = torch.where(use, fb.prim, torch.where(miss_fb, -1, prim))
        b1 = torch.where(use, fb.b1, b1)
        b2 = torch.where(use, fb.b2, b2)
        valid = torch.where(ovr, fb.valid, valid)

    if presorted:
        unp = lambda x: x[:N]
    else:
        unp = lambda x: x[inv_perm][:N]
    return Hit(t=unp(t), prim=unp(prim), b1=unp(b1), b2=unp(b2),
               valid=unp(valid))
