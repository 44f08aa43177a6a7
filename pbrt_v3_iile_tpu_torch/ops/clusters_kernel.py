"""Fused cluster traversal (K1): tables, wrapper of ``csrc/cluster_traverse.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``pbrt_v3_iile_tpu/ops/clusters_pallas.py``
(``_traverse_group_kernel``, wrapper ``intersect_clusters_fused``); see
the CUDA source for the design and what bounds it on the H100.  Per
wave: coherence sort (dead rays last, skipped when presorted) -> exact
per-ray cull per 64-ray group -> one stable sort of the candidates by
entry distance -> the kernel -> barycentrics from a 2x2 solve -> the
overflow groups (more than max_candidates clusters) through the BVH
kernel.  The overflow branch is a Python ``if`` on ``overflow.any()``,
one host sync per wave.

On CPU tensors the kernel step runs the plain version, a dense per-group
evaluation of the same candidate lists; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import clusters as cluster_lib
from .intersect import Hit

C = 128          # triangles per cluster
NF = 16          # ray feature floats (10 used)
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
# the kernel step: CUDA launch and plain version
# ---------------------------------------------------------------------------

def _lib():
    from .. import _build

    fn = _build.load("cluster_traverse").cluster_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def traverse_groups_cuda(feat, cand, cpk, ctn, ncand, rays, t_max,
                         any_hit: bool = False):
    """Launch K1: one block per 64-ray group.  cand/cpk (Gn,MAXC) i32,
    ctn (Gn,MAXC) f32, ncand (Gn,) i32, rays (Gn*64,16) f32, t_max
    (Gn*64,) f32 -> (t, prim) of shape (Gn*64,)."""
    from .. import _build

    global LAUNCHES
    Gn, maxc = cand.shape
    N = Gn * G_DEFAULT
    dev = rays.device
    _build.check_args(dev, (
        ("feat", feat, torch.float32, (feat.shape[0], NRS, C)),
        ("cand", cand, torch.int32, (Gn, maxc)),
        ("cpk", cpk, torch.int32, (Gn, maxc)),
        ("ctn", ctn, torch.float32, (Gn, maxc)),
        ("ncand", ncand, torch.int32, (Gn,)),
        ("rays", rays, torch.float32, (N, NF)),
        ("t_max", t_max, torch.float32, (N,))))
    t = torch.empty(N, dtype=torch.float32, device=dev)
    prim = torch.empty(N, dtype=torch.int32, device=dev)
    if Gn == 0:
        return t, prim
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feat.data_ptr(), cand.data_ptr(), cpk.data_ptr(),
                 ctn.data_ptr(), ncand.data_ptr(), rays.data_ptr(),
                 t_max.data_ptr(), t.data_ptr(), prim.data_ptr(), Gn, maxc,
                 int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"cluster_traverse launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, prim


def traverse_groups_plain(feat, cand, cpk, ctn, ncand, rays, t_max,
                          any_hit: bool = False, chunk: int = 8):
    """Plain PyTorch version of K1: every ray against every triangle of
    its group's first ncand candidates, densely (chunks of groups).  The
    kernel's early break is exact, so the closest hit is the same; for
    any-hit the kernel may stop at any hit, so only validity is shared."""
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


def traverse_groups(feat, cand, cpk, ctn, ncand, rays, t_max,
                    any_hit: bool = False):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if rays.device.type == "cuda":
        return traverse_groups_cuda(feat, cand, cpk, ctn, ncand, rays, t_max,
                                    any_hit)
    return traverse_groups_plain(feat, cand, cpk, ctn, ncand, rays, t_max,
                                 any_hit)


# ---------------------------------------------------------------------------
# the wave: sort, cull, candidate tables, kernel, barycentrics, overflow
# ---------------------------------------------------------------------------

def candidate_tables(cp, os_, ds_, ts_, max_candidates: int = MAXC_DEFAULT):
    """Per-group candidate lists in entry-distance order.

    Returns (cand, cpk, ctn, ncand, n_cand): cand/cpk/ctn (Gn, MAXC) with
    cpk = tri_off*256 + tri_cnt (0 on empty slots), ncand = min(n_cand,
    MAXC), n_cand the full per-group candidate count."""
    group = G_DEFAULT
    Np = os_.shape[0]
    Gn = Np // group
    K = cp.aabb_min.shape[0]
    MAXC = min(max_candidates, ((K + NB - 1) // NB) * NB)
    MAXC = ((MAXC + NB - 1) // NB) * NB
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
    """(Np,3) rays -> (Np,16) kernel features [d, o x d, -o, 1, 0...]."""
    r6, r8 = cluster_lib.ray_features(os_, ds_)
    pad = torch.zeros((os_.shape[0], NF - 10), dtype=torch.float32,
                      device=os_.device)
    return torch.cat([r6, r8[:, :4], pad], dim=1).contiguous()


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
    ``fallback(o, d, t_alive)``.  presorted: rays already arrive
    coherence-sorted with dead rays last (no sort, no unsort).  Groups
    are 64 rays, the kernel's block size."""
    N = o.shape[0]
    G = G_DEFAULT
    dev = o.device
    pad = (-N) % G
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=dev)])
        d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]], dtype=d.dtype,
                                       device=dev).expand(pad, 3)])
        t_max = torch.cat([t_max, torch.full((pad,), -1.0, dtype=t_max.dtype,
                                             device=dev)])
    Np = N + pad
    Gn = Np // G
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

    cand, cpk, ctn, ncand, n_cand = candidate_tables(cp, os_, ds_, ts_,
                                                     max_candidates)
    MAXC = cand.shape[1]
    rays = ray_table(os_, ds_)
    t, prim = traverse_groups(cp.feat, cand, cpk, ctn, ncand, rays,
                              ts_.contiguous(), any_hit=any_hit)
    valid = prim >= 0
    if tri_p0 is not None:
        b1, b2 = _barycentrics(os_, ds_, t, prim, valid, tri_p0, tri_e1,
                               tri_e2)
    else:
        b1 = torch.zeros(Np, device=dev)
        b2 = torch.zeros(Np, device=dev)

    overflow = n_cand > MAXC
    if fallback is not None and bool(overflow.any()):
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
