"""BVH traversal (K2): the 4-wide BVH, its plain version and the wrapper of
``csrc/bvh_traverse.cu``.

Replaces the TPU packet kernel ``pbrt_v3_iile_tpu/ops/intersect_pallas.py``
(``_traverse_kernel``/``_traverse_packet``, wrapper ``intersect_bvh_pallas``).
The kernel walks a 4-wide BVH collapsed on the host from the binary
``FlatBVH`` (``build_bvh4_np``); see the source for its design.  On CPU
tensors ``intersect_bvh_kernel`` runs the binary walker
``ops/intersect.py::intersect_bvh`` (the JAX package's semantics, which the
CPU renders and goldens follow); on CUDA tensors it launches the kernel or
raises.  ``bvh_traverse_wide_plain`` is the kernel's own plain version:
the same wide nodes in the same order, which the kernel must match bit for
bit on the card (the tests and ``chip_smoke.py`` use it).

Closest hit: the least (t, prim) over the triangles of the visited leaves,
so an exact tie in t goes to the smaller BVH-order prim id (the binary
walker keeps the first it visits) and the order of one step's triangle
tests does not matter.  Per step a ray tests the 4 child boxes of one wide
node against [0, t] (the walker's slab test, bit for bit) and the
triangles of the hit leaf children, then takes the nearest hit inner child
by (tnear, slot) and pushes the others, far first, with their tnear; a
popped entry whose tnear is not below t is dropped.  The
walker's result can differ only by the tie rule and where a triangle's t
rounds below its box's tnear (the box is then culled or not depending on
the visiting order).  Any-hit stops after the first step that finds a hit,
with the least (t, prim) of that step's triangles.

It serves the ``bvh`` accel and the overflow groups of the fused cluster
kernel.  Its motion variant (a compile-time flag of the same kernel)
carries every traversal of a motion-blurred scene, with per-ray times, on
the tables of ``build_motion_split_np``: a BVH over the triangles that do
not move, walked with no lerp, then a small BVH over the moving ones for
the keyframe segment around the ray's time, whose triangles are lerped
between the segment's two sub-keyframes as the reference's walker lerps
them (``pbrt_v3_iile_tpu/ops/intersect.py:111-124``).
``bvh_traverse_motion_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from .intersect import (MAX_LEAF, Hit, _moller_raw, intersect_bvh,
                        motion_segment)

WIDTH = 4         # children per wide node (kWidth of csrc/bvh_traverse.cu)
NODE_INTS = 8 * WIDTH  # one wide node: 32 * WIDTH bytes (see build_bvh4_np)
STACK_MAX = 64    # deepest stack a build may need (the plain version's
                  # stack; the kernel's spill region is sized per scene)

MOTION_PAD = 2.0 ** -18  # a triangle's box in the motion tables is widened
                         # by this times its largest |p0|, |e1| or |e2|
                         # component (_segment_boxes)

LAUNCHES = 0         # kernel launches (not plain-version calls) since import
LAUNCHES_MOTION = 0  # ... of the motion variant
_SPILL = {}   # (device, stack depth, motion) -> the kernel's spill entries
_WORK = {}    # (device, stream) -> workspace: ray counter, block counter,
              # then the stack spill (int2 entries)


def build_bvh4_np(nodes_packed, width: int = WIDTH):
    """Collapse the binary BVH (``nodes_packed``, (M, 8) i32 in
    LinearBVHNode order) into a ``width``-wide BVH (the kernel's: WIDTH).

    Each wide node takes an inner binary node's two children and opens the
    inner child of largest surface area (ties: the smaller binary index)
    until it holds ``width`` or only leaves; its slots are in binary
    (depth-first) order.  Wide nodes are numbered breadth first, so the
    top of the tree is one contiguous block.  A binary root that is a leaf
    makes a wide root with that one leaf.

    Returns (nodes (W, 8 * width) i32, stack_depth): per node, in blocks
    of ``width``, the children's boxes as bit-exact copies of the binary
    boxes, SoA (min x, min y, min z, max x, max y, max z as float bits),
    the children (>= 0 an inner wide node; < 0 a leaf ~(first prim << 3 |
    count), count 1..MAX_LEAF; -1 an empty slot) and the binary node of
    each child (-1 empty; the kernel does not read it); and the deepest
    stack a traversal can need (per node, its inner children less one,
    summed down the deepest path).  Raises if that exceeds STACK_MAX.
    A binary leaf of more than MAX_LEAF triangles (the builders make them
    where centroids coincide) keeps its first MAX_LEAF, the ones the
    binary walker tests.
    """
    nodes = np.ascontiguousarray(np.asarray(nodes_packed, np.int32))
    bmin = nodes[:, 0:3].view(np.float32)
    bmax = nodes[:, 3:6].view(np.float32)
    ext = bmax.astype(np.float64) - bmin.astype(np.float64)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 0] * ext[:, 2]).tolist()
    right = nodes[:, 6].tolist()
    count = (nodes[:, 7] >> 2).tolist()

    if int(nodes[:, 6].max()) >= 1 << 28:
        raise ValueError("a leaf's first prim id must fit in 28 bits")
    slots = []   # per wide node: its binary children
    queue = [0]  # binary node of each wide node, breadth first
    below = [0]  # per wide node: stack entries its ancestors pushed
    depth = 0
    w = 0
    while w < len(queue):
        b = queue[w]
        if count[b] > 0:
            kids = [b]
        else:
            kids = [b + 1, right[b]]
            while len(kids) < width:
                inner = [k for k in kids if count[k] == 0]
                if not inner:
                    break
                k = max(inner, key=lambda k: (area[k], -k))
                i = kids.index(k)
                kids[i:i + 1] = [k + 1, right[k]]
            kids.sort()
        slots.append(kids)
        inner = [k for k in kids if count[k] == 0]
        push = max(len(inner) - 1, 0)  # the nearest is taken, not pushed
        depth = max(depth, below[w] + push)
        queue.extend(inner)
        below.extend([below[w] + push] * len(inner))
        w += 1
    if depth > STACK_MAX:
        raise ValueError(f"the {width}-wide BVH needs a stack of {depth} "
                         f"entries; the BVH kernel holds {STACK_MAX}")

    W = len(slots)
    kid = np.full((W, width), -1, np.int64)
    for w, ks in enumerate(slots):
        kid[w, :len(ks)] = ks
    used = kid >= 0
    src = np.where(used, kid, 0)
    leaf = used & (nodes[src, 7] >> 2 > 0)
    inner = used & ~leaf
    wide_id = np.zeros(nodes.shape[0], np.int64)
    wide_id[np.asarray(queue, np.int64)] = np.arange(W)
    out = np.zeros((W, 8 * width), np.int32)
    for a in range(6):
        out[:, width * a:width * (a + 1)] = np.where(used, nodes[src, a], 0)
    leaf_code = ~((nodes[src, 6].astype(np.int64) << 3)
                  | np.minimum(nodes[src, 7] >> 2, MAX_LEAF))
    out[:, 6 * width:7 * width] = np.where(inner, wide_id[src],
                                           np.where(leaf, leaf_code, -1))
    out[:, 7 * width:] = kid
    return out, depth


def pack_nodes_np(flat) -> np.ndarray:
    """A binary ``FlatBVH`` as the (M, 8) i32 rows of ``nodes_packed``:
    bits of min3, bits of max3, right (a leaf's first prim), count << 2 |
    axis."""
    nodes = np.zeros((flat.node_min.shape[0], 8), np.int32)
    nodes[:, 0:3] = flat.node_min.astype(np.float32).view(np.int32)
    nodes[:, 3:6] = flat.node_max.astype(np.float32).view(np.int32)
    nodes[:, 6] = flat.node_right.astype(np.int32)
    nodes[:, 7] = ((flat.node_count.astype(np.int32) << 2)
                   | flat.node_axis.astype(np.int32))
    return nodes


def _empty_wide():
    """A wide BVH over no triangle: one node whose slots are all empty."""
    out = np.zeros((1, NODE_INTS), np.int32)
    out[:, 6 * WIDTH:] = -1
    return out


def _segment_boxes(rows):
    """Per triangle, the box that holds it at every lerp parameter between
    its K keyframe rows (K, n, 12): the implicit vertices p0, p0 + e1,
    p0 + e2 of each row (exact in float64), widened on each side by
    MOTION_PAD times the triangle's largest |p0|, |e1| or |e2| component.
    The kernel lerps each float as a + tl (b - a), three rounded
    operations, so a lerped component lies within 7 * 2**-24 of that
    magnitude of the exact lerp, and a vertex (p0 + e1, two lerped
    components) within 2**-20 of it; the exact lerp lies between the
    keyframes.  The pad is 4 times that, and rounding the padded box to
    float32 moves each side by at most 2**-24 of its own magnitude, far
    below the pad.  Returns (lo, hi), each (n, 3) f32."""
    r = rows.astype(np.float64)
    p0 = r[..., 0:3]
    v = np.stack([p0, p0 + r[..., 3:6], p0 + r[..., 6:9]], axis=-2)
    pad = np.abs(r[..., 0:9]).max(axis=(0, 2)) * MOTION_PAD
    lo = v.min(axis=(0, 2)) - pad[:, None]
    hi = v.max(axis=(0, 2)) + pad[:, None]
    return lo.astype(np.float32), hi.astype(np.float32)


def _wide_over(rows):
    """A 4-wide BVH over the triangles of rows (K, n, 12), boxed by
    ``_segment_boxes``: (wide nodes, stack bound, the triangles' order in
    its leaves).  The binary build is the native one where it exists: the
    kernel's result does not depend on this BVH's order."""
    from . import bvh as bvhlib

    if rows.shape[1] == 0:
        return _empty_wide(), 0, np.zeros(0, np.int64)
    lo, hi = _segment_boxes(rows)
    flat = bvhlib.build_bvh(np.stack([lo, hi, hi], axis=1))
    wide, depth = build_bvh4_np(pack_nodes_np(flat))
    return wide, depth, flat.prim_order


def build_motion_split_np(tris_steps, nodes_packed) -> dict:
    """The motion variant's tables for the (M, T, 12) sub-keyframe stack
    in the scene's BVH order (``tris_steps_packed``), as device-scene
    leaves.  A triangle is static when its M rows are bit-equal and moving
    otherwise.  ``mot_nodes`` holds, from node 0, a 4-wide BVH over the
    static triangles (the scene's own, collapsed from ``nodes_packed``,
    when no triangle moves), then for each keyframe segment s in 0..M-2 a
    4-wide BVH over the moving triangles boxed over keyframes s and s + 1
    (``_segment_boxes``), starting at ``mot_roots[s]``.  A static leaf
    indexes ``mot_static_tris`` (S, 12): p0, e1, e2, the triangle's prim
    id (int32 bits), pad; a moving leaf of segment s indexes
    ``mot_moving_tris[s]`` (M - 1, V, 24): the triangle's rows at
    keyframes s and s + 1, each with its prim id in column 9.  So the
    kernel returns the scene's prim ids.  ``mot_stack``: the deepest stack
    of any of these BVHs.  With fewer than 2 keyframes (a static scene)
    the tables are placeholders with no segment (``mot_roots`` empty),
    which the plain version and the launch refuse."""
    steps = np.ascontiguousarray(np.asarray(tris_steps, np.float32))
    M, T = steps.shape[:2]
    if M < 2:
        return dict(mot_nodes=_empty_wide(), mot_roots=np.zeros(0, np.int32),
                    mot_static_tris=np.zeros((1, 12), np.float32),
                    mot_moving_tris=np.zeros((1, 1, 24), np.float32),
                    mot_stack=np.int32(0))
    bits = steps.view(np.int32)
    moves = (bits != bits[:1]).any(axis=(0, 2))
    moving, static = np.nonzero(moves)[0], np.nonzero(~moves)[0]
    if moving.size == 0:
        wide, depth = build_bvh4_np(nodes_packed)
        s_order = np.arange(T)
    else:
        wide, depth, s_order = _wide_over(steps[:1, static])
        s_order = static[s_order]
    static_tris = np.zeros((max(s_order.size, 1), 12), np.float32)
    static_tris[:s_order.size] = steps[0, s_order]
    static_tris.view(np.int32)[:s_order.size, 9] = s_order
    parts, roots = [wide], []
    base = wide.shape[0]
    V = max(moving.size, 1)
    moving_tris = np.zeros((M - 1, V, 24), np.float32)
    for s in range(M - 1):
        seg_wide, seg_depth, order = _wide_over(steps[s:s + 2, moving])
        ids = moving[order]
        moving_tris[s, :ids.size, 0:12] = steps[s, ids]
        moving_tris[s, :ids.size, 12:24] = steps[s + 1, ids]
        moving_tris.view(np.int32)[s, :ids.size, 9] = ids
        moving_tris.view(np.int32)[s, :ids.size, 21] = ids
        kids = seg_wide[:, 6 * WIDTH:7 * WIDTH]
        kids[kids >= 0] += base       # inner children: into mot_nodes
        roots.append(base)
        parts.append(seg_wide)
        base += seg_wide.shape[0]
        depth = max(depth, seg_depth)
    return dict(mot_nodes=np.concatenate(parts),
                mot_roots=np.asarray(roots, np.int32),
                mot_static_tris=static_tris, mot_moving_tris=moving_tris,
                mot_stack=np.int32(depth))


def motion_split(leaves: dict, device):
    """The motion tables of ``build_motion_split_np`` as tensors on
    ``device``, with the attributes the motion variant's functions read
    (a DeviceScene has the same)."""
    out = {k: (int(v) if k == "mot_stack" else torch.as_tensor(v, device=device))
           for k, v in leaves.items() if k.startswith("mot_")}
    return SimpleNamespace(**out)


def _walk_wide(nodes, tri_fn, o, d, inv_d, hit, node, idx, any_hit, work):
    """Walk the wide BVH ``nodes`` from each live ray's ``node`` (rays
    ``idx``) in the kernel's order, lowering hit = (t, prim, b1, b2) in
    place.  tri_fn(rays (n,), pid (n, K)) -> (the triangles (n K, >= 9):
    p0, e1, e2; their prim ids (n, K) i64), for the leaf entries pid."""
    t, prim, b1, b2 = hit
    dev = o.device
    W = nodes.shape[1] // 8  # the nodes' width
    st_node = torch.zeros((o.shape[0], STACK_MAX), dtype=torch.int64, device=dev)
    st_tn = torch.zeros((o.shape[0], STACK_MAX), dtype=torch.float32, device=dev)
    sp = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    slot = torch.arange(W, device=dev)
    tri_j = torch.arange(MAX_LEAF, device=dev)  # a leaf's triangles
    while idx.numel() > 0:
        n = idx.numel()
        row = nodes[node[idx]]
        box = (row[:, 0:6 * W].contiguous().view(torch.float32)
               .reshape(n, 6, W))
        child = row[:, 6 * W:7 * W].long()
        oo, dd, ii = o[idx], d[idx], inv_d[idx]
        tt, pp, bb1, bb2 = t[idx], prim[idx], b1[idx], b2[idx]
        tlo = (box[:, 0:3] - oo[:, :, None]) * ii[:, :, None]
        thi = (box[:, 3:6] - oo[:, :, None]) * ii[:, :, None]
        tnear = torch.amax(torch.minimum(tlo, thi), dim=1)
        tfar = torch.amin(torch.maximum(tlo, thi), dim=1) * 1.0000004
        hit_ = (tnear <= tfar) & (tnear < tt[:, None]) & (tfar > 0.0)
        # every triangle of the hit leaf children at once, then the least
        # (t, prim) of those below the ray's best
        code = ~child
        first, cnt = code >> 3, code & 7
        m = ((hit_ & (child < 0))[:, :, None]
             & (tri_j[None, None, :] < cnt[:, :, None])).reshape(n, -1)
        if work is not None:
            work["tris"] = work.get("tris", 0) + int(m.sum())
        pid = torch.where(m, (first[:, :, None] + tri_j).reshape(n, -1), 0)
        tr, gid = tri_fn(idx, pid)
        oo_, dd_ = (x.repeat_interleave(pid.shape[1], 0) for x in (oo, dd))
        ok, tk, uk, vk = (x.reshape(n, -1) for x in _moller_raw(
            oo_, dd_, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9]))
        below = (tk < tt[:, None]) | ((tk == tt[:, None]) & (gid < pp[:, None]))
        ok &= m & below
        tk = torch.where(ok, tk, math.inf)
        t_best = tk.min(1).values
        p_best, j = torch.where(ok & (tk == t_best[:, None]), gid,
                                torch.iinfo(torch.int64).max).min(1)
        upd = ok.any(1)
        tt = torch.where(upd, t_best, tt)
        pp = torch.where(upd, p_best, pp)
        bb1 = torch.where(upd, uk.gather(1, j[:, None])[:, 0], bb1)
        bb2 = torch.where(upd, vk.gather(1, j[:, None])[:, 0], bb2)
        t[idx], prim[idx], b1[idx], b2[idx] = tt, pp, bb1, bb2
        if work is not None:
            work["nodes"] = work.get("nodes", 0) + n
        # the hit inner children by (tnear, slot): the nearest is next, the
        # others are pushed far first
        go = hit_ & (child >= 0) & (tnear < tt[:, None])
        before = ((tnear[:, None, :] < tnear[:, :, None])
                  | ((tnear[:, None, :] == tnear[:, :, None])
                     & (slot[None, None, :] < slot[None, :, None])))
        rank = (go[:, None, :] & before).sum(-1)
        s_ = sp[idx]
        rows_n, rows_t = st_node[idx], st_tn[idx]
        for r in range(W - 1, 0, -1):
            m = go & (rank == r)
            has = m.any(1)
            val = torch.where(m, child, 0).sum(1)
            tnv = torch.where(m, tnear, 0.0).sum(1)
            pos = torch.where(has, s_, 0)[:, None]
            for rows, v in ((rows_n, val), (rows_t, tnv)):
                keep = rows.gather(1, pos)[:, 0]
                rows.scatter_(1, pos, torch.where(has, v, keep)[:, None])
            s_ = s_ + has.long()
        if work is not None and n:
            work["stack"] = max(work.get("stack", 0), int(s_.max()))
        nearest = go & (rank == 0)
        nxt = torch.where(nearest.any(1), torch.where(nearest, child, 0).sum(1),
                          torch.full_like(s_, -1))
        # pop until an entry is nearer than t, or the stack is empty
        need = (nxt < 0) & (s_ > 0)
        while bool(need.any()):
            s_ = s_ - need.long()
            pos = torch.clamp(s_, min=0)[:, None]
            pn, pt = rows_n.gather(1, pos)[:, 0], rows_t.gather(1, pos)[:, 0]
            take = need & (pt < tt)
            nxt = torch.where(take, pn, nxt)
            need = need & ~take & (s_ > 0)
        if any_hit:
            nxt = torch.where(pp >= 0, torch.full_like(nxt, -1), nxt)
        node[idx], sp[idx] = nxt, s_
        st_node[idx], st_tn[idx] = rows_n, rows_t
        idx = idx[nxt >= 0]


def _inv_dir(d):
    return torch.where(torch.abs(d) > 1e-12,
                       1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.where(d >= 0, 1e30, -1e30))


def _miss(t_max):
    """(t, prim i64, b1, b2) of rays that hit nothing yet."""
    N, dev = t_max.shape[0], t_max.device
    return (t_max.clone(), torch.full((N,), -1, dtype=torch.int64, device=dev),
            torch.zeros(N, dtype=torch.float32, device=dev),
            torch.zeros(N, dtype=torch.float32, device=dev))


def bvh_traverse_wide_plain(bvh4_nodes, tris_packed, o, d, t_max,
                            any_hit: bool = False, work: dict = None):
    """The kernel's plain version: every live ray steps one wide node an
    iteration, in the kernel's order (module docstring), with the same
    rounded operations.  Returns (t, prim i32, b1, b2) as the kernel.
    work: a dict to which the wide-node visits ("nodes"), the triangle
    tests ("tris") and the deepest stack seen ("stack") are added."""
    hit = _miss(t_max)
    # a ray with t_max <= 0 can hit nothing (0 < t < t_max): it stays a miss
    idx = torch.nonzero(t_max > 0)[:, 0]
    node = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    _walk_wide(bvh4_nodes, lambda rays, pid: (tris_packed[pid].reshape(-1, 12),
                                              pid),
               o, d, _inv_dir(d), hit, node, idx, any_hit, work)
    t, prim, b1, b2 = hit
    return t, prim.to(torch.int32), b1, b2


def _segments(split) -> int:
    """The keyframe segments of the motion tables ``split``; raises on a
    static scene's placeholders."""
    if split.mot_roots.shape[0] == 0:
        raise ValueError("the motion variant needs at least 2 keyframes")
    return split.mot_roots.shape[0]


def _row_ids(rows, col):
    """The prim ids kept as int32 bits in column col of the rows (..., C)."""
    return rows[..., col].contiguous().view(torch.int32).long()


def bvh_traverse_motion_plain(split, o, d, t_max, time, any_hit: bool = False,
                              work: dict = None):
    """The motion variant's plain version, in the kernel's order: each
    ray walks the static BVH of ``split`` (``build_motion_split_np``'s
    tables: a DeviceScene or ``motion_split``) from node 0, reading its
    triangles as they are, then, unless any-hit found a hit, the moving
    BVH of its keyframe segment from ``mot_roots[seg]``, bounded by the
    (t, prim) the first walk left, with each triangle lerped between its
    two keyframe rows at tl as r0 + tl (r1 - r0).  Returns (t, prim i32,
    b1, b2) as the kernel; work as ``bvh_traverse_wide_plain``'s, summed
    over both walks, and the second walk's (lerped) tests ("moving_tris")."""
    moving = split.mot_moving_tris
    seg, tl = motion_segment(time, _segments(split) + 1)
    hit = _miss(t_max)
    inv_d = _inv_dir(d)
    idx = torch.nonzero(t_max > 0)[:, 0]
    node = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)

    def static(rays, pid):
        rows = split.mot_static_tris[pid]
        return rows.reshape(-1, 12), _row_ids(rows, 9)

    def lerped(rays, pid):
        rows = moving[seg[rays][:, None], pid]           # (n, K, 24)
        a, b = rows[..., 0:9], rows[..., 12:21]
        tr = a + tl[rays][:, None, None] * (b - a)
        return tr.reshape(-1, 9), _row_ids(rows, 9)

    _walk_wide(split.mot_nodes, static, o, d, inv_d, hit, node, idx, any_hit,
               work)
    if any_hit:
        idx = idx[hit[1][idx] < 0]
    node[idx] = split.mot_roots.long()[seg[idx]]
    before = work.get("tris", 0) if work is not None else 0
    _walk_wide(split.mot_nodes, lerped, o, d, inv_d, hit, node, idx, any_hit,
               work)
    if work is not None:
        work["moving_tris"] = (work.get("moving_tris", 0)
                               + work.get("tris", 0) - before)
    t, prim, b1, b2 = hit
    return t, prim.to(torch.int32), b1, b2


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load("bvh_traverse")
    fn = lib.bvh_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn = lib.bvh_traverse_motion
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    for name in ("bvh_traverse_spill_entries",
                 "bvh_traverse_motion_spill_entries"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_int]
    return lib


def _workspace(lib, dev, stack_depth: int, stream: int, motion: bool):
    """The kernel's workspace on `stream`, kept across launches: two
    counters (zeroed here once; the kernel's last block sets them back to
    0) and the stack spill for stacks of `stack_depth` entries (sized for
    the larger of the two variants' persistent grids it has served)."""
    key = (dev.index, stack_depth, motion)
    entries = _SPILL.get(key)
    if entries is None:
        entries = (lib.bvh_traverse_motion_spill_entries if motion
                   else lib.bvh_traverse_spill_entries)(stack_depth)
        if entries < 0:
            raise RuntimeError("bvh_traverse: occupancy query failed: "
                               f"cudaError {-entries}")
        _SPILL[key] = entries
    work = _WORK.get((dev.index, stream))
    if work is None or work.shape[0] < 2 + 2 * entries:
        work = torch.zeros(2 + 2 * entries, dtype=torch.int32, device=dev)
        _WORK[(dev.index, stream)] = work
    return work


def _check_launch(name, dev, specs, stack_depth, aligned, n_list):
    """The checks of both variants before a launch: the tensors (specs as
    ``_build.check_args``), the stack bound, the 16-byte starts of the
    tables read as float4 (aligned: (name, tensor)), and n_list, the
    largest leaf index, against the (prim << 5 | lane) test list."""
    from .. import _build

    _build.check_args(dev, specs)
    if n_list > 1 << 26:
        raise ValueError(f"{name}: the kernel lists a step's tests as "
                         "(prim << 5 | lane): at most 2**26 triangles")
    if not 0 <= stack_depth <= STACK_MAX:
        raise ValueError(f"stack_depth {stack_depth} outside [0, {STACK_MAX}]")
    for what, x in aligned:
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: the kernel reads it 16 bytes at a time "
                             "and needs a 16-byte aligned start")


def _empty_hits(n, dev):
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def bvh_traverse_cuda(bvh4_nodes, stack_depth: int, tris_packed, o, d, t_max,
                      any_hit: bool = False):
    """Launch the kernel: returns (t, prim, b1, b2) for CUDA tensors.
    stack_depth: ``build_bvh4_np``'s bound, which sizes the stack spill."""
    global LAUNCHES
    n = o.shape[0]
    dev = o.device
    _check_launch("bvh_traverse", dev, (
        ("bvh4_nodes", bvh4_nodes, torch.int32,
         (bvh4_nodes.shape[0], NODE_INTS)),
        ("tris_packed", tris_packed, torch.float32, (tris_packed.shape[0], 12)),
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("t_max", t_max, torch.float32, (n,))), stack_depth,
        (("bvh4_nodes", bvh4_nodes), ("tris_packed", tris_packed)),
        tris_packed.shape[0])
    t, prim, b1, b2 = out = _empty_hits(n, dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        work = _workspace(lib, dev, stack_depth, stream, False)
        err = lib.bvh_traverse(
            bvh4_nodes.data_ptr(), tris_packed.data_ptr(), o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), t.data_ptr(), prim.data_ptr(),
            b1.data_ptr(), b2.data_ptr(), n, int(any_hit), work.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def bvh_traverse_motion_cuda(split, o, d, t_max, time, any_hit: bool = False):
    """Launch the motion variant on ``split`` (the tables of
    ``build_motion_split_np``: a DeviceScene or ``motion_split``) with
    per-ray times (N,) in [0, 1]: returns (t, prim, b1, b2) for CUDA
    tensors, as ``bvh_traverse_motion_plain``."""
    global LAUNCHES_MOTION
    n = o.shape[0]
    dev = o.device
    nodes, roots = split.mot_nodes, split.mot_roots
    static, moving = split.mot_static_tris, split.mot_moving_tris
    S, V = static.shape[0], moving.shape[1]
    _segments(split)
    if moving.numel() // 4 > 1 << 31:
        raise ValueError("the motion variant reads a moving triangle's two "
                         "rows (6 float4s) of its (M - 1, V, 24) table at an "
                         "offset of 32 bits: at most 2**31 float4s")
    _check_launch("bvh_traverse_motion", dev, (
        ("mot_nodes", nodes, torch.int32, (nodes.shape[0], NODE_INTS)),
        ("mot_roots", roots, torch.int32, (moving.shape[0],)),
        ("mot_static_tris", static, torch.float32, (S, 12)),
        ("mot_moving_tris", moving, torch.float32, (moving.shape[0], V, 24)),
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("t_max", t_max, torch.float32, (n,)),
        ("time", time, torch.float32, (n,))), split.mot_stack,
        (("mot_nodes", nodes), ("mot_static_tris", static),
         ("mot_moving_tris", moving)), max(S, V))
    t, prim, b1, b2 = out = _empty_hits(n, dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        work = _workspace(lib, dev, split.mot_stack, stream, True)
        err = lib.bvh_traverse_motion(
            nodes.data_ptr(), roots.data_ptr(), static.data_ptr(),
            moving.data_ptr(), o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            time.data_ptr(), t.data_ptr(), prim.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), n, int(any_hit), moving.shape[0] + 1, V,
            work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse_motion launch failed: cudaError {err}")
    LAUNCHES_MOTION += 1
    return out


def intersect_bvh_kernel(scene, o, d, t_max, any_hit: bool = False,
                         time=None) -> Hit:
    """Closest-hit (or any-hit) of each ray against the scene BVH; with
    per-ray times (a motion-blurred scene) the motion variant."""
    if o.device.type != "cuda":
        return intersect_bvh(scene, o, d, t_max, any_hit=any_hit, time=time)
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    if time is None:
        t, prim, b1, b2 = bvh_traverse_cuda(
            scene.bvh4_nodes, scene.bvh4_stack, scene.tris_packed, o, d, t_max,
            any_hit=any_hit)
    else:
        t, prim, b1, b2 = bvh_traverse_motion_cuda(
            scene, o, d, t_max, time.contiguous(), any_hit=any_hit)
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
