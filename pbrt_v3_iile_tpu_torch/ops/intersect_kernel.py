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
kernel.  Its motion variant (a compile-time flag of the same kernel) takes
per-ray times and lerps each tested triangle between the two
sub-keyframes of ``tris_steps_packed`` around the ray's time, as the
reference's walker does (``pbrt_v3_iile_tpu/ops/intersect.py:111-124``):
it carries every traversal of a motion-blurred scene.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .intersect import (MAX_LEAF, Hit, _moller_raw, intersect_bvh,
                        lerp_steps, motion_segment)

WIDTH = 4         # children per wide node (kWidth of csrc/bvh_traverse.cu)
NODE_INTS = 8 * WIDTH  # one wide node: 32 * WIDTH bytes (see build_bvh4_np)
STACK_MAX = 64    # deepest stack a build may need (the plain version's
                  # stack; the kernel's spill region is sized per scene)

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


def bvh_traverse_wide_plain(bvh4_nodes, tris_packed, o, d, t_max,
                            any_hit: bool = False, work: dict = None,
                            time=None, tris_steps=None):
    """The kernel's plain version: every live ray steps one wide node an
    iteration, in the kernel's order (module docstring), with the same
    rounded operations.  Returns (t, prim i32, b1, b2) as the kernel.
    work: a dict to which the wide-node visits ("nodes"), the triangle
    tests ("tris") and the deepest stack seen ("stack") are added.
    time, tris_steps: the motion variant's per-ray times (N,) and the
    (M, T, 12) sub-keyframes its triangles are lerped between."""
    N = o.shape[0]
    dev = o.device
    W = bvh4_nodes.shape[1] // 8  # the nodes' width
    inv_d = torch.where(torch.abs(d) > 1e-12,
                        1.0 / torch.where(d == 0, torch.ones_like(d), d),
                        torch.where(d >= 0, 1e30, -1e30))
    t = t_max.clone()
    prim = torch.full((N,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(N, dtype=torch.float32, device=dev)
    b2 = torch.zeros(N, dtype=torch.float32, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    st_node = torch.zeros((N, STACK_MAX), dtype=torch.int64, device=dev)
    st_tn = torch.zeros((N, STACK_MAX), dtype=torch.float32, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    slot = torch.arange(W, device=dev)
    tri_j = torch.arange(MAX_LEAF, device=dev)  # a leaf's triangles
    if time is not None:
        seg_all, tl_all = motion_segment(time, tris_steps.shape[0])
    # a ray with t_max <= 0 can hit nothing (0 < t < t_max): it stays a miss
    idx = torch.nonzero(t_max > 0)[:, 0]
    while idx.numel() > 0:
        n = idx.numel()
        row = bvh4_nodes[node[idx]]
        box = (row[:, 0:6 * W].contiguous().view(torch.float32)
               .reshape(n, 6, W))
        child = row[:, 6 * W:7 * W].long()
        oo, dd, ii = o[idx], d[idx], inv_d[idx]
        tt, pp, bb1, bb2 = t[idx], prim[idx], b1[idx], b2[idx]
        tlo = (box[:, 0:3] - oo[:, :, None]) * ii[:, :, None]
        thi = (box[:, 3:6] - oo[:, :, None]) * ii[:, :, None]
        tnear = torch.amax(torch.minimum(tlo, thi), dim=1)
        tfar = torch.amin(torch.maximum(tlo, thi), dim=1) * 1.0000004
        hit = (tnear <= tfar) & (tnear < tt[:, None]) & (tfar > 0.0)
        # every triangle of the hit leaf children at once, then the least
        # (t, prim) of those below the ray's best
        code = ~child
        first, cnt = code >> 3, code & 7
        m = ((hit & (child < 0))[:, :, None]
             & (tri_j[None, None, :] < cnt[:, :, None])).reshape(n, -1)
        if work is not None:
            work["tris"] = work.get("tris", 0) + int(m.sum())
        pid = torch.where(m, (first[:, :, None] + tri_j).reshape(n, -1), 0)
        if time is None:
            tr = tris_packed[pid].reshape(-1, 12)
        else:
            rep_ = pid.shape[1]
            tr = lerp_steps(tris_steps, seg_all[idx].repeat_interleave(rep_),
                            tl_all[idx].repeat_interleave(rep_),
                            pid.reshape(-1))
        oo_, dd_ = (x.repeat_interleave(pid.shape[1], 0) for x in (oo, dd))
        ok, tk, uk, vk = (x.reshape(n, -1) for x in _moller_raw(
            oo_, dd_, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9]))
        below = (tk < tt[:, None]) | ((tk == tt[:, None]) & (pid < pp[:, None]))
        ok &= m & below
        tk = torch.where(ok, tk, math.inf)
        t_best = tk.min(1).values
        p_best, j = torch.where(ok & (tk == t_best[:, None]), pid,
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
        go = hit & (child >= 0) & (tnear < tt[:, None])
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
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
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


def bvh_traverse_cuda(bvh4_nodes, stack_depth: int, tris_packed, o, d, t_max,
                      any_hit: bool = False, time=None, tris_steps=None):
    """Launch the kernel: returns (t, prim, b1, b2) for CUDA tensors.
    stack_depth: ``build_bvh4_np``'s bound, which sizes the stack spill.
    time (N,) and tris_steps (M, T, 12), M >= 2: the motion variant, which
    reads its triangles from tris_steps (tris_packed is not read)."""
    from .. import _build

    global LAUNCHES, LAUNCHES_MOTION
    n = o.shape[0]
    dev = o.device
    motion = time is not None
    tris = tris_steps if motion else tris_packed
    specs = [("bvh4_nodes", bvh4_nodes, torch.int32,
              (bvh4_nodes.shape[0], NODE_INTS)),
             ("o", o, torch.float32, (n, 3)),
             ("d", d, torch.float32, (n, 3)),
             ("t_max", t_max, torch.float32, (n,))]
    if motion:
        specs += [("tris_steps", tris_steps, torch.float32,
                   (tris_steps.shape[0], tris_steps.shape[1], 12)),
                  ("time", time, torch.float32, (n,))]
        if tris_steps.shape[0] < 2:
            raise ValueError("the motion variant needs at least 2 keyframes")
        if tris_steps.numel() // 4 > 1 << 31:
            raise ValueError("the motion variant indexes the float4 rows of "
                             "steps x triangles (3 a triangle) in 32 bits")
    else:
        specs.append(("tris_packed", tris_packed, torch.float32,
                      (tris_packed.shape[0], 12)))
    _build.check_args(dev, specs)
    n_tris = tris.shape[-2]
    if n_tris > 1 << 26:
        raise ValueError("the kernel lists a step's tests as (prim << 5 | "
                         "lane): at most 2**26 triangles")
    if not 0 <= stack_depth <= STACK_MAX:
        raise ValueError(f"stack_depth {stack_depth} outside [0, {STACK_MAX}]")
    for name, x in (("bvh4_nodes", bvh4_nodes), ("triangles", tris)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it 16 bytes at a time "
                             "and needs a 16-byte aligned start")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    b2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, b1, b2
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        work = _workspace(lib, dev, stack_depth, stream, motion)
        if motion:
            err = lib.bvh_traverse_motion(
                bvh4_nodes.data_ptr(), tris_steps.data_ptr(), o.data_ptr(),
                d.data_ptr(), t_max.data_ptr(), time.data_ptr(), t.data_ptr(),
                prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), n, int(any_hit),
                tris_steps.shape[0], n_tris, work.data_ptr(), stream)
        else:
            err = lib.bvh_traverse(
                bvh4_nodes.data_ptr(), tris_packed.data_ptr(),
                o.data_ptr(), d.data_ptr(), t_max.data_ptr(), t.data_ptr(),
                prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), n, int(any_hit),
                work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse launch failed: cudaError {err}")
    if motion:
        LAUNCHES_MOTION += 1
    else:
        LAUNCHES += 1
    return t, prim, b1, b2


def intersect_bvh_kernel(scene, o, d, t_max, any_hit: bool = False,
                         time=None) -> Hit:
    """Closest-hit (or any-hit) of each ray against the scene BVH; with
    per-ray times (a motion-blurred scene) the motion variant."""
    if o.device.type != "cuda":
        return intersect_bvh(scene, o, d, t_max, any_hit=any_hit, time=time)
    t, prim, b1, b2 = bvh_traverse_cuda(
        scene.bvh4_nodes, scene.bvh4_stack, scene.tris_packed, o.contiguous(),
        d.contiguous(), t_max.contiguous(), any_hit=any_hit,
        time=None if time is None else time.contiguous(),
        tris_steps=None if time is None else scene.tris_steps_packed)
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
