"""kd-tree traversal (K3): the wrapper of ``csrc/kd_traverse.cu``.

Replaces the reference's XLA walker ``pbrt_v3_iile_tpu/ops/kdtree.py``
(``intersect_kd``, a ``lax.while_loop``; there is no Pallas kernel for it).
On CPU tensors ``intersect_kd_kernel`` runs the plain version
``ops/kdtree.py::intersect_kd_plain``; on CUDA tensors it launches the
kernel or raises.  The kernel walks one ray a thread with the plain
version's rounded operations in its order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .intersect import Hit
from .kdtree import intersect_kd_plain

LAUNCHES = 0  # kernel launches (not plain-version calls) since import


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load("kd_traverse")
    fn = lib.kd_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
    return lib


def kd_traverse_cuda(scene, o, d, t_max, any_hit: bool = False):
    """Launch the kernel: returns (t, prim, b1, b2) for CUDA tensors."""
    from .. import _build

    global LAUNCHES
    n = o.shape[0]
    dev = o.device
    K, P = scene.kd_meta.shape[0], scene.kd_prims.shape[0]
    _build.check_args(dev, (
        ("kd_split", scene.kd_split, torch.float32, (K,)),
        ("kd_meta", scene.kd_meta, torch.int32, (K,)),
        ("kd_offset", scene.kd_offset, torch.int32, (K,)),
        ("kd_prims", scene.kd_prims, torch.int32, (P,)),
        ("kd_bounds", scene.kd_bounds, torch.float32, (2, 3)),
        ("tris_packed", scene.tris_packed, torch.float32,
         (scene.tris_packed.shape[0], 12)),
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("t_max", t_max, torch.float32, (n,))))
    if scene.tris_packed.data_ptr() % 16:
        raise ValueError("tris_packed: the kernel reads it 16 bytes at a "
                         "time and needs a 16-byte aligned start")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    b2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, b1, b2
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kd_traverse(
            scene.kd_split.data_ptr(), scene.kd_meta.data_ptr(),
            scene.kd_offset.data_ptr(), scene.kd_prims.data_ptr(), P,
            scene.kd_bounds.data_ptr(), scene.tris_packed.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), t.data_ptr(),
            prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), n, int(any_hit),
            stream)
    if err != 0:
        raise RuntimeError(f"kd_traverse launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, prim, b1, b2


def intersect_kd_kernel(scene, o, d, t_max, any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) of each ray against the scene's kd-tree.
    Raises if the scene was built without it (its placeholder would miss
    every triangle)."""
    if not scene.has_kdtree:
        raise ValueError("the scene was built without its kd-tree: build it "
                         "with with_kdtree=True for the kdtree accel")
    if o.device.type != "cuda":
        return intersect_kd_plain(scene, o, d, t_max, any_hit=any_hit)
    t, prim, b1, b2 = kd_traverse_cuda(scene, o.contiguous(), d.contiguous(),
                                       t_max.contiguous(), any_hit=any_hit)
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
