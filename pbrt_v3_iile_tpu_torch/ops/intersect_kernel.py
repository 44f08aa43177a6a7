"""BVH traversal (K2): wrapper of ``csrc/bvh_traverse.cu``.

Replaces the TPU packet kernel ``pbrt_v3_iile_tpu/ops/intersect_pallas.py``
(``_traverse_kernel``/``_traverse_packet``, wrapper ``intersect_bvh_pallas``)
with one thread per ray following the reference walker's semantics; see
the source for what bounds it on the H100.  On CPU tensors the wrapper
runs the plain PyTorch version, the vectorized walker
``ops/intersect.py::intersect_bvh``; on CUDA tensors it launches the
kernel or raises.

It serves the ``bvh`` accel and the overflow groups of the fused
cluster kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .intersect import Hit, intersect_bvh

LAUNCHES = 0  # kernel launches (not plain-version calls) since import


def _lib():
    from .. import _build

    lib = _build.load("bvh_traverse")
    fn = lib.bvh_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    return fn


def bvh_traverse_cuda(nodes_packed, tris_packed, o, d, t_max,
                      any_hit: bool = False):
    """Launch the kernel: returns (t, prim, b1, b2) for CUDA tensors."""
    from .. import _build

    global LAUNCHES
    n = o.shape[0]
    dev = o.device
    _build.check_args(dev, (
        ("nodes_packed", nodes_packed, torch.int32, (nodes_packed.shape[0], 8)),
        ("tris_packed", tris_packed, torch.float32, (tris_packed.shape[0], 12)),
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("t_max", t_max, torch.float32, (n,))))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    b2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, b1, b2
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nodes_packed.data_ptr(), tris_packed.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), t.data_ptr(), prim.data_ptr(),
                 b1.data_ptr(), b2.data_ptr(), n, int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, prim, b1, b2


def intersect_bvh_kernel(scene, o, d, t_max, any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) of each ray against the scene BVH."""
    if o.device.type != "cuda":
        return intersect_bvh(scene, o, d, t_max, any_hit=any_hit)
    t, prim, b1, b2 = bvh_traverse_cuda(
        scene.nodes_packed, scene.tris_packed, o.contiguous(), d.contiguous(),
        t_max.contiguous(), any_hit=any_hit)
    return Hit(t=t, prim=prim, b1=b1, b2=b2, valid=prim >= 0)
