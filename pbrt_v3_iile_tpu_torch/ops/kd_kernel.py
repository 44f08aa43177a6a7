"""kd-tree traversal (K3): the wrapper of ``csrc/kd_traverse.cu``.

Replaces the reference's XLA walker ``pbrt_v3_iile_tpu/ops/kdtree.py``
(``intersect_kd``, a ``lax.while_loop``; there is no Pallas kernel for it).
On CPU tensors ``intersect_kd_kernel`` runs the plain version
``ops/kdtree.py::intersect_kd_plain``; on CUDA tensors it launches the
kernel or raises.  The kernel runs persistent warps that pool their
lanes' leaf tests (see the source for its design), with the plain
version's rounded operations and its per-ray order, so the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .intersect import Hit
from .kdtree import intersect_kd_plain

LAUNCHES = 0  # kernel launches (not plain-version calls) since import
_WORK = {}    # (device, stream) -> workspace: the two counters, then the
              # stack spill (int4 entries)


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load("kd_traverse")
    fn = lib.kd_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    lib.kd_traverse_work_entries.restype = ctypes.c_int
    lib.kd_traverse_work_entries.argtypes = []
    return lib


def _workspace(lib, dev, stream: int):
    """The kernel's workspace on `stream`, kept across launches: two
    counters (zeroed here once; the kernel's last block sets them back to
    0) and the stack spill of its persistent grid."""
    work = _WORK.get((dev.index, stream))
    if work is None:
        entries = lib.kd_traverse_work_entries()
        if entries < 0:
            raise RuntimeError("kd_traverse: occupancy query failed: "
                               f"cudaError {-entries}")
        work = torch.zeros(4 * entries, dtype=torch.int32, device=dev)
        _WORK[(dev.index, stream)] = work
    return work


def kd_traverse_cuda(scene, o, d, t_max, any_hit: bool = False):
    """Launch the kernel: returns (t, prim, b1, b2) for CUDA tensors."""
    from .. import _build

    global LAUNCHES
    n = o.shape[0]
    dev = o.device
    K, P = scene.kd_meta.shape[0], scene.kd_tris.shape[0]
    _build.check_args(dev, (
        ("kd_split", scene.kd_split, torch.float32, (K,)),
        ("kd_meta", scene.kd_meta, torch.int32, (K,)),
        ("kd_offset", scene.kd_offset, torch.int32, (K,)),
        ("kd_tris", scene.kd_tris, torch.float32, (P, 12)),
        ("kd_bounds", scene.kd_bounds, torch.float32, (2, 3)),
        ("o", o, torch.float32, (n, 3)),
        ("d", d, torch.float32, (n, 3)),
        ("t_max", t_max, torch.float32, (n,))))
    if scene.kd_tris.data_ptr() % 16:
        raise ValueError("kd_tris: the kernel reads it 16 bytes at a "
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
        work = _workspace(lib, dev, stream)
        err = lib.kd_traverse(
            scene.kd_split.data_ptr(), scene.kd_meta.data_ptr(),
            scene.kd_offset.data_ptr(), scene.kd_tris.data_ptr(), P,
            scene.kd_bounds.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), t.data_ptr(), prim.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), n, int(any_hit), work.data_ptr(), stream)
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
