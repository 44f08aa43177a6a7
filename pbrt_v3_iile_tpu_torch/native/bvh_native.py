"""ctypes bridge to the C++ binned-SAH BVH builder.

Compiles ``native/bvh_builder.cpp`` on first use with
``g++ -O3 -march=native -shared -fPIC`` into ``build/native/`` at the
repository root, under a file name that carries a hash of the source and
the flags (an edited source rebuilds; nothing is written beside the
source).  ``available()`` says whether ``g++`` is on the PATH; a failed
compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None


def available() -> bool:
    return shutil.which("g++") is not None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbvh_builder_{h.hexdigest()[:16]}.so")


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", *FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed for bvh_builder.cpp:\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.bvh_build.restype = ctypes.c_int64
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return lib


def build(tri_p: np.ndarray):
    """tri_p (T,3,3) f32 -> ops.bvh.FlatBVH; raises if the builder fails."""
    from ..ops.bvh import FlatBVH

    lib = _load()
    t = np.ascontiguousarray(tri_p, dtype=np.float32)
    n = t.shape[0]
    cap = max(2 * n, 2)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_right = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    node_axis = np.zeros(cap, np.int32)
    order = np.empty(n, np.int64)
    max_depth = ctypes.c_int32(0)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    m = lib.bvh_build(fp(t), n, fp(node_min), fp(node_max), ip(node_right),
                      ip(node_count), ip(node_axis), lp(order),
                      ctypes.byref(max_depth))
    if m <= 0:
        raise RuntimeError(f"native BVH build failed ({m}) on {n} triangles")
    return FlatBVH(
        node_min=node_min[:m].copy(), node_max=node_max[:m].copy(),
        node_right=node_right[:m].copy(), node_count=node_count[:m].copy(),
        node_axis=node_axis[:m].copy(), prim_order=order,
        max_depth=int(max_depth.value),
    )
