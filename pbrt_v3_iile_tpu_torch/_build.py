"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its
first CUDA call with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC

into ``build/torch_kernels/`` at the repository root, under a file name
that carries a hash of the source and the flags (an edited ``.cu``
rebuilds), and is loaded with ctypes.  ``--fmad=false`` keeps every
``a*b+c`` a rounded multiply and a rounded add, as the reference's
interpret mode and the plain PyTorch versions compute them, so the
triangle tests agree at shared edges.  A missing ``nvcc`` or a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "pbrt_v3_iile_tpu_torch/csrc need the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def check_args(device, specs):
    """Validate tensors before their pointers go to a kernel: each of
    specs is (name, tensor, dtype, shape); all must be contiguous and on
    the CUDA ``device``."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    for name, x, dtype, shape in specs:
        if x.device != device:
            raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def load(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``csrc/<name>.cu``."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        out = library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   f"{res.stdout}\n{res.stderr}")
            if verbose and (res.stdout or res.stderr):
                print(res.stdout + res.stderr, flush=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
        return lib
