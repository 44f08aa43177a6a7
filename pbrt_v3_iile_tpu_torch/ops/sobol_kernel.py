"""The Sobol draws of the wavefront samplers: the wrapper of
``csrc/sobol_draw.cu``.

One launch computes a whole draw of ``samplers.ctx_uniform`` on a
``SampleCtx`` (k Owen-scrambled (0,2) columns, ``owen_draw_cuda``) or the
sobol kinds' ``samplers.pixel_samples`` (two XOR-scrambled columns,
``xor_pair_cuda``), bit for bit what their plain versions
(``samplers.owen_draw_plain``, ``samplers.sobol_pixel_samples_plain``)
compute in int64 PyTorch ops.  ``samplers`` launches the kernel for CUDA
tensors and keeps the plain versions for CPU tensors.  The wave's shared
(0,2) point and each column's seed word are host values, computed here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import lds

LAUNCHES = 0  # kernel launches since import
CAMERA_MIX = (0, 0x85EBCA77)  # pixel_samples' x and y seed words

_bits = functools.lru_cache(maxsize=16)(lds.sobol02_bits_int)


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load("sobol_draw")
    fn = lib.sobol_draw
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_uint] * 6 + [ctypes.c_void_p] * 2)
    return lib


def draw_mix(salt: int, bounce: int, purpose: int, k: int) -> list:
    """The seed word of each column c of a draw: the lane's seed is
    hash_u32(pixel ^ word), as ``samplers._dim_seed`` computes it."""
    return [((((bounce * 64 + purpose * 4 + c) & lds.M32) * 0x9E3779B9) ^ salt)
            & lds.M32 for c in range(k)]


def _launch(pixel, index: int, mix, owen: bool, flat: bool):
    from .. import _build

    global LAUNCHES
    if pixel.dim() != 1:
        raise ValueError(f"pixel: expected shape (N,), got {tuple(pixel.shape)}")
    n, dev = pixel.shape[0], pixel.device
    _build.check_args(dev, (("pixel", pixel, torch.int64, (n,)),))
    out = torch.empty((n,) if flat else (n, len(mix)), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    xb, yb = _bits(int(index))
    words = list(mix) + [0] * (4 - len(mix))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sobol_draw(pixel.data_ptr(), n, len(mix), int(owen),
                                *words, xb, yb, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sobol_draw launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def owen_draw_cuda(pixel, index: int, salt: int, bounce: int, purpose: int,
                   shape):
    """``ctx_uniform``'s draw on a SampleCtx(pixel, index, salt): shape (N,)
    or (N, k) with k <= 4, N the lanes of ``pixel`` ((N,) int64, CUDA,
    contiguous, u32 values)."""
    k = 1 if len(shape) == 1 else shape[1]
    if not 1 <= k <= 4:
        raise ValueError(f"a draw has 1 to 4 columns, got {k}")
    return _launch(pixel, index, draw_mix(salt, bounce, purpose, k), True,
                   flat=len(shape) == 1)


def xor_pair_cuda(pixel, pass_idx: int):
    """``pixel_samples``' sobol kinds: (N, 2) in [0, 1]."""
    return _launch(pixel, pass_idx, CAMERA_MIX, False, flat=False)
