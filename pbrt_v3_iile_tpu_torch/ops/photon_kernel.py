"""SPPM photon gather's range query (K4): the wrapper of
``csrc/photon_gather.cu`` and its plain version.

Replaces the range query of the reference's
``integrators/sppm.py::_gather`` (a ``fori_loop`` of K_CAP steps in each of
the <= 8 hashed grid cells a visible point's ball overlaps; there is no
Pallas kernel for it).  ``photon_query`` takes the visible points' cell
ranges (``lo_c``, ``hi_c``), validity, positions and squared radii, and the
photon map hashed into m buckets (m a power of two) and stably sorted by
bucket, and returns

- ``slots`` (N, 8 * K_CAP) int32: slot o * K_CAP + k holds the sorted index
  of the k-th photon of the point's o-th cell offset (the reference's
  (ox, oy, oz) order) that lies within the radius, or -1;
- ``M`` (N,) float32: the number of such photons;
- ``dropped`` (N,) int32: the photons beyond K_CAP in its cells.

On CPU tensors it runs ``photon_query_plain``; on CUDA tensors it launches
the kernel or raises.  Both do the same rounded operations, so they agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

K_CAP = 32          # photons taken per cell per visible point
N_OFFSETS = 8       # cell offsets (ox, oy, oz) in {0, 1}^3
LAUNCHES = 0        # kernel launches (not plain-version calls) since import

_M32 = 0xFFFFFFFF


def hash_cells(ic, m: int):
    """Spatial hash of int cell coordinates ic (N,3) into [0, m) (m a power
    of two): |x*73856093 ^ y*19349663 ^ z*83492791| mod m with the products
    wrapped to int32 as the reference's, int32 out."""
    c = ic.to(torch.int64)
    h = (((c[:, 0] * 73856093) & _M32) ^ ((c[:, 1] * 19349663) & _M32)
         ^ ((c[:, 2] * 83492791) & _M32))
    h = torch.where(h >= 2 ** 31, h - 2 ** 32, h)     # the int32 value
    return (torch.abs(h) & (m - 1)).to(torch.int32)


def photon_query_plain(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m: int):
    """The range query in plain PyTorch (the kernel's contract)."""
    N = lo_c.shape[0]
    Pn = h_sorted.shape[0]
    dev = lo_c.device
    ks = torch.arange(K_CAP, dtype=torch.int64, device=dev)
    slots, seen = [], []
    M = torch.zeros(N, dtype=torch.float32, device=dev)
    dropped = torch.zeros(N, dtype=torch.int32, device=dev)
    for ox in range(2):
        for oy in range(2):
            for oz in range(2):
                cc = lo_c + torch.tensor([ox, oy, oz], dtype=torch.int32, device=dev)
                in_range = torch.all(cc <= hi_c, dim=-1) & valid
                hc = hash_cells(cc, m)
                for h_prev, in_prev in seen:
                    in_range = in_range & ~(in_prev & (hc == h_prev))
                seen.append((hc, in_range))
                lo = torch.searchsorted(h_sorted, hc).to(torch.int64)
                hi = torch.searchsorted(h_sorted, hc, right=True).to(torch.int64)
                hi_cap = torch.minimum(hi, lo + K_CAP)
                dropped = dropped + torch.where(in_range, hi - hi_cap, 0).to(torch.int32)
                j = lo[:, None] + ks[None, :]                       # (N, K_CAP)
                take = in_range[:, None] & (j < hi_cap[:, None])
                pp = p_sorted[torch.clamp(j, 0, max(Pn - 1, 0))]      # (N, K_CAP, 3)
                dv = pp - vp_p[:, None, :]
                d2 = (dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]) \
                    + dv[..., 2] * dv[..., 2]
                near = take & (d2 <= r2[:, None])
                slots.append(torch.where(near, j, -1).to(torch.int32))
                M = M + near.sum(dim=1).to(torch.float32)
    return torch.cat(slots, dim=1), M, dropped


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load("photon_gather")
    fn = lib.photon_gather
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    return lib


def photon_query_cuda(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m: int):
    """Launch the kernel on CUDA tensors -> (slots, M, dropped)."""
    from .. import _build

    global LAUNCHES
    N, Pn = lo_c.shape[0], h_sorted.shape[0]
    dev = lo_c.device
    if m <= 0 or m & (m - 1):
        raise ValueError(f"m = {m}: the bucket count must be a power of two")
    valid_u8 = valid.to(torch.uint8)
    _build.check_args(dev, (
        ("lo_c", lo_c, torch.int32, (N, 3)),
        ("hi_c", hi_c, torch.int32, (N, 3)),
        ("valid", valid_u8, torch.uint8, (N,)),
        ("vp_p", vp_p, torch.float32, (N, 3)),
        ("r2", r2, torch.float32, (N,)),
        ("h_sorted", h_sorted, torch.int32, (Pn,)),
        ("p_sorted", p_sorted, torch.float32, (Pn, 3))))
    slots = torch.empty((N, N_OFFSETS * K_CAP), dtype=torch.int32, device=dev)
    M = torch.empty(N, dtype=torch.float32, device=dev)
    dropped = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return slots, M, dropped
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.photon_gather(
            lo_c.data_ptr(), hi_c.data_ptr(), valid_u8.data_ptr(),
            vp_p.data_ptr(), r2.data_ptr(), h_sorted.data_ptr(),
            p_sorted.data_ptr(), Pn, m, slots.data_ptr(), M.data_ptr(),
            dropped.data_ptr(), N, stream)
    if err != 0:
        raise RuntimeError(f"photon_gather launch failed: cudaError {err}")
    LAUNCHES += 1
    return slots, M, dropped


def photon_query(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m: int):
    """The range query of every visible point: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    args = [x.contiguous() for x in (lo_c, hi_c, valid, vp_p, r2, h_sorted,
                                     p_sorted)]
    if lo_c.device.type != "cuda":
        return photon_query_plain(*args, m)
    return photon_query_cuda(*args, m)
