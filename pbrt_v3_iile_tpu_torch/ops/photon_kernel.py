"""SPPM photon gather's range query (K4): the wrapper of
``csrc/photon_gather.cu`` and its plain version.

Replaces the range query of the reference's
``integrators/sppm.py::_gather`` (a ``fori_loop`` of K_CAP steps in each of
the <= 8 hashed grid cells a visible point's ball overlaps; there is no
Pallas kernel for it).  ``photon_query`` takes the visible points' cell
ranges (``lo_c``, ``hi_c``), validity, positions and squared radii, and the
photon map hashed into m buckets (m a power of two) and stably sorted by
bucket, and returns

- ``pair_point`` (P,) int32 and ``pair_photon`` (P,) int32: each photon
  within a point's radius as (the point, the photon's sorted index), in
  (point, cell offset in the reference's (ox, oy, oz) order, k) order,
  which is the row-major order of the reference's (N, 8, K_CAP) slots;
- ``M`` (N,) float32: the number of such photons of each point;
- ``dropped`` (N,) int32: the photons beyond K_CAP in its cells.

On CPU tensors it runs ``photon_query_plain``; on CUDA tensors it launches
the kernels or raises.  Both do the same rounded operations, so they agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

K_CAP = 32          # photons taken per cell per visible point
N_OFFSETS = 8       # cell offsets (ox, oy, oz) in {0, 1}^3
LAUNCHES = 0         # queries on the card (not plain-version calls) since import
KERNEL_LAUNCHES = 0  # their kernel launches: start table, count and fill

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


def bucket_start_plain(h_sorted, m: int):
    """The bucket-start table (m + 1,) int32: start[b] is the number of
    photons in buckets below b, so bucket b's run is [start[b],
    start[b + 1]) of the sorted photons (h_sorted's values lie in [0, m])."""
    n_b = torch.bincount(h_sorted.long(), minlength=m + 1)[:m + 1]
    start = torch.zeros(m + 1, dtype=torch.int64, device=h_sorted.device)
    start[1:] = torch.cumsum(n_b[:m], 0)
    return start.to(torch.int32)


def photon_query_plain(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m: int):
    """The range query in plain PyTorch (the kernels' contract): the
    (N, 8, K_CAP) mask of the photons within each point's radius,
    compacted in row-major order."""
    N = lo_c.shape[0]
    Pn = h_sorted.shape[0]
    dev = lo_c.device
    ks = torch.arange(K_CAP, dtype=torch.int64, device=dev)
    start = bucket_start_plain(h_sorted, m).to(torch.int64)
    offs = torch.tensor([[ox, oy, oz] for ox in range(2) for oy in range(2)
                         for oz in range(2)], dtype=torch.int32, device=dev)
    cc = lo_c[:, None, :] + offs[None]                              # (N, 8, 3)
    in_range = torch.all(cc <= hi_c[:, None, :], dim=-1) & valid[:, None]
    hc = hash_cells(cc.reshape(-1, 3), m).reshape(N, N_OFFSETS).to(torch.int64)
    # a cell is skipped when an earlier in-range offset has its bucket
    earlier = torch.tril(torch.ones(N_OFFSETS, N_OFFSETS, dtype=torch.bool,
                                    device=dev), diagonal=-1)       # [o, q<o]
    seen = (in_range[:, None, :] & (hc[:, :, None] == hc[:, None, :])
            & earlier[None]).any(-1)
    keep = in_range & ~seen
    lo, hi = start[hc], start[hc + 1]
    run = torch.where(keep, torch.clamp(hi - lo, max=K_CAP), 0)       # (N, 8)
    dropped = torch.where(keep, hi - lo - run, 0).sum(1).to(torch.int32)
    src = p_sorted if Pn else p_sorted.new_zeros((1, 3))   # no photon: no run
    near, photon = [], []
    for o in range(N_OFFSETS):
        j = lo[:, o, None] + ks[None, :]                            # (N, K_CAP)
        pp = src[torch.clamp(j, 0, max(Pn - 1, 0))]                 # (N, K_CAP, 3)
        dv = pp - vp_p[:, None, :]
        d2 = (dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]) \
            + dv[..., 2] * dv[..., 2]
        near.append((ks[None, :] < run[:, o, None]) & (d2 <= r2[:, None]))
        photon.append(j.to(torch.int32))
    near = torch.stack(near, 1)                                     # (N, 8, K_CAP)
    n, o, k = torch.nonzero(near, as_tuple=True)
    pair_photon = torch.stack(photon, 1)[n, o, k]
    return (n.to(torch.int32), pair_photon, near.sum((1, 2)).to(torch.float32),
            dropped)


@functools.cache
def _lib():
    from .. import _build

    lib = _build.load("photon_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.photon_count.restype = lib.photon_fill.restype = i32
    lib.photon_points_per_warp.restype = i32
    lib.photon_points_per_warp.argtypes = []
    lib.photon_count.argtypes = [ptr] * 7 + [i32] * 3 + [ptr] * 5
    lib.photon_fill.argtypes = [ptr] * 7 + [i32] * 2 + [ptr] * 4
    return lib


def photon_query_cuda(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m: int):
    """Launch the kernels on CUDA tensors -> (pair_point, pair_photon, M,
    dropped): the start table and the count pass, the prefix sum of the
    groups' pair counts, one host read of the total, the fill pass."""
    from .. import _build

    global LAUNCHES, KERNEL_LAUNCHES
    N, Pn = lo_c.shape[0], h_sorted.shape[0]
    dev = lo_c.device
    if m <= 0 or m & (m - 1):
        raise ValueError(f"m = {m}: the bucket count must be a power of two")
    valid_u8 = (valid.view(torch.uint8) if valid.dtype == torch.bool
                else valid.to(torch.uint8))
    _build.check_args(dev, (
        ("lo_c", lo_c, torch.int32, (N, 3)),
        ("hi_c", hi_c, torch.int32, (N, 3)),
        ("valid", valid_u8, torch.uint8, (N,)),
        ("vp_p", vp_p, torch.float32, (N, 3)),
        ("r2", r2, torch.float32, (N,)),
        ("h_sorted", h_sorted, torch.int32, (Pn,)),
        ("p_sorted", p_sorted, torch.float32, (Pn, 3))))
    M = torch.empty(N, dtype=torch.float32, device=dev)
    dropped = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        none = torch.empty(0, dtype=torch.int32, device=dev)
        return none, none.clone(), M, dropped
    lib = _lib()
    start = torch.empty(m + 1, dtype=torch.int32, device=dev)
    groups = -(-N // lib.photon_points_per_warp())
    group_pairs = torch.empty(groups, dtype=torch.int64, device=dev)
    inputs = (lo_c.data_ptr(), hi_c.data_ptr(), valid_u8.data_ptr(),
              vp_p.data_ptr(), r2.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.photon_count(*inputs, h_sorted.data_ptr(), p_sorted.data_ptr(),
                               Pn, m, N, start.data_ptr(), M.data_ptr(),
                               dropped.data_ptr(), group_pairs.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"photon_count launch failed: cudaError {err}")
        KERNEL_LAUNCHES += 2
        group_end = torch.cumsum(group_pairs, 0)
        P = int(group_end[-1])                       # the one host sync
        pair_point = torch.empty(P, dtype=torch.int32, device=dev)
        pair_photon = torch.empty(P, dtype=torch.int32, device=dev)
        if P > 0:
            err = lib.photon_fill(*inputs, start.data_ptr(), p_sorted.data_ptr(),
                                  m, N, group_end.data_ptr(),
                                  pair_point.data_ptr(), pair_photon.data_ptr(),
                                  stream)
            if err != 0:
                raise RuntimeError(f"photon_fill launch failed: cudaError {err}")
            KERNEL_LAUNCHES += 1
    LAUNCHES += 1
    return pair_point, pair_photon, M, dropped


def photon_query(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m: int):
    """The range query of every visible point: the kernels on CUDA tensors,
    the plain version on CPU tensors."""
    args = [x.contiguous() for x in (lo_c, hi_c, valid, vp_p, r2, h_sorted,
                                     p_sorted)]
    if lo_c.device.type != "cuda":
        return photon_query_plain(*args, m)
    return photon_query_cuda(*args, m)
