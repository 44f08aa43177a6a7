"""Stochastic progressive photon mapping, port vs JAX.

- ``_hash_cells`` bit for bit on random int32 cells, negative ones, and
  the cell whose 32-bit hash is INT_MIN (abs(INT_MIN) = INT_MIN, the
  reference's remainder is still 0);
- the photon gather: the port's ``_gather`` (the plain version of K4's
  range query, ``ops/photon_kernel.py``, and the batched BSDF evaluation
  of the pairs it finds) against the JAX package's jitted ``_gather`` on 256
  visible points and 4,096 photons whose data holds an overfull cell (>
  K_CAP photons), cells at negative coordinates and two neighbour cells of
  one point that hash to one bucket: Phi within 1e-6 of its largest
  value, M and dropped equal; the range query's pair list is consistent
  with M, in point order, and names only photons within each point's
  radius;
- the range query's plain version (``photon_query_plain``) against the
  slot table the kernel wrote before its pair list (``_slot_table``, kept
  here as the yardstick), compacted by ``nonzero``: the pairs, M and
  dropped bit for bit, also with no pair, no point, no valid photon and
  no photon; its bucket-start table against ``searchsorted``;
- the 16^2 atrium golden of ``tools/make_bidir_golden.py`` (radius 0.05,
  4 iterations) by tests/test_golden.py's criterion, the photon-cell
  overflow count within 1% of the reference's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.integrators import sppm as jsppm
from pbrt_v3_iile_tpu.ops import bsdf as jbsdf
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.integrators import sppm as tsppm
from pbrt_v3_iile_tpu_torch.ops import bsdf as tbsdf
from pbrt_v3_iile_tpu_torch.ops import photon_kernel
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from torch_parity import REPO, golden_criterion, jax_scene_leaves, to_np, tt

MATS = """
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "point" "point from" [0 2 0] "rgb I" [3 3 3]
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "trianglemesh" "point P" [-4 0 -4  4 0 -4  4 0 4] "integer indices" [0 1 2]
Material "plastic" "rgb Kd" [0.2 0.3 0.5] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.1]
Shape "trianglemesh" "point P" [-4 1 -4  4 1 -4  4 1 4] "integer indices" [0 1 2]
Material "matte" "rgb Kd" [0.3 0.6 0.3] "float sigma" [20]
Shape "trianglemesh" "point P" [-4 2 -4  4 2 -4  4 2 4] "integer indices" [0 1 2]
WorldEnd
"""


def test_hash_cells_matches_jax():
    rng = np.random.default_rng(0)
    ic = rng.integers(-2 ** 31, 2 ** 31, (4096, 3), dtype=np.int64).astype(np.int32)
    ic[:512] = rng.integers(-40, 40, (512, 3))
    # (0, INT_MIN, 0) hashes to INT_MIN: its abs is INT_MIN
    ic[512] = (0, -2 ** 31, 0)
    for m in (1, 4096, 1 << 21):
        want = np.asarray(jsppm._hash_cells(jnp.asarray(ic), jnp.int32(m)))
        got = tsppm._hash_cells(torch.from_numpy(ic), m).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all() and (got < m).all()
    h = (np.int64(0) ^ ((np.int64(-2 ** 31) * 19349663) & 0xFFFFFFFF))
    assert h == 2 ** 31   # the INT_MIN row really hashes to INT_MIN


def _gather_inputs():
    """Visible points and photons with an overfull cell, negative cell
    coordinates and two neighbour cells of one point in one bucket."""
    rng = np.random.default_rng(1)
    N, P = 256, 4096
    m = 4096                                  # next_pow2(P)
    origin = np.float32([-2.0, -2.0, -2.0])
    radius = rng.uniform(0.05, 0.2, N).astype(np.float32)
    radius[0] = 0.2
    cell = np.float32(2.0) * np.float32(radius.max())
    vp_p = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    ph_p = rng.uniform(-3.0, 3.0, (P, 3)).astype(np.float32)
    # an overfull cell: 80 photons within 0.05 of point 1
    vp_p[1] = (1.3, 0.7, -0.4)
    ph_p[:80] = vp_p[1] + rng.uniform(-0.05, 0.05, (80, 3))
    # points and photons at negative cell coordinates
    vp_p[2:6] = rng.uniform(-2.9, -2.3, (4, 3))
    ph_p[80:400] = rng.uniform(-3.0, -2.0, (320, 3))
    # two neighbour cells that share a bucket: a point on their common
    # border (or corner) with photons on both sides
    ic = np.stack(np.meshgrid(*[np.arange(-64, 64)] * 3, indexing="ij"),
                  -1).reshape(-1, 3)
    h0 = np.asarray(jsppm._hash_cells(jnp.asarray(ic, jnp.int32), jnp.int32(m)))
    for off in np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1],
                         [0, 1, 1], [1, 1, 1]]):
        h1 = np.asarray(jsppm._hash_cells(jnp.asarray(ic + off, jnp.int32),
                                          jnp.int32(m)))
        hit = np.nonzero(h0 == h1)[0]
        if hit.size:
            c = ic[hit[0]]
            break
    border = origin + (c + np.where(off > 0, 1.0, 0.5)) * cell
    vp_p[7] = border
    radius[7] = 0.15
    ph_p[400:440] = border + rng.uniform(-0.1, 0.1, (40, 3))
    ph_ok = rng.random(P) > 0.1
    frames = []
    for _ in range(3):
        v = rng.normal(size=(N, 3)).astype(np.float32)
        frames.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    # an orthonormal frame per point
    ns = frames[0]
    t = np.cross(ns, frames[1])
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(ns, t)
    wo = np.abs(rng.normal(size=(N, 3))).astype(np.float32)
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)) * [1, 1, 1]
    wo = (wo[:, :1] * t + wo[:, 1:2] * b + wo[:, 2:] * ns).astype(np.float32)
    wi = rng.normal(size=(P, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    return dict(vp_p=vp_p, radius=radius, origin=origin, cell=cell,
                ph_p=ph_p.astype(np.float32), ph_ok=ph_ok,
                ph_pow=rng.uniform(0.0, 2.0, (P, 3)).astype(np.float32),
                ph_wi=wi, valid=rng.random(N) > 0.05,
                beta=rng.uniform(0.2, 1.0, (N, 3)).astype(np.float32),
                frame=(t.astype(np.float32), b.astype(np.float32),
                       ns.astype(np.float32)),
                wo=wo, mat=rng.integers(0, 3, N).astype(np.int32))


def test_gather_matches_jax():
    x = _gather_inputs()
    js = jdev.build_device_scene(japi.load_scene_string(MATS), with_clusters=False)
    ts = scene_from_numpy(jax_scene_leaves(js), "cpu")

    # jitted, as the reference's render_sppm runs it
    @jax.jit
    def gather_j(valid, p, wo, beta, frame, mat, *rest):
        vp = dict(valid=valid, p=p, wo=wo, beta=beta, frame=frame,
                  params=jbsdf.gather_params(js, mat))
        return jsppm._gather(vp, *rest)

    vp_t = dict(valid=tt(x["valid"]), p=tt(x["vp_p"]), wo=tt(x["wo"]),
                beta=tt(x["beta"]), frame=tuple(tt(f) for f in x["frame"]),
                params=tbsdf.gather_params(ts, tt(x["mat"])))
    ph = ("ph_p", "ph_pow", "ph_wi", "ph_ok")
    Phi_j, M_j, d_j = gather_j(
        jnp.asarray(x["valid"]), jnp.asarray(x["vp_p"]), jnp.asarray(x["wo"]),
        jnp.asarray(x["beta"]), tuple(jnp.asarray(f) for f in x["frame"]),
        jnp.asarray(x["mat"]), *(jnp.asarray(x[k]) for k in ph),
        jnp.asarray(x["radius"]), jnp.asarray(x["origin"]),
        jnp.float32(x["cell"]))
    Phi_t, M_t, d_t = tsppm._gather(vp_t, *(tt(x[k]) for k in ph),
                                    tt(x["radius"]), tt(x["origin"]),
                                    torch.tensor(x["cell"]))
    Phi_j = np.asarray(Phi_j)
    np.testing.assert_array_equal(to_np(M_t), np.asarray(M_j))
    assert int(d_t) == int(d_j) > 0
    assert np.abs(to_np(Phi_t) - Phi_j).max() <= 1e-6 * np.abs(Phi_j).max()
    assert (np.asarray(M_j) > 0).sum() > 30

    # the range query itself: its pairs agree with M and lie in the radius
    m, h_sorted, order = tsppm.photon_map(tt(x["ph_p"]), tt(x["ph_ok"]),
                                          tt(x["origin"]), torch.tensor(x["cell"]))
    lo_c, hi_c = tsppm.cell_ranges(vp_t, tt(x["radius"]), tt(x["origin"]),
                                   torch.tensor(x["cell"]))
    assert (lo_c < 0).any()
    pair_point, pair_photon, M, dropped = photon_kernel.photon_query(
        lo_c, hi_c, vp_t["valid"], vp_t["p"], tt(x["radius"]) ** 2, h_sorted,
        tt(x["ph_p"])[order], m)
    assert pair_point.dtype == pair_photon.dtype == torch.int32
    n = pair_point.long()
    np.testing.assert_array_equal(
        torch.bincount(n, minlength=256).numpy(), to_np(M))
    assert bool((n[1:] >= n[:-1]).all())
    src = order[pair_photon.long()]
    d2 = ((tt(x["ph_p"])[src] - vp_t["p"][n]) ** 2).sum(-1)
    assert bool((d2 <= tt(x["radius"])[n] ** 2 * (1 + 1e-5)).all())
    assert bool(tt(x["ph_ok"])[src].all())
    assert int(dropped.sum()) == int(d_j)
    # the shared bucket is visited once: point 7 counts each photon once
    assert len(set(src[n == 7].tolist())) == int((n == 7).sum()) > 0


def _slot_table(lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m):
    """The range query as an (N, 8 * K_CAP) slot table (slot o * K_CAP + k:
    the sorted index of the k-th photon of the point's o-th cell offset
    within its radius, or -1), M and dropped: the form the kernel had
    before its pair list, written apart from photon_query_plain as its
    yardstick."""
    K_CAP = photon_kernel.K_CAP
    N = lo_c.shape[0]
    Pn = h_sorted.shape[0]
    ks = torch.arange(K_CAP, dtype=torch.int64)
    slots, seen = [], []
    M = torch.zeros(N, dtype=torch.float32)
    dropped = torch.zeros(N, dtype=torch.int32)
    for ox in range(2):
        for oy in range(2):
            for oz in range(2):
                cc = lo_c + torch.tensor([ox, oy, oz], dtype=torch.int32)
                in_range = torch.all(cc <= hi_c, dim=-1) & valid
                hc = photon_kernel.hash_cells(cc, m)
                for h_prev, in_prev in seen:
                    in_range = in_range & ~(in_prev & (hc == h_prev))
                seen.append((hc, in_range))
                lo = torch.searchsorted(h_sorted, hc).to(torch.int64)
                hi = torch.searchsorted(h_sorted, hc, right=True).to(torch.int64)
                hi_cap = torch.minimum(hi, lo + K_CAP)
                dropped = dropped + torch.where(in_range, hi - hi_cap, 0).to(torch.int32)
                j = lo[:, None] + ks[None, :]                       # (N, K_CAP)
                take = in_range[:, None] & (j < hi_cap[:, None])
                pp = (p_sorted[torch.clamp(j, 0, Pn - 1)] if Pn
                      else torch.zeros(N, K_CAP, 3))
                dv = pp - vp_p[:, None, :]
                d2 = (dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]) \
                    + dv[..., 2] * dv[..., 2]
                near = take & (d2 <= r2[:, None])
                slots.append(torch.where(near, j, -1).to(torch.int32))
                M = M + near.sum(dim=1).to(torch.float32)
    return torch.cat(slots, dim=1), M, dropped


def _query_args(x, keep=None, ph_ok=None):
    """photon_query's arguments for _gather_inputs' data; keep: the visible
    points kept; ph_ok: the photons' validity in place of x's."""
    cell = torch.tensor(x["cell"])
    ok = tt(x["ph_ok"]) if ph_ok is None else torch.as_tensor(ph_ok)
    m, h_sorted, order = tsppm.photon_map(tt(x["ph_p"]), ok, tt(x["origin"]),
                                          cell)
    keep = slice(None) if keep is None else keep
    vp = dict(p=tt(x["vp_p"])[keep], valid=tt(x["valid"])[keep])
    radius = tt(x["radius"])[keep]
    lo_c, hi_c = tsppm.cell_ranges(vp, radius, tt(x["origin"]), cell)
    return (lo_c, hi_c, vp["valid"], vp["p"], radius * radius, h_sorted,
            tt(x["ph_p"])[order].contiguous(), m)


@pytest.mark.parametrize("case", ["gather_inputs", "no_pair", "no_point",
                                  "no_valid_photon", "no_photon"])
def test_photon_query_plain_matches_slot_table(case):
    """photon_query_plain's pair list is the slot table's nonzero
    compaction bit for bit, with M and dropped equal: on _gather_inputs
    (an overfull cell, negative cells, a shared bucket), on points whose
    balls hold no photon, with no point, with every photon invalid and
    with no photon."""
    x = _gather_inputs()
    keep = ph_ok = None
    if case == "no_pair":
        # cells of 2e-4: the visited buckets hold only other cells' photons
        x["radius"] = np.full_like(x["radius"], 1e-4)
        x["cell"] = np.float32(2e-4)
    elif case == "no_point":
        keep = slice(0, 0)
    elif case == "no_valid_photon":
        ph_ok = np.zeros(x["ph_p"].shape[0], bool)
    elif case == "no_photon":
        for k in ("ph_p", "ph_ok"):
            x[k] = x[k][:0]
    args = _query_args(x, keep, ph_ok)
    pair_point, pair_photon, M, dropped = photon_kernel.photon_query_plain(*args)
    slots, M_t, dropped_t = _slot_table(*args)
    n, k = torch.nonzero(slots >= 0, as_tuple=True)
    assert pair_point.dtype == pair_photon.dtype == torch.int32
    assert torch.equal(pair_point, n.to(torch.int32))
    assert torch.equal(pair_photon, slots[n, k])
    assert torch.equal(M, M_t) and torch.equal(dropped, dropped_t)
    if case == "gather_inputs":
        assert int(M.max()) > photon_kernel.K_CAP and int(dropped.sum()) > 0
        assert (args[0] < 0).any()
    if case == "no_point":
        assert pair_point.shape == (0,) and M.shape == (0,)
    if case != "gather_inputs":
        assert pair_point.shape == (0,)
    if case in ("no_valid_photon", "no_photon"):
        assert int(dropped.sum()) == 0


def test_bucket_start_plain_matches_searchsorted():
    """The bucket-start table against searchsorted: start[b] is the first
    sorted index whose bucket is >= b and start[b + 1] the first past it,
    with empty buckets, the sentinel m, m = 2 and every photon invalid."""
    rng = np.random.default_rng(5)
    cases = [np.sort(rng.integers(0, 64, 200)),                 # empty buckets
             np.sort(np.r_[rng.integers(0, 64, 150), [64] * 50]),  # sentinel 64
             np.array([0, 0, 1, 2, 2]),                          # m = 2
             np.full(7, 2),                                      # all invalid
             np.zeros(0, np.int64)]                              # no photon
    for h in cases:
        m = 2 if h.size == 0 or h.max() <= 2 else 64
        h_sorted = torch.as_tensor(h, dtype=torch.int32)
        start = photon_kernel.bucket_start_plain(h_sorted, m)
        b = torch.arange(m + 1, dtype=torch.int32)
        assert start.dtype == torch.int32 and start.shape == (m + 1,)
        assert torch.equal(start.long(), torch.searchsorted(h_sorted, b))
        assert torch.equal(start[1:].long(),
                           torch.searchsorted(h_sorted, b[:-1], right=True))


def test_sppm_golden16():
    import importlib.util

    from pbrt_v3_iile_tpu_torch.integrators import render as trender
    from pbrt_v3_iile_tpu_torch.scene import api as tapi

    spec = importlib.util.spec_from_file_location(
        "make_bidir_golden", os.path.join(REPO, "tools", "make_bidir_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    z = np.load(os.path.join(REPO, "tests", "golden", "bidir16_sppm.npz"))
    case = tool.case_of(z)
    sd = tool.load_case(tapi, case)
    img, st = trender.render(sd, spp=case["iterations"], seed=case["seed"],
                             device="cpu")
    ok, info = golden_criterion(img, z["img"])
    assert ok, info
    want = int(z["dropped"])
    assert abs(st["dropped"] - want) <= 0.01 * want, (st["dropped"], want)
