"""The frozen K1 count equals the repository's check's count, computed with
the port's own candidate tables, on a seeded soup; bound() is the larger of
the two peaks' times."""

import types

import pytest
import torch

from benchmark import roofline


def test_bound_takes_the_larger_time():
    # the slab tests of chip_smoke's 65,536-ray bounce wave alone
    t, by = roofline.bound(72_351_744 * roofline.CULL_OPS, 0)
    assert by == "operations" and t == pytest.approx(72_351_744 * 28 / 67e12)
    # K2's yardstick: 10.7 MB at 3.35 TB/s is 3.2 us
    t, by = roofline.bound(0, 10.7e6)
    assert by == "bytes" and t == pytest.approx(3.194e-6, rel=1e-3)


def _soup(seed, K=96, G=64, groups=24):
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((K, 3), generator=g) * 8 - 4
    h = torch.rand((K, 3), generator=g) * 0.6 + 0.05
    cnt = torch.randint(1, 129, (K,), generator=g, dtype=torch.int32)
    off = torch.cumsum(cnt, 0).to(torch.int32) - cnt
    cp = types.SimpleNamespace(aabb_min=c - h, aabb_max=c + h, tri_off=off, tri_cnt=cnt)
    N = G * groups
    o = torch.rand((N, 3), generator=g) * 8 - 4
    d = torch.nn.functional.normalize(torch.randn((N, 3), generator=g), dim=1)
    t_max = torch.where(torch.rand(N, generator=g) < 0.1, -1.0, 20.0)
    t_out = torch.where(t_max > 0, torch.rand(N, generator=g) * 10, t_max)
    return cp, o, d, t_max, t_out


def _check_count(cp, o, d, t_max, t_out, maxc):
    """chip_smoke.py's count of K1's bound, with the port's tables."""
    from pbrt_v3_iile_tpu_torch.ops import clusters_kernel as K1

    cand, cpk, ctn, ncand, n_cand = K1.candidate_tables(cp, o, d, t_max, maxc)
    G, K = K1.G_DEFAULT, cp.aabb_min.shape[0]
    live = (t_max > 0).reshape(-1, G)
    gmax = torch.where(live, t_out.reshape(-1, G), -3e38).amax(1)
    slot = torch.arange(cand.shape[1])[None, :]
    need = ((slot < ncand[:, None]) & (n_cand <= maxc)[:, None]
            & ((ctn < gmax[:, None]) | (slot == 0)))
    tris = int(((cpk & 255) * need).sum())
    slabs = int(live.any(1).sum()) * G * K
    ops = slabs * 28 + tris * G * 50
    nbytes = (int(torch.unique(cand[need]).numel()) * 22 * K1.C * 4
              + K * (24 + 8) + t_max.shape[0] * (28 + 8) + cand.shape[0] * 4)
    return ops, nbytes, slabs, tris


@pytest.mark.parametrize("seed, maxc", [(1, 96), (2, 96), (3, 32)])
def test_k1_count_matches_the_check(seed, maxc):
    cp, o, d, t_max, t_out = _soup(seed)
    ops, nbytes, slabs, tris = _check_count(cp, o, d, t_max, t_out, maxc)
    w = roofline.k1_work(cp.aabb_min, cp.aabb_max, cp.tri_cnt, o, d, t_max, t_out, maxc)
    assert (w["ops"], w["bytes"], w["slab_tests"], w["triangles"]) == (ops, nbytes, slabs, tris)
    assert tris > 0
