"""Halton and MaxMinDist streams, port vs JAX, bit for bit.

The port computes the radical inverses on the host in float32 numpy
(the wavefront's pass index is one value), digit by digit as the
reference's loop does.  XLA on the CPU contracts that loop's
``val + digit * scale`` into a fused multiply-add; the port rounds each
digit's product-and-sum once as well, so the streams are identical.
``scrambled_radical_inverse`` and ``halton_dim`` for all 128 dimensions
are held to SHA-256 digests of the JAX package's output
(tests/golden/halton_streams.npz, tools/make_scenes_golden.py: one JAX
program per dimension compiles in ~45 s), and a few dimensions live.
Also the JAX package's properties of these streams
(tests/test_sampling.py, tests/test_globalsampler.py) on the port.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.ops import lds as jlds
from pbrt_v3_iile_tpu.ops import samplers as jsmp
from pbrt_v3_iile_tpu_torch.ops import lds as tlds
from pbrt_v3_iile_tpu_torch.ops import samplers as tsmp
from pbrt_v3_iile_tpu_torch.ops import threefry

from torch_parity import REPO

GOLDEN = os.path.join(REPO, "tests", "golden", "halton_streams.npz")


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a, np.float32)).tobytes()).hexdigest()


def test_halton_dims_match_jax_digests():
    z = np.load(GOLDEN)
    idx = z["idx"]
    assert idx.shape == (4096,) and tlds.N_HALTON_DIMS == 128
    assert tlds.PRIMES_FULL == jlds.PRIMES_FULL
    bad = [d for d in range(128)
           if _digest(tlds.scrambled_radical_inverse(d, idx))
           != z["scrambled_radical_inverse"][d]
           or _digest(tlds.halton_dim(idx, d)) != z["halton_dim"][d]]
    assert not bad, f"dimensions differing from the JAX package: {bad}"


def test_radical_inverses_match_jax_live():
    idx = np.random.default_rng(1).integers(0, 2 ** 32, 4096,
                                            dtype=np.uint64).astype(np.uint32)
    # one dimension live beside the digests (bases 2 and 3 unpermuted run
    # live in test_pixel_samples_bit_exact)
    np.testing.assert_array_equal(
        tlds.scrambled_radical_inverse(127, idx),
        np.asarray(jlds.scrambled_radical_inverse(127, jnp.asarray(idx))))
    for dim in (0, 5, 77, 130, 447):   # the dynamic form wraps at 128
        np.testing.assert_array_equal(
            tlds.scrambled_radical_inverse_dyn(dim, idx),
            np.asarray(jlds.scrambled_radical_inverse_dyn(jnp.uint32(dim),
                                                          jnp.asarray(idx))))
    # the digit permutations are the same seeded arrays, per seed
    for seed in (0, 3):
        for b in (2, 29, 719):
            np.testing.assert_array_equal(tlds._digit_perms(seed)[b],
                                          jlds._digit_perms(seed)[b])


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6])
def test_maxmin_matrix_matches_jax(m):
    tc, ts = tlds._maxmin_matrix(m)
    jc, js = jlds._maxmin_matrix(m)
    np.testing.assert_array_equal(tc, jc)
    assert ts == js


@pytest.mark.parametrize("n", [4, 16, 64, 8192])
def test_maxmin02_matches_jax(n):
    rng = np.random.default_rng(n)
    sx = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    sy = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    for i in (0, 1, n // 2 + 1, n + 5):
        jx, jy = jlds.maxmin02(jnp.full((256,), i, jnp.uint32), n,
                               jnp.asarray(sx), jnp.asarray(sy))
        tx, ty = tlds.maxmin02_shared(i, n, torch.as_tensor(sx.astype(np.int64)),
                                      torch.as_tensor(sy.astype(np.int64)))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("kind", ["halton", "halton-global", "maxmindist"])
def test_pixel_samples_bit_exact(kind):
    pix = np.arange(4096)
    for pass_idx, spp in ((5, 16), (37, 64)):
        jk = jsmp.wave_key(jax.random.PRNGKey(2), pass_idx, 0,
                           jsmp.DIM_PIXEL_JITTER)
        tk = tsmp.wave_key(threefry.prng_key(2), pass_idx, 0,
                           tsmp.DIM_PIXEL_JITTER)
        a = np.asarray(jsmp.pixel_samples(kind, jk, jnp.asarray(pix, jnp.uint32),
                                          pass_idx, spp))
        b = tsmp.pixel_samples(kind, tk, torch.as_tensor(pix), pass_idx,
                               spp).numpy()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(3000,), (3000, 3)])
def test_ctx_uniform_halton_ctx_bit_exact(shape):
    pix = np.random.default_rng(8).permutation(65536)[:shape[0]]
    jkey, tkey = jax.random.PRNGKey(11), threefry.prng_key(11)
    for pass_idx in (1000,):
        jctx = jsmp.make_sample_ctx(jkey, jnp.asarray(pix, jnp.int32), pass_idx,
                                    kind="halton-global")
        tctx = tsmp.make_sample_ctx(tkey, torch.as_tensor(pix), pass_idx,
                                    kind="halton-global")
        assert isinstance(tctx, tsmp.HaltonCtx)
        assert isinstance(tctx.with_pixel(tctx.pixel[:5]), tsmp.HaltonCtx)
        for bounce, purpose in ((0, 2), (6, 15)):
            a = np.asarray(jsmp.ctx_uniform(jctx, jkey, bounce, purpose, shape))
            b = tsmp.ctx_uniform(tctx, tkey, bounce, purpose, shape).numpy()
            np.testing.assert_array_equal(a, b)
    # halton and maxmindist take the padded-sobol context, as in JAX
    for kind in ("halton", "maxmindist"):
        ctx = tsmp.make_sample_ctx(tkey, torch.as_tensor(pix), 3, kind=kind)
        assert type(ctx) is tsmp.SampleCtx


def test_scrambled_radical_inverse_high_dims():
    """tests/test_sampling.py's property on the port: uniform in [0,1),
    the first min(n, base) samples in distinct 1/base strata, and the
    dynamic-dimension form within 2e-5 of the static one."""
    i = np.arange(1024, dtype=np.uint32)
    for dim in (17, 40, 100):
        v = tlds.scrambled_radical_inverse(dim, i)
        assert (v >= 0).all() and (v < 1).all()
        assert abs(v.mean() - 0.5) < 0.05
        base = tlds.PRIMES_FULL[dim]
        nb = min(1024, base)
        assert len(set(np.floor(v[:nb] * base).astype(int).tolist())) == nb
        np.testing.assert_allclose(v, tlds.scrambled_radical_inverse_dyn(dim, i),
                                   atol=2e-5)


def test_maxmin_beats_sobol_min_distance():
    """tests/test_sampling.py's property on the port: the searched
    patterns beat sobol02's toroidal min distance by 20%."""
    def min_d2(xs, ys):
        dx = np.abs(xs[:, None] - xs[None, :])
        dy = np.abs(ys[:, None] - ys[None, :])
        dx, dy = np.minimum(dx, 1 - dx), np.minimum(dy, 1 - dy)
        d2 = dx * dx + dy * dy
        np.fill_diagonal(d2, 9.0)
        return d2.min()

    for m in (4, 6):
        n = 1 << m
        mm = np.asarray([tlds.maxmin02_bits_int(i, n) for i in range(n)],
                        np.float64) / 2 ** 32
        sb = np.asarray([tlds.sobol02_bits_int(i) for i in range(n)],
                        np.float64) / 2 ** 32
        dm, ds = min_d2(mm[:, 0], mm[:, 1]), min_d2(sb[:, 0], sb[:, 1])
        assert dm > ds * 1.2, (m, dm, ds)


def test_ctx_uniform_stratified_over_passes():
    """tests/test_globalsampler.py's property on the port: per pixel, one
    decision's samples over 16 passes form a (0,2)-net, one to each 1/16
    stratum."""
    key = threefry.prng_key(0)
    pix = torch.arange(8)
    n_pass = 16
    us = np.stack([tsmp.ctx_uniform(tsmp.make_sample_ctx(key, pix, p), key, 2,
                                    tsmp.DIM_LIGHT_SAMPLE, (8, 2)).numpy()
                   for p in range(n_pass)])
    for px in range(8):
        counts = np.bincount((us[:, px, 0] * n_pass).astype(int),
                             minlength=n_pass)
        assert (counts == 1).all(), (px, counts)
