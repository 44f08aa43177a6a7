"""Parity of the port's random streams and sample warps with the JAX package.

Random streams must be bit-exact: the port's render of a seed is meant
to be the same estimator realisation as the JAX render.  Float helpers
(vecmath, sampling) agree within 1e-6 (f32 rounding of the same ops; the
transcendentals of the two libraries may differ in the last ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_v3_iile_tpu.ops import lds as jlds
from pbrt_v3_iile_tpu.ops import samplers as jsmp
from pbrt_v3_iile_tpu.ops import sampling as jsampling
from pbrt_v3_iile_tpu.utils import vecmath as jvm
from pbrt_v3_iile_tpu_torch.ops import lds as tlds
from pbrt_v3_iile_tpu_torch.ops import samplers as tsmp
from pbrt_v3_iile_tpu_torch.ops import sampling as tsampling
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.utils import vecmath as tvm

from torch_parity import assert_close, run_both

U32_EDGES = np.array([0, 1, 2, 61, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF], np.uint32)


def _u32(n, seed):
    x = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    x = x.astype(np.uint32)
    x[:len(U32_EDGES)] = U32_EDGES
    return x


def _t64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _key_pair(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 7, 3, 12345, 2 ** 31 - 1])
def test_threefry_keys_fold_in_split_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    assert _key_pair(jk) == tk
    for data in (0, 1, 5, 0x5D5, 0xFFFFFFFF, 123456789):
        assert _key_pair(jax.random.fold_in(jk, data)) == threefry.fold_in(tk, data)
    js = jax.random.split(jk)
    assert [_key_pair(k) for k in js] == threefry.split(tk)


@pytest.mark.parametrize("shape", [(100000,), (333, 3), (7, 2)])
def test_threefry_uniform_bit_exact(shape):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 3), 9)
    tk = threefry.fold_in(threefry.fold_in(threefry.prng_key(7), 3), 9)
    u_j = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
    u_t = threefry.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(u_j.view(np.uint32), u_t.view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (0, 10), (-5, 1000)])
def test_threefry_randint_bit_exact(lo, hi):
    for seed in range(20):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5D5)
        tk = threefry.fold_in(threefry.prng_key(seed), 0x5D5)
        a = np.asarray(jax.random.randint(jk, (64,), lo, hi, dtype=jnp.int32))
        b = threefry.randint(tk, (64,), lo, hi).numpy()
        np.testing.assert_array_equal(a, b)


def test_hash_and_scrambles_bit_exact():
    x = _u32(100000, 1)
    s = _u32(100000, 2)
    np.testing.assert_array_equal(
        np.asarray(jlds.hash_u32(jnp.asarray(x))).astype(np.int64),
        tlds.hash_u32(_t64(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jlds.owen_scramble_u32(jnp.asarray(x), jnp.asarray(s))
                   ).astype(np.int64),
        tlds.owen_scramble_u32(_t64(x), _t64(s)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jlds._reverse_bits32(jnp.asarray(x))).astype(np.int64),
        tlds._reverse_bits32(_t64(x)).numpy())


def test_sobol_streams_bit_exact():
    idx = _u32(100000, 3) % 65536
    idx[:len(U32_EDGES)] = U32_EDGES
    sx, sy = _u32(100000, 4), _u32(100000, 5)
    jx, jy = jlds.sobol02_bits(jnp.asarray(idx))
    tx, ty = tlds.sobol02_bits(_t64(idx))
    np.testing.assert_array_equal(np.asarray(jx).astype(np.int64), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jy).astype(np.int64), ty.numpy())
    for i in (0, 1, 2, 5, 63, 1000, 0xFFFFFFFF):
        assert tlds.sobol02_bits_int(i) == tuple(
            int(np.asarray(v)[0]) for v in jlds.sobol02_bits(
                jnp.asarray([i], jnp.uint32)))
    for a, b in zip(jlds.sobol02(jnp.asarray(idx), jnp.asarray(sx), jnp.asarray(sy)),
                    tlds.sobol02(_t64(idx), _t64(sx), _t64(sy))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jlds.sobol02_owen(jnp.asarray(idx), jnp.asarray(sx),
                                      jnp.asarray(sy)),
                    tlds.sobol02_owen(_t64(idx), _t64(sx), _t64(sy))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # radical_inverse is float arithmetic (XLA on the CPU contracts its
    # multiply-add into an FMA): equal to 1 ulp
    for base in (2, 3, 5):
        assert_close(tlds.radical_inverse(base, _t64(idx[:4096])).numpy(),
                     np.asarray(jlds.radical_inverse(base,
                                                     jnp.asarray(idx[:4096]))),
                     rtol=2e-7, atol=1e-7, name=f"radical_inverse({base})")


@pytest.mark.parametrize("shape", [(5000,), (5000, 2), (5000, 3)])
@pytest.mark.parametrize("bounce,purpose", [(0, 2), (3, 5), (1, 15)])
def test_ctx_uniform_bit_exact(shape, bounce, purpose):
    pix = np.random.default_rng(8).permutation(65536)[:shape[0]]
    jkey = jax.random.PRNGKey(11)
    tkey = threefry.prng_key(11)
    jctx = jsmp.make_sample_ctx(jkey, jnp.asarray(pix, jnp.int32), 6)
    tctx = tsmp.make_sample_ctx(tkey, _t64(pix), 6)
    assert int(jctx.salt) == tctx.salt
    a = np.asarray(jsmp.ctx_uniform(jctx, jkey, bounce, purpose, shape))
    b = tsmp.ctx_uniform(tctx, tkey, bounce, purpose, shape).numpy()
    np.testing.assert_array_equal(a, b)
    a = np.asarray(jsmp.ctx_uniform(None, jkey, bounce, purpose, shape))
    b = tsmp.ctx_uniform(None, tkey, bounce, purpose, shape).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "stratified", "sobol"])
def test_pixel_samples_bit_exact(kind):
    pix = np.arange(4096)
    jk = jsmp.wave_key(jax.random.PRNGKey(2), 3, 0, jsmp.DIM_PIXEL_JITTER)
    tk = tsmp.wave_key(threefry.prng_key(2), 3, 0, tsmp.DIM_PIXEL_JITTER)
    a = np.asarray(jsmp.pixel_samples(kind, jk, jnp.asarray(pix, jnp.uint32), 5, 16))
    b = tsmp.pixel_samples(kind, tk, _t64(pix), 5, 16).numpy()
    np.testing.assert_array_equal(a, b)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_vecmath_matches():
    rng = np.random.default_rng(0)
    a, b, n = _unit(rng, 4096), _unit(rng, 4096), _unit(rng, 4096)
    p = rng.uniform(-50, 50, (4096, 3)).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    cases = [
        ("dot", lambda m: m.dot, (a, b)),
        ("cross", lambda m: m.cross, (a, b)),
        ("normalize", lambda m: m.normalize, (p,)),
        ("face_forward", lambda m: m.face_forward, (a, b)),
        ("reflect", lambda m: m.reflect, (a, n)),
        ("coordinate_system", lambda m: m.coordinate_system, (n,)),
        ("spherical_theta", lambda m: m.spherical_theta, (a,)),
        ("spherical_phi", lambda m: m.spherical_phi, (a,)),
        ("luminance", lambda m: m.luminance, (np.abs(p),)),
        ("offset_ray_origin", lambda m: m.offset_ray_origin, (p, n, a)),
        ("refract", lambda m: m.refract, (a, n, eta)),
    ]
    for name, get, args in cases:
        j, t = run_both(get(jvm), get(tvm), *args)
        js = j if isinstance(j, tuple) else (j,)
        ts = t if isinstance(t, tuple) else (t,)
        assert len(js) == len(ts)
        for x, y in zip(js, ts):
            assert_close(y, x, rtol=1e-6, atol=1e-6, name=name)


def test_sampling_warps_match():
    rng = np.random.default_rng(1)
    u = rng.random((8192, 2), dtype=np.float32)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.999999, 0.0], [0.25, 0.75]]
    ct = rng.uniform(0.0, 0.99, 8192).astype(np.float32)
    pdfs = rng.uniform(0.0, 5.0, (2, 8192)).astype(np.float32)
    for name in ("concentric_sample_disk", "cosine_sample_hemisphere",
                 "uniform_sample_sphere", "uniform_sample_hemisphere",
                 "uniform_sample_triangle"):
        j, t = run_both(getattr(jsampling, name), getattr(tsampling, name), u)
        assert_close(t, j, rtol=1e-6, atol=1e-6, name=name)
    j, t = run_both(jsampling.uniform_sample_cone, tsampling.uniform_sample_cone,
                    u, ct)
    assert_close(t, j, rtol=1e-6, atol=1e-6, name="cone")
    j, t = run_both(lambda f, g: jsampling.power_heuristic(1.0, f, 1.0, g),
                    lambda f, g: tsampling.power_heuristic(1.0, f, 1.0, g),
                    pdfs[0], pdfs[1])
    assert_close(t, j, rtol=1e-6, atol=1e-7, name="power_heuristic")
