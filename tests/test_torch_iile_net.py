"""IILE parity of the port's host-side pieces against the JAX package:
the probe transforms, the hemispherical probe camera, the schedule, and
IISPTNet at full width with the committed pretrained weights.

Inputs come from numpy seeds.  Tolerances: transforms and camera
directions within 1e-6 relative (+1e-6 absolute near zero: the two
libraries' log, exp, sin and cos differ in the last ulp); integer probe
pixels and their masks exactly; schedule task lists equal; IISPTNet's
output within 1e-4 max|y| + 1e-5 (15 convolutions accumulate in
different orders).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.integrators import schedule as jsched
from pbrt_v3_iile_tpu.ml import train as jtrain
from pbrt_v3_iile_tpu.models import iisptnet as jnet
from pbrt_v3_iile_tpu.models import transforms as jnnx
from pbrt_v3_iile_tpu.ops import camera as jcam
from pbrt_v3_iile_tpu_torch.integrators import schedule as tsched
from pbrt_v3_iile_tpu_torch.models import iisptnet as tnet
from pbrt_v3_iile_tpu_torch.models import transforms as tnnx
from pbrt_v3_iile_tpu_torch.models import weights as tweights
from pbrt_v3_iile_tpu_torch.ops import camera as tcam

from torch_parity import assert_close, run_both, to_np, tt

RTOL, ATOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def flax_vars():
    return jtrain.load_pretrained(jtrain.default_pretrained_path())


def _gbuffer(rng, shape):
    """Probe-like maps: radiance >= 0 with zeros, unit normals, distances
    with misses (-1)."""
    inten = rng.exponential(0.3, shape + (3,)).astype(np.float32)
    inten[rng.random(shape) < 0.1] = 0.0
    nrm = rng.normal(size=shape + (3,)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dist = rng.uniform(0.1, 20.0, shape + (1,)).astype(np.float32)
    dist[rng.random(shape) < 0.1] = -1.0
    return inten, nrm, dist


@pytest.mark.parametrize("name", ["positive_log", "positive_log_inverse",
                                  "normals_downstream"])
def test_elementwise_transforms(name):
    x = np.random.default_rng(1).normal(0.0, 3.0, 4096).astype(np.float32)
    j, t = run_both(getattr(jnnx, name), getattr(tnnx, name), x)
    assert_close(t, j, RTOL, ATOL, name)


@pytest.mark.parametrize("name", ["intensity_downstream_half",
                                  "intensity_downstream_full",
                                  "intensity_upstream", "distance_downstream"])
def test_scaled_transforms(name):
    rng = np.random.default_rng(2)
    x = rng.exponential(1.0, (64, 16)).astype(np.float32)
    mean = rng.exponential(0.5, (64, 1)).astype(np.float32)
    mean[:4] = 0.0                   # the zero-mean branches
    if name == "distance_downstream":
        mean[:2] = -1.0
    j, t = run_both(getattr(jnnx, name), getattr(tnnx, name), x, mean)
    assert_close(t, j, RTOL, ATOL, name)


def test_probe_transforms_round_trip():
    rng = np.random.default_rng(3)
    inten, nrm, dist = _gbuffer(rng, (5, 8, 8))
    inten[0] = 0.0                   # a black probe: zero means
    (xj, auxj), (xt, auxt) = run_both(jnnx.probe_to_network_input,
                                      tnnx.probe_to_network_input,
                                      inten, nrm, dist)
    assert_close(xt, xj, RTOL, ATOL, "x")
    for k in ("chan_means", "overall_mean"):
        assert_close(auxt[k], auxj[k], RTOL, ATOL, k)
    y = rng.normal(0.0, 0.5, (5, 8, 8, 3)).astype(np.float32)
    y[1] = -1.0                      # all-zero output: the multiplier's branch
    rj = jnnx.network_output_to_radiance(jnp.asarray(y),
                                         {k: jnp.asarray(v) for k, v in auxj.items()})
    rt = tnnx.network_output_to_radiance(tt(y), {k: tt(v) for k, v in auxj.items()})
    assert_close(to_np(rt), np.asarray(rj), RTOL, ATOL, "radiance")


def _probe_normals(rng, P):
    n = rng.normal(size=(P, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[0], n[1] = (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)   # the pole frames
    return n


def test_hemi_frames_and_directions():
    rng = np.random.default_rng(4)
    n = _probe_normals(rng, 64)
    pos = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    j, t = run_both(jcam.hemi_frames, tcam.hemi_frames, pos, n)
    for a, b, name in zip(t, j, ("right", "up", "look")):
        assert_close(a, b, RTOL, ATOL, name)
    for hs in (8, 32):
        (dj, sj), (dt, st) = to_np(jcam.hemi_directions(hs)), to_np(
            tcam.hemi_directions(hs))
        assert_close(dt, dj, RTOL, ATOL, "directions")
        assert_close(st, sj, RTOL, ATOL, "sin_theta")


@pytest.mark.parametrize("hs", [8, 32])
def test_hemi_rays_and_pixels(hs):
    rng = np.random.default_rng(5 + hs)
    P = 32
    n = _probe_normals(rng, P)
    pos = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    jit = rng.random((P, hs, hs, 2), dtype=np.float32)
    j, t = run_both(lambda a, b, c: jcam.hemi_generate_rays(a, b, hs, c),
                    lambda a, b, c: tcam.hemi_generate_rays(a, b, hs, c),
                    pos, n, jit)
    assert_close(t[0], j[0], RTOL, ATOL, "o")
    assert_close(t[1], j[1], RTOL, ATOL, "d jittered")
    j, t = run_both(lambda a, b: jcam.hemi_generate_rays(a, b, hs),
                    lambda a, b: tcam.hemi_generate_rays(a, b, hs), pos, n)
    assert_close(t[1], j[1], RTOL, ATOL, "d centres")
    # the inverse map of random directions, in and out of each hemisphere
    right, up, look = (x[:, None, :] for x in to_np(tcam.hemi_frames(tt(pos), tt(n))))
    w = rng.normal(size=(P, 2048, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    j, t = run_both(lambda *a: jcam.hemi_dir_to_pixel(*a, hs),
                    lambda *a: tcam.hemi_dir_to_pixel(*a, hs),
                    w, right, up, look)
    for a, b, name in zip(t, j, ("x", "y", "ok")):
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), (name, int((a != b).sum()))
    assert 0.3 < t[2].mean() < 0.7     # both sides of the hemisphere seen


@pytest.mark.parametrize("w,h,n,radius", [(512, 512, 16, 100.0),
                                          (700, 300, 9, 100.0),
                                          (64, 64, 8, 4.0), (16, 16, 3, 100.0)])
def test_schedule_tasks_equal(w, h, n, radius):
    a = tsched.compute_schedule(w, h, n, radius_start=radius)
    b = jsched.compute_schedule(w, h, n, radius_start=radius)
    assert [vars(t) for t in a] == [vars(t) for t in b]
    assert tsched.NUMBER_TILES == jsched.NUMBER_TILES


def test_weights_npz_equal_flax_variables(flax_vars):
    sd = tweights.load_iisptnet_npz()
    net = tweights.iisptnet_from_flax(
        {k: {m: {p: np.asarray(v) for p, v in d.items()} for m, d in t.items()}
         for k, t in flax_vars.items()})
    ref = net.state_dict()
    assert sd.keys() == ref.keys()
    for k in sd:
        assert torch.equal(sd[k], ref[k]), k
    assert net.k == tnet.K
    assert tnet.forward_flops(32) == 990_117_888   # 0.99 GFLOP a 32^2 probe


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tweights.load_iisptnet_npz(os.path.join(tmp_path, "absent.npz"))


@pytest.mark.parametrize("shape", [(3, 32, 32, 7), (2, 8, 8, 7)])
def test_iisptnet_full_width(flax_vars, shape):
    x = np.random.default_rng(6).normal(0.0, 1.0, shape).astype(np.float32)
    y_ref = np.asarray(jnet.IISPTNet().apply(flax_vars, jnp.asarray(x),
                                             train=False))
    net = tweights.load_iisptnet(device="cpu")
    with torch.no_grad():
        y = net(tt(x)).numpy()
    assert y.shape == y_ref.shape
    err = np.abs(y - y_ref).max()
    assert err <= 1e-4 * np.abs(y_ref).max() + 1e-5, err
