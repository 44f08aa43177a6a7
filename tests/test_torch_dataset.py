"""The port's training data against the JAX package's: augmentation,
normalization, batching, the probe dataset generator, the PFM loader,
the losses and the image metrics.

Inputs come from numpy seeds.  Tolerances: ``augment`` exact for all 16
variants (flips and rotations only move values); ``example_from_maps``
within 1e-6 relative (+1e-6 absolute) (log, exp and the means round differently in the last ulp);
``batches_from_raw`` for a fixed key: the same permutation (so the same
examples and variants) and batches within 1e-6; the losses within 1e-7
relative in float64 (in float32 within 1e-6: the two libraries' means
sum in different orders); the metrics (a numpy copy) equal.  ``generate_examples`` is
held to a golden of the JAX function (``tools/make_train_golden.py``;
calling it here would cost ~35 s of compilation): ``valid`` equal, maps
within 1e-5 on the valid probes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.ml import dataset as jds
from pbrt_v3_iile_tpu.ml import losses as jlosses
from pbrt_v3_iile_tpu.utils import image as jimage
from pbrt_v3_iile_tpu.utils import metrics as jmetrics
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.ml import dataset as tds
from pbrt_v3_iile_tpu_torch.ml import losses as tlosses
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.utils import metrics as tmetrics

from torch_parity import REPO, assert_close, to_np, tt

GOLDEN_BOX = os.path.join(REPO, "tests", "golden", "train_box32_bvh_h8_g4_s2_s0.npz")


def raw_examples(n, hemi=8, seed=0):
    """Probe-like raw maps: radiance >= 0, unit normals, distances with
    misses (-1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.exponential(0.5, (hemi, hemi, 3)).astype(np.float32)
        d = (p * rng.exponential(1.0, p.shape)).astype(np.float32)
        nrm = rng.normal(size=(hemi, hemi, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        z = rng.uniform(0.2, 9.0, (hemi, hemi, 1)).astype(np.float32)
        z[rng.random((hemi, hemi)) < 0.1] = -1.0
        out.append(dict(p=p, d=d, n=nrm, z=z))
    return out


@pytest.mark.parametrize("aug", range(16))
def test_augment_equal(aug):
    # non-square maps with a batch axis: a rotation's direction and a
    # flip's axis both show
    m = np.random.default_rng(aug).normal(size=(2, 6, 4, 3)).astype(np.float32)
    want = np.asarray(jds.augment(jnp.asarray(m), aug))
    got = to_np(tds.augment(tt(m), aug))
    assert got.shape == want.shape and np.array_equal(got, want), aug


@pytest.mark.parametrize("aug", [0, 5, 10, 15])
def test_example_from_maps(aug):
    ex = raw_examples(1)[0]
    xj, yj = jds.example_from_maps(*(jnp.asarray(ex[k]) for k in "pdnz"), aug)
    xt, yt = tds.example_from_maps(*(tt(ex[k]) for k in "pdnz"), aug)
    assert_close(to_np(xt), np.asarray(xj), 1e-6, 1e-6, "x")
    assert_close(to_np(yt), np.asarray(yj), 1e-6, 1e-6, "y")


def test_batches_from_raw_same_batches():
    raw = raw_examples(3)
    key = jax.random.PRNGKey(7)
    want = list(jds.batches_from_raw(raw, 4, key))
    got = list(tds.batches_from_raw(raw, 4, threefry.prng_key(7)))
    assert len(got) == len(want) == 12      # 3 examples x 16 variants / 4
    for (xt, yt), (xj, yj) in zip(got, want):
        assert_close(to_np(xt), np.asarray(xj), 1e-6, 1e-6, "x")
        assert_close(to_np(yt), np.asarray(yj), 1e-6, 1e-6, "y")


@pytest.mark.parametrize("name", ["l1", "rel_l1", "rel_mse"])
def test_losses(name):
    rng = np.random.default_rng(3)
    out = rng.exponential(1.0, (4, 8, 8, 3))
    tgt = rng.exponential(1.0, (4, 8, 8, 3))
    tgt[0] = 0.0                                 # the eps branch
    # the formulas, in float64 on both sides
    with jax.enable_x64(True):
        want = float(jlosses.get(name)(jnp.asarray(out), jnp.asarray(tgt)))
    got = float(tlosses.get(name)(torch.from_numpy(out), torch.from_numpy(tgt)))
    assert abs(got - want) <= 1e-7 * abs(want), (got, want)
    # in float32 the two libraries' means sum in different orders (2 ulps
    # apart here)
    out, tgt = out.astype(np.float32), tgt.astype(np.float32)
    want = float(jlosses.get(name)(jnp.asarray(out), jnp.asarray(tgt)))
    got = float(tlosses.get(name)(tt(out), tt(tgt)))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    assert tlosses.EPS == jlosses.EPS


def test_generate_examples_matches_jax_golden():
    g = np.load(GOLDEN_BOX)
    sd = tapi.load_scene_string(str(g["scene_text"]))
    scene, cam = trender.build(sd, "cpu")
    maps = tds.generate_examples(
        scene, cam, tcam.KIND.get(sd.camera.kind, 0),
        threefry.prng_key(int(g["seed"])), torch.as_tensor(g["coords"]),
        hemi_size=int(g["hemi_size"]), gt_spp=int(g["gt_spp"]), accel="bvh")
    valid = g["valid"]
    assert np.array_equal(maps["valid"].numpy(), valid)
    assert 4 <= valid.sum() < valid.size     # misses and hits both present
    for k in "pdnz":
        got = maps[k].numpy()
        assert got.shape == g[k].shape, k
        assert_close(got[valid], g[k][valid], 0.0, 1e-5, k)


def test_load_pfm_dataset(tmp_path):
    raw = raw_examples(2)
    for i, ex in enumerate(raw):
        for k in "pdnz":
            m = ex[k][..., 0] if k in "dz" else ex[k]   # 1-channel d and z
            jimage.write_pfm(str(tmp_path / f"{k}_{i}_{3 * i}.pfm"), m)
    (tmp_path / "p_9_9.pfm").write_bytes(b"")           # incomplete set: skipped
    key = lambda ex: float(ex["p"].sum())
    want = sorted(jds.load_pfm_dataset([str(tmp_path)]), key=key)
    got = sorted(tds.load_pfm_dataset([str(tmp_path)]), key=key)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in "pdnz":
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def test_metrics_copy_equal():
    rng = np.random.default_rng(4)
    a = rng.exponential(0.5, (16, 16, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    for name in ("l1", "mse", "psnr", "ssim"):
        assert getattr(tmetrics, name)(a, b) == getattr(jmetrics, name)(a, b), name
    assert tmetrics.compressed_entropy_kb(a) == jmetrics.compressed_entropy_kb(a)
