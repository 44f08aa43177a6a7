"""Training datasets for IISPTNet (port of ``ml/dataset.py``).

Two sources:
1. Generation on the device (the reference's render_reference,
   iispt.cpp:456-526 and Li_reference :650-744): probe G-buffers and a
   many-sample hemispherical ground truth, rendered as tensors.
2. A loader of reference-format PFM set directories (ml/iispt_dataset.py
   generate_pfm_filenames).

Augmentation and normalization follow ml/iispt_dataset.py __getitem__:
16 variants (4 rotations x 4 flips, iispt_transforms.py:36-73); p goes
downstream-half with p's own mean, d downstream-full with d's mean, n
to [-1, 1], z distance-downstream with z's mean.  Every draw is keyed as
the JAX package keys it, so the same key gives the same probes, the same
permutation and the same batches.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import transforms as nnx
from ..ops import samplers as smplr
from ..ops import threefry
from ..utils import image as imglib


# ---------------------------------------------------------------------------
# augmentation (ref: iispt_transforms.augmentList)
# ---------------------------------------------------------------------------

def augment(maps, aug: int):
    """maps: (..., H, W, C); aug in [0, 16): flip index aug // 4 (0 none,
    1 vertical, 2 horizontal, 3 both), rotation index aug % 4 (k x 90
    degrees, from the H axis towards the W axis, as ``jnp.rot90``)."""
    flip = aug // 4
    rot = aug % 4
    if flip == 1:
        maps = torch.flip(maps, dims=(-3,))
    elif flip == 2:
        maps = torch.flip(maps, dims=(-2,))
    elif flip == 3:
        maps = torch.flip(maps, dims=(-3, -2))
    if rot:
        maps = torch.rot90(maps, k=rot, dims=(-3, -2))
    return maps


def example_from_maps(p, d, n, z, aug: int = 0):
    """Raw maps -> (x (H, W, 7), y (H, W, 3)), normalized as
    iispt_dataset.__getitem__ does."""
    p, d, n, z = (augment(m, aug) for m in (p, d, n, z))
    y = nnx.intensity_downstream_half(p, torch.mean(p))
    xd = nnx.intensity_downstream_full(d, torch.mean(d))
    xn = nnx.normals_downstream(n)
    xz = nnx.distance_downstream(z, torch.mean(z))
    return torch.cat([xd, xn, xz], dim=-1), y


# ---------------------------------------------------------------------------
# generation on the device (replaces render_reference)
# ---------------------------------------------------------------------------

def generate_examples(scene, cam, cam_kind: int, key, pixel_coords,
                      hemi_size: int = 32, gt_spp: int = 16,
                      accel: str = "bvh"):
    """Raw training maps of probes at the given film pixels, on the
    scene's device.

    pixel_coords: (P, 2) integer film pixels (the reference_tiles grid,
    iispt.cpp:498-505); gt_spp hemispherical renders are averaged into
    each probe's ground truth (the reference's default is 4096).  Draws:
    the pixel jitter from wave_key(key, 9, 0, DIM_PIXEL_JITTER), the 1-spp
    G-buffer from fold_in(key, 1), the i-th ground-truth render from
    fold_in(key, 100 + i).

    Returns a dict of tensors: p (P, Hs, Hs, 3) the ground truth, d (P,
    Hs, Hs, 3) the 1-spp intensity, n (P, Hs, Hs, 3) camera-space normals,
    z (P, Hs, Hs, 1) distances, valid (P,).
    """
    from ..integrators import probes as probelib
    from ..ops import camera as camlib

    P = pixel_coords.shape[0]
    dev = pixel_coords.device
    kj = smplr.wave_key(key, 9, 0, smplr.DIM_PIXEL_JITTER)
    p_film = pixel_coords.to(torch.float32) + smplr.uniform(kj, (P, 2), dev)
    o, d = camlib.generate_rays(cam, p_film, kind=cam_kind)
    fi = probelib.find_first_nonspecular(scene, o, d, key, accel=accel)

    # the 1-spp probe G-buffer (the network's input)
    gb = probelib.render_probes(scene, fi["p"], fi["n"],
                                threefry.fold_in(key, 1), hemi_size,
                                accel=accel)

    # the ground truth: the mean of gt_spp jittered probe renders
    acc = torch.zeros((P, hemi_size, hemi_size, 3), dtype=torch.float32,
                      device=dev)
    for i in range(gt_spp):
        acc = acc + probelib.render_probes(
            scene, fi["p"], fi["n"], threefry.fold_in(key, 100 + i),
            hemi_size, accel=accel).intensity
    return dict(p=acc / gt_spp, d=gb.intensity, n=gb.normals, z=gb.distance,
                valid=fi["found"])


# ---------------------------------------------------------------------------
# reference-format PFM directories (ref: iispt_dataset.load_dataset)
# ---------------------------------------------------------------------------

def load_pfm_dataset(set_dirs):
    """Scans directories of {p,d,n,z}_x_y.pfm files; returns a list of raw
    example dicts (numpy)."""
    examples = []
    for dirname in set_dirs:
        for f in os.listdir(dirname):
            if not (f.startswith("p_") and f.endswith(".pfm")):
                continue
            _, x, y = f[:-4].split("_")
            paths = {k: os.path.join(dirname, f"{k}_{x}_{y}.pfm")
                     for k in "pdnz"}
            if not all(os.path.exists(v) for v in paths.values()):
                continue
            ex = {k: imglib.read_pfm(v) for k, v in paths.items()}
            for k in "pdn":
                if ex[k].ndim == 2:
                    ex[k] = np.stack([ex[k]] * 3, axis=-1)
            if ex["z"].ndim == 2:
                ex["z"] = ex["z"][..., None]
            examples.append(ex)
    return examples


def batches_from_raw(raw_examples, batch_size: int, key, n_augment: int = 16,
                     device=None):
    """Yields (x (B, H, W, 7), y (B, H, W, 3)) with random augmentation.

    raw_examples: dicts of maps p, d, n, z (numpy arrays or tensors); each
    example is normalized where its maps lie and the batch is moved to
    ``device`` (default: left there).  The permutation is numpy's from a
    seed drawn as ``jax.random.randint(key, (), 0, 2**31 - 1)``, so a key
    gives the batches the JAX package gives."""
    seed = int(threefry.randint(key, (), 0, 2**31 - 1))
    idx = np.random.default_rng(seed).permutation(len(raw_examples) * n_augment)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    for start in range(0, len(idx) - batch_size + 1, batch_size):
        xs, ys = [], []
        for j in idx[start:start + batch_size]:
            ex = raw_examples[j // n_augment]
            x, y = example_from_maps(t(ex["p"]), t(ex["d"]), t(ex["n"]),
                                     t(ex["z"]), int(j % n_augment))
            xs.append(x)
            ys.append(y)
        x, y = torch.stack(xs), torch.stack(ys)
        if device is not None:
            x, y = x.to(device), y.to(device)
        yield x, y
