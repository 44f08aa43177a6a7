"""Differentiable rendering: image gradients with respect to the scene's
material and light parameters (port of ``integrators/grad.py``).

The reference renderer is not differentiable; the JAX package's
extension is detached sampling (path replay with frozen decisions): the
sampled directions, the pdfs, the lobe and roulette choices and every
traversal output are detached (``PathConfig.differentiable``,
``integrators/path.py``), so reverse-mode autograd differentiates only
the smooth shading terms (f, Le, Li, cos) along the sampled paths, an
unbiased gradient of the pixel values for fixed path geometry.  No
kernel needs a gradient: the traversal kernels' outputs are detached.

Differentiable leaves of the DeviceScene (``DIFF_FIELDS``): mat_kd,
mat_ks, mat_kr, mat_kt, mat_rough, mat_sigma, light_L.
"""

from __future__ import annotations

import copy

import torch

from ..ops import camera as camlib
from ..ops import samplers as smplr
from ..ops import threefry
from . import path as pathlib_

DIFF_FIELDS = ("mat_kd", "mat_ks", "mat_kr", "mat_kt", "mat_rough",
               "mat_sigma", "light_L")


def split_scene(scene):
    """-> (dict of the DIFF_FIELDS tensors, the scene)."""
    return {f: getattr(scene, f) for f in DIFF_FIELDS}, scene


def _merge(scene, diff_params):
    """A shallow copy of the scene with the given leaves replaced."""
    out = copy.copy(scene)
    for name, value in diff_params.items():
        setattr(out, name, value)
    return out


def make_image_and_grad_fn(sd, cfg: pathlib_.PathConfig = None, spp: int = 4,
                           loss_fn=None, device="cuda"):
    """-> f(scene, cam, key) -> (image (H,W,3), {field: gradient}), the
    gradient of loss_fn(image) (default: the mean) with respect to each of
    DIFF_FIELDS, over spp passes of the uncompacted path loop keyed as the
    reference keys them.  key: a threefry key (``threefry.prng_key``).
    cfg: the path integrator's settings (default: the scene's, for
    ``device``)."""
    H, W = sd.film.y_resolution, sd.film.x_resolution
    if cfg is None:
        from . import render as renderlib
        cfg = renderlib.make_integrator_config(sd, device=device)
    cfg = cfg.replace(differentiable=True, compact_schedule=())
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    if loss_fn is None:
        loss_fn = torch.mean

    def render_image(scene, cam, key):
        dev = scene.tri_p0.device
        py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev),
                                indexing="ij")
        pix = torch.stack([px, py], dim=-1).reshape(-1, 2)
        img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
        for p in range(spp):
            k = threefry.fold_in(key, p)
            jitter = smplr.uniform(smplr.wave_key(k, 0, 0, smplr.DIM_PIXEL_JITTER),
                                   (H * W, 2), dev)
            o, d = camlib.generate_rays(cam, pix + jitter, kind=cam_kind)
            L, _ = pathlib_.trace_paths(scene, o, d, k, cfg)
            img = img + L.reshape(H, W, 3)
        return img / spp

    def run(scene, cam, key):
        diff, _ = split_scene(scene)
        leaves = {f: v.detach().clone().requires_grad_(True)
                  for f, v in diff.items()}
        img = render_image(_merge(scene, leaves), cam, key)
        grads = torch.autograd.grad(loss_fn(img), list(leaves.values()),
                                    allow_unused=True)
        return img.detach(), {
            f: torch.zeros_like(leaves[f]) if g is None else g
            for f, g in zip(DIFF_FIELDS, grads)}

    return run
