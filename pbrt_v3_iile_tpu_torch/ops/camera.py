"""Camera ray generation (port of ``ops/camera.py``).

Perspective, orthographic and environment cameras with a thin lens.
The raster-to-camera matrix is built on the host exactly as the
reference builds it (ScreenToRaster with the y flip, then the inverse
perspective); rays are generated on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_v3_iile_tpu.utils import transforms as xf

from ..utils import vecmath as vm
from . import sampling as smp

KIND = {"perspective": 0, "orthographic": 1, "environment": 2,
        "realistic": 3}


@dataclass
class Camera:
    cam_to_world: torch.Tensor      # (4,4) f32
    raster_to_camera: torch.Tensor  # (4,4) f32
    lens_radius: float
    focal_distance: float
    resolution: tuple               # (x, y)


def make_camera(desc, film, device) -> Camera:
    """Camera from a CameraDesc/FilmDesc; realistic lenses and camera
    motion are not ported yet (ROADMAP Queue 1, slice 3)."""
    if desc.kind == "realistic" and getattr(desc, "lens_file", ""):
        raise NotImplementedError("realistic camera is not ported yet "
                                  "(ROADMAP slice 3)")
    if getattr(desc, "cam_to_world_end", None) is not None:
        raise NotImplementedError("camera motion blur is not ported yet "
                                  "(ROADMAP slice 3)")
    xres, yres = film.x_resolution, film.y_resolution
    aspect = xres / yres
    if desc.screen_window is not None:
        x0, x1, y0, y1 = desc.screen_window
    elif aspect > 1.0:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    s2r = (xf.scale(xres, yres, 1.0)
           @ xf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
           @ xf.translate(-x0, -y1, 0.0))
    if desc.kind == "orthographic":
        c2s = np.eye(4)
    else:
        c2s = xf.perspective(desc.fov, 1e-2, 1000.0)
    r2c = xf.inverse(c2s) @ xf.inverse(s2r)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Camera(cam_to_world=f32(desc.cam_to_world),
                  raster_to_camera=f32(r2c),
                  lens_radius=float(np.float32(desc.lens_radius)),
                  focal_distance=float(np.float32(desc.focal_distance)),
                  resolution=(int(xres), int(yres)))


def _apply44_point(m, p):
    ph = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return ph / w[..., None]


def _apply44_vector(m, v):
    return v @ m[:3, :3].T


def generate_rays(cam: Camera, p_film, u_lens=None, kind: int = 0):
    """p_film: (N,2) raster-space sample positions -> world (o, d)."""
    N = p_film.shape[0]
    dev = p_film.device
    p_cam = _apply44_point(cam.raster_to_camera, torch.cat(
        [p_film, torch.zeros((N, 1), dtype=p_film.dtype, device=dev)], dim=-1))
    if kind == 1:
        o_cam = p_cam
        d_cam = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(N, 3)
    elif kind == 2:
        theta = math.pi * p_film[:, 1] / float(cam.resolution[1])
        phi = 2.0 * math.pi * p_film[:, 0] / float(cam.resolution[0])
        d_cam = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                             torch.sin(theta) * torch.sin(phi)], dim=-1)
        o_cam = torch.zeros((N, 3), device=dev)
    elif kind == 0:
        o_cam = torch.zeros((N, 3), device=dev)
        d_cam = vm.normalize(p_cam)
    else:
        raise NotImplementedError(f"camera kind {kind} is not ported yet")

    if u_lens is not None and cam.lens_radius > 0.0:
        p_lens = cam.lens_radius * smp.concentric_sample_disk(u_lens)
        ft = cam.focal_distance / torch.clamp(d_cam[:, 2], min=1e-6)
        p_focus = o_cam + ft[:, None] * d_cam
        o_cam = torch.cat([p_lens, torch.zeros((N, 1), device=dev)], dim=-1)
        d_cam = vm.normalize(p_focus - o_cam)

    o = _apply44_point(cam.cam_to_world, o_cam)
    d = vm.normalize(_apply44_vector(cam.cam_to_world, d_cam))
    return o, d
