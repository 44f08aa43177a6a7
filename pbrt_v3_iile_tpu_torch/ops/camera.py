"""Camera ray generation (port of ``ops/camera.py``).

Perspective, orthographic and environment cameras with a thin lens, the
realistic lens-system camera (realistic.cpp: a pbrt lens table traced
element by element, the rear aperture sampled whole and vignetted rays
weighted 0) and camera motion blur (an AnimatedTransform between the
start and end camera transforms, interpolated per ray).  The
raster-to-camera matrix, the lens table's focusing and the motion
decomposition are computed on the host exactly as the reference computes
them; rays are generated on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import stats as statslib
from ..utils import transforms as xf
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
    # the realistic lens system, front to rear, float32 on the host (E = 0
    # for the other kinds): curvature radius, thickness to the next
    # interface (the last: to the film, focused), index of refraction (0:
    # air) and aperture radius, in m; the film's physical half extents
    lens_curv: np.ndarray = None
    lens_thick: np.ndarray = None
    lens_eta: np.ndarray = None
    lens_ap: np.ndarray = None
    film_half: np.ndarray = None
    # camera motion (None when static): the decompositions of the start
    # and end camera-to-world transforms (translation, rotation quaternion
    # w x y z on the shortest arc, scale) as float32 tensors, the shutter
    # and the TransformTimes
    anim: dict = None


def load_lens_file(path: str):
    """A pbrt lens .dat table: rows of (curvature radius, thickness, eta,
    aperture diameter) in mm, front to rear (realistic.cpp's constructor:
    values / 1000 to m, the diameter / 2 to a radius); ``#`` starts a
    comment.  Returns float64 (curv, thick, eta, ap_r)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 4:
                rows.append(vals[:4])
    a = np.asarray(rows, np.float64)
    return (a[:, 0] * 1e-3, a[:, 1] * 1e-3, a[:, 2], a[:, 3] * 1e-3 / 2.0)


def _trace_lens_np(o, d, curv, thick, eta, ap_r, from_scene=False):
    """One ray traced through the lens stack on the host in float64, in
    pbrt's lens space (film at z = 0, the elements at negative z, the
    scene towards -inf; realistic.cpp TraceLensesFromFilm / FromScene).
    Returns (o, d) past the last interface, or None where the ray is
    blocked or totally reflected."""
    o = np.asarray(o, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    E = len(curv)
    zv = -np.cumsum(thick[::-1])[::-1]  # each element's vertex z
    order = range(E) if from_scene else range(E - 1, -1, -1)
    prev_eta = 1.0
    for i in order:
        z = zv[i]
        R = curv[i]
        if R == 0.0:
            if abs(d[2]) < 1e-15:
                return None
            t = (z - o[2]) / d[2]
        else:
            zc = z + R
            oc = o - np.array([0.0, 0.0, zc])
            A = d @ d
            B = 2 * (d @ oc)
            C = oc @ oc - R * R
            disc = B * B - 4 * A * C
            if disc < 0:
                return None
            sq = np.sqrt(disc)
            t0, t1 = (-B - sq) / (2 * A), (-B + sq) / (2 * A)
            use_closer = (d[2] > 0) != (R < 0)
            t = min(t0, t1) if use_closer else max(t0, t1)
        if t < 0:
            return None
        p = o + t * d
        if p[0] ** 2 + p[1] ** 2 > ap_r[i] ** 2:
            return None
        o = p
        if R != 0.0:
            n = (p - np.array([0.0, 0.0, z + R]))
            n = n / np.linalg.norm(n)
            if n @ d > 0:
                n = -n
            if from_scene:
                eta_i = prev_eta
                eta_t = eta[i] if eta[i] != 0 else 1.0
                prev_eta = eta_t
            else:
                eta_i = eta[i] if eta[i] != 0 else 1.0
                eta_t = 1.0 if i == 0 else (eta[i - 1]
                                            if eta[i - 1] != 0 else 1.0)
            r = eta_i / eta_t
            wi = -d / np.linalg.norm(d)
            cos_i = n @ wi
            sin2_t = r * r * max(0.0, 1.0 - cos_i * cos_i)
            if sin2_t >= 1.0:
                return None
            cos_t = np.sqrt(1.0 - sin2_t)
            d = r * (-wi) + (r * cos_i - cos_t) * n
    return o, d


def focus_lens(curv, thick, eta, ap_r, focus_distance: float):
    """The thicknesses with the rear one adjusted so that the axial point
    at focus_distance images onto the film: a marginal ray from that point
    through the front vertex's edge is traced and the film moved to where
    it crosses the axis, four times at most (the reference's focusing).
    Returns float64 thicknesses."""
    thick = np.asarray(thick, np.float64).copy()
    for _ in range(4):
        front_z = -float(np.sum(thick))
        h = max(ap_r[0] * 0.05, 1e-5)
        src = np.array([0.0, 0.0, front_z - min(focus_distance, 1e5)])
        dvec = np.array([h, 0.0, front_z]) - src
        dvec = dvec / np.linalg.norm(dvec)
        res = _trace_lens_np(src, dvec, curv, thick, eta, ap_r,
                             from_scene=True)
        if res is None:
            break
        o, d = res
        if abs(d[0]) < 1e-12:
            break
        z_f = o[2] + (-o[0] / d[0]) * d[2]  # where it crosses the axis
        thick[-1] += z_f
        if abs(z_f) < 1e-7:
            break
        thick[-1] = max(thick[-1], 1e-4)
    return thick


def make_camera(desc, film, device) -> Camera:
    """Camera from a CameraDesc/FilmDesc: the static camera, and with an
    end transform (``ActiveTransform EndTime``) its motion."""
    cam = _make_camera_static(desc, film, device)
    if getattr(desc, "cam_to_world_end", None) is not None:
        T0, q0, S0 = xf.decompose(desc.cam_to_world)
        T1, q1, S1 = xf.decompose(desc.cam_to_world_end)
        if float(np.dot(q0, q1)) < 0.0:
            q1 = -q1  # the shortest arc (quaternion.cpp Slerp)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        cam.anim = dict(t0=f32(T0), t1=f32(T1), q0=f32(q0), q1=f32(q1),
                        s0=f32(S0), s1=f32(S1))
    return cam


def shutter_time(desc, u_time):
    """(N,) shutter samples -> each ray's time (perspective.cpp:
    Lerp(sample.time, shutterOpen, shutterClose)) as a parameter of the
    TransformTimes, clamped to [0, 1]: the one time that moves both the
    camera and the animated shapes."""
    t0, t1 = desc.transform_times
    t = desc.shutter_open + u_time * (desc.shutter_close - desc.shutter_open)
    return torch.clamp((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0)


def _make_camera_static(desc, film, device) -> Camera:
    xres, yres = film.x_resolution, film.y_resolution
    aspect = xres / yres
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if desc.kind == "realistic" and getattr(desc, "lens_file", ""):
        curv, thick, eta, ap_r = load_lens_file(desc.lens_file)
        ap_d = getattr(desc, "aperture_diameter", 0.0)
        if ap_d > 0:
            # aperturediameter (mm) caps the stop row (curvature 0)
            ap_r = np.where(curv == 0.0, np.minimum(ap_r, ap_d * 1e-3 / 2), ap_r)
        if desc.focal_distance < 1e5:
            thick = focus_lens(curv, thick, eta, ap_r, desc.focal_distance)
        diag = getattr(film, "diagonal", 35.0) * 1e-3
        hx = 0.5 * np.sqrt(diag * diag / (1.0 + (yres / xres) ** 2))
        hy = hx * yres / xres
        return Camera(cam_to_world=f32(desc.cam_to_world),
                      raster_to_camera=f32(np.eye(4)),
                      lens_radius=float(np.float32(ap_r[-1])),
                      focal_distance=float(np.float32(desc.focal_distance)),
                      resolution=(int(xres), int(yres)),
                      lens_curv=np.asarray(curv, np.float32),
                      lens_thick=np.asarray(thick, np.float32),
                      lens_eta=np.asarray(eta, np.float32),
                      lens_ap=np.asarray(ap_r, np.float32),
                      film_half=np.asarray([hx, hy], np.float32))
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


def realistic_generate_rays(cam: Camera, p_film, u_lens):
    """Film to rear element to scene through the spherical lens stack
    (realistic.cpp GenerateRay and TraceLensesFromFilm): the whole rear
    aperture is sampled and a vignetted ray gets weight 0 (no exit-pupil
    tables), the loop over the elements is unrolled, and the weight is
    cos^4 of the film ray.  Returns (o, d, weight) in world space."""
    N = p_film.shape[0]
    dev = p_film.device
    f = np.float32
    E = cam.lens_curv.shape[0]
    res = torch.tensor(cam.resolution, dtype=torch.float32, device=dev)
    # raster to the physical film point, x mirrored (realistic.cpp's
    # pFilm(-pFilm2.x, pFilm2.y, 0)), in lens space: film at z = 0, the
    # elements at negative z
    s = p_film / res[None, :]
    fx = -(2.0 * s[:, 0] - 1.0) * float(cam.film_half[0])
    fy = (2.0 * s[:, 1] - 1.0) * float(cam.film_half[1])
    zero = torch.zeros(N, dtype=torch.float32, device=dev)
    o = torch.stack([fx, fy, zero], dim=-1)
    rear_z = float(-cam.lens_thick[E - 1])
    p_disk = float(cam.lens_ap[E - 1]) * smp.concentric_sample_disk(u_lens)
    d = vm.normalize(torch.cat([p_disk, torch.full((N, 1), rear_z, device=dev)],
                               dim=-1) - o)
    cos0 = torch.abs(d[:, 2])
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    zv = -np.cumsum(cam.lens_thick[::-1], dtype=f)[::-1]
    for i in range(E - 1, -1, -1):
        z, R = f(zv[i]), f(cam.lens_curv[i])
        zc = f(z + R)
        if R == 0.0:  # the aperture stop: a plane
            dz = d[:, 2]
            dz_safe = torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
            t = (float(z) - o[:, 2]) / dz_safe
            ok = ok & (t > 0.0)
        else:
            oc = o - torch.tensor([0.0, 0.0, float(zc)], device=dev)
            A = vm.dot(d, d)
            B = 2.0 * vm.dot(d, oc)
            C = vm.dot(oc, oc) - float(f(R * R))
            disc = B * B - 4.0 * A * C
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t0 = (-B - sq) / (2.0 * A)
            t1 = (-B + sq) / (2.0 * A)
            closer = (d[:, 2] > 0) != (R < 0)
            t = torch.where(closer, torch.minimum(t0, t1), torch.maximum(t0, t1))
            ok = ok & (disc >= 0.0) & (t > 0.0)
        p = o + t[:, None] * d
        ok = ok & (p[:, 0] ** 2 + p[:, 1] ** 2 <= float(f(cam.lens_ap[i] ** 2)))
        if R != 0.0:
            # refraction from element i's glass into element i-1's (air
            # past the front); Refract of core/reflection.h
            n = vm.normalize(p - torch.tensor([0.0, 0.0, float(zc)], device=dev))
            n = torch.where((vm.dot(n, d) > 0.0)[:, None], -n, n)
            eta_i = f(1.0) if cam.lens_eta[i] == 0.0 else cam.lens_eta[i]
            eta_t = (f(1.0) if i == 0 or cam.lens_eta[i - 1] == 0.0
                     else cam.lens_eta[i - 1])
            r = f(eta_i / eta_t)
            wi = -vm.normalize(d)
            cos_i = vm.dot(n, wi)
            sin2_t = float(f(r * r)) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            d_ref = float(r) * (-wi) + (float(r) * cos_i - cos_t)[:, None] * n
            ok = ok & ~(sin2_t >= 1.0)
            d = d_ref
        o = p
    c2 = cos0 * cos0
    w = torch.where(ok, c2 * c2, 0.0)  # cos^4 as the reference's integer power
    # back to camera space (z towards the scene), then to the world
    flip = torch.tensor([1.0, 1.0, -1.0], device=dev)
    o_w = _apply44_point(cam.cam_to_world, o * flip)
    d_w = vm.normalize(_apply44_vector(cam.cam_to_world, vm.normalize(d * flip)))
    return o_w, d_w, w


def generate_rays(cam: Camera, p_film, u_lens=None, kind: int = 0,
                  time=None):
    """p_film: (N,2) raster-space sample positions -> world (o, d).
    time: (N,) ray times of a moving camera (``shutter_time``): each
    ray's camera-to-world is the AnimatedTransform at its time."""
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
        raise ValueError(f"camera kind {kind}: the realistic camera traces "
                         "its rays with realistic_generate_rays")

    if u_lens is not None and cam.lens_radius > 0.0:
        p_lens = cam.lens_radius * smp.concentric_sample_disk(u_lens)
        ft = cam.focal_distance / torch.clamp(d_cam[:, 2], min=1e-6)
        p_focus = o_cam + ft[:, None] * d_cam
        o_cam = torch.cat([p_lens, torch.zeros((N, 1), device=dev)], dim=-1)
        d_cam = vm.normalize(p_focus - o_cam)

    if time is not None:
        # AnimatedTransform::Interpolate at each ray's time: T(t) R(t) S(t)
        a, dt = cam.anim, time
        T = a["t0"][None, :] + dt[:, None] * (a["t1"] - a["t0"])[None, :]
        R = _quat_to_matrix(_quat_slerp(dt, a["q0"], a["q1"]))
        S = a["s0"][None] + dt[:, None, None] * (a["s1"] - a["s0"])[None]
        M = torch.einsum("nij,njk->nik", R, S)
        o = torch.einsum("nij,nj->ni", M, o_cam) + T
        d = vm.normalize(torch.einsum("nij,nj->ni", M, d_cam))
        return o, d
    o = _apply44_point(cam.cam_to_world, o_cam)
    d = vm.normalize(_apply44_vector(cam.cam_to_world, d_cam))
    return o, d


def _quat_slerp(t, q0, q1):
    """Slerp of (4,) quaternions at (N,) parameters -> (N,4)
    (quaternion.cpp Slerp; a plain lerp when they are nearly parallel)."""
    dq = torch.dot(q0, q1)
    theta = torch.arccos(torch.clamp(dq, -1.0, 1.0))
    small = torch.abs(dq) > 0.9995
    sin_th = torch.clamp(torch.sin(theta), min=1e-9)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_th)
    w1 = torch.where(small, t, torch.sin(t * theta) / sin_th)
    q = w0[:, None] * q0[None, :] + w1[:, None] * q1[None, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _quat_to_matrix(q):
    """(N,4) w x y z -> (N,3,3) rotation matrices."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def camera_position(cam: Camera):
    """World-space camera origin (camera.cpp getCameraWorldPosition)."""
    return cam.cam_to_world[:3, 3]


# ---------------------------------------------------------------------------
# Camera importance of the perspective pinhole (light tracing: BDPT's t=1)
# ---------------------------------------------------------------------------

def _persp_film_area(cam: Camera):
    """The film's area on the camera-space z = 1 plane (the A of the
    perspective camera's importance; perspective.cpp's constructor)."""
    dev = cam.raster_to_camera.device
    corners = torch.tensor([[0.0, 0.0, 0.0],
                            [float(cam.resolution[0]), float(cam.resolution[1]),
                             0.0]], device=dev)
    pc = _apply44_point(cam.raster_to_camera, corners)
    pc = pc / pc[:, 2:3]
    return torch.abs((pc[1, 0] - pc[0, 0]) * (pc[1, 1] - pc[0, 1]))


def camera_forward(cam: Camera):
    fwd = cam.cam_to_world[:3, 2]
    return fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-12)


def project_to_raster(cam: Camera, p_world):
    """World points -> (raster coordinates (N,2), on-film mask): the
    pinhole's world-to-raster projection (perspective.cpp Sample_Wi)."""
    w2c = torch.linalg.inv(cam.cam_to_world)
    c2r = torch.linalg.inv(cam.raster_to_camera)
    p_cam = _apply44_point(w2c, p_world)
    behind = p_cam[:, 2] <= 1e-6
    raster = _apply44_point(c2r, p_cam)[:, :2]
    rx, ry = float(cam.resolution[0]), float(cam.resolution[1])
    on = (~behind & (raster[:, 0] >= 0.0) & (raster[:, 0] < rx)
          & (raster[:, 1] >= 0.0) & (raster[:, 1] < ry))
    return raster, on


def pdf_we_dir(cam: Camera, d_world):
    """Directional density of the perspective camera's ray sampling
    (perspective.cpp Pdf_We: 1 / (A cos^3), 0 outside the frustum)."""
    A = _persp_film_area(cam)
    cos_t = d_world @ camera_forward(cam)
    _, on_film = project_to_raster(cam, camera_position(cam)[None, :] + d_world)
    ok = (cos_t > 1e-6) & on_film
    return torch.where(ok, 1.0 / torch.clamp(A * cos_t ** 3, min=1e-12), 0.0)


def sample_wi(cam: Camera, p_ref):
    """The direction from p_ref to the pinhole (perspective.cpp Sample_Wi
    with lensRadius 0) -> dict(wi (N,3), we_over_pdf (N,) = We / pdf =
    1 / (A cos^3 dist^2), raster (N,2), valid (N,), dist (N,))."""
    to_cam = camera_position(cam)[None, :] - p_ref
    dist = torch.sqrt(torch.clamp(torch.sum(to_cam * to_cam, dim=-1), min=1e-20))
    wi = to_cam / dist[:, None]
    cos_t = -wi @ camera_forward(cam)
    raster, on_film = project_to_raster(cam, p_ref)
    A = _persp_film_area(cam)
    valid = (cos_t > 1e-6) & on_film
    we_over_pdf = torch.where(
        valid, 1.0 / torch.clamp(A * cos_t ** 3 * dist ** 2, min=1e-20), 0.0)
    return dict(wi=wi, we_over_pdf=we_over_pdf, raster=raster, valid=valid,
                dist=dist)


# ---------------------------------------------------------------------------
# Hemispheric probe cameras (batched; hemispheric.cpp)
# ---------------------------------------------------------------------------

def hemi_frames(pos, normal):
    """LookAt frames of P probes -> (right, up, look), each (P,3): the
    camera's x, y and z axes in world space.  The up hint is +z unless the
    normal is the z axis, then +y."""
    d = vm.normalize(normal)
    pole = (torch.abs(d[..., 0]) < 1e-9) & (torch.abs(d[..., 1]) < 1e-9)
    # copies from pageable host memory: on the card the host waits for them
    with statslib.sync_point("hemi_up_hints"):
        y_up = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device)
        z_up = torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
    up = torch.where(pole[..., None], y_up, z_up).expand(d.shape)
    right = vm.normalize(vm.cross(up, d))
    return right, vm.cross(d, right), d


def _hemi_dir(ys, xs):
    """Camera-space direction at normalized (row, col) positions: theta
    over rows, phi over columns, both over [0, pi]."""
    theta = math.pi * ys
    phi = math.pi * xs
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.cos(phi), torch.cos(theta) * torch.ones_like(phi),
                        sin_t * torch.sin(phi)], dim=-1)


def hemi_directions(hemi_size: int, device=None, dtype=torch.float32):
    """Camera-space direction of each probe pixel centre (H,W,3) and its
    sin(theta) (H,W)."""
    c = (torch.arange(hemi_size, dtype=dtype, device=device) + 0.5) / hemi_size
    d = _hemi_dir(c[:, None], c[None, :].expand(hemi_size, hemi_size))
    return d, torch.sin(math.pi * c[:, None]).expand(hemi_size, hemi_size)


def hemi_generate_rays(pos, normal, hemi_size: int, jitter=None):
    """Probe ray generation: pos, normal (P,3) -> o, d (P,H,W,3).
    jitter: optional (P,H,W,2) sub-pixel offsets in [0,1)."""
    P = pos.shape[0]
    right, up, look = hemi_frames(pos, normal)
    if jitter is None:
        d_cam, _ = hemi_directions(hemi_size, pos.device, pos.dtype)
        d_cam = d_cam[None].expand(P, hemi_size, hemi_size, 3)
    else:
        idx = torch.arange(hemi_size, dtype=pos.dtype, device=pos.device)
        ys = (idx[None, :, None] + jitter[..., 1]) / hemi_size
        xs = (idx[None, None, :] + jitter[..., 0]) / hemi_size
        d_cam = _hemi_dir(ys, xs)
    d = (d_cam[..., 0:1] * right[:, None, None, :]
         + d_cam[..., 1:2] * up[:, None, None, :]
         + d_cam[..., 2:3] * look[:, None, None, :])
    return pos[:, None, None, :].expand(d.shape), d


def hemi_dir_to_pixel(wi_world, right, up, look, hemi_size: int):
    """World direction -> probe pixel (x, y) (int32) and an in-range mask
    (hemispheric.cpp getLightSampleNn: theta = acos(y), phi = atan2(z, x))."""
    x_c = vm.dot(wi_world, right)
    y_c = vm.dot(wi_world, up)
    z_c = vm.dot(wi_world, look)
    theta = torch.arccos(torch.clamp(y_c, -1.0, 1.0))
    phi = torch.atan2(z_c, x_c)
    x = torch.floor(hemi_size * phi / math.pi).to(torch.int32)
    y = torch.floor(hemi_size * theta / math.pi).to(torch.int32)
    ok = (x >= 0) & (x < hemi_size) & (y >= 0) & (y < hemi_size)
    return x, y, ok
