"""Hemispherical probe rendering: batched G-buffers and the specular
chase (port of ``integrators/probes.py``).

A batch of P probes is one wavefront of P * H^2 rays traced by the path
integrator with probe semantics (iispt_d.cpp RenderView and Li): max
depth 3, NEE at each bounce, no emitted light on the primary segment,
and the primary hit's distance and camera-space normal captured.
``find_first_nonspecular`` follows mirror and glass bounces to the first
diffuse hit (iisptrenderrunner.cpp find_intersection).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import bsdf as bsdflib
from ..ops import camera as camlib
from ..ops import intersect as isect
from ..ops import samplers as smplr
from ..scene.api import MAT_GLASS, MAT_MIRROR
from ..utils import vecmath as vm
from . import path as pathlib_

NO_INTERSECTION_DISTANCE = -1.0  # (iispt_d.cpp:50)
PROBE_MAX_DEPTH = 3              # (iispt_d.cpp:505)
MAX_CHASE = 24                   # specular bounces followed


@dataclass
class ProbeGBuffer:
    intensity: torch.Tensor  # (P, H, W, 3) radiance (direct + short indirect)
    normals: torch.Tensor    # (P, H, W, 3) camera-space normals
    distance: torch.Tensor   # (P, H, W, 1) hit distance (-1 = miss)
    right: torch.Tensor      # (P, 3) probe camera frame
    up: torch.Tensor         # (P, 3)
    look: torch.Tensor       # (P, 3)
    origin: torch.Tensor     # (P, 3)


def render_probes(scene, positions, normals, key, hemi_size: int = 32,
                  accel: str = "bvh") -> ProbeGBuffer:
    """positions, normals: (P, 3) world-space probe anchors (the normal is
    the outward surface normal, already flipped towards the viewer)."""
    P = positions.shape[0]
    Hs = hemi_size
    dev = positions.device
    right, up, look = camlib.hemi_frames(positions, normals)
    jit_u = smplr.uniform(smplr.wave_key(key, 0, 0, smplr.DIM_HEMI),
                          (P, Hs, Hs, 2), dev)
    o, d = camlib.hemi_generate_rays(positions, normals, Hs, jit_u)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    # off the anchor surface along the probe normal
    o = vm.offset_ray_origin(o, torch.repeat_interleave(normals, Hs * Hs, 0), d)
    cfg = pathlib_.PathConfig(max_depth=PROBE_MAX_DEPTH, skip_bounce0_le=True,
                              accel=accel)
    kp = smplr.wave_key(key, 0, 0, smplr.DIM_PROBE)
    L, aux = pathlib_.trace_paths(scene, o, d, kp, cfg, collect_aux=True)
    n_world = aux["normal"].reshape(P, Hs, Hs, 3)
    # camera-space normal (iispt_d.cpp:105-107: WorldToCamera applied)
    n_cam = torch.stack([torch.einsum("phwc,pc->phw", n_world, right),
                         torch.einsum("phwc,pc->phw", n_world, up),
                         torch.einsum("phwc,pc->phw", n_world, look)], dim=-1)
    return ProbeGBuffer(intensity=L.reshape(P, Hs, Hs, 3), normals=n_cam,
                        distance=aux["distance"].reshape(P, Hs, Hs, 1),
                        right=right, up=up, look=look, origin=positions)


def find_first_nonspecular(scene, o, d, key, accel: str = "bvh"):
    """Specular chase of N rays, at most MAX_CHASE bounces.  Returns a
    dict: found (N,), p, n (the geometric normal flipped against the ray),
    wo, mat (N,), uv (N,2) and beta (N,3) (the specular chain's
    throughput)."""
    N = o.shape[0]
    dev = o.device
    z3 = lambda: torch.zeros((N, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((N, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    found = torch.zeros(N, dtype=torch.bool, device=dev)
    p, n, wo = z3(), z3(), z3()
    mat = torch.zeros(N, dtype=torch.int32, device=dev)
    uv = torch.zeros((N, 2), dtype=torch.float32, device=dev)
    for i in range(MAX_CHASE):
        t_max = torch.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max, accel=accel)
        it = isect.make_interaction(scene, o, d, hit)

        params = bsdflib.gather_params(scene, torch.clamp(it.mat, min=0),
                                       uv=it.uv, p=it.p)
        is_spec = (params.kind == MAT_MIRROR) | (params.kind == MAT_GLASS)
        stop_here = alive & hit.valid & ~is_spec

        # the first non-specular hit
        n_out = vm.face_forward(it.ng, -d)
        stop3 = stop_here[:, None]
        p = torch.where(stop3, it.p, p)
        n = torch.where(stop3, n_out, n)
        wo = torch.where(stop3, it.wo, wo)
        mat = torch.where(stop_here, it.mat, mat)
        uv = torch.where(stop3, it.uv, uv)
        found = found | stop_here

        # follow the specular bounce
        cont = alive & hit.valid & is_spec
        ns = vm.face_forward(it.ns, it.ng)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        u_lobe = smplr.uniform(smplr.wave_key(key, 1, i, smplr.DIM_BSDF_LOBE),
                               (N,), dev)
        u_dir = smplr.uniform(smplr.wave_key(key, 1, i, smplr.DIM_BSDF_DIR),
                              (N, 2), dev)
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None]
        ok = cont & bs.valid
        ok3 = ok[:, None]
        beta = torch.where(ok3, beta_new, beta)
        o = torch.where(ok3, vm.offset_ray_origin(it.p, n_out, wi_w), o)
        d = torch.where(ok3, wi_w, d)
        alive = ok
    return dict(found=found, p=p, n=n, wo=wo, mat=mat, uv=uv, beta=beta)
