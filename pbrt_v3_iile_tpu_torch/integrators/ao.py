"""Ambient occlusion integrator (port of ``integrators/ao.py``; ref:
src/integrators/ao.cpp AOIntegrator): cosine- or uniform-sampled
hemisphere visibility at the first hit, one occlusion sample a pass
(the render driver's pass loop accumulates them)."""

from __future__ import annotations

import torch

from ..ops import intersect as isect
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..utils import vecmath as vm


def trace_ao(scene, o, d, key, cos_sample: bool = True, accel: str = "bvh"):
    """One closest-hit and one any-hit wave -> radiance (N, 3)."""
    N = o.shape[0]
    t_max = torch.full((N,), 1e30, dtype=torch.float32, device=o.device)
    hit = isect.intersect(scene, o, d, t_max, accel=accel)
    it = isect.make_interaction(scene, o, d, hit)
    # the face-forwarded geometric normal, as ao.cpp takes it
    n = vm.face_forward(it.ng, -d)
    t_f, b_f = vm.coordinate_system(n)
    u = smplr.uniform(smplr.wave_key(key, 0, 0, smplr.DIM_BSDF_DIR), (N, 2),
                      o.device)
    if cos_sample:
        w_local = smp.cosine_sample_hemisphere(u)
    else:
        w_local = smp.uniform_sample_hemisphere(u)
    wi = vm.to_world(w_local, t_f, b_f, n)
    o_sh = vm.offset_ray_origin(it.p, n, wi)
    occ = isect.occluded(scene, o_sh, wi, t_max, accel=accel)
    # estimator (ao.cpp:101-118): cossample v cos / (cos / pi) / pi = v;
    # uniform v cos / (1 / 2pi) / pi = 2 v cos
    if cos_sample:
        val = torch.ones_like(t_max)
    else:
        val = 2.0 * torch.abs(w_local[..., 2])
    L = torch.where(hit.valid & ~occ, val, torch.zeros_like(val))
    return L[:, None].expand(N, 3).contiguous()
