"""Wavefront path integrator with NEE and one-sample MIS (port of
``integrators/path.py``).

Estimator: emitted light on bounce 0 and after specular bounces, one NEE
sample per bounce weighted against the continuation BSDF sample by the
power heuristic (the light strategy's density is sel_pdf * pdf), and
Russian roulette after bounce 3 with q = max(.05, 1 - max(beta * eta)).
The bounce loop is a Python loop; ``_trace_paths_compact`` shrinks the
wave as paths die (budget RR, a coherence sort per bounce, radiance
flushed to the pixel at every compaction).

Variants: ``nee_all`` takes one NEE sample of every light (the
directlighting "all" strategy, selection pdfs of 1); ``direct_only``
continues only specular paths, and lets a non-specular continuation live
one more segment as a "ghost" that collects the MIS-weighted emission it
hits; ``skip_bounce0_le`` drops emission seen by the primary segment
(IILE probes); ``collect_aux`` returns the primary segment's hit
distance and geometric normal (the probe G-buffer).

Materials and transport (``volumetric``, ``has_subsurface``,
``has_hair``, each set from the scene by ``make_integrator_config``):
homogeneous media by channel-mixed distance sampling with analytic
transmittance, grid-density media by delta tracking (``grid_media``), the
Henyey-Greenstein phase function at medium vertices, null-material
medium boundaries passed straight through, NEE at medium vertices with a
shadow transmittance through the ray's own medium (ratio tracking in
grids; boundary crossings are ignored, as the reference ignores them),
the exact spatial BSSRDF (Fresnel entry, one probe ray along a
MIS-selected axis to the exit point, the cosine exit lobe and NEE at the
exit), and the hair fiber lobe.  Every draw is keyed as the reference
keys it, so a render is the reference's estimator realisation.

Object motion blur: a per-ray ``time`` (constant along a path) goes to
every traversal and interaction of the path (closest hit, NEE shadows,
the BSSRDF probe and its exit shadow), and rides the compacted loop's
sort with the rest of the state.

Explicit primary samples (``u_prim``, PSSMLT): the bounce loop's medium,
light-selection, light, lobe, direction and roulette uniforms come from
a (N, max_depth + 1, PRIM_DIMS_PER_BOUNCE) tensor, so that a path is a
deterministic function of it.  The differentiable mode (``grad``,
``integrators/grad.py``) detaches the path's geometry and its sampling
decisions (the traversal and the interaction, the sampled direction and
its pdfs, the roulette's throughput) exactly where the reference stops
gradients, so that autograd differentiates the shading terms along
frozen paths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..ops import bsdf as bsdflib
from ..ops import clusters as cluster_lib
from ..ops import intersect as isect
from ..ops import lights as lightlib
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..ops import threefry
from ..scene.api import LIGHT_INFINITE, MAT_SUBSURFACE
from ..utils import stats as statslib
from ..utils import vecmath as vm


RR_START = 3  # Russian roulette from the bounce after this one

# the primary samples of one bounce when an explicit u drives the tracer
# (PSSMLT): [medium u0, u1, light select, light u0..u2, lobe, direction
# u0, u1, roulette]
PRIM_DIMS_PER_BOUNCE = 10


@dataclass(frozen=True)
class PathConfig:
    max_depth: int = 5
    rr_threshold: float = 1.0
    nee_all: bool = False          # one NEE sample per light slot
    direct_only: bool = False      # continue only specular paths
    skip_bounce0_le: bool = False  # no emission on the primary segment
    accel: str = "bvh"             # "bvh" | "clusters"
    cluster_maxc: int = 192        # candidate clusters per group before
                                   # the group goes to the BVH kernel
    spatial_lights: bool = False   # per-voxel light selection
    compact_schedule: tuple = ()   # per-bounce wave fractions; () = off
    volumetric: bool = False       # participating media (volpath)
    grid_media: bool = False       # grid-density media: delta and ratio
                                   # tracking
    track_steps: int = 64          # null-collision steps per segment at most
    has_hair: bool = None          # compute the hair fiber lobe (None:
                                   # when the scene holds a hair material)
    has_subsurface: bool = False   # the exact BSSRDF continuation
    differentiable: bool = False   # detached sampling (integrators/grad.py)

    def replace(self, **kw):
        return replace(self, **kw)


@dataclass
class PathState:
    """SoA state of the wavefront (one lane per path)."""
    o: torch.Tensor
    d: torch.Tensor
    beta: torch.Tensor
    L: torch.Tensor
    alive: torch.Tensor
    spec: torch.Tensor
    prev_pdf: torch.Tensor
    eta_scale: torch.Tensor
    ghost: torch.Tensor      # direct_only: a non-specular continuation's
                             # last segment
    med: torch.Tensor        # (N,) i32 the medium the ray travels in, or -1
    ray_count: torch.Tensor  # () int64, on the device
    aux_t: torch.Tensor = None  # collect_aux, bounce 0: hit t or -1
    aux_n: torch.Tensor = None  # ... and the geometric normal or 0


def _initial_state(scene, o0, d0, beta0):
    N = o0.shape[0]
    dev = o0.device
    return PathState(
        med=torch.full((N,), scene.camera_medium, dtype=torch.int32,
                       device=dev),
        o=o0, d=d0, beta=beta0,
        L=torch.zeros((N, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(N, dtype=torch.bool, device=dev),
        spec=torch.zeros(N, dtype=torch.bool, device=dev),
        prev_pdf=torch.ones(N, dtype=torch.float32, device=dev),
        eta_scale=torch.ones(N, dtype=torch.float32, device=dev),
        ghost=torch.zeros(N, dtype=torch.bool, device=dev),
        ray_count=torch.zeros((), dtype=torch.int64, device=dev))


def trace_paths(scene, o0, d0, key, cfg: PathConfig, beta0=None,
                sample_ctx=None, collect_aux: bool = False, time=None,
                u_prim=None):
    """Trace N paths -> (radiance (N,3), aux dict with "rays", and with
    collect_aux the primary hit's "distance" (N,) (-1 on a miss) and
    geometric "normal" (N,3)).  beta0: (N,3) initial throughput (the
    realistic camera's weights); time: (N,) shutter times in [0, 1] of a
    scene with object motion; u_prim: (N, max_depth + 1,
    PRIM_DIMS_PER_BOUNCE) explicit primary samples (not with nee_all),
    traced on the uncompacted loop."""
    N = o0.shape[0]
    if beta0 is None:
        beta0 = torch.ones((N, 3), dtype=torch.float32, device=o0.device)
    if u_prim is not None and cfg.nee_all:
        raise ValueError("explicit primary samples take one light sample a bounce")
    if cfg.compact_schedule and cfg.max_depth > 0 and u_prim is None:
        return _trace_paths_compact(scene, o0, d0, key, cfg, beta0, sample_ctx,
                                    collect_aux, time)
    st = _initial_state(scene, o0, d0, beta0)
    aux = {}
    for b in range(cfg.max_depth + 1):
        with statslib.stage(f"path/bounce[{b}]"):
            st = _bounce(scene, st, b, key, cfg, sample_ctx,
                         collect_aux=collect_aux and b == 0, time=time,
                         ub=None if u_prim is None else u_prim[:, b])
        if collect_aux and b == 0:
            aux = dict(distance=st.aux_t, normal=st.aux_n)
    L = torch.where(torch.isfinite(st.L), st.L, torch.zeros_like(st.L))
    return L, dict(aux, rays=st.ray_count)


def _trace_paths_compact(scene, o0, d0, key, cfg: PathConfig, beta0,
                         sample_ctx, collect_aux: bool = False, time=None):
    """Compacted-wavefront loop: per bounce, budget RR with keep
    probability p = min(1, .92 B / live) and 1/p reweighting, then one
    stable coherence sort of the whole state (the rays' times with it)
    with dead lanes last, sliced to the bounce's budget B.  Radiance is
    flushed to the original lane at every compaction, and the bounce runs
    presorted."""
    N = o0.shape[0]
    dev = o0.device
    sched = cfg.compact_schedule
    sizes = [N]
    for b in range(1, cfg.max_depth + 1):
        f = float(sched[min(b, len(sched) - 1)])
        sizes.append(int(min(N, max(1024, round(N * f / 1024.0) * 1024))))
    out = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    pix = torch.arange(N, dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    st = _initial_state(scene, o0, d0, beta0)
    ctx = sample_ctx
    tm = time

    def resort(st, pix, ctx, tm, dropped, B, bounce):
        alive, beta = st.alive, st.beta
        Ncur = st.o.shape[0]
        if B < Ncur:
            live = alive.sum().to(torch.float32)
            p = torch.clamp(0.92 * B / torch.clamp(live, min=1.0), max=1.0)
            u = smplr.ctx_uniform(ctx, key, bounce, smplr.DIM_COMPACT,
                                  (Ncur,), device=dev)
            keep = (~alive) | (u < p)
            beta = torch.where((alive & keep)[:, None], beta / p, beta)
            alive = alive & keep
        sk = cluster_lib.sort_key6(st.o, st.d, scene.world_min, scene.world_max)
        sk = torch.where(alive, sk, 0x7FFFFFFF)
        # lax.sort with payloads is stable: one stable sort, one gather each
        _, perm = torch.sort(sk, stable=True)
        if B < Ncur:
            dropped = dropped + alive[perm[B:]].sum()
        perm = perm[:B]
        st = PathState(
            o=st.o[perm], d=st.d[perm], beta=beta[perm],
            L=torch.zeros((B, 3), dtype=torch.float32, device=dev),
            alive=alive[perm], spec=st.spec[perm], prev_pdf=st.prev_pdf[perm],
            eta_scale=st.eta_scale[perm], ghost=st.ghost[perm],
            med=st.med[perm], ray_count=st.ray_count)
        if ctx is not None:
            ctx = ctx.with_pixel(ctx.pixel[perm])
        return st, pix[perm], ctx, None if tm is None else tm[perm], dropped

    # presort the primary wave too: every traversal of the pass is presorted
    with statslib.stage("path/resort"):
        st, pix, ctx, tm, dropped = resort(st, pix, ctx, tm, dropped, N, 0)
    aux = {}
    for b in range(cfg.max_depth + 1):
        with statslib.stage(f"path/bounce[{b}]"):
            st = _bounce(scene, st, b, key, cfg, ctx, presorted=True,
                         collect_aux=collect_aux and b == 0, time=tm)
        if collect_aux and b == 0:
            # the probe G-buffer back in lane order (the lanes are sorted)
            dist = torch.full((N,), -1.0, dtype=torch.float32, device=dev)
            nrm = torch.zeros((N, 3), dtype=torch.float32, device=dev)
            dist[pix] = st.aux_t
            nrm[pix] = st.aux_n
            aux = dict(distance=dist, normal=nrm)
        with statslib.stage("path/flush"):
            out.index_add_(0, pix, torch.where(torch.isfinite(st.L), st.L,
                                               torch.zeros_like(st.L)))
        if b == cfg.max_depth:
            break
        with statslib.stage("path/resort"):
            st, pix, ctx, tm, dropped = resort(st, pix, ctx, tm, dropped,
                                               sizes[b + 1], b)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out, dict(aux, rays=st.ray_count, compact_overflow=dropped)


def _hg_p(cos_theta, g):
    """Henyey-Greenstein phase function (medium.cpp PhaseHG)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return smp.INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-9)), min=1e-9)


def _hg_sample(d_prop, g, u2):
    """HenyeyGreenstein::Sample_p about the propagation direction d_prop
    (= -wo): pbrt measures cos theta against wo, so g > 0 puts the mass
    forward, at wi ~ d_prop.  Returns (wi, pdf)."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 1e-3, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[:, 0])
    cos_t = torch.where(small, 1.0 - 2.0 * u2[:, 0],
                        (1.0 + g * g - sqr * sqr) / (2.0 * g_safe))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[:, 1]
    # the frame about d_prop; the phase is evaluated at dot(wo, wi) = -cos_t
    fwd = vm.normalize(d_prop)
    t1, t2 = vm.coordinate_system(fwd)
    wi = ((sin_t * torch.cos(phi))[:, None] * t1
          + (sin_t * torch.sin(phi))[:, None] * t2 + cos_t[:, None] * fwd)
    return wi, _hg_p(-cos_t, g)


# the trilinear corners (dx, dy, dz) in the reference's lerp order
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _grid_lookup(scene, med_id):
    """The per-lane constants of the grid density lookups of ``med_id``
    (N,): gathered once, evaluated by ``_grid_eval`` at each point."""
    med_id = med_id.long()
    G = scene.med_density.shape[0]
    gid = torch.clamp(scene.med_grid_id[med_id], 0, G - 1)
    return (scene.med_w2m[med_id], gid, scene.med_grid_dims[gid.long()],
            torch.tensor(_CORNERS, dtype=torch.int32,
                         device=med_id.device))


def _grid_eval(scene, look, p_world):
    """Trilinear grid density at world points (grid.cpp
    GridDensityMedium::Density and ::D: medium space is the unit cube,
    sample coordinates p (nx, ny, nz) - 0.5, zero outside the grid).  The
    eight corners are gathered at once; the lerps run in the reference's
    order."""
    w2m, gid, dims, corners = look
    pm = torch.einsum("nij,nj->ni", w2m[:, :3, :3], p_world) + w2m[:, :3, 3]
    pg = pm * dims.to(torch.float32) - 0.5
    pf = torch.floor(pg)
    f = pg - pf
    idx = pf.to(torch.int32)[:, None, :] + corners[None]          # (N,8,3)
    dz, dy, dx = scene.med_density.shape[1:]
    inb = ((idx >= 0) & (idx < dims[:, None, :])).all(-1)
    lim = torch.tensor([dx - 1, dy - 1, dz - 1], dtype=torch.int32,
                       device=idx.device)
    idx = torch.minimum(torch.clamp(idx, min=0), lim)
    flat = ((gid[:, None] * dz + idx[..., 2]) * dy + idx[..., 1]) * dx + idx[..., 0]
    v = scene.med_density.reshape(-1)[flat.long()]
    v = torch.where(inb, v, torch.zeros_like(v))                  # (N,8)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    d00 = v[:, 0] * (1 - fx) + v[:, 1] * fx
    d10 = v[:, 2] * (1 - fx) + v[:, 3] * fx
    d01 = v[:, 4] * (1 - fx) + v[:, 5] * fx
    d11 = v[:, 6] * (1 - fx) + v[:, 7] * fx
    d0 = d00 * (1 - fy) + d10 * fy
    d1 = d01 * (1 - fy) + d11 * fy
    return d0 * (1 - fz) + d1 * fz


def _grid_exit(look, o, d):
    """The ray parameter beyond which o + t d stays outside the support of
    the grid's density (the medium-space box where a trilinear corner is
    in the grid, (-0.5/n, 1 + 0.5/n) per axis, widened by 1e-3): the
    density there is exactly 0, so a tracking step beyond it changes
    nothing.  NaN (never beyond) where the slab test is undefined."""
    w2m, _, dims, _ = look
    om = torch.einsum("nij,nj->ni", w2m[:, :3, :3], o) + w2m[:, :3, 3]
    dm = torch.einsum("nij,nj->ni", w2m[:, :3, :3], d)
    half = 0.5 / dims.to(torch.float32) + 1e-3
    inv = 1.0 / dm
    t0, t1 = (-half - om) * inv, (1.0 + half - om) * inv
    return torch.amin(torch.maximum(t0, t1), dim=-1)


def _grid_density(scene, med_id, p_world):
    """Trilinear grid density of media ``med_id`` (N,) at world points."""
    return _grid_eval(scene, _grid_lookup(scene, med_id), p_world)


# the tracking loops draw their uniforms TRACK_CHECK steps at a time and
# test before each such chunk whether every lane is done (a host sync): a
# step of a done lane changes nothing, so stopping there gives the same
# result as running all track_steps.  A lane is also done once its track
# has left the grid's support (_grid_exit): its later steps see density 0
# and change neither the transmittance nor the collision
TRACK_CHECK = 8


def _track_uniforms(key, steps, N, done):
    """The uniforms of tracking steps i = 0 .. steps - 1, each
    uniform(fold_in(key, i), (N, 2)), drawn TRACK_CHECK steps at a time;
    stops before a chunk when every lane of ``done()`` is."""
    for i0 in range(0, steps, TRACK_CHECK):
        with statslib.sync_point("track_done"):
            all_done = bool(done().all())
        if all_done:
            return
        yield from threefry.uniform_folded(key, i0, min(TRACK_CHECK, steps - i0),
                                           (N, 2), done().device)


def _delta_track(scene, key, bounce, medc, track, t_surf, o, d, sig_t0,
                 steps):
    """Delta tracking in grid media (grid.cpp GridDensityMedium::Sample):
    exponential steps under the majorant max_density * sigma_t, a real
    collision with probability density / max_density.  Rays that stay
    unresolved after ``steps`` steps go on to the surface.  Returns the
    collision distance and whether a real collision happened."""
    N = o.shape[0]
    dev = o.device
    maxd = scene.med_max_density[medc]
    inv_maj = 1.0 / torch.clamp(maxd * sig_t0, min=1e-20)
    inv_maxd = 1.0 / torch.clamp(maxd, min=1e-20)
    look = _grid_lookup(scene, medc)
    t_out = _grid_exit(look, o, d)
    k_dt = smplr.wave_key(key, 0, bounce, smplr.DIM_MEDIUM_TRACK)
    t = torch.zeros(N, dtype=torch.float32, device=dev)
    done = ~track | (t_out <= 0.0)
    scat = torch.zeros(N, dtype=torch.bool, device=dev)
    for u in _track_uniforms(k_dt, steps, N, lambda: done):
        t_c = t - torch.log(torch.clamp(1.0 - u[:, 0], min=1e-9)) * inv_maj
        reach = t_c >= t_surf
        dens = _grid_eval(scene, look, o + t_c[:, None] * d)
        real = ~done & track & ~reach & (dens * inv_maxd > u[:, 1])
        t = torch.where(done, t, t_c)
        scat = scat | real
        done = done | reach | real | (t_c >= t_out)
    return t, scat


def _ratio_track(scene, key, bounce, medc, need, dist, o, d, sig_t0, steps):
    """Ratio tracking of the transmittance along a shadow ray in grid
    media (grid.cpp GridDensityMedium::Tr)."""
    N = o.shape[0]
    dev = o.device
    maxd = scene.med_max_density[medc]
    inv_maj = 1.0 / torch.clamp(maxd * sig_t0, min=1e-20)
    inv_maxd = 1.0 / torch.clamp(maxd, min=1e-20)
    look = _grid_lookup(scene, medc)
    t_out = _grid_exit(look, o, d)
    k_rt = smplr.wave_key(key, 0, bounce, smplr.DIM_MEDIUM_TR)
    t = torch.zeros(N, dtype=torch.float32, device=dev)
    trv = torch.ones(N, dtype=torch.float32, device=dev)
    done = ~need | (t_out <= 0.0)
    for u in _track_uniforms(k_rt, steps, N, lambda: done):
        t = torch.where(done, t, t - torch.log(
            torch.clamp(1.0 - u[:, 0], min=1e-9)) * inv_maj)
        reach = t >= dist
        dens = _grid_eval(scene, look, o + t[:, None] * d)
        trv = torch.where(~done & ~reach,
                          trv * torch.clamp(1.0 - dens * inv_maxd, 0.0, 1.0), trv)
        done = done | reach | (t >= t_out)
    return trv


def _detach_fields(x):
    """A dataclass of tensors with each tensor detached."""
    return type(x)(**{k: v.detach() if isinstance(v, torch.Tensor) else v
                      for k, v in vars(x).items()})


def _bounce(scene, st: PathState, bounce: int, key, cfg: PathConfig,
            sample_ctx=None, presorted: bool = False,
            collect_aux: bool = False, time=None, ub=None) -> PathState:
    """One wavefront bounce: intersect -> medium event -> Le -> NEE ->
    BSDF, phase or BSSRDF continuation -> Russian roulette.  ub: (N,
    PRIM_DIMS_PER_BOUNCE) explicit primary samples of this bounce."""
    # the differentiable mode freezes the path's geometry and sampling
    sg = (lambda x: x.detach()) if cfg.differentiable else (lambda x: x)
    sg_all = _detach_fields if cfg.differentiable else (lambda x: x)
    o, d, beta, L = sg(st.o), sg(st.d), st.beta, st.L
    alive, spec, prev_pdf, eta_scale = st.alive, st.spec, st.prev_pdf, st.eta_scale
    ghost, med = st.ghost, st.med
    N = o.shape[0]
    dev = o.device

    def draw(purpose, shape):
        return smplr.ctx_uniform(sample_ctx, key, bounce, purpose, shape,
                                 device=dev)

    trav = dict(accel=cfg.accel, cluster_maxc=cfg.cluster_maxc,
                presorted=presorted, time=time)
    with statslib.stage("path/intersect"):
        t_max = torch.where(alive, 1e30, -1.0)
        hit = sg_all(isect.intersect(scene, o, d, t_max, **trav))
        it = sg_all(isect.make_interaction(scene, o, d, hit, time=time))
        ray_count = st.ray_count + alive.sum()
        found = hit.valid & alive

    # ---------- participating medium event ----------
    # (homogeneous.cpp HomogeneousMedium::Sample: channel-mixed distance
    # sampling with analytic transmittance; delta tracking in grids)
    scatter = torch.zeros(N, dtype=torch.bool, device=dev)
    p_med = o
    if cfg.volumetric:
        with statslib.stage("path/medium"):
            D = scene.med_sigma_a.shape[0]
            u_med = ub[:, 0:2] if ub is not None else draw(smplr.DIM_PROBE, (N, 2))
            medc = torch.clamp(med, 0, D - 1).long()
            sig_a, sig_s = scene.med_sigma_a[medc], scene.med_sigma_s[medc]
            sig_t = sig_a + sig_s
            in_med = alive & (med >= 0)
            ch = torch.clamp((u_med[:, 0] * 3).to(torch.int32), max=2)
            st_ch = torch.gather(sig_t, 1, ch.long()[:, None])[:, 0]
            t_surf = torch.where(hit.valid, hit.t, 2.0 * scene.world_radius
                                 / torch.clamp(vm.length(d), min=1e-9))
            t_med = torch.where(
                st_ch > 0.0,
                -torch.log(torch.clamp(1.0 - u_med[:, 1], min=1e-9))
                / torch.clamp(st_ch, min=1e-9), 1e30)
            scatter = in_med & (t_med < t_surf) & (st_ch > 0.0)
            t_eff = torch.minimum(t_med, t_surf)
            tr = torch.exp(-sig_t * t_eff[:, None])
            pdf_med = torch.mean(sig_t * tr, dim=-1)
            pdf_surf = torch.mean(tr, dim=-1)
            w_med = torch.where(
                scatter[:, None], tr * sig_s / torch.clamp(pdf_med, min=1e-20)[:, None],
                tr / torch.clamp(pdf_surf, min=1e-20)[:, None])
            if cfg.grid_media:
                is_grid = scene.med_grid_id[medc] >= 0
                sig_t0 = sig_t[:, 0]
                t_g, scat_g = _delta_track(
                    scene, key, bounce, medc, in_med & is_grid & (sig_t0 > 0.0),
                    t_surf, o, d, sig_t0, cfg.track_steps)
                w_grid = torch.where(scat_g[:, None],
                                     sig_s / torch.clamp(sig_t, min=1e-20),
                                     torch.ones_like(sig_s))
                scatter = torch.where(is_grid, scat_g, scatter)
                t_eff = torch.where(is_grid, torch.minimum(t_g, t_surf), t_eff)
                w_med = torch.where(is_grid[:, None], w_grid, w_med)
            beta = torch.where(in_med[:, None], beta * w_med, beta)
            p_med = o + t_eff[:, None] * d
            # a ray that scattered did not reach the surface this segment
            found = found & ~scatter

    # ---------- emitted radiance ----------
    with statslib.stage("path/emitted"):
        esc = alive & ~hit.valid & ~scatter
        env = lightlib.environment_le(scene, d)
        if cfg.nee_all:
            # every light has its own NEE sample: the light strategy's density
            # for a direction is the bare per-light pdf
            inf_sel_pdf = 1.0
        elif cfg.spatial_lights:
            inf_sel_pdf = lightlib.infinite_select_pdf_spatial(scene, o)
        else:
            live_l = torch.arange(scene.light_kind.shape[0], device=dev) < scene.n_lights
            inf_sel_pdf = torch.sum(torch.where(
                (scene.light_kind == LIGHT_INFINITE) & live_l, scene.light_pdf,
                torch.zeros_like(scene.light_pdf)))
        if scene.has_env_map > 0:
            env_dir_pdf = lightlib._env_dir_pdf(scene, d)
        else:
            env_dir_pdf = torch.full((N,), smp.INV_4PI, device=dev)
        env_pdf = env_dir_pdf * inf_sel_pdf
        def mis(light_pdf):
            """Power-heuristic weight against the light strategy, or 1 on
            bounce 0 and after specular bounces."""
            if bounce == 0:
                return torch.ones_like(prev_pdf)
            return torch.where(spec, 1.0, smp.power_heuristic(1.0, prev_pdf, 1.0,
                                                              light_pdf))

        zero3 = torch.zeros_like(L)
        skip0 = cfg.skip_bounce0_le and bounce == 0
        if not skip0:
            L = L + torch.where(esc[:, None], beta * env * mis(env_pdf)[:, None],
                                zero3)

        emissive = found & (it.light >= 0)
        lid = torch.clamp(it.light, min=0)
        le = lightlib.area_light_le(scene, lid, it.ng, it.wo)
        hit_cos = torch.abs(vm.dot(it.ng, d))
        if cfg.nee_all:
            hit_sel_pdf = 1.0
        elif cfg.spatial_lights:
            hit_sel_pdf = lightlib.light_select_pdf_spatial(scene, o, lid)
        else:
            hit_sel_pdf = scene.light_pdf[lid.long()]
        area_pdf = lightlib.pdf_li(scene, lid, o, d, hit.t, hit_cos) * hit_sel_pdf
        if not skip0:
            L = L + torch.where(emissive[:, None],
                                beta * le * mis(area_pdf)[:, None], zero3)

    aux_t = aux_n = None
    if collect_aux:
        aux_t = torch.where(hit.valid, hit.t, -1.0)
        aux_n = torch.where(hit.valid[:, None], it.ng, torch.zeros_like(it.ng))

    alive = found & (bounce < cfg.max_depth)
    if cfg.direct_only:
        # a ghost segment existed only to collect the BSDF-sampled half of
        # the direct light's MIS
        alive = alive & ~ghost

    # ---------- shading frame and material ----------
    with statslib.stage("path/material"):
        ns = vm.face_forward(it.ns, it.ng)
        ng_f = vm.face_forward(it.ng, -d)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        T_w = scene.tri_p0.shape[0]
        is_tri = (hit.prim >= 0) & (hit.prim < T_w)
        tid = torch.clamp(hit.prim, 0, T_w - 1).long()
        cone_r = vm.length(it.p - scene.tex_cone_o[None, :]) * scene.tex_theta
        tex_w = torch.where(is_tri, cone_r * scene.tri_uv_density[tid],
                            torch.zeros_like(cone_r))
        params = bsdflib.gather_params(scene, torch.clamp(it.mat, min=0), uv=it.uv,
                                       p=it.p, tex_width=tex_w, face=it.face)
        black = bsdflib.is_black(params)
        if cfg.volumetric:
            # a null-material medium boundary: pass straight through and
            # switch medium (the reference skips the null BSDF's intersection)
            entering = vm.dot(d, it.ng) < 0.0
            m_in, m_out = scene.tri_med_in[tid], scene.tri_med_out[tid]
            has_iface = is_tri & ((m_in >= 0) | (m_out >= 0))
            passthrough = found & black & has_iface
            alive = alive & (~black | passthrough)
            # medium vertices live on, whatever the surface behind them
            alive = alive | (scatter & (bounce < cfg.max_depth))
            g_hg = scene.med_g[torch.clamp(med, 0, scene.med_g.shape[0] - 1).long()]
        else:
            alive = alive & ~black
            passthrough = torch.zeros(N, dtype=torch.bool, device=dev)

        # an exact-BSSRDF surface takes its own continuation (below) and has
        # no NEE at the entry vertex: the reference's entry BSDF is a pure
        # Fresnel interface
        if cfg.has_subsurface:
            sss = found & alive & (params.kind == MAT_SUBSURFACE)
            if cfg.volumetric:
                # a medium vertex ends the segment before the surface
                sss = sss & ~scatter & ~passthrough
            beta_pre_sss = beta
        else:
            sss = torch.zeros(N, dtype=torch.bool, device=dev)
        not_sss = ~sss

    # ---------- NEE ----------
    def nee_once(light_id, sel_pdf, u_l, extra_mask):
        """One light sample's MIS-weighted contribution and its count of
        shadow rays; a medium vertex uses the phase function."""
        p_ref = (torch.where(scatter[:, None], p_med, it.p) if cfg.volumetric
                 else it.p)
        ls = lightlib.sample_li(scene, light_id, p_ref, u_l)
        wi_l = vm.to_local(ls.wi, t_f, b_f, ns)
        f_l, scat_pdf = bsdflib.evaluate(params, wo_l, wi_l,
                                         enable_hair=cfg.has_hair)
        scat_pdf = sg(scat_pdf)
        cos_l = vm.absdot(ls.wi, ns)
        can_nee = (alive & (bsdflib.has_nonspecular(params) | scatter)
                   & (ls.pdf > 0.0) & (vm.luminance(ls.li) > 0.0)
                   & (scene.n_lights > 0) & extra_mask)
        o_sh = vm.offset_ray_origin(it.p, ng_f, ls.wi)
        if cfg.volumetric:
            ph = _hg_p(vm.dot(-d, ls.wi), g_hg)
            f_l = torch.where(scatter[:, None], ph[:, None], f_l)
            scat_pdf = torch.where(scatter, ph, scat_pdf)
            cos_l = torch.where(scatter, 1.0, cos_l)
            o_sh = torch.where(scatter[:, None], p_med, o_sh)
        # shadow length from the offset origin (the offset can move the
        # origin towards the light by a scale-relative distance)
        d_off = vm.dot(o_sh - p_ref, ls.wi)
        sh_tmax = torch.where(can_nee, (ls.dist - d_off) * 0.999, -1.0)
        occ = isect.occluded(scene, o_sh, ls.wi, sh_tmax, **trav)
        vis = can_nee & ~occ
        w_l = torch.where(ls.is_delta, 1.0,
                          smp.power_heuristic(1.0, ls.pdf * sel_pdf, 1.0,
                                              scat_pdf))
        li = ls.li
        if cfg.volumetric:
            # the shadow ray's transmittance through the ray's own medium
            # (exact in unbounded fog; boundary crossings are ignored)
            medc2 = torch.clamp(med, 0, scene.med_sigma_a.shape[0] - 1).long()
            sig_t2 = scene.med_sigma_a[medc2] + scene.med_sigma_s[medc2]
            d_sh = torch.clamp(ls.dist, max=4.0 * scene.world_radius)
            tr_sh = torch.exp(-sig_t2 * d_sh[:, None])
            if cfg.grid_media:
                is_grid2 = scene.med_grid_id[medc2] >= 0
                sig_t20 = sig_t2[:, 0]
                tr_g = _ratio_track(
                    scene, key, bounce, medc2,
                    can_nee & (med >= 0) & is_grid2 & (sig_t20 > 0.0),
                    d_sh, o_sh, ls.wi, sig_t20, cfg.track_steps)
                tr_sh = torch.where(is_grid2[:, None], tr_g[:, None], tr_sh)
            li = torch.where((med >= 0)[:, None], li * tr_sh, li)
        contrib = beta * f_l * li * (cos_l * w_l / torch.clamp(
            ls.pdf * sel_pdf, min=1e-12))[:, None]
        return torch.where(vis[:, None], contrib, zero3), can_nee.sum()

    with statslib.stage("path/nee"):
        if cfg.nee_all:
            # UniformSampleAllLights: one sample of each live light slot, from
            # the threefry stream whatever the sampler (the reference's bits)
            k_light = smplr.wave_key(key, 0, bounce, smplr.DIM_LIGHT_SAMPLE)
            u_all = smplr.uniform(k_light, (N, scene.light_kind.shape[0], 3), dev)
            ones = torch.ones(N, device=dev)
            for li in range(scene.n_lights):
                c_nee, n_sh = nee_once(torch.full((N,), li, dtype=torch.int32,
                                                  device=dev), ones, u_all[:, li],
                                       not_sss)
                L = L + c_nee
                ray_count = ray_count + n_sh
        else:
            u_sel = ub[:, 2] if ub is not None else draw(smplr.DIM_LIGHT_SELECT, (N,))
            u_l = ub[:, 3:6] if ub is not None else draw(smplr.DIM_LIGHT_SAMPLE, (N, 3))
            if cfg.spatial_lights:
                p_sel = (torch.where(scatter[:, None], p_med, it.p)
                         if cfg.volumetric else it.p)
                light_id, sel_pdf = lightlib.choose_light_spatial(scene, u_sel, p_sel)
            else:
                light_id, sel_pdf = lightlib.choose_light(scene, u_sel)
            c_nee, n_sh = nee_once(light_id, sel_pdf, u_l, not_sss)
            L = L + c_nee
            ray_count = ray_count + n_sh

    # ---------- BSDF sample / continuation ----------
    with statslib.stage("path/bsdf"):
        u_lobe = ub[:, 6] if ub is not None else draw(smplr.DIM_BSDF_LOBE, (N,))
        u_dir = ub[:, 7:9] if ub is not None else draw(smplr.DIM_BSDF_DIR, (N, 2))
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir, enable_hair=cfg.has_hair)
        # detached sampling: the direction and its pdf are frozen, bs.f carries
        # the material's gradient
        wi_w = sg(vm.to_world(bs.wi, t_f, b_f, ns))
        cos_w = sg(vm.absdot(wi_w, ns))
        beta_new = beta * bs.f * (cos_w / torch.clamp(sg(bs.pdf), min=1e-12))[:, None]
        if cfg.volumetric:
            # a medium vertex samples Henyey-Greenstein (p / pdf = 1); a
            # null-material boundary continues straight on
            wi_hg, pdf_hg = _hg_sample(-d, g_hg, u_dir)
            wi_w = torch.where(scatter[:, None], wi_hg, wi_w)
            beta_new = torch.where(scatter[:, None], beta, beta_new)
            wi_w = torch.where(passthrough[:, None], d, wi_w)
            beta_new = torch.where(passthrough[:, None], beta, beta_new)
        lum_new = vm.luminance(beta_new)
        ok = (bs.valid & alive & (vm.luminance(torch.abs(beta_new)) > 0.0)
              & torch.isfinite(lum_new))
        if cfg.volumetric:
            ok = ok | (alive & (scatter | passthrough))
        beta = torch.where(ok[:, None], beta_new, beta)
        alive = alive & ok
        if cfg.direct_only:
            ghost = alive & ~bs.is_specular
        spec = bs.is_specular
        prev_pdf = sg(torch.where(bs.is_specular, 1.0, bs.pdf))
        if cfg.volumetric:
            spec = torch.where(scatter, False, torch.where(passthrough, True, spec))
            prev_pdf = torch.where(scatter, pdf_hg, prev_pdf)
            # medium transitions on transmission and at null boundaries
            crossing = (bs.is_transmission & ~scatter) | passthrough
            med = torch.where(found & crossing & is_tri,
                              torch.where(entering, m_in, m_out), med)
        eta_rel = torch.where(vm.dot(it.wo, it.ng) > 0.0, params.eta,
                              1.0 / torch.clamp(params.eta, min=1e-6))
        eta_scale = torch.where(bs.is_transmission, eta_scale * eta_rel * eta_rel,
                                eta_scale)
        o = vm.offset_ray_origin(it.p, ng_f, wi_w)
        if cfg.volumetric:
            o = torch.where(scatter[:, None], p_med, o)
        d = wi_w

    if cfg.has_subsurface:
        with statslib.stage("path/bssrdf"):
            L, beta, o, d, alive, spec, prev_pdf, ray_count = _bssrdf(
                scene, cfg, trav, draw, it, params, sss, beta_pre_sss, u_lobe,
                wo_l, t_f, b_f, ns, ng_f,
                (L, beta, o, d, alive, spec, prev_pdf, ray_count), sg_all)

    # ---------- russian roulette ----------
    with statslib.stage("path/roulette"):
        rr_beta_max = sg(vm.max_component(beta * eta_scale[:, None]))
        do_rr = (rr_beta_max < cfg.rr_threshold) & (bounce > RR_START)
        q = torch.clamp(1.0 - rr_beta_max, min=0.05)
        u_rr = ub[:, 9] if ub is not None else draw(smplr.DIM_RR, (N,))
        killed = do_rr & (u_rr < q)
        alive = alive & ~killed
        beta = torch.where((do_rr & ~killed)[:, None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
    return PathState(o=o, d=d, beta=beta, L=L, alive=alive, spec=spec,
                     prev_pdf=prev_pdf, eta_scale=eta_scale, ghost=ghost,
                     med=med, ray_count=ray_count, aux_t=aux_t, aux_n=aux_n)


X999 = 19.87   # the radius (over d) below which the mixture has 0.999


def _bssrdf(scene, cfg, trav, draw, it, params, sss, beta_pre, u_lobe, wo_l,
            t_f, b_f, ns, ng_f, state, sg_all=lambda x: x):
    """The exact BSSRDF continuation of the lanes ``sss`` (bssrdf.cpp
    SeparableBSSRDF::Sample_Sp and Pdf_Sp, path.cpp's subsurface block).
    A Burley normalized-diffusion radial profile stands in for the
    reference's tabulated beam diffusion: per channel Sr integrates to
    the albedo A, and a mixture of two exponentials samples it exactly.
    Entry: the Fresnel choice between the specular reflection and entering.
    Exit point: a probe ray along a MIS-selected local axis, the closest
    hit of the same material.  Exit lobe: cosine x (1 - Fr) / c (the
    SeparableBSSRDFAdapter; the entry and exit eta^2 scalings cancel).
    Returns the updated (L, beta, o, d, alive, spec, prev_pdf, ray_count);
    sg_all detaches the probe's interaction in the differentiable mode."""
    L, beta, o, d, alive, spec, prev_pdf, ray_count = state
    N = o.shape[0]
    ones = torch.ones_like(params.eta)
    fr_o = bsdflib.fr_dielectric(wo_l[..., 2], ones, params.eta)
    go_reflect = u_lobe < fr_o
    # the specular entry reflection: f cos / pdf = kr (Fresnel cancels
    # against its selection probability)
    wi_refl_l = torch.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], dim=-1)
    d_refl = vm.to_world(wi_refl_l, t_f, b_f, ns)

    u4 = draw(smplr.DIM_SSS_PROBE, (N, 4))
    u_ax, u_ch, u_r, u_phi = u4[:, 0], u4[:, 1], u4[:, 2], u4[:, 3]
    d_all = torch.clamp(scene.mat_sss_d[torch.clamp(it.mat, min=0).long()],
                        min=1e-6)                                  # (N,3)
    A_prof = params.kd
    ch = torch.clamp((u_ch * 3.0).to(torch.int32), 0, 2)
    d_ch = torch.gather(d_all, 1, ch.long()[:, None])[:, 0]
    # the radius from the mixture of two exponentials (Sr sampled exactly)
    mix = u_r < 0.25
    u1 = torch.clamp(torch.where(mix, u_r / 0.25, (u_r - 0.25) / 0.75), 0.0,
                     1.0 - 1e-7)
    r_s = torch.where(mix, -d_ch * torch.log1p(-u1),
                      -3.0 * d_ch * torch.log1p(-u1))
    r_max = d_ch * X999
    r_ok = r_s < r_max
    half_l = torch.sqrt(torch.clamp(r_max * r_max - r_s * r_s, min=0.0))
    phi = 2.0 * math.pi * u_phi
    # the probe axis: ns with probability .5, each tangent .25
    a_ns = u_ax < 0.5
    a_t = (u_ax >= 0.5) & (u_ax < 0.75)

    def pick(v_ns, v_t, v_b):
        return torch.where(a_ns[:, None], v_ns,
                           torch.where(a_t[:, None], v_t, v_b))

    vx, vy, vz = pick(t_f, b_f, ns), pick(b_f, ns, t_f), pick(ns, t_f, b_f)
    base = (it.p + r_s[:, None] * (torch.cos(phi)[:, None] * vx
                                   + torch.sin(phi)[:, None] * vy)
            + half_l[:, None] * vz)
    p_dir = -vz
    do_probe = sss & ~go_reflect & r_ok
    probe_tmax = torch.where(do_probe, 2.0 * half_l, -1.0)
    ph = isect.intersect(scene, base, p_dir, probe_tmax, accel=cfg.accel,
                         cluster_maxc=cfg.cluster_maxc, time=trav["time"])
    # the differentiable mode freezes the probe's geometry as the path's
    pit = sg_all(isect.make_interaction(scene, base, p_dir, ph, time=trav["time"]))
    ray_count = ray_count + do_probe.sum()
    same = ph.valid & (pit.mat == it.mat)
    diffv = pit.p - it.p
    r_act = vm.length(diffv)
    dL = torch.stack([vm.dot(diffv, t_f), vm.dot(diffv, b_f),
                      vm.dot(diffv, ns)], dim=-1)
    nL = torch.stack([vm.dot(pit.ns, t_f), vm.dot(pit.ns, b_f),
                      vm.dot(pit.ns, ns)], dim=-1)
    # the radii projected on each probe axis (bssrdf.cpp Pdf_Sp)
    rp_t = torch.sqrt(dL[:, 1] ** 2 + dL[:, 2] ** 2)
    rp_b = torch.sqrt(dL[:, 2] ** 2 + dL[:, 0] ** 2)
    rp_n = torch.sqrt(dL[:, 0] ** 2 + dL[:, 1] ** 2)

    def p_area(rr, dd):
        # the radius sampler's area pdf, per channel
        rr_ = torch.clamp(rr, min=1e-6)[:, None]
        pr = 0.25 * (torch.exp(-rr_ / dd) + torch.exp(-rr_ / (3.0 * dd))) / dd
        return pr / (2.0 * math.pi * rr_)

    pdf_sp = (0.25 * torch.abs(nL[:, 0]) * p_area(rp_t, d_all).mean(-1)
              + 0.25 * torch.abs(nL[:, 1]) * p_area(rp_b, d_all).mean(-1)
              + 0.5 * torch.abs(nL[:, 2]) * p_area(rp_n, d_all).mean(-1))
    ra = torch.clamp(r_act, min=1e-6)[:, None]
    sp = A_prof * (torch.exp(-ra / d_all) + torch.exp(-ra / (3.0 * d_all))) / (
        8.0 * math.pi * d_all * ra)
    w_sp = sp / torch.clamp(pdf_sp, min=1e-12)[:, None]

    # the exit lobe: cosine x (1 - Fr) / c (bssrdf.h SeparableBSSRDF::Sw,
    # c = 1 - 2 FresnelMoment1(1 / eta))
    u_e = draw(smplr.DIM_SSS_EXIT, (N, 2))
    wi_e_l = smp.cosine_sample_hemisphere(u_e)
    # two-sided: where the entry normal faced away from the viewer the
    # mesh is wound inward, and the exit normal flips with it
    flip = torch.where(vm.dot(it.ng, it.wo) < 0.0, -1.0, 1.0)
    nf_exit = pit.ns * flip[:, None]
    t_e, b_e = vm.coordinate_system(nf_exit)
    wi_e_w = vm.to_world(wi_e_l, t_e, b_e, nf_exit)
    cos_e = torch.clamp(wi_e_l[..., 2], min=0.0)
    fr_i = bsdflib.fr_dielectric(cos_e, ones, params.eta)
    c_norm = torch.clamp(1.0 - 2.0 * bsdflib.fresnel_moment1(
        1.0 / torch.clamp(params.eta, min=1e-6)), min=1e-4)
    beta_enter = beta_pre * w_sp * ((1.0 - fr_i) / c_norm)[:, None]
    beta_refl = beta_pre * params.kr
    enter_ok = (do_probe & same & (pdf_sp > 0.0)
                & torch.isfinite(vm.luminance(beta_enter)) & (cos_e > 0.0))

    # NEE at the exit vertex (path.cpp's subsurface block: L += beta *
    # UniformSampleOneLight(pi)); the exit lobe is f = (1 - Fr) / (c pi),
    # pdf = cos / pi, weighted against the cosine continuation
    u_sel_x = draw(smplr.DIM_SSS_NEE, (N, 4))
    if cfg.spatial_lights:
        lid_x, selp_x = lightlib.choose_light_spatial(scene, u_sel_x[:, 0], pit.p)
    else:
        lid_x, selp_x = lightlib.choose_light(scene, u_sel_x[:, 0])
    lsx = lightlib.sample_li(scene, lid_x, pit.p, u_sel_x[:, 1:4])
    cos_lx = torch.clamp(vm.dot(lsx.wi, nf_exit), min=0.0)
    fr_lx = bsdflib.fr_dielectric(cos_lx, ones, params.eta)
    f_sw_x = (1.0 - fr_lx) / (c_norm * math.pi)
    can_x = (enter_ok & (lsx.pdf > 0.0) & (cos_lx > 0.0)
             & (vm.luminance(lsx.li) > 0.0) & (scene.n_lights > 0))
    o_shx = vm.offset_ray_origin(pit.p, nf_exit, lsx.wi)
    shx_tmax = torch.where(
        can_x, (lsx.dist - vm.dot(o_shx - pit.p, lsx.wi)) * 0.999, -1.0)
    occ_x = isect.occluded(scene, o_shx, lsx.wi, shx_tmax, accel=cfg.accel,
                           cluster_maxc=cfg.cluster_maxc, time=trav["time"])
    ray_count = ray_count + can_x.sum()
    w_mis_x = torch.where(lsx.is_delta, 1.0,
                          smp.power_heuristic(1.0, lsx.pdf * selp_x, 1.0,
                                              cos_lx / math.pi))
    contrib_x = (beta_pre * w_sp
                 * (f_sw_x * cos_lx * w_mis_x / torch.clamp(
                     lsx.pdf * selp_x, min=1e-12))[:, None] * lsx.li)
    L = L + torch.where((can_x & ~occ_x & ~go_reflect & sss)[:, None],
                        contrib_x, torch.zeros_like(contrib_x))
    sss_ok = torch.where(go_reflect, vm.luminance(beta_refl) > 0.0, enter_ok)
    sss_beta = torch.where(go_reflect[:, None], beta_refl, beta_enter)
    sss_o = torch.where(go_reflect[:, None],
                        vm.offset_ray_origin(it.p, ng_f, d_refl),
                        vm.offset_ray_origin(pit.p, nf_exit, wi_e_w))
    sss_dir = torch.where(go_reflect[:, None], d_refl, wi_e_w)
    s3 = sss[:, None]
    return (L, torch.where(s3, sss_beta, beta), torch.where(s3, sss_o, o),
            torch.where(s3, sss_dir, d), torch.where(sss, sss_ok, alive),
            torch.where(sss, go_reflect, spec),
            torch.where(sss, torch.where(go_reflect, 1.0, cos_e / math.pi),
                        prev_pdf),
            ray_count)
