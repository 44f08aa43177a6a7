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

Not ported: participating media, the exact BSSRDF, hair, explicit
primary samples (``u_prim``) and the differentiable mode.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..ops import bsdf as bsdflib
from ..ops import clusters as cluster_lib
from ..ops import intersect as isect
from ..ops import lights as lightlib
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..scene.api import LIGHT_INFINITE
from ..utils import stats as statslib
from ..utils import vecmath as vm


RR_START = 3  # Russian roulette from the bounce after this one


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
    ray_count: torch.Tensor  # () int64, on the device
    aux_t: torch.Tensor = None  # collect_aux, bounce 0: hit t or -1
    aux_n: torch.Tensor = None  # ... and the geometric normal or 0


def _initial_state(o0, d0, beta0):
    N = o0.shape[0]
    dev = o0.device
    return PathState(
        o=o0, d=d0, beta=beta0,
        L=torch.zeros((N, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(N, dtype=torch.bool, device=dev),
        spec=torch.zeros(N, dtype=torch.bool, device=dev),
        prev_pdf=torch.ones(N, dtype=torch.float32, device=dev),
        eta_scale=torch.ones(N, dtype=torch.float32, device=dev),
        ghost=torch.zeros(N, dtype=torch.bool, device=dev),
        ray_count=torch.zeros((), dtype=torch.int64, device=dev))


def trace_paths(scene, o0, d0, key, cfg: PathConfig, beta0=None,
                sample_ctx=None, collect_aux: bool = False):
    """Trace N paths -> (radiance (N,3), aux dict with "rays", and with
    collect_aux the primary hit's "distance" (N,) (-1 on a miss) and
    geometric "normal" (N,3))."""
    N = o0.shape[0]
    if beta0 is None:
        beta0 = torch.ones((N, 3), dtype=torch.float32, device=o0.device)
    if cfg.compact_schedule and cfg.max_depth > 0:
        return _trace_paths_compact(scene, o0, d0, key, cfg, beta0, sample_ctx,
                                    collect_aux)
    st = _initial_state(o0, d0, beta0)
    aux = {}
    for b in range(cfg.max_depth + 1):
        st = statslib.timed(f"path/bounce[{b}]", _bounce, scene, st, b, key,
                            cfg, sample_ctx, collect_aux=collect_aux and b == 0)
        if collect_aux and b == 0:
            aux = dict(distance=st.aux_t, normal=st.aux_n)
    L = torch.where(torch.isfinite(st.L), st.L, torch.zeros_like(st.L))
    return L, dict(aux, rays=st.ray_count)


def _trace_paths_compact(scene, o0, d0, key, cfg: PathConfig, beta0,
                         sample_ctx, collect_aux: bool = False):
    """Compacted-wavefront loop: per bounce, budget RR with keep
    probability p = min(1, .92 B / live) and 1/p reweighting, then one
    stable coherence sort of the whole state with dead lanes last, sliced
    to the bounce's budget B.  Radiance is flushed to the original lane
    at every compaction, and the bounce runs presorted."""
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
    st = _initial_state(o0, d0, beta0)
    ctx = sample_ctx

    def resort(st, pix, ctx, dropped, B, bounce):
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
            ray_count=st.ray_count)
        if ctx is not None:
            ctx = ctx.with_pixel(ctx.pixel[perm])
        return st, pix[perm], ctx, dropped

    # presort the primary wave too: every traversal of the pass is presorted
    st, pix, ctx, dropped = resort(st, pix, ctx, dropped, N, 0)
    aux = {}
    for b in range(cfg.max_depth + 1):
        st = statslib.timed(f"path/bounce[{b}]", _bounce, scene, st, b, key,
                            cfg, ctx, presorted=True,
                            collect_aux=collect_aux and b == 0)
        if collect_aux and b == 0:
            # the probe G-buffer back in lane order (the lanes are sorted)
            dist = torch.full((N,), -1.0, dtype=torch.float32, device=dev)
            nrm = torch.zeros((N, 3), dtype=torch.float32, device=dev)
            dist[pix] = st.aux_t
            nrm[pix] = st.aux_n
            aux = dict(distance=dist, normal=nrm)
        out.index_add_(0, pix, torch.where(torch.isfinite(st.L), st.L,
                                           torch.zeros_like(st.L)))
        if b == cfg.max_depth:
            break
        st, pix, ctx, dropped = resort(st, pix, ctx, dropped, sizes[b + 1], b)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out, dict(aux, rays=st.ray_count, compact_overflow=dropped)


def _bounce(scene, st: PathState, bounce: int, key, cfg: PathConfig,
            sample_ctx=None, presorted: bool = False,
            collect_aux: bool = False) -> PathState:
    """One wavefront bounce: intersect -> Le -> NEE -> BSDF continuation
    -> Russian roulette."""
    o, d, beta, L = st.o, st.d, st.beta, st.L
    alive, spec, prev_pdf, eta_scale = st.alive, st.spec, st.prev_pdf, st.eta_scale
    ghost = st.ghost
    N = o.shape[0]
    dev = o.device

    def draw(purpose, shape):
        return smplr.ctx_uniform(sample_ctx, key, bounce, purpose, shape,
                                 device=dev)

    trav = dict(accel=cfg.accel, cluster_maxc=cfg.cluster_maxc,
                presorted=presorted)
    t_max = torch.where(alive, 1e30, -1.0)
    hit = isect.intersect(scene, o, d, t_max, **trav)
    it = isect.make_interaction(scene, o, d, hit)
    ray_count = st.ray_count + alive.sum()
    found = hit.valid & alive

    # ---------- emitted radiance ----------
    esc = alive & ~hit.valid
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
    ns = vm.face_forward(it.ns, it.ng)
    ng_f = vm.face_forward(it.ng, -d)
    t_f, b_f = vm.coordinate_system(ns)
    wo_l = vm.to_local(it.wo, t_f, b_f, ns)
    T_w = scene.tri_p0.shape[0]
    is_tri_w = (hit.prim >= 0) & (hit.prim < T_w)
    dens_w = scene.tri_uv_density[torch.clamp(hit.prim, 0, T_w - 1).long()]
    cone_r = vm.length(it.p - scene.tex_cone_o[None, :]) * scene.tex_theta
    tex_w = torch.where(is_tri_w, cone_r * dens_w, torch.zeros_like(cone_r))
    params = bsdflib.gather_params(scene, torch.clamp(it.mat, min=0), uv=it.uv,
                                   p=it.p, tex_width=tex_w, face=it.face)
    alive = alive & ~bsdflib.is_black(params)

    # ---------- NEE ----------
    def nee_once(light_id, sel_pdf, u_l):
        """One light sample's MIS-weighted contribution and its count of
        shadow rays."""
        ls = lightlib.sample_li(scene, light_id, it.p, u_l)
        wi_l = vm.to_local(ls.wi, t_f, b_f, ns)
        f_l, scat_pdf = bsdflib.evaluate(params, wo_l, wi_l)
        cos_l = vm.absdot(ls.wi, ns)
        can_nee = (alive & bsdflib.has_nonspecular(params) & (ls.pdf > 0.0)
                   & (vm.luminance(ls.li) > 0.0) & (scene.n_lights > 0))
        o_sh = vm.offset_ray_origin(it.p, ng_f, ls.wi)
        # shadow length from the offset origin (the offset can move the
        # origin towards the light by a scale-relative distance)
        d_off = vm.dot(o_sh - it.p, ls.wi)
        sh_tmax = torch.where(can_nee, (ls.dist - d_off) * 0.999, -1.0)
        occ = isect.occluded(scene, o_sh, ls.wi, sh_tmax, **trav)
        vis = can_nee & ~occ
        w_l = torch.where(ls.is_delta, 1.0,
                          smp.power_heuristic(1.0, ls.pdf * sel_pdf, 1.0,
                                              scat_pdf))
        contrib = beta * f_l * ls.li * (cos_l * w_l / torch.clamp(
            ls.pdf * sel_pdf, min=1e-12))[:, None]
        return torch.where(vis[:, None], contrib, zero3), can_nee.sum()

    if cfg.nee_all:
        # UniformSampleAllLights: one sample of each live light slot, from
        # the threefry stream whatever the sampler (the reference's bits)
        k_light = smplr.wave_key(key, 0, bounce, smplr.DIM_LIGHT_SAMPLE)
        u_all = smplr.uniform(k_light, (N, scene.light_kind.shape[0], 3), dev)
        ones = torch.ones(N, device=dev)
        for li in range(scene.n_lights):
            c_nee, n_sh = nee_once(torch.full((N,), li, dtype=torch.int32,
                                              device=dev), ones, u_all[:, li])
            L = L + c_nee
            ray_count = ray_count + n_sh
    else:
        u_sel = draw(smplr.DIM_LIGHT_SELECT, (N,))
        u_l = draw(smplr.DIM_LIGHT_SAMPLE, (N, 3))
        if cfg.spatial_lights:
            light_id, sel_pdf = lightlib.choose_light_spatial(scene, u_sel, it.p)
        else:
            light_id, sel_pdf = lightlib.choose_light(scene, u_sel)
        c_nee, n_sh = nee_once(light_id, sel_pdf, u_l)
        L = L + c_nee
        ray_count = ray_count + n_sh

    # ---------- BSDF sample / continuation ----------
    u_lobe = draw(smplr.DIM_BSDF_LOBE, (N,))
    u_dir = draw(smplr.DIM_BSDF_DIR, (N, 2))
    bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
    wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
    cos_w = vm.absdot(wi_w, ns)
    beta_new = beta * bs.f * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None]
    lum_new = vm.luminance(beta_new)
    ok = (bs.valid & alive & (vm.luminance(torch.abs(beta_new)) > 0.0)
          & torch.isfinite(lum_new))
    beta = torch.where(ok[:, None], beta_new, beta)
    alive = alive & ok
    if cfg.direct_only:
        ghost = alive & ~bs.is_specular
    spec = bs.is_specular
    prev_pdf = torch.where(bs.is_specular, 1.0, bs.pdf)
    eta_rel = torch.where(vm.dot(it.wo, it.ng) > 0.0, params.eta,
                          1.0 / torch.clamp(params.eta, min=1e-6))
    eta_scale = torch.where(bs.is_transmission, eta_scale * eta_rel * eta_rel,
                            eta_scale)
    o = vm.offset_ray_origin(it.p, ng_f, wi_w)
    d = wi_w

    # ---------- russian roulette ----------
    rr_beta_max = vm.max_component(beta * eta_scale[:, None])
    do_rr = (rr_beta_max < cfg.rr_threshold) & (bounce > RR_START)
    q = torch.clamp(1.0 - rr_beta_max, min=0.05)
    u_rr = draw(smplr.DIM_RR, (N,))
    killed = do_rr & (u_rr < q)
    alive = alive & ~killed
    beta = torch.where((do_rr & ~killed)[:, None],
                       beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
    return PathState(o=o, d=d, beta=beta, L=L, alive=alive, spec=spec,
                     prev_pdf=prev_pdf, eta_scale=eta_scale, ghost=ghost,
                     ray_count=ray_count, aux_t=aux_t, aux_n=aux_n)
