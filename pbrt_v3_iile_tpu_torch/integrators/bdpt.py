"""Bidirectional path tracing (port of ``integrators/bdpt.py``).

bdpt.cpp's estimator: a camera subpath and a light subpath, each
random-walked vertex by vertex (``_subpath``, a Python loop over the
vertices: one closest-hit wave, one BSDF sample and one reverse-density
evaluation a vertex), every (s, t) connection strategy with s + t - 2 <=
max depth, and the product-of-ratios MIS weight with remap0 and the
delta flags (``_mis_weight``).  Per camera vertex t, every BSDF
evaluation of the iteration goes into one batched ``bsdf.evaluate``
(``_EvalBatch``) and every connection shadow ray into one ``occluded``
call (``_ShadowBatch``): a handful of launches a strategy row instead of
a handful a strategy.

Light tracing (t = 1, the perspective pinhole only): each light vertex
connects to the camera through the camera-importance model
(``ops/camera.py`` ``sample_wi`` / ``pdf_we_dir``) and splats into a
dense (H*W + 1, 3) film (flat index H*W collects the discarded splats),
which the driver adds at resolve time with a 1/spp scale.

As in the reference, infinite lights are handled pairwise (the escape
against NEE by the power heuristic), light subpaths start from finite
lights only, and every traversal is the BVH's (the BVH kernel, K2),
without a ray time or a medium: the accel, object motion and media of
the scene do not reach BDPT.

``u_ext``/``sel_st``: explicit primary samples and one selected (s, t)
strategy, the deterministic evaluation of Metropolis over BDPT proposals
(``integrators/mlt.py``).
"""

from __future__ import annotations

import torch

from ..ops import bsdf as bsdflib
from ..ops import camera as camlib
from ..ops import intersect as isect
from ..ops import lights as lightlib
from ..ops import samplers as smplr
from ..ops import sampling as smp
from ..ops import threefry
from ..scene.api import LIGHT_INFINITE
from ..utils import vecmath as vm


def _remap0(x):
    """remap0: a zero density counts as 1 in the MIS ratios."""
    return torch.where(x > 0.0, x, torch.ones_like(x))


def _convert(pdf_sa, p_from, p_to, ns_to):
    """Solid-angle pdf at p_from -> area density at p_to
    (bdpt.h Vertex::ConvertDensity)."""
    w = p_to - p_from
    d2 = vm.length_sq(w)
    inv_d2 = torch.where(d2 > 0.0, 1.0 / torch.clamp(d2, min=1e-20),
                         torch.zeros_like(d2))
    cos_t = torch.abs(vm.dot(ns_to, w)) * torch.sqrt(inv_d2)
    return pdf_sa * cos_t * inv_d2


def _new_vertex(N, dev):
    z3 = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    z1 = torch.zeros(N, dtype=torch.float32, device=dev)
    return dict(valid=torch.zeros(N, dtype=torch.bool, device=dev), p=z3, ng=z3,
                ns=z3, wo=z3, beta=torch.ones((N, 3), device=dev), pdf_fwd=z1,
                pdf_rev=z1, delta=torch.zeros(N, dtype=torch.bool, device=dev),
                light=torch.full((N,), -1, dtype=torch.int32, device=dev),
                params=None, t_f=z3, b_f=z3)


def _local(v, w):
    return vm.to_local(w, v["t_f"], v["b_f"], v["ns"])


class _EvalBatch:
    """Deferred BSDF evaluations: add (vertex, wo, wi) world-space
    requests, run one ``bsdf.evaluate`` over their concatenation, read
    back each request's (f, pdf)."""

    def __init__(self):
        self.reqs = []
        self.out = None

    def add(self, v, wo_w, wi_w) -> int:
        self.reqs.append((v["params"], _local(v, wo_w), _local(v, wi_w)))
        return len(self.reqs) - 1

    def run(self):
        if not self.reqs:
            self.out = []
            return
        params = bsdflib.concat_params([r[0] for r in self.reqs])
        f, pdf = bsdflib.evaluate(params, torch.cat([r[1] for r in self.reqs]),
                                  torch.cat([r[2] for r in self.reqs]))
        n = self.reqs[0][1].shape[0]
        self.out = [(f[i * n:(i + 1) * n], pdf[i * n:(i + 1) * n])
                    for i in range(len(self.reqs))]

    def f(self, i):
        return self.out[i][0]

    def pdf(self, i):
        return self.out[i][1]


class _ShadowBatch:
    """Deferred occlusion tests: one ``occluded`` call (the BVH's) for all
    of an iteration's connection rays."""

    def __init__(self):
        self.reqs = []
        self.out = None

    def add(self, o, d, tmax) -> int:
        self.reqs.append((o, d, tmax))
        return len(self.reqs) - 1

    def run(self, scene):
        if not self.reqs:
            self.out = []
            return
        occ = isect.occluded(scene, torch.cat([r[0] for r in self.reqs]),
                             torch.cat([r[1] for r in self.reqs]),
                             torch.cat([r[2] for r in self.reqs]), accel="bvh")
        n = self.reqs[0][0].shape[0]
        self.out = [occ[i * n:(i + 1) * n] for i in range(len(self.reqs))]

    def occ(self, i):
        return self.out[i]


def _subpath(scene, o0, d0, beta0, pdf_dir0, key, n_verts, stream, root_delta,
             collect_env=False, inf_sel_pdf=0.0, root=None, u_vert=None,
             sel_esc=None):
    """Random-walk up to n_verts surface vertices (bdpt.cpp RandomWalk)
    -> (vertex dicts, escaped radiance).  The root vertex is the caller's;
    its pdf_rev (from the first surface vertex's reverse scatter) is
    written into ``root`` when given."""
    N = o0.shape[0]
    dev = o0.device
    o, d, beta, pdf_dir = o0, d0, beta0, pdf_dir0
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    prev_delta, prev_p = root_delta, o0
    prev_ns = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    L_esc = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    verts, rev_prev = [], []
    for b in range(n_verts):
        t_max = torch.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max, accel="bvh")
        it = isect.make_interaction(scene, o, d, hit)
        found = hit.valid & alive

        if collect_env:
            esc = alive & ~hit.valid
            if sel_esc is not None:
                # one selected strategy: the escape after segment b is the
                # (s=0, t=b+2) strategy
                esc = esc & sel_esc[0] & (sel_esc[1] == b + 2)
            env = lightlib.environment_le(scene, d)
            if scene.has_env_map > 0:
                env_pdf = lightlib._env_dir_pdf(scene, d) * inf_sel_pdf
            else:
                env_pdf = torch.full((N,), smp.INV_4PI, device=dev) * inf_sel_pdf
            w = smp.power_heuristic(1.0, pdf_dir, 1.0, env_pdf)
            w = torch.ones_like(w) if b == 0 else torch.where(prev_delta, 1.0, w)
            L_esc = L_esc + torch.where(esc[:, None], beta * env * w[:, None],
                                        torch.zeros_like(L_esc))

        ns = vm.face_forward(it.ns, it.ng)
        t_f, b_f = vm.coordinate_system(ns)
        params = bsdflib.gather_params(scene, torch.clamp(it.mat, min=0),
                                       uv=it.uv, p=it.p)
        v = dict(valid=found, p=it.p, ng=it.ng, ns=ns, wo=it.wo, beta=beta,
                 light=torch.where(found, it.light, -1), t_f=t_f, b_f=b_f,
                 params=params,
                 pdf_fwd=torch.where(found, _convert(pdf_dir, prev_p, it.p, ns),
                                     0.0))

        # the continuation (u_vert: explicit primary samples)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        if u_vert is not None:
            u_lobe, u_dir = u_vert[:, b, 0], u_vert[:, b, 1:3]
        else:
            u_lobe = smplr.uniform(smplr.wave_key(key, stream, b,
                                                  smplr.DIM_BSDF_LOBE), (N,), dev)
            u_dir = smplr.uniform(smplr.wave_key(key, stream, b,
                                                 smplr.DIM_BSDF_DIR), (N, 2), dev)
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
        v["delta"] = bs.is_specular
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        # the reverse density onto the previous vertex (area measure there)
        _, rev_sa = bsdflib.evaluate(params, vm.to_local(wi_w, t_f, b_f, ns), wo_l)
        rev_sa = torch.where(bs.is_specular, 0.0, rev_sa)
        rev_prev.append(torch.where(found, _convert(rev_sa, it.p, prev_p, prev_ns),
                                    0.0))

        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None]
        ok = (found & bs.valid & ~bsdflib.is_black(params)
              & (vm.luminance(torch.abs(beta_new)) > 0.0))
        ng_f = vm.face_forward(it.ng, it.wo)
        o = torch.where(ok[:, None], vm.offset_ray_origin(it.p, ng_f, wi_w), o)
        d = torch.where(ok[:, None], wi_w, d)
        beta = torch.where(ok[:, None], beta_new, beta)
        alive = ok
        pdf_dir = torch.where(bs.is_specular, 1.0, bs.pdf)
        prev_delta, prev_p, prev_ns = bs.is_specular, it.p, ns
        verts.append(v)

    for i, v in enumerate(verts):
        # vertex i's pdf_rev comes from vertex i+1's reverse scatter
        v["pdf_rev"] = (rev_prev[i + 1] if i + 1 < n_verts
                        else torch.zeros(N, dtype=torch.float32, device=dev))
    if root is not None and n_verts > 0:
        root["pdf_rev"] = rev_prev[0]
    return verts, L_esc


def _mis_weight(cam, lit, s, t, rev_over, delta_over, lit0_delta_pos,
                with_t1: bool = False):
    """bdpt.cpp MISWeight: the product of ratios over the alternative
    strategies of the same path length.  with_t1 includes the t' = 1
    (light-tracing) alternative, valid only when the camera's importance
    densities are real and the t = 1 strategies are evaluated.
    rev_over / delta_over: {('c'|'l', index): tensor} overrides at the
    junction."""
    def rev(side, i):
        if (side, i) in rev_over:
            return rev_over[(side, i)]
        return (cam if side == "c" else lit)[i]["pdf_rev"]

    def delta(side, i):
        if (side, i) in delta_over:
            return delta_over[(side, i)]
        return (cam if side == "c" else lit)[i]["delta"]

    sum_ri = torch.zeros_like(cam[0]["p"][:, 0])
    ri = 1.0
    for i in range(t - 1, 0 if with_t1 else 1, -1):
        ri = ri * _remap0(rev("c", i)) / _remap0(cam[i]["pdf_fwd"])
        nd = ~delta("c", i) & ~delta("c", i - 1)
        sum_ri = sum_ri + torch.where(nd, ri, 0.0)
    ri = 1.0
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev("l", i)) / _remap0(lit[i]["pdf_fwd"])
        prev_d = delta("l", i - 1) if i > 0 else lit0_delta_pos
        nd = ~delta("l", i) & ~prev_d
        sum_ri = sum_ri + torch.where(nd, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def trace_bdpt(scene, o0, d0, key, max_depth: int, cam=None, film_hw=None,
               u_ext=None, sel_st=None):
    """BDPT estimate of N camera rays -> (L (N,3), aux).  key: the
    wave's threefry key.  cam + film_hw ((H, W)) switch on the t = 1
    strategies: aux["splat"] is then the pass's (H*W + 1, 3) splat film.
    aux["rays"]: N (2 max_depth + 1), as the reference counts them."""
    N = o0.shape[0]
    dev = o0.device
    with_t1 = cam is not None and film_hw is not None
    T = max_depth + 1          # camera surface vertices (t = index + 2)
    S = max_depth              # light surface vertices beyond the root
    zero3 = torch.zeros((N, 3), dtype=torch.float32, device=dev)

    Ls = scene.light_kind.shape[0]
    live = torch.arange(Ls, device=dev) < scene.n_lights
    inf_sel_pdf = torch.sum(torch.where(
        (scene.light_kind == LIGHT_INFINITE) & live, scene.light_pdf,
        torch.zeros_like(scene.light_pdf)))

    def _sel(s_, t_):
        if sel_st is None:
            return torch.ones(N, dtype=torch.bool, device=dev)
        return (sel_st[0] == s_) & (sel_st[1] == t_)

    # ---- the camera subpath (its root: the pinhole at o0) ----
    cam_root = _new_vertex(N, dev)
    cam_root["valid"] = torch.ones(N, dtype=torch.bool, device=dev)
    cam_root["p"] = o0
    pdf_dir_cam0 = (camlib.pdf_we_dir(cam, d0) if with_t1
                    else torch.ones(N, device=dev))
    cam_surf, L = _subpath(
        scene, o0, d0, torch.ones((N, 3), device=dev), pdf_dir_cam0, key, T,
        stream=11, root_delta=torch.zeros(N, dtype=torch.bool, device=dev),
        collect_env=True, inf_sel_pdf=inf_sel_pdf,
        u_vert=None if u_ext is None else u_ext["cam"],
        sel_esc=None if sel_st is None else (sel_st[0] == 0, sel_st[1]))
    cam_vs = [cam_root] + cam_surf

    # ---- the light subpath (its root sampled from the finite lights) ----
    fin_pdf, fin_cdf = lightlib.finite_light_distribution(scene)
    if u_ext is not None:
        u_sel, u_le = u_ext["root"][:, 0], u_ext["root"][:, 1:7]
    else:
        u_sel = smplr.uniform(smplr.wave_key(key, 12, 0, smplr.DIM_LIGHT_SELECT),
                              (N,), dev)
        u_le = smplr.uniform(smplr.wave_key(key, 12, 0, smplr.DIM_LIGHT_SAMPLE),
                             (N, 6), dev)
    lid = torch.clamp(torch.searchsorted(fin_cdf, u_sel.contiguous()), 0,
                      max(scene.n_lights - 1, 0)).to(torch.int32)
    sel_fin = fin_pdf[lid.long()]
    sel_full = scene.light_pdf[lid.long()]
    em = lightlib.sample_le(scene, lid, u_le)
    em_ok = em.valid & (sel_fin > 0.0) & torch.any(fin_pdf > 0.0)

    lit_root = _new_vertex(N, dev)
    lit_root.update(valid=em_ok, p=em.o, ng=em.n_l, ns=em.n_l, beta=em.le,
                    light=lid,
                    # the origin density under the full light distribution,
                    # one measure shared by every strategy's weight
                    pdf_fwd=em.pdf_pos * sel_full)
    # IsDeltaLight: a delta position or direction ends the s' = 0 term
    lit0_delta_pos = em.delta_pos | em.delta_dir

    beta1 = em.le * (vm.absdot(em.n_l, em.d) / torch.clamp(
        sel_fin * em.pdf_pos * em.pdf_dir, min=1e-20))[:, None]
    beta1 = torch.where(em_ok[:, None], beta1, zero3)
    o1 = vm.offset_ray_origin(em.o, em.n_l, em.d)
    lit_surf, _ = _subpath(scene, o1, em.d, beta1, em.pdf_dir, key, S,
                           stream=13, root_delta=em.delta_dir, root=lit_root,
                           u_vert=None if u_ext is None else u_ext["lit"])
    for v in lit_surf:
        v["valid"] = v["valid"] & em_ok
    lit = [lit_root] + lit_surf

    # ---- the connections (s >= 0, t >= 2): per t, phase 1 gathers the
    # geometry and queues every BSDF evaluation and shadow ray, the batches
    # run once, phase 2 assembles the contributions and weights ----
    kx = smplr.wave_key(key, 14, 0, smplr.DIM_LIGHT_SAMPLE)
    for t in range(2, T + 2):
        pt, pt_minus = cam_vs[t - 1], cam_vs[t - 2]
        eb, sb = _EvalBatch(), _ShadowBatch()
        # every strategy is bounded by the path depth s + t - 2 <= maxDepth
        do_s1 = t - 1 <= max_depth
        s_max = max_depth + 2 - t

        # phase 1: s = 1
        if u_ext is not None:
            u_sel1, u_l1 = u_ext["nee"][:, t - 2, 0], u_ext["nee"][:, t - 2, 1:4]
        else:
            k_s1 = threefry.fold_in(kx, t)
            u_sel1 = smplr.uniform(threefry.fold_in(k_s1, 0), (N,), dev)
            u_l1 = smplr.uniform(threefry.fold_in(k_s1, 1), (N, 3), dev)
        lid1, sel1 = lightlib.choose_light(scene, u_sel1)
        ls = lightlib.sample_li(scene, lid1, pt["p"], u_l1)
        can1 = (pt["valid"] & bsdflib.has_nonspecular(pt["params"])
                & (ls.pdf > 0.0) & (vm.luminance(ls.li) > 0.0)
                & (scene.n_lights > 0))
        e_f_pt = eb.add(pt, pt["wo"], ls.wi)       # f and forward pdf at pt
        e_rev_pm = eb.add(pt, ls.wi, pt["wo"])     # pt scattering backwards
        o_sh1 = vm.offset_ray_origin(pt["p"], vm.face_forward(pt["ng"], pt["wo"]),
                                     ls.wi)
        # the shadow length from the offset origin
        sh1 = sb.add(o_sh1, ls.wi, torch.where(
            can1, (ls.dist - vm.dot(o_sh1 - pt["p"], ls.wi)) * 0.999, -1.0))

        # phase 1: s >= 2
        s_meta = []
        for s in range(2, min(S + 2, s_max + 1)):
            qs = lit[s - 1]
            both = (pt["valid"] & qs["valid"]
                    & bsdflib.has_nonspecular(pt["params"])
                    & bsdflib.has_nonspecular(qs["params"]))
            w_pq = pt["p"] - qs["p"]
            d2 = torch.clamp(vm.length_sq(w_pq), min=1e-20)
            dist = torch.sqrt(d2)
            dir_qp = w_pq / dist[:, None]          # qs -> pt
            e = (eb.add(qs, qs["wo"], dir_qp), eb.add(pt, pt["wo"], -dir_qp),
                 eb.add(pt, -dir_qp, pt["wo"]), eb.add(qs, dir_qp, qs["wo"]))
            o_sh2 = vm.offset_ray_origin(
                qs["p"], vm.face_forward(qs["ng"], qs["wo"]), dir_qp)
            sh2 = sb.add(o_sh2, dir_qp, torch.where(
                both, (dist - vm.dot(o_sh2 - qs["p"], dir_qp)) * 0.997, -1.0))
            s_meta.append(dict(s=s, qs=qs, both=both, d2=d2, dir_qp=dir_qp, e=e,
                               sh=sh2))

        eb.run()
        sb.run(scene)

        # phase 2: s = 0 (pt is on an emitter)
        emissive = pt["valid"] & (pt["light"] >= 0)
        plid = torch.clamp(pt["light"], min=0)
        C0 = pt["beta"] * lightlib.area_light_le(scene, plid, pt["ng"], pt["wo"])
        rev_over = {("c", t - 1): lightlib.pdf_light_origin(scene, plid)}
        if t - 2 >= 1:
            dir_pm = vm.normalize(pt_minus["p"] - pt["p"])
            rev_over[("c", t - 2)] = _convert(
                lightlib.pdf_le_dir(scene, plid, pt["ns"], dir_pm),
                pt["p"], pt_minus["p"], pt_minus["ns"])
        delta_over = {("c", t - 1): torch.zeros(N, dtype=torch.bool, device=dev)}
        w0 = _mis_weight(cam_vs, lit, 0, t, rev_over, delta_over, lit0_delta_pos,
                         with_t1=with_t1)
        L = L + torch.where((emissive & _sel(0, t))[:, None], C0 * w0[:, None],
                            zero3)

        # phase 2: s = 1
        if not do_s1:
            continue
        f_pt = eb.f(e_f_pt)
        bsdf_pdf_pt = torch.where(pt["delta"], 0.0, eb.pdf(e_f_pt))
        cos_pt = vm.absdot(ls.wi, pt["ns"])
        vis1 = can1 & ~sb.occ(sh1)
        C1 = pt["beta"] * f_pt * ls.li * (cos_pt / torch.clamp(
            ls.pdf * sel1, min=1e-20))[:, None]
        is_inf1 = scene.light_kind[lid1.long()] == LIGHT_INFINITE
        # environment paths: pairwise against the escape strategy
        w_env = smp.power_heuristic(1.0, ls.pdf * sel1, 1.0, bsdf_pdf_pt)
        # finite lights: the vertex machinery with a resampled qs
        p_qs = pt["p"] + ls.wi * ls.dist[:, None]
        rev_over = {
            # pt.pdfRev: the light emits towards pt
            ("c", t - 1): _convert(lightlib.pdf_le_dir(scene, lid1, ls.n_l, -ls.wi),
                                   p_qs, pt["p"], pt["ns"]),
            # qs.pdfRev: pt samples towards qs
            ("l", 0): _convert(bsdf_pdf_pt, pt["p"], p_qs, ls.n_l),
        }
        if t - 2 >= 1:
            rev_sa_pm = torch.where(pt["delta"], 0.0, eb.pdf(e_rev_pm))
            rev_over[("c", t - 2)] = _convert(rev_sa_pm, pt["p"], pt_minus["p"],
                                              pt_minus["ns"])
        qs1 = dict(_new_vertex(N, dev),
                   pdf_fwd=lightlib.pdf_light_origin(scene, lid1),
                   delta=ls.is_delta)
        delta_over = {("c", t - 1): torch.zeros(N, dtype=torch.bool, device=dev),
                      ("l", 0): ls.is_delta}
        w1 = _mis_weight(cam_vs, [qs1] + lit[1:], 1, t, rev_over, delta_over,
                         ls.is_delta, with_t1=with_t1)
        w = torch.where(is_inf1, w_env, w1)
        L = L + torch.where((vis1 & _sel(1, t))[:, None], C1 * w[:, None], zero3)

        # phase 2: s >= 2
        for m in s_meta:
            s, qs = m["s"], m["qs"]
            qs_minus = lit[s - 2]
            e_fq, e_fp, e_rpm, e_rqm = m["e"]
            g = (vm.absdot(qs["ns"], m["dir_qp"]) * vm.absdot(pt["ns"], m["dir_qp"])
                 / m["d2"])
            cval = qs["beta"] * eb.f(e_fq) * eb.f(e_fp) * pt["beta"] * g[:, None]
            can2 = m["both"] & (vm.luminance(torch.abs(cval)) > 0.0)
            vis2 = can2 & ~sb.occ(m["sh"])
            pdf_q_fwd = torch.where(qs["delta"], 0.0, eb.pdf(e_fq))
            pdf_p_fwd = torch.where(pt["delta"], 0.0, eb.pdf(e_fp))
            rev_over = {
                ("c", t - 1): _convert(pdf_q_fwd, qs["p"], pt["p"], pt["ns"]),
                ("l", s - 1): _convert(pdf_p_fwd, pt["p"], qs["p"], qs["ns"]),
            }
            if t - 2 >= 1:
                rev_sa_pm = torch.where(pt["delta"], 0.0, eb.pdf(e_rpm))
                rev_over[("c", t - 2)] = _convert(rev_sa_pm, pt["p"],
                                                  pt_minus["p"], pt_minus["ns"])
            # qs_minus.pdfRev: qs scatters back towards qs_minus
            rev_sa_qm = torch.where(qs["delta"], 0.0, eb.pdf(e_rqm))
            rev_over[("l", s - 2)] = _convert(rev_sa_qm, qs["p"], qs_minus["p"],
                                              qs_minus["ns"])
            false = torch.zeros(N, dtype=torch.bool, device=dev)
            w2 = _mis_weight(cam_vs, lit, s, t, rev_over,
                             {("c", t - 1): false, ("l", s - 1): false},
                             lit0_delta_pos, with_t1=with_t1)
            L = L + torch.where((vis2 & _sel(s, t))[:, None], cval * w2[:, None],
                                zero3)

    # ---- t = 1: light tracing, splatted where each light vertex projects
    # (bdpt.cpp ConnectBDPT t == 1); batched across the s strategies ----
    aux = {}
    if with_t1:
        Hf, Wf = film_hw
        splat = torch.zeros((Hf * Wf + 1, 3), dtype=torch.float32, device=dev)
        cam_p = camlib.camera_position(cam)
        eb, sb = _EvalBatch(), _ShadowBatch()
        t1_meta = []
        for s_ in range(2, S + 2):
            qs = lit[s_ - 1]
            sw = camlib.sample_wi(cam, qs["p"])
            can = qs["valid"] & bsdflib.has_nonspecular(qs["params"]) & sw["valid"]
            e = (eb.add(qs, qs["wo"], sw["wi"]), eb.add(qs, sw["wi"], qs["wo"]))
            o_sh = vm.offset_ray_origin(qs["p"], vm.face_forward(qs["ng"], qs["wo"]),
                                        sw["wi"])
            sh = sb.add(o_sh, sw["wi"], torch.where(
                can, (sw["dist"] - vm.dot(o_sh - qs["p"], sw["wi"])) * 0.999, -1.0))
            t1_meta.append(dict(s=s_, qs=qs, sw=sw, can=can, e=e, sh=sh))
        eb.run()
        sb.run(scene)
        for m in t1_meta:
            s_, qs, sw = m["s"], m["qs"], m["sw"]
            qs_minus = lit[s_ - 2]
            e_fq, e_rqm = m["e"]
            cos_q = vm.absdot(sw["wi"], qs["ns"])
            Ct1 = qs["beta"] * eb.f(e_fq) * (sw["we_over_pdf"] * cos_q)[:, None]
            can = m["can"] & (vm.luminance(torch.abs(Ct1)) > 0.0)
            vis = can & ~sb.occ(m["sh"])
            # MIS: the camera side is the camera vertex alone; the light side
            # takes the camera's direction density onto qs and qs's reverse
            # scatter onto qs_minus
            rev_over = {("l", s_ - 1): _convert(camlib.pdf_we_dir(cam, -sw["wi"]),
                                                cam_p[None, :], qs["p"], qs["ns"])}
            rev_sa_qm = torch.where(qs["delta"], 0.0, eb.pdf(e_rqm))
            rev_over[("l", s_ - 2)] = _convert(rev_sa_qm, qs["p"], qs_minus["p"],
                                               qs_minus["ns"])
            wt1 = _mis_weight(cam_vs, lit, s_, 1, rev_over,
                              {("l", s_ - 1): torch.zeros(N, dtype=torch.bool,
                                                          device=dev)},
                              lit0_delta_pos, with_t1=True)
            val = torch.where(vis[:, None], Ct1 * wt1[:, None], zero3)
            val = torch.where(torch.isfinite(val), val, zero3)
            px = torch.clamp(torch.nan_to_num(sw["raster"][:, 0]).to(torch.int64),
                             0, Wf - 1)
            py = torch.clamp(torch.nan_to_num(sw["raster"][:, 1]).to(torch.int64),
                             0, Hf - 1)
            flat = torch.where(vis, py * Wf + px, Hf * Wf)
            splat.index_add_(0, flat, val)
        aux["splat"] = splat

    L = torch.where(torch.isfinite(L), L, zero3)
    aux["rays"] = torch.tensor(N * (2 * max_depth + 1), device=dev)
    return L, aux
