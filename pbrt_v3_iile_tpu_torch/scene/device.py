"""Device scene: every scene entity as flat tensors (port of ``scene/device.py``).

``build_leaves`` runs the reference's host build (the port's copy of its
BVH builder, same orderings, same tables) in numpy and returns the leaves under the
reference's names; ``state.scene_from_numpy`` moves them to a device as
a ``DeviceScene``.  The reference module imports jax at the top, so its
numpy helpers are carried here as copies.

Covered: triangles (with their ptex face index and their media
interfaces), spheres, the BVH (``nodes_packed``/``tris_packed``),
materials (with the subsurface diffusion lengths and the Fourier tables,
``ops/fourierbsdf.py``), lights (point, spot, distant, infinite,
goniometric and projection lights with their stacked direction maps,
triangle and sphere area lights, with the power and spatial selection
tables), the constant and map environment, homogeneous and grid-density
media, world bounds, the cluster pack of the fused traversal kernel, the
kd-tree of the ``kdtree`` accel, and object motion blur: the sub-keyframes
of animated shapes (``tris_steps_packed``, ``tri_ng_steps``,
``tri_ns_steps``) with a BVH over the union of all of them.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import bvh as bvhlib
from ..ops import fourierbsdf as fourierlib
from ..utils import log
from ..utils import transforms as xf
from . import api as apilib
from . import textures as texlib
from .state import DeviceScene, scene_from_numpy

__all__ = ["DeviceScene", "build_device_scene", "build_leaves",
           "scene_from_numpy"]

def _smooth_from_geo(p):
    """Zero shading normals signal 'use the geometric normal'."""
    return np.zeros_like(p)


def _default_uv(n):
    uv = np.zeros((n, 3, 2), np.float32)
    uv[:, 1, 0] = 1.0
    uv[:, 2, 1] = 1.0
    return uv


def _geo_normal(pp):
    ng = np.cross(pp[:, 1] - pp[:, 0], pp[:, 2] - pp[:, 0])
    a2 = np.linalg.norm(ng, axis=-1, keepdims=True)
    return np.where(a2 > 1e-20, ng / np.maximum(a2, 1e-20), 0.0)


def _anim_eval(anim, t):
    """A decomposed AnimatedTransform at time t in [0, 1] (transform.cpp
    AnimatedTransform::Interpolate: translation and scale lerp, rotation
    slerps) applied to its shape: (verts (cnt,3,3), shading normals
    (cnt,3,3))."""
    q = xf.quat_slerp(float(t), anim["q0"], anim["q1"])
    R = xf.quat_to_matrix(q)
    S = anim["S0"] + t * (anim["S1"] - anim["S0"])
    T = anim["T0"] + t * (anim["T1"] - anim["T0"])
    M3 = (R @ S).astype(np.float64)
    pw = np.asarray(anim["p_obj"], np.float64) @ M3.T + T[None, None, :]
    n_obj = anim.get("n_obj")
    if n_obj is None:
        n_obj = _smooth_from_geo(anim["p_obj"])
    inv_t = np.linalg.inv(M3).T
    nw = np.asarray(n_obj, np.float64) @ inv_t.T
    nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
    return pw.astype(np.float32), nw.astype(np.float32)


def _motion_steps(sd):
    """The scene's sub-keyframe count: enough that each piecewise-linear
    segment spans at most 15 degrees of the largest rotation, in [2, 16]."""
    max_angle = 0.0
    for b in sd.tri_blocks:
        anim = b.get("anim")
        if anim is not None:
            c = abs(float(np.dot(anim["q0"], anim["q1"])))
            max_angle = max(max_angle, 2.0 * np.arccos(min(c, 1.0)))
    steps = int(np.ceil(np.degrees(max_angle) / 15.0)) + 1
    return int(np.clip(steps, 2, 16))


def _motion_stacks(sd, n_steps):
    """Per block, its vertices and shading normals at each sub-keyframe
    (n_steps, T, 3, 3): the decomposed animation evaluated, a two-keyframe
    block lerped, a static block repeated."""
    p_rows, ns_rows = [], []
    for b in sd.tri_blocks:
        anim = b.get("anim")
        bn = b["n"] if b["n"] is not None else _smooth_from_geo(b["p"])
        if anim is not None:
            evs = [_anim_eval(anim, i / (n_steps - 1)) for i in range(n_steps)]
            p_rows.append(np.stack([e[0] for e in evs]))
            ns_rows.append(np.stack([e[1] for e in evs]))
        elif b.get("p_end") is not None:
            be = b["p_end"]
            bne = b["n_end"] if b.get("n_end") is not None else bn
            ts = np.linspace(0.0, 1.0, n_steps)[:, None, None, None]
            p_rows.append(b["p"][None] * (1 - ts) + be[None] * ts)
            ns_rows.append(bn[None] * (1 - ts) + bne[None] * ts)
        else:
            p_rows.append(np.repeat(b["p"][None], n_steps, 0))
            ns_rows.append(np.repeat(bn[None], n_steps, 0))
    return np.concatenate(p_rows, axis=1), np.concatenate(ns_rows, axis=1)


def build_leaves(sd, with_clusters: bool = False, with_kdtree: bool = None
                 ) -> dict:
    """Host build of the device scene as a dict of numpy leaves named as
    the reference's DeviceScene fields (clusters as ``clusters.*``,
    textures as ``textures.*``).  with_kdtree None builds the kd-tree
    when the scene file asks for it (``Accelerator "kdtree"``); else its
    leaves are the reference's placeholder (one empty leaf)."""
    if with_kdtree is None:
        with_kdtree = getattr(sd, "accelerator", "bvh") == "kdtree"
    has_motion = bool(sd.tri_blocks) and sd.has_motion
    if sd.tri_blocks:
        p = np.concatenate([b["p"] for b in sd.tri_blocks], axis=0)
        ns = np.concatenate(
            [b["n"] if b["n"] is not None else _smooth_from_geo(b["p"])
             for b in sd.tri_blocks], axis=0)
        uv = np.concatenate(
            [b["uv"] if b["uv"] is not None else _default_uv(b["p"].shape[0])
             for b in sd.tri_blocks], axis=0)
        mat = np.concatenate([b["mat"] for b in sd.tri_blocks])
        lig = np.concatenate([b["light"] for b in sd.tri_blocks])
        face = np.concatenate(
            [b.get("face", np.arange(b["p"].shape[0], dtype=np.int32))
             for b in sd.tri_blocks])
        m_in, m_out = (np.concatenate(
            [b.get(k, np.full(b["p"].shape[0], -1, np.int32))
             for b in sd.tri_blocks]) for k in ("med_in", "med_out"))
    else:
        p = np.zeros((1, 3, 3), np.float32)
        ns = np.zeros((1, 3, 3), np.float32)
        uv = np.zeros((1, 3, 2), np.float32)
        mat = np.zeros(1, np.int32)
        lig = np.full(1, -1, np.int32)
        face = np.zeros(1, np.int32)
        m_in = np.full(1, -1, np.int32)
        m_out = np.full(1, -1, np.int32)

    if has_motion:
        # the BVH's boxes cover the whole shutter: built over the union of
        # every sub-keyframe's vertices (the numpy builder reads only each
        # prim's bounds and centroid, so a (T, 3 M, 3) stack is its input),
        # with the numpy builder as the reference builds it
        p_steps, ns_steps = _motion_stacks(sd, _motion_steps(sd))
        flat = bvhlib.build_bvh(np.concatenate(list(p_steps), axis=1),
                                use_native=False)
    else:
        flat = bvhlib.build_bvh(p)
    order = flat.prim_order
    # every per-triangle table in BVH order: the order of the prim ids
    # that the traversal kernels return
    p, ns, uv, mat, lig = p[order], ns[order], uv[order], mat[order], lig[order]
    face = face[order]
    m_in, m_out = m_in[order], m_out[order]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    ng = _geo_normal(p)
    if has_motion:
        p_steps, ns_steps = p_steps[:, order], ns_steps[:, order]
        tris_steps = np.zeros(p_steps.shape[:2] + (12,), np.float32)
        tris_steps[:, :, 0:3] = p_steps[:, :, 0]
        tris_steps[:, :, 3:6] = p_steps[:, :, 1] - p_steps[:, :, 0]
        tris_steps[:, :, 6:9] = p_steps[:, :, 2] - p_steps[:, :, 0]
        ng_steps = np.stack([_geo_normal(ps) for ps in p_steps])
    else:  # the reference's placeholders of a static scene
        tris_steps = np.zeros((1, 1, 12), np.float32)
        ns_steps, ng_steps = ns[None, :1], ng[None, :1]

    # ---- spheres (padded to >= 1) ----
    S = max(1, len(sd.spheres))
    sph_center = np.zeros((S, 3), np.float32)
    sph_radius = np.zeros(S, np.float32)
    sph_mat = np.zeros(S, np.int32)
    sph_light = np.full(S, -1, np.int32)
    for i, s in enumerate(sd.spheres):
        sph_center[i] = s["center"]
        sph_radius[i] = s["radius"]
        sph_mat[i] = s["mat"]
        sph_light[i] = s["light"]

    # ---- materials SoA ----
    M = len(sd.materials)
    z3 = lambda: np.zeros((M, 3), np.float32)
    mk = np.zeros(M, np.int32)
    kd, ks, kr, kt, meta, mk_k = z3(), z3(), z3(), z3(), z3(), z3()
    rough = np.zeros(M, np.float32)
    uro = np.full(M, -1.0, np.float32)
    vro = np.full(M, -1.0, np.float32)
    eta = np.full(M, 1.5, np.float32)
    sigma = np.zeros(M, np.float32)
    remap = np.ones(M, np.float32)
    mat_aux = np.zeros((M, 8), np.float32)
    tex_leaves, tex_ids = texlib.build_table_np(sd.textures)
    kd_tex = np.full(M, -1, np.int32)
    ks_tex = np.full(M, -1, np.int32)
    sg_tex = np.full(M, -1, np.int32)
    ro_tex = np.full(M, -1, np.int32)
    fr_id = np.full(M, -1, np.int32)
    fourier_tables = []
    sss_d = np.zeros((M, 3), np.float32)
    for i, m in enumerate(sd.materials):
        if getattr(m, "fourier_table", None) is not None:
            fr_id[i] = len(fourier_tables)
            fourier_tables.append(m.fourier_table)
        if getattr(m, "sss_d", None) is not None:
            sss_d[i] = m.sss_d
        kd_tex[i] = tex_ids.get(m.kd_tex, -1)
        ks_tex[i] = tex_ids.get(m.ks_tex, -1)
        sg_tex[i] = tex_ids.get(m.sigma_tex, -1)
        ro_tex[i] = tex_ids.get(m.rough_tex, -1)
        mk[i] = m.kind
        for dst, val in ((kd, m.kd), (ks, m.ks), (kr, m.kr), (kt, m.kt),
                         (meta, m.metal_eta), (mk_k, m.metal_k)):
            if val is not None:
                dst[i] = val
        rough[i] = m.roughness
        uro[i] = m.uroughness
        vro[i] = m.vroughness
        eta[i] = m.eta
        sigma[i] = m.sigma
        remap[i] = 1.0 if m.remap_roughness else 0.0
        if m.aux is not None:
            mat_aux[i] = m.aux

    # ---- light-triangle table (area lights, original block order) ----
    nL = max(1, len(sd.lights))
    l_off = np.zeros(nL, np.int32)
    l_cnt = np.zeros(nL, np.int32)
    l_area = np.zeros(nL, np.float32)
    if sd.tri_blocks:
        tri_light_orig = np.concatenate([b["light"] for b in sd.tri_blocks])
        tri_p_orig = np.concatenate([b["p"] for b in sd.tri_blocks], axis=0)
    else:
        tri_light_orig = np.full(0, -1, np.int32)
        tri_p_orig = np.zeros((0, 3, 3), np.float32)
    ltp, lte1, lte2, ltng, ltarea, ltlight = [], [], [], [], [], []
    for li, lrec in enumerate(sd.lights):
        if lrec.kind == apilib.LIGHT_AREA_TRI and lrec.tri_count > 0:
            sel = np.arange(lrec.tri_start, lrec.tri_start + lrec.tri_count)
            tp = tri_p_orig[sel]
            te1 = tp[:, 1] - tp[:, 0]
            te2 = tp[:, 2] - tp[:, 0]
            cr = np.cross(te1, te2)
            a = 0.5 * np.linalg.norm(cr, axis=-1)
            n = np.where(a[:, None] > 1e-20,
                         cr / np.maximum(2 * a[:, None], 1e-20), 0.0)
            l_off[li] = int(sum(len(x) for x in ltarea))
            l_cnt[li] = tp.shape[0]
            l_area[li] = float(a.sum())
            ltp.append(tp[:, 0]); lte1.append(te1); lte2.append(te2)
            ltng.append(n); ltarea.append(a)
            ltlight.append(np.full(tp.shape[0], li, np.int32))
        elif lrec.kind == apilib.LIGHT_AREA_SPHERE:
            r = sd.spheres[lrec.sphere_index]["radius"]
            l_area[li] = float(4.0 * np.pi * r * r)
    if ltarea:
        ltri_p0 = np.concatenate(ltp).astype(np.float32)
        ltri_e1 = np.concatenate(lte1).astype(np.float32)
        ltri_e2 = np.concatenate(lte2).astype(np.float32)
        ltri_ng = np.concatenate(ltng).astype(np.float32)
        ltri_area = np.concatenate(ltarea).astype(np.float32)
        ltri_light = np.concatenate(ltlight)
        ltri_cdf = np.zeros_like(ltri_area)
        for li in range(len(sd.lights)):
            o, c = l_off[li], l_cnt[li]
            if c > 0:
                seg = ltri_area[o:o + c]
                ltri_cdf[o:o + c] = np.cumsum(seg) / max(seg.sum(), 1e-20)
    else:
        ltri_p0 = ltri_e1 = ltri_e2 = ltri_ng = np.zeros((1, 3), np.float32)
        ltri_area = np.zeros(1, np.float32)
        ltri_cdf = np.ones(1, np.float32)
        ltri_light = np.full(1, -1, np.int32)

    # ---- lights SoA ----
    L = nL
    lkind = np.zeros(L, np.int32)
    lL = np.zeros((L, 3), np.float32)
    lpos = np.zeros((L, 3), np.float32)
    ldir = np.tile(np.array([[0, 0, 1.0]], np.float32), (L, 1))
    lct = np.full(L, -1.0, np.float32)
    lcf = np.full(L, -1.0, np.float32)
    l2s = np.zeros(L, np.float32)
    lsph = np.full(L, -1, np.int32)
    for i, lrec in enumerate(sd.lights):
        lkind[i] = lrec.kind
        lL[i] = lrec.L
        if lrec.position is not None:
            lpos[i] = lrec.position
        if lrec.direction is not None:
            ldir[i] = lrec.direction
        lct[i] = lrec.cos_total
        lcf[i] = lrec.cos_falloff
        l2s[i] = 1.0 if lrec.two_sided else 0.0
        lsph[i] = lrec.sphere_index
    lmap = _build_light_maps(sd, L)

    env = _build_env_map(sd)
    med = _build_media(sd)

    wmin = p.min(axis=(0, 1)) if p.size else np.zeros(3)
    wmax = p.max(axis=(0, 1)) if p.size else np.ones(3)
    for s in sd.spheres:
        wmin = np.minimum(wmin, np.asarray(s["center"]) - s["radius"])
        wmax = np.maximum(wmax, np.asarray(s["center"]) + s["radius"])
    wradius = max(0.5 * float(np.linalg.norm(wmax - wmin)), 1e-3)

    # ---- light selection: power-weighted or uniform ----
    nl = len(sd.lights)
    use_power = sd.integrator.light_strategy in ("power", "spatial")
    powers = np.zeros(L, np.float64)
    for i, lrec in enumerate(sd.lights):
        lum = float(np.dot(np.asarray(lrec.L, np.float64),
                           [0.212671, 0.715160, 0.072169]))
        if lrec.kind == apilib.LIGHT_POINT:
            powers[i] = 4.0 * np.pi * lum
        elif lrec.kind == apilib.LIGHT_SPOT:
            powers[i] = 2.0 * np.pi * lum * (
                1.0 - 0.5 * (lrec.cos_falloff + lrec.cos_total))
        elif lrec.kind in (apilib.LIGHT_DISTANT, apilib.LIGHT_INFINITE):
            powers[i] = np.pi * wradius * wradius * lum
        elif lrec.kind in (apilib.LIGHT_AREA_TRI, apilib.LIGHT_AREA_SPHERE):
            powers[i] = (np.pi * lum * max(l_area[i], 1e-12)
                         * (2.0 if lrec.two_sided else 1.0))
        elif lrec.kind == apilib.LIGHT_GONIO:
            # goniometric.h Power(): 4 pi I * mean(map)
            powers[i] = 4.0 * np.pi * lum * lmap["mean_lum"][i]
        elif lrec.kind == apilib.LIGHT_PROJECTION:
            # projection.cpp Power(): the solid angle of the cone
            tan2 = lmap["proj_ax"][i] * lmap["proj_ay"][i]
            cos_w = 1.0 / np.sqrt(1.0 + tan2)
            powers[i] = (2.0 * np.pi * (1.0 - cos_w) * lum
                         * lmap["mean_lum"][i])
    if use_power and powers[:max(nl, 1)].sum() > 0 and nl > 0:
        lpdf = np.zeros(L, np.float32)
        lpdf[:nl] = (powers[:nl] / powers[:nl].sum()).astype(np.float32)
    else:
        lpdf = np.full(L, 1.0 / max(nl, 1), np.float32)
    lcdf = np.cumsum(lpdf).astype(np.float32)

    # ---- SpatialLightDistribution: per-voxel selection pdf/cdf ----
    if sd.integrator.light_strategy == "spatial" and nl > 0:
        ext = np.maximum(wmax - wmin, 1e-6)
        res = np.clip((ext / float(ext.max()) * 16.0).astype(np.int64), 1, 16)
        lref = np.zeros((L, 3), np.float64)
        has_pos = np.zeros(L, bool)
        for i, lrec in enumerate(sd.lights):
            if lrec.kind in (apilib.LIGHT_POINT, apilib.LIGHT_SPOT,
                             apilib.LIGHT_GONIO, apilib.LIGHT_PROJECTION):
                lref[i] = lpos[i]
                has_pos[i] = True
            elif lrec.kind == apilib.LIGHT_AREA_SPHERE:
                lref[i] = sd.spheres[lrec.sphere_index]["center"]
                has_pos[i] = True
            elif lrec.kind == apilib.LIGHT_AREA_TRI and l_cnt[i] > 0:
                tr = tri_p_orig[tri_light_orig == i]
                if tr.size:
                    lref[i] = tr.reshape(-1, 3).mean(axis=0)
                    has_pos[i] = True
        gz, gy, gx = np.meshgrid(
            (np.arange(res[2]) + 0.5) / res[2],
            (np.arange(res[1]) + 0.5) / res[1],
            (np.arange(res[0]) + 0.5) / res[0], indexing="ij")
        centers = (wmin[None, :]
                   + np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) * ext)
        diag2 = float(np.sum((ext / res.astype(np.float64)) ** 2))
        d2 = np.sum((centers[:, None, :] - lref[None, :, :]) ** 2, axis=-1)
        contrib = powers[None, :] / np.maximum(d2, 0.25 * diag2)
        const = powers[None, :] / max(np.pi * wradius * wradius, 1e-9)
        contrib = np.where(has_pos[None, :], contrib, const)
        contrib[:, nl:] = 0.0
        tot = contrib.sum(axis=1, keepdims=True)
        spat_pdf = np.where(tot > 0, contrib / np.maximum(tot, 1e-30),
                            lpdf[None, :]).astype(np.float32)
        spat_cdf = np.cumsum(spat_pdf, axis=1).astype(np.float32)
        spat_res = res[:3].astype(np.int32)
    else:
        spat_pdf = lpdf[None, :]
        spat_cdf = lcdf[None, :]
        spat_res = np.ones(3, np.int32)
    Lp = ((max(spat_pdf.shape[1], 1) + 7) // 8) * 8
    if spat_pdf.shape[1] < Lp:
        pad_n = Lp - spat_pdf.shape[1]
        spat_pdf = np.concatenate(
            [spat_pdf, np.zeros((spat_pdf.shape[0], pad_n), np.float32)], 1)
        # cdf pad = 2.0 so (cdf < u) never counts a padded slot
        spat_cdf = np.concatenate(
            [spat_cdf, np.full((spat_cdf.shape[0], pad_n), 2.0, np.float32)], 1)

    # ---- packed traversal layouts: one row gather per node / triangle ----
    M_nodes = flat.node_min.shape[0]
    nodes_packed = np.zeros((M_nodes, 8), np.int32)
    nodes_packed[:, 0:3] = flat.node_min.astype(np.float32).view(np.int32)
    nodes_packed[:, 3:6] = flat.node_max.astype(np.float32).view(np.int32)
    nodes_packed[:, 6] = flat.node_right.astype(np.int32)
    nodes_packed[:, 7] = ((flat.node_count.astype(np.int32) << 2)
                          | flat.node_axis.astype(np.int32))
    tris_packed = np.zeros((p.shape[0], 12), np.float32)
    tris_packed[:, 0:3] = p[:, 0]
    tris_packed[:, 3:6] = e1
    tris_packed[:, 6:9] = e2
    from ..ops.intersect_kernel import build_bvh4_np
    bvh4_nodes, bvh4_stack = build_bvh4_np(nodes_packed)

    # ---- ray-cone texture filter inputs ----
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    uv_area = 0.5 * np.abs(duv1[..., 0] * duv2[..., 1]
                           - duv1[..., 1] * duv2[..., 0])
    w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    uv_density = np.sqrt(uv_area / np.maximum(w_area, 1e-20))
    cam = sd.camera
    if cam.kind == "perspective":
        tex_theta = (2.0 * np.tan(0.5 * np.deg2rad(cam.fov))
                     / max(sd.film.y_resolution, 1))
    else:
        tex_theta = 0.0

    leaves = dict(
        tri_p0=p[:, 0], tri_e1=e1, tri_e2=e2, tri_ng=ng, tri_ns=ns,
        tri_uv=uv, tri_mat=mat, tri_light=lig, tri_face=face,
        node_min=flat.node_min, node_max=flat.node_max,
        node_right=flat.node_right, node_count=flat.node_count,
        node_axis=flat.node_axis, nodes_packed=nodes_packed,
        tris_packed=tris_packed, bvh4_nodes=bvh4_nodes,
        bvh4_stack=np.int32(bvh4_stack), sph_center=sph_center, sph_radius=sph_radius, sph_mat=sph_mat,
        sph_light=sph_light, n_spheres=np.int32(len(sd.spheres)),
        mat_kind=mk, mat_kd=kd, mat_ks=ks, mat_kr=kr, mat_kt=kt,
        mat_rough=rough, mat_urough=uro, mat_vrough=vro, mat_eta=eta,
        mat_metal_eta=meta, mat_metal_k=mk_k, mat_sigma=sigma,
        mat_remap=remap, mat_aux=mat_aux, mat_kd_tex=kd_tex,
        mat_ks_tex=ks_tex, mat_sigma_tex=sg_tex, mat_rough_tex=ro_tex,
        mat_sss_d=sss_d, mat_fourier_id=fr_id,
        light_kind=lkind, light_L=lL, light_pos=lpos, light_dir=ldir,
        light_cos_total=lct, light_cos_falloff=lcf, light_two_sided=l2s,
        light_sphere=lsph, light_tri_off=l_off, light_tri_cnt=l_cnt,
        light_area=l_area, light_pdf=lpdf, light_cdf=lcdf,
        n_lights=np.int32(nl), light_w2l=lmap["w2l"], light_img=lmap["img"],
        light_img_id=lmap["img_id"], light_proj_ax=lmap["proj_ax"],
        light_proj_ay=lmap["proj_ay"],
        ltri_p0=ltri_p0, ltri_e1=ltri_e1, ltri_e2=ltri_e2, ltri_ng=ltri_ng,
        ltri_area=ltri_area, ltri_cdf=ltri_cdf, ltri_light=ltri_light,
        tri_med_in=m_in, tri_med_out=m_out,
        camera_medium=np.int32(sd.camera_medium),
        env_img=env["img"], env_marg_cdf=env["marg"],
        env_cond_cdf=env["cond"], env_pdf=env["pdf"],
        env_to_world=env["to_world"], env_world_to=env["world_to"],
        has_env_map=np.int32(env["has"]),
        env_light_id=np.int32(env["light_id"]),
        world_min=wmin, world_max=wmax, spatial_pdf=spat_pdf,
        spatial_cdf=spat_cdf, spatial_res=spat_res,
        world_radius=np.float32(wradius), tri_uv_density=uv_density,
        tex_theta=np.float32(tex_theta),
        tex_cone_o=np.asarray(cam.cam_to_world[:3, 3], np.float32),
        tris_steps_packed=tris_steps, tri_ng_steps=ng_steps,
        tri_ns_steps=ns_steps,
    )
    # the kd-tree over the same BVH-ordered triangles: the two aggregates
    # share prim ids
    from ..ops import kdtree as kdlib
    leaves.update(kdlib.kd_leaves(p[:, 0], e1, e2) if with_kdtree
                  else kdlib.placeholder_leaves())
    leaves.update(med)
    leaves.update({f"textures.{k}": v for k, v in tex_leaves.items()})
    if fourier_tables:
        leaves.update({f"fourier.{k}": v for k, v in
                       fourierlib.densify_np(fourier_tables).items()})
    if with_clusters:
        from ..ops.clusters_kernel import build_cluster_pack_np
        pack = build_cluster_pack_np(flat, p[:, 0], e1, e2)
        leaves.update({f"clusters.{k}": v for k, v in pack.items()})
    return leaves


def build_device_scene(sd, device, with_clusters: bool = None,
                       with_kdtree: bool = None) -> DeviceScene:
    """Parse-time scene -> DeviceScene on ``device``.  with_clusters None
    builds the fused-kernel cluster pack exactly when ``device`` is CUDA
    (the default accel there); with_kdtree None builds the kd-tree when
    the scene file asks for it."""
    import torch

    device = torch.device(device)
    if with_clusters is None:
        with_clusters = device.type == "cuda"
    leaves = build_leaves(sd, with_clusters=with_clusters,
                          with_kdtree=with_kdtree)
    return scene_from_numpy(leaves, device)


def _resample_bilinear(img, h, w):
    """Bilinear resample to a fixed (h, w, 3) raster, so that every light
    map stacks into one device array."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    ih, iw = img.shape[:2]
    fy = (np.arange(h) + 0.5) / h * ih - 0.5
    fx = (np.arange(w) + 0.5) / w * iw - 0.5
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, ih - 1)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    ay = np.clip(fy - y0, 0.0, 1.0)[:, None, None]
    ax = np.clip(fx - x0, 0.0, 1.0)[None, :, None]
    out = ((1 - ay) * (1 - ax) * img[y0][:, x0]
           + (1 - ay) * ax * img[y0][:, x1]
           + ay * (1 - ax) * img[y1][:, x0]
           + ay * ax * img[y1][:, x1])
    return out.astype(np.float32)


def _build_light_maps(sd, L, MH=64, MW=128):
    """Goniometric and projection lights: world-to-light rotations, their
    direction maps resampled to one (G, MH, MW, 3) stack, the projection
    window's half extents, and each map's mean luminance (its factor in
    the light's power), as the reference builds them.  A light whose map
    is missing or unreadable keeps no map (a bare point light or cone)."""
    w2l = np.tile(np.eye(3, dtype=np.float32)[None], (L, 1, 1))
    img_id = np.full(L, -1, np.int32)
    proj_ax = np.ones(L, np.float32)
    proj_ay = np.ones(L, np.float32)
    maps = []
    mean_lum = np.ones(L, np.float32)
    for i, lrec in enumerate(sd.lights):
        if lrec.kind not in (apilib.LIGHT_GONIO, apilib.LIGHT_PROJECTION):
            continue
        if lrec.w2l is not None:
            w2l[i] = lrec.w2l
        img = None
        if lrec.map_name and not os.path.exists(lrec.map_name):
            log.warning(f"light map {lrec.map_name} not found; "
                        f"treating as unfiltered")
        elif lrec.map_name:
            try:
                img = texlib._load_image_any(lrec.map_name)
            except (OSError, ValueError) as e:
                log.warning(f"light map load failed: {e}")
        if lrec.kind == apilib.LIGHT_PROJECTION:
            # projection.cpp's screen window: the fov spans the shorter
            # axis, the longer one extends by the aspect ratio
            tan_half = float(np.tan(0.5 * np.deg2rad(lrec.fov)))
            aspect = img.shape[1] / img.shape[0] if img is not None else 1.0
            if aspect > 1.0:
                proj_ax[i], proj_ay[i] = tan_half * aspect, tan_half
            else:
                proj_ax[i], proj_ay[i] = tan_half, tan_half / aspect
        if img is not None:
            img_id[i] = len(maps)
            maps.append(_resample_bilinear(img, MH, MW))
            lum = maps[-1] @ np.array([0.212671, 0.715160, 0.072169])
            mean_lum[i] = float(lum.mean())
    return dict(w2l=w2l, img_id=img_id, proj_ax=proj_ax, proj_ay=proj_ay,
                mean_lum=mean_lum,
                img=(np.stack(maps) if maps
                     else np.ones((1, MH, MW, 3), np.float32)))


def _build_media(sd):
    """The media's coefficients, world-to-medium transforms and density
    grids, padded to one (G, DZ, DY, DX) stack, as the reference builds
    them (at least one slot of each)."""
    D = max(1, len(sd.media))
    med_a = np.zeros((D, 3), np.float32)
    med_s = np.zeros((D, 3), np.float32)
    med_g = np.zeros(D, np.float32)
    med_gid = np.full(D, -1, np.int32)
    med_w2m = np.tile(np.eye(4, dtype=np.float32), (D, 1, 1))
    med_maxd = np.ones(D, np.float32)
    grids = []
    for i, mrec in enumerate(sd.media):
        med_a[i] = mrec.sigma_a
        med_s[i] = mrec.sigma_s
        med_g[i] = mrec.g
        if getattr(mrec, "density", None) is not None:
            med_gid[i] = len(grids)
            grids.append(np.asarray(mrec.density, np.float32))
            med_w2m[i] = np.asarray(mrec.w2m, np.float32)
            med_maxd[i] = max(float(mrec.density.max()), 1e-9)
    if grids:
        dz = max(g.shape[0] for g in grids)
        dy = max(g.shape[1] for g in grids)
        dx = max(g.shape[2] for g in grids)
        med_dens = np.zeros((len(grids), dz, dy, dx), np.float32)
        med_dims = np.zeros((len(grids), 3), np.int32)
        for gi, g in enumerate(grids):
            med_dens[gi, :g.shape[0], :g.shape[1], :g.shape[2]] = g
            med_dims[gi] = [g.shape[2], g.shape[1], g.shape[0]]  # nx, ny, nz
    else:
        med_dens = np.ones((1, 1, 1, 1), np.float32)
        med_dims = np.ones((1, 3), np.int32)
    return dict(med_sigma_a=med_a, med_sigma_s=med_s, med_g=med_g,
                med_grid_id=med_gid, med_w2m=med_w2m, med_density=med_dens,
                med_grid_dims=med_dims, med_max_density=med_maxd)


def _build_env_map(sd):
    """Lat-long env map + its 2D sampling distribution (first infinite
    light with a map), as the reference builds it."""
    out = dict(img=np.zeros((1, 1, 3), np.float32),
               marg=np.ones(1, np.float32), cond=np.ones((1, 1), np.float32),
               pdf=np.zeros((1, 1), np.float32),
               to_world=np.eye(3, dtype=np.float32),
               world_to=np.eye(3, dtype=np.float32), has=0, light_id=-1)
    for li, lrec in enumerate(sd.lights):
        if lrec.kind != apilib.LIGHT_INFINITE or not lrec.map_name:
            continue
        if not os.path.exists(lrec.map_name):
            log.warning(f"env map {lrec.map_name} not found; using "
                        f"constant color")
            continue
        try:
            img = texlib._load_image_any(lrec.map_name)
        except (OSError, ValueError) as e:
            log.warning(f"env map load failed: {e}")
            continue
        img = img * np.asarray(lrec.L, np.float32)
        if lrec.to_world is not None:
            q, _ = np.linalg.qr(np.asarray(lrec.to_world, np.float64))
            out["to_world"] = q.astype(np.float32)
            out["world_to"] = q.T.astype(np.float32)
        EH, EW = img.shape[:2]
        lum = img @ np.array([0.212671, 0.715160, 0.072169])
        theta = (np.arange(EH) + 0.5) / EH * np.pi
        w = lum * np.sin(theta)[:, None] + 1e-12
        row_int = w.sum(axis=1)
        marg = np.cumsum(row_int) / row_int.sum()
        cond = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
        p_uv = w / w.sum() * (EH * EW)
        sin_t = np.maximum(np.sin(theta)[:, None], 1e-6)
        pdf = p_uv / (2.0 * np.pi * np.pi * sin_t)
        out.update(img=img.astype(np.float32), marg=marg.astype(np.float32),
                   cond=cond.astype(np.float32), pdf=pdf.astype(np.float32),
                   has=1, light_id=li)
        break
    return out
