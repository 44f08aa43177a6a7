"""Shape -> world-space triangle soup conversion (host-side, numpy).

Replaces the reference's per-shape plugin classes (ref: src/shapes/*): on
TPU every surface is triangles in one flat array; quadrics are tessellated
at build time (analytic sphere *lights* stay analytic for cone sampling —
see scene/api.py).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import log

from ..utils import transforms as xf
from . import loopsubdiv, ply
from .paramset import ParamSet


def create_triangles(kind: str, ps: ParamSet, ctm, reverse_orientation: bool,
                     base_dir: str):
    """Returns (p (T,3,3), n (T,3,3) or None, uv (T,3,2) or None)."""
    if kind == "trianglemesh":
        mesh = _trianglemesh(ps)
    elif kind == "plymesh":
        fn = ps.find_one_string("filename", "")
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        mesh = ply.load_ply(fn)
    elif kind == "loopsubdiv":
        p = ps.find_points("P")
        idx = ps.find_ints("indices").reshape(-1, 3)
        nlevels = ps.find_one_int("nlevels", ps.find_one_int("levels", 3))
        v, n, f = loopsubdiv.subdivide(p, idx, nlevels)
        mesh = {"p": v, "n": n, "indices": f}
    elif kind == "sphere":
        mesh = _tessellate_sphere(ps)
    elif kind == "disk":
        mesh = _tessellate_disk(ps)
    elif kind == "cylinder":
        mesh = _tessellate_cylinder(ps)
    elif kind == "cone":
        mesh = _tessellate_cone(ps)
    elif kind == "paraboloid":
        mesh = _tessellate_paraboloid(ps)
    elif kind == "hyperboloid":
        mesh = _tessellate_hyperboloid(ps)
    elif kind == "heightfield":
        mesh = _heightfield(ps)
    elif kind == "curve":
        mesh = _tessellate_curve(ps)
    elif kind == "nurbs":
        mesh = _tessellate_nurbs(ps)
    else:
        import sys
        log.warning(f"unknown shape '{kind}', skipping")
        return None

    if mesh is None:
        return None
    p = xf.apply_point(ctm, mesh["p"])
    n = None
    if mesh.get("n") is not None:
        n = xf.apply_normal(ctm, mesh["n"])
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(ln > 1e-20, n / np.maximum(ln, 1e-20), 0.0)
    idx = mesh["indices"]
    flip = reverse_orientation != xf.swaps_handedness(ctm)
    if flip and n is not None:
        n = -n
    tp = p[idx].astype(np.float32)                     # (T, 3, 3)
    tn = None if n is None else n[idx].astype(np.float32)
    tuv = None
    if mesh.get("uv") is not None:
        tuv = np.asarray(mesh["uv"])[idx].astype(np.float32)
    if flip:
        # swap winding so the geometric normal flips consistently
        tp = tp[:, [0, 2, 1], :]
        if tn is not None:
            tn = tn[:, [0, 2, 1], :]
        if tuv is not None:
            tuv = tuv[:, [0, 2, 1], :]
    return tp, tn, tuv


def _trianglemesh(ps: ParamSet):
    p = ps.find_points("P")
    idx = ps.find_ints("indices")
    if p is None or idx is None:
        return None
    mesh = {"p": p, "indices": idx.reshape(-1, 3)}
    n = ps.find_points("N")
    if n is not None:
        mesh["n"] = n
    uv = ps.find_floats("uv")
    if uv is None:
        uv = ps.find_floats("st")
    if uv is not None:
        mesh["uv"] = uv.reshape(-1, 2)
    return mesh


def _tessellate_sphere(ps: ParamSet, n_theta: int = 32, n_phi: int = 64):
    """Lat-long tessellation with per-vertex exact normals; a tessellated
    sphere with smooth normals is visually equivalent to the analytic
    quadric (ref: src/shapes/sphere.cpp) at these densities."""
    r = ps.find_one_float("radius", 1.0)
    zmin = ps.find_one_float("zmin", -r)
    zmax = ps.find_one_float("zmax", r)
    theta_min = np.arccos(np.clip(zmax / r, -1, 1))
    theta_max = np.arccos(np.clip(zmin / r, -1, 1))
    phi_max = np.deg2rad(ps.find_one_float("phimax", 360.0))
    t = np.linspace(theta_min, theta_max, n_theta + 1)
    ph = np.linspace(0.0, phi_max, n_phi + 1)
    tt, pp = np.meshgrid(t, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.sin(tt) * np.sin(pp)
    z = np.cos(tt)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    nrm = verts.copy()
    p = verts * r
    uv = np.stack([pp / max(phi_max, 1e-9),
                   (tt - theta_min) / max(theta_max - theta_min, 1e-9)],
                  axis=-1).reshape(-1, 2)
    idx = []
    W = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * W + j
            b = a + 1
            c = a + W
            d = c + 1
            idx.append([a, d, b])
            idx.append([a, c, d])
    return {"p": p, "n": nrm, "uv": uv, "indices": np.asarray(idx)}


def _tessellate_disk(ps: ParamSet, n: int = 64):
    r = ps.find_one_float("radius", 1.0)
    ir = ps.find_one_float("innerradius", 0.0)
    h = ps.find_one_float("height", 0.0)
    phi_max = np.deg2rad(ps.find_one_float("phimax", 360.0))
    ph = np.linspace(0.0, phi_max, n + 1)
    outer = np.stack([r * np.cos(ph), r * np.sin(ph), np.full_like(ph, h)], axis=-1)
    if ir > 0:
        inner = np.stack([ir * np.cos(ph), ir * np.sin(ph), np.full_like(ph, h)],
                         axis=-1)
        verts = np.concatenate([outer, inner], axis=0)
        idx = []
        for j in range(n):
            a, b = j, j + 1
            c, d = n + 1 + j, n + 1 + j + 1
            idx.append([a, b, d])
            idx.append([a, d, c])
    else:
        center = np.array([[0.0, 0.0, h]])
        verts = np.concatenate([outer, center], axis=0)
        idx = [[n + 1, j, j + 1] for j in range(n)]
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]]), (verts.shape[0], 1))
    return {"p": verts, "n": nrm, "indices": np.asarray(idx)}


def _grid_indices(n_u: int, n_v: int):
    """Triangle indices for an (n_u+1)x(n_v+1) vertex grid laid out
    row-major over u (rows) then v (cols)."""
    W = n_v + 1
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    a = (i * W + j).reshape(-1)
    b = a + 1
    c = a + W
    d = c + 1
    return np.concatenate(
        [np.stack([a, d, b], axis=-1), np.stack([a, c, d], axis=-1)], axis=0)


def _tessellate_cone(ps: ParamSet, n_v: int = 16, n_phi: int = 64):
    """Cone apex at (0,0,h) (ref: src/shapes/cone.cpp parametrization:
    p = (r(1-v)cos phi, r(1-v)sin phi, v h))."""
    r = ps.find_one_float("radius", 1.0)
    h = ps.find_one_float("height", 1.0)
    phi_max = np.deg2rad(ps.find_one_float("phimax", 360.0))
    v = np.linspace(0.0, 1.0, n_v + 1)
    ph = np.linspace(0.0, phi_max, n_phi + 1)
    vv, pp = np.meshgrid(v, ph, indexing="ij")
    x = r * (1.0 - vv) * np.cos(pp)
    y = r * (1.0 - vv) * np.sin(pp)
    z = vv * h
    p = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    # surface normal of x^2+y^2 = (r(1-z/h))^2: (h cos, h sin, r)/|.|
    sl = np.hypot(h, r)
    nrm = np.stack([h * np.cos(pp) / sl, h * np.sin(pp) / sl,
                    np.full_like(pp, r / sl)], axis=-1).reshape(-1, 3)
    uv = np.stack([pp / max(phi_max, 1e-9), vv], axis=-1).reshape(-1, 2)
    return {"p": p, "n": nrm, "uv": uv, "indices": _grid_indices(n_v, n_phi)}


def _tessellate_paraboloid(ps: ParamSet, n_v: int = 32, n_phi: int = 64):
    """z = zmax (x^2+y^2)/radius^2 patch between zmin..zmax (ref:
    src/shapes/paraboloid.cpp)."""
    r = ps.find_one_float("radius", 1.0)
    zmin = ps.find_one_float("zmin", 0.0)
    zmax = ps.find_one_float("zmax", 1.0)
    phi_max = np.deg2rad(ps.find_one_float("phimax", 360.0))
    z = np.linspace(max(zmin, 1e-6 * abs(zmax)), zmax, n_v + 1)
    ph = np.linspace(0.0, phi_max, n_phi + 1)
    zz, pp = np.meshgrid(z, ph, indexing="ij")
    rad = r * np.sqrt(np.clip(zz / zmax, 0.0, None))
    x = rad * np.cos(pp)
    y = rad * np.sin(pp)
    p = np.stack([x, y, zz], axis=-1).reshape(-1, 3)
    # gradient of f = x^2 + y^2 - (r^2/zmax) z
    k = r * r / zmax
    g = np.stack([2 * x, 2 * y, np.full_like(x, -k)], axis=-1).reshape(-1, 3)
    nrm = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    uv = np.stack([pp / max(phi_max, 1e-9),
                   (zz - zmin) / max(zmax - zmin, 1e-9)],
                  axis=-1).reshape(-1, 2)
    return {"p": p, "n": nrm, "uv": uv, "indices": _grid_indices(n_v, n_phi)}


def _tessellate_hyperboloid(ps: ParamSet, n_v: int = 32, n_phi: int = 64):
    """Surface of revolution sweeping the segment p1->p2 around z (ref:
    src/shapes/hyperboloid.cpp: x = xr cos phi - yr sin phi, ...)."""
    p1 = ps.find_floats("p1")
    p2 = ps.find_floats("p2")
    p1 = np.asarray(p1 if p1 is not None else [0.0, 0.0, 0.0], np.float64)
    p2 = np.asarray(p2 if p2 is not None else [1.0, 1.0, 1.0], np.float64)
    phi_max = np.deg2rad(ps.find_one_float("phimax", 360.0))
    v = np.linspace(0.0, 1.0, n_v + 1)
    ph = np.linspace(0.0, phi_max, n_phi + 1)
    vv, pp = np.meshgrid(v, ph, indexing="ij")
    pr = p1[None, None, :] + vv[..., None] * (p2 - p1)[None, None, :]
    cosp, sinp = np.cos(pp), np.sin(pp)
    x = pr[..., 0] * cosp - pr[..., 1] * sinp
    y = pr[..., 0] * sinp + pr[..., 1] * cosp
    z = pr[..., 2]
    p = np.stack([x, y, z], axis=-1)
    dpdu = np.stack([-y, x, np.zeros_like(x)], axis=-1)
    d = (p2 - p1)
    dpdv = np.stack([d[0] * cosp - d[1] * sinp,
                     d[0] * sinp + d[1] * cosp,
                     np.full_like(x, d[2])], axis=-1)
    g = np.cross(dpdu, dpdv)
    ln = np.linalg.norm(g, axis=-1, keepdims=True)
    nrm = np.where(ln > 1e-12, g / np.maximum(ln, 1e-12), 0.0)
    uv = np.stack([pp / max(phi_max, 1e-9), vv], axis=-1)
    return {"p": p.reshape(-1, 3), "n": nrm.reshape(-1, 3),
            "uv": uv.reshape(-1, 2), "indices": _grid_indices(n_v, n_phi)}


def _heightfield(ps: ParamSet):
    """Regular grid z(x,y) over [0,1]^2 (ref: src/shapes/heightfield.cpp
    CreateHeightfield — the reference also converts to a trianglemesh)."""
    nu = ps.find_one_int("nu", 0)
    nv = ps.find_one_int("nv", 0)
    z = ps.find_floats("Pz")
    if nu < 2 or nv < 2 or z is None or z.size != nu * nv:
        return None
    x = np.arange(nu, dtype=np.float64) / (nu - 1)
    y = np.arange(nv, dtype=np.float64) / (nv - 1)
    # reference ordering: x varies fastest (heightfield.cpp pos loop)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    p = np.stack([xx, yy, np.asarray(z).reshape(nv, nu)], axis=-1)
    uv = np.stack([xx, yy], axis=-1)
    return {"p": p.reshape(-1, 3), "uv": uv.reshape(-1, 2),
            "indices": _grid_indices(nv - 1, nu - 1)}


def _bezier_eval(cp, t):
    """Cubic Bezier position and tangent. cp: (4,3); t: (S,)."""
    t = t[:, None]
    u = 1.0 - t
    p = (u ** 3 * cp[0] + 3 * u * u * t * cp[1]
         + 3 * u * t * t * cp[2] + t ** 3 * cp[3])
    d = (3 * u * u * (cp[1] - cp[0]) + 6 * u * t * (cp[2] - cp[1])
         + 3 * t * t * (cp[3] - cp[2]))
    return p, d


def _tessellate_curve(ps: ParamSet, n_s: int = None, n_tube: int = None):
    """Cubic Bezier curve segments (ref: src/shapes/curve.cpp). The
    reference intersects the curve analytically per-ray; here each
    segment is diced: 'cylinder' curves become tubes, 'flat'/'ribbon'
    become two-sided ribbons oriented by a rotation-minimizing frame
    (or the given ribbon normals).

    Dicing resolution follows the curve's "splitdepth" parameter (the
    reference's recursive-split budget, curve.cpp CreateCurveShape
    default 3): n_s = 2^splitdepth subsegments, 6-sided tubes at
    splitdepth >= 3, 3-sided below.  Hair assets (cyhair2pbrt emits
    splitdepth 1) thus cost 12 triangles per Bezier segment instead of
    192 — the geometry-amplification fix for 10k+ strand grooms
    (BENCH_NOTES round 4 hair stress test)."""
    cps = ps.find_points("P")
    if cps is None or cps.shape[0] < 4:
        return None
    sd_ = int(ps.find_one_int("splitdepth", 4))
    if n_s is None:
        n_s = max(1, 1 << sd_)
    if n_tube is None:
        n_tube = 6 if sd_ >= 3 else 3
    ctype = ps.find_one_string("type", "flat")
    w0 = ps.find_one_float("width", 1.0)
    width0 = ps.find_one_float("width0", w0)
    width1 = ps.find_one_float("width1", w0)
    rib_n = ps.find_points("N")
    n_seg = (cps.shape[0] - 1) // 3
    all_p, all_n, all_uv, all_idx = [], [], [], []
    base = 0
    for s in range(n_seg):
        cp = cps[3 * s:3 * s + 4].astype(np.float64)
        t = np.linspace(0.0, 1.0, n_s + 1)
        u_glob = (s + t) / n_seg
        pos, tan = _bezier_eval(cp, t)
        tl = np.linalg.norm(tan, axis=-1, keepdims=True)
        tan = tan / np.maximum(tl, 1e-12)
        width = width0 + (width1 - width0) * u_glob
        # frame: ribbon normals if given, else rotation-minimizing
        if rib_n is not None and rib_n.shape[0] >= 2:
            n0 = rib_n[min(s, rib_n.shape[0] - 2)]
            n1 = rib_n[min(s + 1, rib_n.shape[0] - 1)]
            nrm = (1 - t)[:, None] * n0 + t[:, None] * n1
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                              1e-12)
            side = np.cross(tan, nrm)
        else:
            ref = np.array([0.0, 0.0, 1.0])
            if abs(np.dot(ref, tan[0])) > 0.9:
                ref = np.array([1.0, 0.0, 0.0])
            side = np.cross(tan, ref)
            side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True),
                               1e-12)
            nrm = np.cross(side, tan)
        if ctype == "cylinder":
            ang = np.linspace(0.0, 2 * np.pi, n_tube + 1)
            ring = (np.cos(ang)[None, :, None] * nrm[:, None, :]
                    + np.sin(ang)[None, :, None] * side[:, None, :])
            pts = pos[:, None, :] + 0.5 * width[:, None, None] * ring
            vn = ring
            uvs = np.stack(
                [np.broadcast_to(u_glob[:, None], ring.shape[:2]),
                 np.broadcast_to(ang[None, :] / (2 * np.pi),
                                 ring.shape[:2])], axis=-1)
            idx = _grid_indices(n_s, n_tube) + base
            base += (n_s + 1) * (n_tube + 1)
        else:  # flat / ribbon -> quad strip
            off = 0.5 * width[:, None] * side
            pts = np.stack([pos - off, pos + off], axis=1)
            vn = np.stack([nrm, nrm], axis=1)
            uvs = np.stack(
                [np.stack([u_glob, u_glob], axis=1),
                 np.broadcast_to(np.array([0.0, 1.0]), (n_s + 1, 2))],
                axis=-1)
            idx = _grid_indices(n_s, 1) + base
            base += (n_s + 1) * 2
        all_p.append(pts.reshape(-1, 3))
        all_n.append(vn.reshape(-1, 3))
        all_uv.append(uvs.reshape(-1, 2))
        all_idx.append(idx)
    return {"p": np.concatenate(all_p), "n": np.concatenate(all_n),
            "uv": np.concatenate(all_uv), "indices": np.concatenate(all_idx)}


def _bspline_basis(knots, order, t):
    """Cox-de-Boor basis functions. Returns (len(t), n_ctrl) matrix
    where n_ctrl = len(knots) - order."""
    knots = np.asarray(knots, np.float64)
    n_ctrl = knots.size - order
    t = np.asarray(t, np.float64)
    # degree-0
    B = np.zeros((t.size, knots.size - 1))
    for i in range(knots.size - 1):
        B[:, i] = (t >= knots[i]) & (t < knots[i + 1])
    for k in range(1, order):
        Bn = np.zeros((t.size, knots.size - 1 - k))
        for i in range(knots.size - 1 - k):
            d1 = knots[i + k] - knots[i]
            d2 = knots[i + k + 1] - knots[i + 1]
            a = (t - knots[i]) / d1 if d1 > 0 else 0.0
            b = (knots[i + k + 1] - t) / d2 if d2 > 0 else 0.0
            Bn[:, i] = a * B[:, i] + b * B[:, i + 1]
        B = Bn
    # clamp: ensure each row sums to ~1 (end-point fix)
    s = B.sum(axis=1, keepdims=True)
    bad = (s[:, 0] <= 1e-9)
    if bad.any():
        # end of domain: last basis = 1
        B[bad] = 0.0
        B[bad, -1] = 1.0
        s = B.sum(axis=1, keepdims=True)
    return B[:, :n_ctrl] / np.maximum(s, 1e-12)


def _tessellate_nurbs(ps: ParamSet, res: int = 48):
    """NURBS patch diced to a grid (the reference also dices NURBS into a
    trianglemesh at render time — ref: src/shapes/nurbs.cpp)."""
    nu = ps.find_one_int("nu", 0)
    nv = ps.find_one_int("nv", 0)
    uorder = ps.find_one_int("uorder", 0)
    vorder = ps.find_one_int("vorder", 0)
    uknots = ps.find_floats("uknots")
    vknots = ps.find_floats("vknots")
    if min(nu, nv, uorder, vorder) <= 0 or uknots is None or vknots is None:
        return None
    pw = ps.find_floats("Pw")
    if pw is not None:
        cp = pw.reshape(nv, nu, 4).astype(np.float64)
    else:
        p = ps.find_points("P")
        if p is None:
            return None
        cp = np.concatenate([p.reshape(nv, nu, 3),
                             np.ones((nv, nu, 1))], axis=-1)
    u0 = ps.find_one_float("u0", float(uknots[uorder - 1]))
    u1 = ps.find_one_float("u1", float(uknots[nu]))
    v0 = ps.find_one_float("v0", float(vknots[vorder - 1]))
    v1 = ps.find_one_float("v1", float(vknots[nv]))
    us = np.linspace(u0, u1 - 1e-9 * max(abs(u1), 1.0), res + 1)
    vs = np.linspace(v0, v1 - 1e-9 * max(abs(v1), 1.0), res + 1)
    Bu = _bspline_basis(uknots, uorder, us)          # (res+1, nu)
    Bv = _bspline_basis(vknots, vorder, vs)          # (res+1, nv)
    # homogeneous tensor product: S[t,s] = sum_v sum_u Bv[t,v] Bu[s,u] cp[v,u]
    pts_h = np.einsum("tv,su,vuk->tsk", Bv, Bu, cp)
    w = np.maximum(pts_h[..., 3:4], 1e-12)
    p = pts_h[..., :3] / w
    # normals by finite differences on the grid
    du = np.gradient(p, axis=1)
    dv = np.gradient(p, axis=0)
    g = np.cross(du, dv)
    ln = np.linalg.norm(g, axis=-1, keepdims=True)
    nrm = np.where(ln > 1e-12, g / np.maximum(ln, 1e-12), 0.0)
    uu, vvm = np.meshgrid((us - u0) / max(u1 - u0, 1e-9),
                          (vs - v0) / max(v1 - v0, 1e-9), indexing="xy")
    uv = np.stack([uu, vvm], axis=-1)
    return {"p": p.reshape(-1, 3), "n": nrm.reshape(-1, 3),
            "uv": uv.reshape(-1, 2), "indices": _grid_indices(res, res)}


def _tessellate_cylinder(ps: ParamSet, n: int = 64):
    r = ps.find_one_float("radius", 1.0)
    zmin = ps.find_one_float("zmin", -1.0)
    zmax = ps.find_one_float("zmax", 1.0)
    phi_max = np.deg2rad(ps.find_one_float("phimax", 360.0))
    ph = np.linspace(0.0, phi_max, n + 1)
    bottom = np.stack([r * np.cos(ph), r * np.sin(ph), np.full_like(ph, zmin)],
                      axis=-1)
    top = np.stack([r * np.cos(ph), r * np.sin(ph), np.full_like(ph, zmax)],
                   axis=-1)
    verts = np.concatenate([bottom, top], axis=0)
    nrm = np.concatenate(
        [np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], axis=-1)] * 2,
        axis=0,
    )
    idx = []
    for j in range(n):
        a, b = j, j + 1
        c, d = n + 1 + j, n + 1 + j + 1
        idx.append([a, b, d])
        idx.append([a, d, c])
    return {"p": verts, "n": nrm, "indices": np.asarray(idx)}
