"""Plain PyTorch reference of pbrt-v3's ``path`` integrator, for the scenes
the benchmark renders.

It imports nothing of the program under test and takes nothing the
program made: its own reader of the pbrt-v3 scene subset below (and of
binary PLY meshes), its own BVH, its own camera, BSDFs and lights, and
its own random numbers from a ``torch.Generator`` seeded by the caller.
It estimates the image pbrt-v3's PathIntegrator estimates: next-event
estimation of one light a vertex, weighted against the continuation ray
by the power heuristic, Russian roulette after bounce 3, emission seen on
the camera ray and after specular bounces at full weight.  Its sampling
differs from the program's (uniform random numbers, the full microfacet
distribution, uniform light selection), so the two agree in expectation
and not sample by sample.

Scene subset: LookAt, Translate, Scale, Camera "perspective", Film,
Sampler, Integrator, AttributeBegin/End, WorldBegin/End, LightSource
"distant" and "infinite" (constant), AreaLightSource "area" (one-sided),
Material "matte" (sigma 0), "plastic", "uber" (no Kr, Kt, opacity),
"metal", "glass" (smooth), Shape "trianglemesh" and "plymesh" (binary
little-endian, optional vertex normals).  Anything else raises.

``dtype`` is the floating-point type of every quantity the tracer
computes; ``torch.bfloat16`` is the benchmark's control.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

MATTE, PLASTIC, UBER, METAL, GLASS = range(5)
_KINDS = {"matte": MATTE, "plastic": PLASTIC, "uber": UBER, "metal": METAL,
          "glass": GLASS}
# metal.cpp's default copper spectra, as RGB
COPPER_ETA = (0.2004, 0.9240, 1.1022)
COPPER_K = (3.9129, 2.4528, 2.1421)
LEAF = 4          # triangles a BVH leaf
RAY_EPS = 1e-4    # spawn offset along the geometric normal (scene units)
SHADOW_EPS = 1e-4  # relative shortening of a shadow ray to a light point
RAY_CHUNK = 1 << 18  # rays a breadth-first walk
MAX_EDGE = 0.25   # BVH pieces are no longer than this (scene units)

_TOKEN = re.compile(r'"[^"]*"|\[|\]|#[^\n]*|[^\s\[\]"#]+')


# ---------------------------------------------------------------------------
# scene file
# ---------------------------------------------------------------------------

@dataclass
class SceneData:
    """The scene as flat float64 numpy arrays on the host."""
    fov: float = 90.0
    cam_to_world: np.ndarray = None          # (4, 4)
    width: int = 0
    height: int = 0
    max_depth: int = 5
    tris: np.ndarray = None                  # (T, 3, 3) world vertices
    normals: np.ndarray = None               # (T, 3, 3) or zeros
    has_n: np.ndarray = None                 # (T,) bool
    mat: np.ndarray = None                   # (T,) material row
    emit: np.ndarray = None                  # (T, 3) area light radiance
    materials: list = field(default_factory=list)  # dicts
    distant: list = field(default_factory=list)    # (w to light, L)
    infinite: list = field(default_factory=list)   # L


def _params(toks, i):
    """Parameter list at toks[i:] -> (dict name -> (type, values), next i)."""
    out = {}
    while i < len(toks) and toks[i].startswith('"'):
        decl = toks[i][1:-1].split()
        if len(decl) != 2:
            raise ValueError(f"bad parameter declaration {toks[i]}")
        ty, name = decl
        i += 1
        if toks[i] == "[":
            j = toks.index("]", i)
            vals = toks[i + 1:j]
            i = j + 1
        else:
            vals = [toks[i]]
            i += 1
        if ty in ("string", "texture", "bool"):
            vals = [v.strip('"') for v in vals]
        else:
            vals = [float(v) for v in vals]
        out[name] = (ty, vals)
    return out, i


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0])


def _look_at(pos, look, up):
    """pbrt's LookAt: the world-to-camera matrix."""
    pos, look, up = (np.asarray(v, np.float64) for v in (pos, look, up))
    d = look - pos
    d /= np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, new_up, d, pos
    return np.linalg.inv(c2w)


def read_ply(path):
    """Binary little-endian PLY -> (positions (V,3), normals (V,3) or None,
    triangles (F,3)); polygons are split into fans."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header") + len(b"end_header")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: only binary little-endian PLY is read")
    types = {"float": "<f4", "float32": "<f4", "double": "<f8", "int": "<i4",
             "int32": "<i4", "uint": "<u4", "uchar": "u1", "uint8": "u1",
             "short": "<i2", "ushort": "<u2", "char": "i1"}
    elems, cur = [], None
    for line in header:
        w = line.split()
        if w[:1] == ["element"]:
            cur = [w[1], int(w[2]), []]
            elems.append(cur)
        elif w[:1] == ["property"]:
            cur[2].append(w[1:])
    off = end
    verts = faces = None
    for name, count, props in elems:
        if name == "vertex":
            dt = np.dtype([(p[1], types[p[0]]) for p in props])
            verts = np.frombuffer(data, dt, count, off)
            off += dt.itemsize * count
        elif name == "face":
            (_, cty, ity, _), = props
            cty, ity = np.dtype(types[cty]), np.dtype(types[ity])
            polys = []
            for _ in range(count):
                n = int(np.frombuffer(data, cty, 1, off)[0])
                off += cty.itemsize
                idx = np.frombuffer(data, ity, n, off)
                off += ity.itemsize * n
                polys.extend((idx[0], idx[k], idx[k + 1]) for k in range(1, n - 1))
            faces = np.asarray(polys, np.int64)
        else:
            raise ValueError(f"{path}: unexpected PLY element {name}")
    pos = np.stack([verts["x"], verts["y"], verts["z"]], 1).astype(np.float64)
    nrm = None
    if "nx" in verts.dtype.names:
        nrm = np.stack([verts["nx"], verts["ny"], verts["nz"]], 1).astype(np.float64)
    return pos, nrm, faces


def _material(kind, ps):
    def rgb(name, default):
        return list(ps[name][1]) if name in ps else list(default)

    def flt(name, default):
        return float(ps[name][1][0]) if name in ps else default

    if kind not in _KINDS:
        raise ValueError(f"material {kind!r} is outside the reference's subset")
    m = dict(kind=_KINDS[kind], kd=[0.0] * 3, ks=[0.0] * 3, rough=0.0, eta=1.5,
             metal_eta=list(COPPER_ETA), metal_k=list(COPPER_K))
    if kind == "matte":
        if flt("sigma", 0.0) != 0.0:
            raise ValueError("matte with sigma > 0 is outside the subset")
        m["kd"] = rgb("Kd", [0.5] * 3)
    elif kind in ("plastic", "uber"):
        m["kd"] = rgb("Kd", [0.25] * 3)
        m["ks"] = rgb("Ks", [0.25] * 3)
        m["rough"] = flt("roughness", 0.1)
        if kind == "uber":
            m["eta"] = flt("eta", flt("index", 1.5))
            if any(rgb("Kr", [0] * 3)) or any(rgb("Kt", [0] * 3)):
                raise ValueError("uber with Kr or Kt is outside the subset")
    elif kind == "metal":
        m["metal_eta"] = rgb("eta", COPPER_ETA)
        m["metal_k"] = rgb("k", COPPER_K)
        m["rough"] = flt("roughness", 0.01)
    elif kind == "glass":
        m["eta"] = flt("eta", flt("index", 1.5))
        if flt("uroughness", 0.0) or flt("vroughness", 0.0):
            raise ValueError("rough glass is outside the subset")
    if ps.get("remaproughness", ("bool", ["true"]))[1][0] != "true":
        raise ValueError("remaproughness false is outside the subset")
    return m


def load_scene(path, width=None, height=None, max_depth=None) -> SceneData:
    """Read a pbrt-v3 scene of the subset; width, height and max_depth,
    when given, replace the file's."""
    with open(path) as f:
        toks = [t for t in _TOKEN.findall(f.read()) if not t.startswith("#")]
    base = os.path.dirname(os.path.abspath(path))
    sd = SceneData()
    ctm = np.eye(4)
    mat = _material("matte", {})
    area = None
    stack = []
    mats, mat_key = [], {}
    tris, nrms, has_n, mat_of, emit = [], [], [], [], []
    i = 0
    while i < len(toks):
        t = toks[i]
        i += 1
        if t == "LookAt":
            v = [float(x) for x in toks[i:i + 9]]
            i += 9
            ctm = ctm @ _look_at(v[0:3], v[3:6], v[6:9])
        elif t == "Translate":
            ctm = ctm @ _translate(*[float(x) for x in toks[i:i + 3]])
            i += 3
        elif t == "Scale":
            ctm = ctm @ _scale(*[float(x) for x in toks[i:i + 3]])
            i += 3
        elif t in ("WorldBegin",):
            ctm = np.eye(4)
        elif t == "WorldEnd":
            pass
        elif t == "AttributeBegin":
            stack.append((ctm, mat, area))
        elif t == "AttributeEnd":
            ctm, mat, area = stack.pop()
        elif t in ("Camera", "Film", "Sampler", "Integrator", "LightSource",
                   "AreaLightSource", "Material", "Shape"):
            kind = toks[i].strip('"')
            ps, i = _params(toks, i + 1)
            if t == "Camera":
                if kind != "perspective":
                    raise ValueError(f"camera {kind!r} is outside the subset")
                sd.fov = float(ps.get("fov", ("float", [90.0]))[1][0])
                sd.cam_to_world = np.linalg.inv(ctm)
            elif t == "Film":
                sd.width = int(ps.get("xresolution", ("integer", [640]))[1][0])
                sd.height = int(ps.get("yresolution", ("integer", [480]))[1][0])
            elif t == "Sampler":
                pass                       # the reference samples at random
            elif t == "Integrator":
                if kind != "path":
                    raise ValueError(f"integrator {kind!r} is outside the subset")
                sd.max_depth = int(ps.get("maxdepth", ("integer", [5]))[1][0])
            elif t == "LightSource":
                L = np.asarray(ps.get("L", ("rgb", [1, 1, 1]))[1], np.float64)
                L = L * float(ps.get("scale", ("float", [1.0]))[1][0])
                if kind == "distant":
                    fr = np.asarray(ps.get("from", ("point", [0, 0, 0]))[1])
                    to = np.asarray(ps.get("to", ("point", [0, 0, 1]))[1])
                    w = ctm[:3, :3] @ (fr - to)
                    sd.distant.append((w / np.linalg.norm(w), L))
                elif kind == "infinite":
                    if "mapname" in ps:
                        raise ValueError("an infinite light's map is outside "
                                         "the subset")
                    sd.infinite.append(L)
                else:
                    raise ValueError(f"light {kind!r} is outside the subset")
            elif t == "AreaLightSource":
                if kind not in ("area", "diffuse"):
                    raise ValueError(f"area light {kind!r} is outside the subset")
                if ps.get("twosided", ("bool", ["false"]))[1][0] == "true":
                    raise ValueError("two-sided area lights are outside the subset")
                area = (np.asarray(ps.get("L", ("rgb", [1, 1, 1]))[1], np.float64)
                        * float(ps.get("scale", ("float", [1.0]))[1][0]))
            elif t == "Material":
                mat = _material(kind, ps)
            else:  # Shape
                if kind == "trianglemesh":
                    pos = np.asarray(ps["P"][1], np.float64).reshape(-1, 3)
                    idx = np.asarray(ps["indices"][1], np.int64).reshape(-1, 3)
                    nrm = (np.asarray(ps["N"][1], np.float64).reshape(-1, 3)
                           if "N" in ps else None)
                elif kind == "plymesh":
                    pos, nrm, idx = read_ply(os.path.join(
                        base, ps["filename"][1][0]))
                else:
                    raise ValueError(f"shape {kind!r} is outside the subset")
                if np.linalg.det(ctm[:3, :3]) < 0:
                    raise ValueError("a handedness-swapping transform is "
                                     "outside the subset")
                pw = pos @ ctm[:3, :3].T + ctm[:3, 3]
                key = repr(sorted(mat.items()))
                if key not in mat_key:
                    mat_key[key] = len(mats)
                    mats.append(mat)
                tris.append(pw[idx])
                if nrm is not None:
                    nw = nrm @ np.linalg.inv(ctm[:3, :3])
                    nw /= np.maximum(np.linalg.norm(nw, axis=1, keepdims=True),
                                     1e-30)
                    nrms.append(nw[idx])
                else:
                    nrms.append(np.zeros((len(idx), 3, 3)))
                has_n.append(np.full(len(idx), nrm is not None))
                mat_of.append(np.full(len(idx), mat_key[key]))
                emit.append(np.tile(area if area is not None else np.zeros(3),
                                    (len(idx), 1)))
        else:
            raise ValueError(f"directive {t!r} is outside the reference's subset")
    sd.tris = np.concatenate(tris)
    sd.normals = np.concatenate(nrms)
    sd.has_n = np.concatenate(has_n)
    sd.mat = np.concatenate(mat_of)
    sd.emit = np.concatenate(emit)
    sd.materials = mats
    if width is not None:
        sd.width, sd.height = int(width), int(height)
    if max_depth is not None:
        sd.max_depth = int(max_depth)
    return sd


# ---------------------------------------------------------------------------
# BVH: a complete binary tree over median splits, leaves of LEAF triangles,
# built over pieces of the triangles no longer than MAX_EDGE
# ---------------------------------------------------------------------------

def split_long(tris):
    """Bisect the longest edge of every triangle longer than MAX_EDGE until
    none is -> (pieces (P,3,3), parent (P,), bary (P,3,2): each corner's
    (b1, b2) in its parent's barycentrics).  The pieces keep the parent's
    winding, so its plane and normal."""
    T = tris.shape[0]
    v = tris.copy()
    parent = np.arange(T)
    bary = np.tile(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), (T, 1, 1))
    while True:
        edge = np.linalg.norm(v - np.roll(v, -1, axis=1), axis=2)  # (v0v1, v1v2, v2v0)
        big = edge.max(1) > MAX_EDGE
        if not big.any():
            return v, parent, bary
        k = edge[big].argmax(1)
        roll = (np.arange(3)[None, :] + k[:, None]) % 3      # longest edge first
        vb = np.take_along_axis(v[big], roll[:, :, None], 1)
        bb = np.take_along_axis(bary[big], roll[:, :, None], 1)
        vm, bm = (vb[:, 0] + vb[:, 1]) / 2, (bb[:, 0] + bb[:, 1]) / 2
        va = np.stack([vb[:, 0], vm, vb[:, 2]], 1)
        vc = np.stack([vm, vb[:, 1], vb[:, 2]], 1)
        ba = np.stack([bb[:, 0], bm, bb[:, 2]], 1)
        bc = np.stack([bm, bb[:, 1], bb[:, 2]], 1)
        pb = parent[big]
        v = np.concatenate([v[~big], va, vc])
        bary = np.concatenate([bary[~big], ba, bc])
        parent = np.concatenate([parent[~big], pb, pb])


def build_bvh(tris):
    """(T,3,3) -> (slot_tri (S,) triangle of each leaf slot or -1, node
    boxes lo, hi (2L-1, 3), number of leaves L).  Node i's children are
    2i+1 and 2i+2; leaves are the last L nodes, leaf k holding slots
    [LEAF k, LEAF (k+1)).  Each level splits every node's triangles at the
    median of their centroids along the node's longest centroid extent."""
    T = tris.shape[0]
    n_leaves = 1 << max(0, math.ceil(math.log2(max(1, -(-T // LEAF)))))
    S = n_leaves * LEAF
    cen = tris.mean(1)
    perm = np.arange(S)              # slot -> triangle or >= T (empty)
    seg = S
    while seg > LEAF:
        ids = np.arange(S) // seg
        real = perm < T
        c = np.where(real[:, None], cen[np.minimum(perm, T - 1)], np.nan)
        lo = np.where(real[:, None], c, np.inf).reshape(-1, seg, 3).min(1)
        hi = np.where(real[:, None], c, -np.inf).reshape(-1, seg, 3).max(1)
        axis = np.argmax(np.where(np.isfinite(hi - lo), hi - lo, -1.0), 1)
        key = np.where(real, c[np.arange(S), axis[ids]], np.inf)
        perm = perm[np.lexsort((key, ids))]
        seg //= 2
    slot_tri = np.where(perm < T, perm, -1)
    v = np.where((slot_tri >= 0)[:, None, None], tris[np.maximum(slot_tri, 0)],
                 np.nan).reshape(n_leaves, LEAF * 3, 3)
    lo = np.where(np.isnan(v), np.inf, v).min(1)
    hi = np.where(np.isnan(v), -np.inf, v).max(1)
    los, his = [lo], [hi]
    while lo.shape[0] > 1:
        lo = np.minimum(lo[0::2], lo[1::2])
        hi = np.maximum(hi[0::2], hi[1::2])
        los.append(lo)
        his.append(hi)
    return (slot_tri, np.concatenate(los[::-1]), np.concatenate(his[::-1]),
            n_leaves)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(a):
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                           min=1e-30)


def _fr_dielectric(cos_i, eta_i, eta_t):
    """pbrt-v3 FrDielectric (cos_i signed; eta_i, eta_t broadcastable)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1 - ci * ci, min=0))
    sin_t = ei / et * sin_i
    ct = torch.sqrt(torch.clamp(1 - sin_t * sin_t, min=0))
    r_par = (et * ci - ei * ct) / (et * ci + ei * ct)
    r_perp = (ei * ci - et * ct) / (ei * ci + et * ct)
    fr = (r_par * r_par + r_perp * r_perp) / 2
    return torch.where(sin_t >= 1, torch.ones_like(fr), fr)


def _fr_conductor(cos_i, eta, k):
    """pbrt-v3 FrConductor with eta_i = 1; cos_i (N,), eta, k (N,3)."""
    c = torch.clamp(torch.abs(cos_i), 0, 1)[:, None]
    c2 = c * c
    s2 = 1 - c2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4 * e2 * k2, min=0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0))
    t2 = 2 * c * a
    rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp + rs)


def _tr_d(wh, alpha):
    c2 = wh[:, 2] * wh[:, 2]
    tan2 = torch.clamp(1 - c2, min=0) / c2
    a2 = alpha * alpha
    e = 1 + tan2 / a2
    d = 1 / (math.pi * a2 * c2 * c2 * e * e)
    return torch.where(c2 > 0, d, torch.zeros_like(d))


def _tr_lambda(w, alpha):
    c2 = w[:, 2] * w[:, 2]
    tan2 = torch.clamp(1 - c2, min=0) / c2
    lam = (-1 + torch.sqrt(1 + alpha * alpha * tan2)) / 2
    return torch.where(c2 > 0, lam, torch.zeros_like(lam))


def roughness_to_alpha(r):
    """TrowbridgeReitzDistribution::RoughnessToAlpha."""
    x = math.log(max(r, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


class Tracer:
    """The scene on ``device`` in ``dtype``, and pbrt-v3's path estimator."""

    def __init__(self, sd: SceneData, device, dtype=torch.float32):
        self.sd = sd
        self.dev = torch.device(device)
        self.dt = dtype
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self.dev
                                      ).to(dtype)
        pieces, parent, bary = split_long(sd.tris)
        slot_piece, lo, hi, n_leaves = build_bvh(pieces)
        self.n_leaves = n_leaves
        self.levels = int(math.log2(n_leaves)) + 1
        self.lo, self.hi = f(lo), f(hi)
        self.nonempty = torch.as_tensor((lo <= hi).all(1), device=self.dev)
        sp_ = np.maximum(slot_piece, 0)
        p = pieces[sp_]
        self.s_p0 = f(p[:, 0])
        self.s_e1 = f(p[:, 1] - p[:, 0])
        self.s_e2 = f(p[:, 2] - p[:, 0])
        self.s_ok = torch.as_tensor(slot_piece >= 0, device=self.dev)
        # a slot's parent triangle, and its corners in the parent's (b1, b2)
        self.slot_tri = torch.as_tensor(np.where(slot_piece >= 0, parent[sp_], -1),
                                        device=self.dev)
        self.s_bary = f(bary[sp_])
        self.p0 = f(sd.tris[:, 0])
        self.e1 = f(sd.tris[:, 1] - sd.tris[:, 0])
        self.e2 = f(sd.tris[:, 2] - sd.tris[:, 0])
        self.nrm = f(sd.normals)
        self.has_n = torch.as_tensor(sd.has_n, device=self.dev)
        self.mat = torch.as_tensor(sd.mat, device=self.dev)
        self.emit = f(sd.emit)
        m = sd.materials
        self.m_kind = torch.as_tensor([x["kind"] for x in m], device=self.dev)
        self.m_kd = f([x["kd"] for x in m])
        self.m_ks = f([x["ks"] for x in m])
        self.m_alpha = f([roughness_to_alpha(x["rough"]) for x in m])
        self.m_eta = f([x["eta"] for x in m])
        self.m_meta = f([x["metal_eta"] for x in m])
        self.m_mk = f([x["metal_k"] for x in m])
        # lights: one slot each for the distant lights, the infinite lights
        # (summed) and the area triangles (together, chosen by area)
        lit = np.nonzero(sd.emit.max(1) > 0)[0]
        self.area_tri = torch.as_tensor(lit, device=self.dev)
        ar = 0.5 * np.linalg.norm(np.cross(sd.tris[lit, 1] - sd.tris[lit, 0],
                                           sd.tris[lit, 2] - sd.tris[lit, 0]),
                                  axis=1)
        self.area_total = float(ar.sum())
        self.area_cdf = f(np.cumsum(ar) / max(ar.sum(), 1e-30))
        self.sun = [(f(w), f(L)) for w, L in sd.distant]
        self.sky = f(np.sum(sd.infinite, 0)) if sd.infinite else None
        self.n_slots = len(self.sun) + (self.sky is not None) + (len(lit) > 0)
        self.p_sel = 1.0 / max(self.n_slots, 1)
        # camera
        aspect = sd.width / sd.height
        sx, sy = (aspect, 1.0) if aspect > 1 else (1.0, 1.0 / aspect)
        self.screen = (sx, sy)
        self.tan_half = math.tan(math.radians(sd.fov) / 2)
        self.c2w = f(sd.cam_to_world)

    # -- traversal --------------------------------------------------------

    def intersect(self, o, d, t_max):
        """Closest hit of rays (N,3) with t in (0, t_max) -> (t, tri (-1:
        none), b1, b2), in chunks of RAY_CHUNK rays."""
        outs = [self._intersect_chunk(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK],
                                      t_max[s:s + RAY_CHUNK])
                for s in range(0, o.shape[0], RAY_CHUNK)]
        return tuple(torch.cat(x) for x in zip(*outs))

    def _intersect_chunk(self, o, d, t_max):
        """The tree walked breadth first: level by level, every (ray, node)
        pair whose box the ray enters before t_max becomes the pairs of the
        node's children; at the leaves every pair tests its triangles, and
        each ray keeps its nearest hit."""
        N, dev, dt = o.shape[0], self.dev, self.dt
        inv = 1 / torch.where(torch.abs(d) > 1e-30, d, torch.full_like(d, 1e-30))
        ray = torch.arange(N, device=dev)
        node = torch.zeros(N, dtype=torch.int64, device=dev)
        for level in range(self.levels):
            if level:
                node = torch.stack([2 * node + 1, 2 * node + 2], 1).reshape(-1)
                ray = ray.repeat_interleave(2)
            oo, iv = o[ray], inv[ray]
            t0 = (self.lo[node] - oo) * iv
            t1 = (self.hi[node] - oo) * iv
            tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0)
            tf = torch.maximum(t0, t1).amin(-1)
            keep = (tn <= tf) & (tn < t_max[ray]) & self.nonempty[node]
            ray, node = ray[keep], node[keep]
        slots = ((node - (self.n_leaves - 1))[:, None] * LEAF
                 + torch.arange(LEAF, device=dev))
        p0, e1, e2 = self.s_p0[slots], self.s_e1[slots], self.s_e2[slots]
        dv = d[ray][:, None]
        pv = _cross(dv, e2)
        det = _dot(e1, pv)
        idet = 1 / torch.where(det == 0, torch.full_like(det, 1e-30), det)
        tv = o[ray][:, None] - p0
        u = _dot(tv, pv) * idet
        qv = _cross(tv, e1)
        v = _dot(dv, qv) * idet
        t = _dot(e2, qv) * idet
        ok = (self.s_ok[slots] & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > 0) & (t < t_max[ray][:, None]))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        tb, kb = t.min(1)
        best = torch.full((N,), float("inf"), dtype=dt, device=dev)
        best = best.scatter_reduce(0, ray, tb, "amin")
        win = torch.isfinite(tb) & (tb == best[ray])
        ray_w, kb_w = ray[win], kb[win][:, None]
        sb = slots[win].gather(1, kb_w)[:, 0]
        ub, vb = u[win].gather(1, kb_w)[:, 0], v[win].gather(1, kb_w)[:, 0]
        cb = self.s_bary[sb]                  # the piece's corners in its parent
        pb = ((1 - ub - vb)[:, None] * cb[:, 0] + ub[:, None] * cb[:, 1]
              + vb[:, None] * cb[:, 2])
        t_out = torch.where(torch.isfinite(best), best, t_max)
        tri = torch.full((N,), -1, dtype=torch.int64, device=dev)
        b1 = torch.zeros(N, dtype=dt, device=dev)
        b2 = torch.zeros(N, dtype=dt, device=dev)
        tri[ray_w] = self.slot_tri[sb]
        b1[ray_w] = pb[:, 0]
        b2[ray_w] = pb[:, 1]
        return t_out, tri, b1, b2

    def occluded(self, o, d, t_max):
        return self.intersect(o, d, t_max)[1] >= 0

    # -- BSDFs (local shading frame, +z the shading normal) ---------------

    def _bsdf_f(self, m, wo, wi, reflect):
        """Sum of the non-specular lobes (pbrt-v3 BSDF::f)."""
        kind = self.m_kind[m]
        kd, ks = self.m_kd[m], self.m_ks[m]
        alpha = self.m_alpha[m]
        diff = ((kind == MATTE) | (kind == PLASTIC) | (kind == UBER))
        f = torch.where((diff & reflect)[:, None], kd / math.pi,
                        torch.zeros_like(kd))
        wh = wo + wi
        ok = (wo[:, 2] != 0) & (wi[:, 2] != 0) & (torch.abs(wh).amax(-1) > 0)
        wh = _normalize(wh)
        # the Fresnel term of the half vector as wi meets it (pbrt-v3-IILE's
        # microfacet.cpp: no Faceforward of wh, so plastic's reversed
        # indices total-internally reflect from either side)
        cos_h = _dot(wi, wh)
        one = torch.ones_like(alpha)
        eta = self.m_eta[m]
        fr_pl = _fr_dielectric(cos_h, eta, one)[:, None]     # plastic.cpp
        fr_ub = _fr_dielectric(cos_h, one, eta)[:, None]     # uber.cpp
        fr_mt = _fr_conductor(cos_h, self.m_meta[m], self.m_mk[m])
        fr = torch.where((kind == PLASTIC)[:, None], fr_pl,
                         torch.where((kind == METAL)[:, None], fr_mt, fr_ub))
        spec = torch.where((kind == METAL)[:, None], torch.ones_like(ks), ks)
        g = 1 / (1 + _tr_lambda(wo, alpha) + _tr_lambda(wi, alpha))
        val = _tr_d(wh, alpha) * g / (4 * torch.abs(wi[:, 2] * wo[:, 2]))
        gl = (((kind == PLASTIC) | (kind == UBER)) & (ks.amax(-1) > 0)) | (kind == METAL)
        use = gl & ok & reflect
        f = f + torch.where(use[:, None], spec * fr * val[:, None],
                            torch.zeros_like(f))
        return f

    def _lobes(self, m):
        kind = self.m_kind[m]
        diff = (((kind == MATTE) | (kind == PLASTIC) | (kind == UBER))
                & (self.m_kd[m].amax(-1) > 0))
        gloss = ((((kind == PLASTIC) | (kind == UBER)) & (self.m_ks[m].amax(-1) > 0))
                 | (kind == METAL))
        return diff, gloss

    def _bsdf_pdf(self, m, wo, wi):
        """pbrt-v3 BSDF::Pdf over the non-specular lobes, with the glossy
        lobe sampled from the full distribution D(wh) |cos theta_h|."""
        diff, gloss = self._lobes(m)
        n = diff.to(self.dt) + gloss.to(self.dt)
        same = wo[:, 2] * wi[:, 2] > 0
        p_d = torch.abs(wi[:, 2]) / math.pi
        wh = _normalize(wo + wi)
        p_g = (_tr_d(wh, self.m_alpha[m]) * torch.abs(wh[:, 2])
               / (4 * torch.abs(_dot(wo, wh))))
        p = (torch.where(diff, p_d, torch.zeros_like(p_d))
             + torch.where(gloss, p_g, torch.zeros_like(p_g)))
        return torch.where(same & (n > 0), p / torch.clamp(n, min=1), torch.zeros_like(p))

    # -- estimator ---------------------------------------------------------

    def _rand(self, gen, *shape):
        return torch.rand(shape, generator=gen, device=self.dev).to(self.dt)

    def camera_rays(self, pix, gen):
        W, H = self.sd.width, self.sd.height
        x = (pix % W).to(self.dt) + self._rand(gen, pix.shape[0])
        y = (pix // W).to(self.dt) + self._rand(gen, pix.shape[0])
        sx, sy = self.screen
        px = (-sx + x / W * (2 * sx)) * self.tan_half
        py = (sy - y / H * (2 * sy)) * self.tan_half
        dc = _normalize(torch.stack([px, py, torch.ones_like(px)], -1))
        d = _normalize(dc @ self.c2w[:3, :3].T)
        o = self.c2w[:3, 3].expand_as(d).clone()
        return o, d

    def _light_pdf_area(self, t, cos_l):
        return self.p_sel * t * t / (torch.abs(cos_l) * self.area_total)

    def trace(self, o, d, gen):
        """Radiance (N,3) of one path per ray."""
        dev, dt = self.dev, self.dt
        N = o.shape[0]
        L = torch.zeros((N, 3), dtype=dt, device=dev)
        beta = torch.ones((N, 3), dtype=dt, device=dev)
        spec = torch.ones(N, dtype=torch.bool, device=dev)  # camera ray
        prev_pdf = torch.ones(N, dtype=dt, device=dev)
        lane = torch.arange(N, device=dev)
        big = torch.full((N,), 1e30, dtype=dt, device=dev)
        inv4pi = 1 / (4 * math.pi)
        for bounce in range(self.sd.max_depth + 1):
            n = lane.shape[0]
            if n == 0:
                break
            t, tri, b1, b2 = self.intersect(o, d, big[:n])
            hit = tri >= 0
            # escaped rays: the infinite light, MIS-weighted after a
            # non-specular bounce
            if self.sky is not None:
                pl = self.p_sel * inv4pi
                w = torch.where(spec, torch.ones_like(prev_pdf),
                                prev_pdf ** 2 / (prev_pdf ** 2 + pl * pl))
                add = torch.where((~hit)[:, None], beta * self.sky * w[:, None],
                                  torch.zeros_like(beta))
                L.index_add_(0, lane, add)
            keep = hit
            lane, o, d, beta, spec, prev_pdf = (x[keep] for x in (
                lane, o, d, beta, spec, prev_pdf))
            t, tri, b1, b2 = t[keep], tri[keep], b1[keep], b2[keep]
            n = lane.shape[0]
            if n == 0:
                break
            e1, e2 = self.e1[tri], self.e2[tri]
            p = self.p0[tri] + b1[:, None] * e1 + b2[:, None] * e2
            ng = _normalize(_cross(e1, e2))
            nv = self.nrm[tri]
            ns = _normalize((1 - b1 - b2)[:, None] * nv[:, 0] + b1[:, None] * nv[:, 1]
                            + b2[:, None] * nv[:, 2])
            hn = self.has_n[tri]
            ns = torch.where(hn[:, None], ns, ng)
            ng_s = torch.where((hn & (_dot(ng, ns) < 0))[:, None], -ng, ng)
            # emission of an area light, on the side of its normal
            le = self.emit[tri]
            cos_l = _dot(ng, -d)
            if self.area_total > 0:
                pl = self._light_pdf_area(t, cos_l)
                w = torch.where(spec, torch.ones_like(prev_pdf),
                                prev_pdf ** 2 / (prev_pdf ** 2 + pl * pl))
                add = torch.where((cos_l > 0)[:, None], beta * le * w[:, None],
                                  torch.zeros_like(beta))
                L.index_add_(0, lane, add)
            if bounce == self.sd.max_depth:
                break
            m = self.mat[tri]
            # shading frame
            a = torch.where((torch.abs(ns[:, 0]) > 0.9)[:, None],
                            torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev),
                            torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev))
            ss = _normalize(_cross(a, ns))
            ts = _cross(ns, ss)
            to_loc = lambda v: torch.stack([_dot(v, ss), _dot(v, ts), _dot(v, ns)], -1)
            to_w = lambda v: (v[:, 0:1] * ss + v[:, 1:2] * ts + v[:, 2:3] * ns)
            wo_w = -d
            wo = to_loc(wo_w)
            kind = self.m_kind[m]
            glass = kind == GLASS
            diff, gloss = self._lobes(m)
            smooth = diff | gloss
            # next-event estimation: one light slot, uniformly
            u_l = self._rand(gen, n)
            slot = torch.clamp((u_l * self.n_slots).to(torch.int64), max=self.n_slots - 1)
            wi_w = torch.zeros_like(d)
            li = torch.zeros_like(beta)
            pdf_l = torch.ones_like(prev_pdf)
            t_sh = torch.full_like(prev_pdf, 1e30)
            delta = torch.zeros(n, dtype=torch.bool, device=dev)
            k = 0
            for w_sun, L_sun in self.sun:
                sel = slot == k
                wi_w = torch.where(sel[:, None], w_sun.expand_as(d), wi_w)
                li = torch.where(sel[:, None], L_sun.expand_as(beta), li)
                delta = delta | sel
                k += 1
            if self.sky is not None:
                sel = slot == k
                u = self._rand(gen, n, 2)
                z = 1 - 2 * u[:, 0]
                r = torch.sqrt(torch.clamp(1 - z * z, min=0))
                ph = 2 * math.pi * u[:, 1]
                ws = torch.stack([r * torch.cos(ph), r * torch.sin(ph), z], -1)
                wi_w = torch.where(sel[:, None], ws, wi_w)
                li = torch.where(sel[:, None], self.sky.expand_as(beta), li)
                pdf_l = torch.where(sel, torch.full_like(pdf_l, inv4pi), pdf_l)
                k += 1
            if self.area_total > 0:
                sel = slot == k
                u = self._rand(gen, n, 3)
                j = torch.clamp(torch.searchsorted(self.area_cdf, u[:, 0].contiguous(),
                                                   right=True),
                                max=self.area_tri.numel() - 1)
                at = self.area_tri[j]
                su = torch.sqrt(u[:, 1])
                c0, c1 = 1 - su, u[:, 2] * su
                # barycentrics: c0 on p0, c1 on p1, the rest on p2
                q = self.p0[at] * c0[:, None] + (self.p0[at] + self.e1[at]) * c1[:, None] \
                    + (self.p0[at] + self.e2[at]) * (1 - c0 - c1)[:, None]
                v = q - p
                dist = torch.linalg.vector_norm(v, dim=-1)
                wq = v / torch.clamp(dist, min=1e-30)[:, None]
                nl = _normalize(_cross(self.e1[at], self.e2[at]))
                cq = _dot(nl, -wq)
                wi_w = torch.where(sel[:, None], wq, wi_w)
                li = torch.where((sel & (cq > 0))[:, None], self.emit[at], li)
                pdf_l = torch.where(sel, dist * dist / torch.clamp(
                    torch.abs(cq) * self.area_total, min=1e-30), pdf_l)
                t_sh = torch.where(sel, dist * (1 - SHADOW_EPS), t_sh)
            wi = to_loc(wi_w)
            reflect = _dot(wi_w, ng_s) * _dot(wo_w, ng_s) > 0
            f = self._bsdf_f(m, wo, wi, reflect)
            p_b = self._bsdf_pdf(m, wo, wi)
            pl = self.p_sel * pdf_l
            w = torch.where(delta, torch.ones_like(pl), pl * pl / (pl * pl + p_b * p_b))
            contrib = beta * f * li * (torch.abs(wi[:, 2]) * w / pl)[:, None]
            want = smooth & (contrib.amax(-1) > 0)
            if bool(want.any()):
                ws_ = want.nonzero()[:, 0]
                side = torch.where(_dot(wi_w[ws_], ng_s[ws_]) > 0, 1.0, -1.0).to(dt)
                o_sh = p[ws_] + (RAY_EPS * side)[:, None] * ng_s[ws_]
                blocked = self.occluded(o_sh, wi_w[ws_], t_sh[ws_])
                add = torch.where(blocked[:, None], torch.zeros_like(contrib[ws_]),
                                  contrib[ws_])
                L.index_add_(0, lane[ws_], add)
            # continuation: sample the BSDF
            u = self._rand(gen, n, 3)
            pick_d = diff & (~gloss | (u[:, 0] < 0.5))
            # diffuse: cosine hemisphere on wo's side
            r = torch.sqrt(u[:, 1])
            ph = 2 * math.pi * u[:, 2]
            wd = torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                              torch.sqrt(torch.clamp(1 - u[:, 1], min=0))], -1)
            wd = torch.where((wo[:, 2] < 0)[:, None], wd * torch.tensor(
                [1.0, 1.0, -1.0], dtype=dt, device=dev), wd)
            # glossy: wh from D(wh) |cos theta_h|, mirrored about wh
            al = self.m_alpha[m]
            tan2 = al * al * u[:, 1] / torch.clamp(1 - u[:, 1], min=1e-30)
            ch = 1 / torch.sqrt(1 + tan2)
            sh = torch.sqrt(torch.clamp(1 - ch * ch, min=0))
            wh = torch.stack([sh * torch.cos(ph), sh * torch.sin(ph), ch], -1)
            wh = torch.where((wo[:, 2] < 0)[:, None], -wh, wh)
            wg = -wo + 2 * _dot(wo, wh)[:, None] * wh
            wi_n = torch.where(pick_d[:, None], wd, wg)
            wi_nw = to_w(wi_n)
            refl_n = _dot(wi_nw, ng_s) * _dot(wo_w, ng_s) > 0
            f_n = self._bsdf_f(m, wo, wi_n, refl_n)
            pdf_n = self._bsdf_pdf(m, wo, wi_n)
            ok_n = smooth & (pdf_n > 0) & (f_n.amax(-1) > 0)
            thr = f_n * (torch.abs(wi_n[:, 2]) / torch.clamp(pdf_n, min=1e-30))[:, None]
            # glass: Fresnel-weighted choice of mirror reflection and refraction
            eta = self.m_eta[m]
            one = torch.ones_like(eta)
            cos_o = wo[:, 2]
            F = _fr_dielectric(cos_o, one, eta)
            refl_g = u[:, 0] < F
            entering = cos_o > 0
            e_ratio = torch.where(entering, one / eta, eta)       # eta_i / eta_t
            nz = torch.where(entering, one, -one)
            cos_i = torch.abs(cos_o)
            sin2_t = e_ratio * e_ratio * torch.clamp(1 - cos_i * cos_i, min=0)
            cos_t = torch.sqrt(torch.clamp(1 - sin2_t, min=0))
            wt = -e_ratio[:, None] * wo + (e_ratio * cos_i - cos_t)[:, None] * (
                torch.stack([torch.zeros_like(nz), torch.zeros_like(nz), nz], -1))
            wr = wo * torch.tensor([-1.0, -1.0, 1.0], dtype=dt, device=dev)
            wi_g = torch.where(refl_g[:, None], wr, wt)
            thr_g = torch.where(refl_g, one, e_ratio * e_ratio)[:, None].expand_as(beta)
            ok_g = glass & (refl_g | (sin2_t < 1))
            wi_n = torch.where(glass[:, None], wi_g, wi_n)
            thr = torch.where(glass[:, None], thr_g, thr)
            ok = torch.where(glass, ok_g, ok_n)
            beta = beta * thr
            new_d = _normalize(to_w(wi_n))
            side = torch.where(_dot(new_d, ng_s) > 0, 1.0, -1.0).to(dt)
            o = p + (RAY_EPS * side)[:, None] * ng_s
            d = new_d
            spec = glass
            prev_pdf = torch.where(glass, one, pdf_n)
            # Russian roulette (pbrt-v3: from the bounce after the third)
            if bounce > 3:
                q = torch.clamp(1 - beta.amax(-1), min=0.05)
                live = self._rand(gen, n) >= q
                beta = beta / torch.clamp(1 - q, min=1e-30)[:, None]
                ok = ok & live
            ok = ok & torch.isfinite(beta).all(-1)
            lane, o, d, beta, spec, prev_pdf = (x[ok] for x in (
                lane, o, d, beta, spec, prev_pdf))
        return L


def render(sd: SceneData, spp: int, seed: int, device, dtype=torch.float32,
           chunk: int = 1 << 21):
    """Image (H, W, 3) float32 of ``spp`` paths a pixel, on ``device``;
    the random numbers come from a torch.Generator seeded with seed."""
    tr = Tracer(sd, device, dtype)
    gen = torch.Generator(device=tr.dev)
    gen.manual_seed(int(seed) % (1 << 63))
    HW = sd.width * sd.height
    img = torch.zeros((HW, 3), dtype=torch.float32, device=tr.dev)
    total = HW * spp
    for s in range(0, total, chunk):
        pix = torch.arange(s, min(s + chunk, total), device=tr.dev) % HW
        o, d = tr.camera_rays(pix, gen)
        Lr = tr.trace(o, d, gen).float()
        Lr = torch.nan_to_num(Lr, nan=0.0, posinf=0.0, neginf=0.0)
        img.index_add_(0, pix, Lr)
    return (img / spp).reshape(sd.height, sd.width, 3)
