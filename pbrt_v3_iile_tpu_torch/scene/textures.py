"""Texture table: host build + device evaluation (port of ``scene/textures.py``).

Every kind of the reference: constant, scale, mix, checkerboard, uv,
dots, bilerp, imagemap (one atlas of N_MIPS block-replicated mip levels
per image, trilinear lookup by ray-cone width), the hash-gradient Perlin
noises fbm, wrinkled, windy and marble on the world point, and ptex
(a flat pool of bordered per-face texels, ``scene/ptex.py``).  Nested
scale / mix / checkerboard children are resolved one level deep.  The
reference module imports jax at the top, so its numpy helpers are
carried here as copies.

Evaluation computes a kind only when the table holds it (``kinds``,
read once at build), and the Perlin noise of every octave a call needs
in one stacked evaluation shared by its kinds and children: the
reference evaluates every branch for every lane, which in eager torch
would be thousands of launches per lookup.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops import lds
from ..utils import log
from . import ptex as ptexlib

TEX_CONST = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_CHECKER = 3
TEX_UV = 4
TEX_IMAGE = 5
TEX_DOTS = 6
TEX_FBM = 7
TEX_WRINKLED = 8
TEX_MARBLE = 9
TEX_WINDY = 10
TEX_BILERP = 11
TEX_PTEX = 12

ATLAS_RES = 256
N_MIPS = 6

KIND_IDS = {
    "constant": TEX_CONST, "scale": TEX_SCALE, "mix": TEX_MIX,
    "checkerboard": TEX_CHECKER, "uv": TEX_UV, "imagemap": TEX_IMAGE,
    "dots": TEX_DOTS, "fbm": TEX_FBM, "wrinkled": TEX_WRINKLED,
    "marble": TEX_MARBLE, "windy": TEX_WINDY, "bilerp": TEX_BILERP,
    "ptex": TEX_PTEX,
}
_NOISE_KINDS = (TEX_FBM, TEX_WRINKLED, TEX_MARBLE, TEX_WINDY)
MAX_OCTAVES = 8   # fbm / turbulence octaves evaluated (masked by octaves)
WIND_OCTAVES = 3  # windy's wind fbm, on 0.1 p
WAVE_OCTAVES = 6  # windy's wave fbm, on p


@dataclass
class TextureTable:
    kind: torch.Tensor         # (X,) i32
    v1: torch.Tensor           # (X,3)
    v2: torch.Tensor           # (X,3)
    child1: torch.Tensor       # (X,) i32 nested texture id or -1
    child2: torch.Tensor       # (X,) i32
    uscale: torch.Tensor       # (X,)
    vscale: torch.Tensor       # (X,)
    img: torch.Tensor          # (X,) i32 atlas image index or -1
    octaves: torch.Tensor      # (X,) noise octaves (mix amount)
    omega: torch.Tensor        # (X,) noise roughness
    atlas: torch.Tensor        # (I*N_MIPS, R, R, 3)
    ptex_base: torch.Tensor    # (X,) first face of the texture's file or -1
    ptex_off: torch.Tensor     # (F,) texel offset of each bordered face
    ptex_resu: torch.Tensor    # (F,)
    ptex_resv: torch.Tensor    # (F,)
    ptex_texels: torch.Tensor  # (P,3) flat pool

    def __post_init__(self):
        # the kinds present and whether any texture has a child: read once
        # here, so that evaluation skips what the table cannot need
        self.kinds = frozenset(int(k) for k in self.kind.cpu().tolist())
        self.nested = bool(((self.child1 >= 0) | (self.child2 >= 0)).any())

    def leaves(self):
        return {f"textures.{f.name}": getattr(self, f.name)
                for f in fields(self)}


def _load_image_any(path: str) -> np.ndarray:
    from ..utils import image as imglib

    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "pfm":
        img = imglib.read_pfm(path)
    elif ext == "exr":
        img = imglib.read_exr(path)
    elif ext in ("png", "tga"):
        raw = imglib.read_png(path) if ext == "png" else imglib.read_tga(path)
        img = raw.astype(np.float32) / 255.0
        img = np.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4)  # sRGB -> linear
    else:
        raise ValueError(f"unsupported texture format: {path}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3].astype(np.float32)


def _resample(img: np.ndarray, res: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(res) + 0.5) * h / res - 0.5
    xs = (np.arange(res) + 0.5) * w / res - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    return ((1 - fy) * (1 - fx) * img[y0][:, x0]
            + (1 - fy) * fx * img[y0][:, x1]
            + fy * (1 - fx) * img[y1][:, x0]
            + fy * fx * img[y1][:, x1]).astype(np.float32)


def _mip_pyramid(img: np.ndarray) -> np.ndarray:
    """(R,R,3) -> (N_MIPS,R,R,3) 2x2 box chain, each level block-replicated
    back to R so one gather formula serves every level."""
    levels = [img.astype(np.float32)]
    cur = img
    for k in range(1, N_MIPS):
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                      + cur[0::2, 1::2] + cur[1::2, 1::2])
        levels.append(np.repeat(np.repeat(cur, 2 ** k, axis=0),
                                2 ** k, axis=1).astype(np.float32))
    return np.stack(levels)


def build_table_np(named_textures: dict) -> tuple[dict, dict]:
    """named_textures: name -> TextureRecord.  Returns (numpy leaves,
    name -> id map), with the reference's padding rules."""
    X = max(len(named_textures), 1)
    kind = np.zeros(X, np.int32)
    v1 = np.zeros((X, 3), np.float32)
    v2 = np.zeros((X, 3), np.float32)
    c1 = np.full(X, -1, np.int32)
    c2 = np.full(X, -1, np.int32)
    us = np.ones(X, np.float32)
    vs = np.ones(X, np.float32)
    imgid = np.full(X, -1, np.int32)
    octv = np.full(X, 8.0, np.float32)
    omga = np.full(X, 0.5, np.float32)
    atlas_imgs = []
    ptex_files, ptex_tex_slot = [], []
    names = list(named_textures.keys())
    name_to_id = {n: i for i, n in enumerate(names)}
    for i, n in enumerate(names):
        rec = named_textures[n]
        ps = rec.params
        kind[i] = KIND_IDS.get(rec.kind, TEX_CONST)
        us[i] = rec.uscale
        vs[i] = rec.vscale
        octv[i] = ps.find_one_int("octaves", 8)
        omga[i] = ps.find_one_float("roughness", ps.find_one_float("omega", 0.5))

        def val_or_child(pname, default, slot):
            t = ps.find_texture_name(pname)
            if t is not None and t in name_to_id:
                (c1 if slot == 1 else c2)[i] = name_to_id[t]
                return np.asarray(default, np.float32)
            return ps.find_one_rgb(pname, default).astype(np.float32)

        if rec.kind == "constant":
            v1[i] = ps.find_one_rgb("value", [1, 1, 1])
        elif rec.kind == "scale":
            v1[i] = val_or_child("tex1", [1, 1, 1], 1)
            v2[i] = val_or_child("tex2", [1, 1, 1], 2)
        elif rec.kind == "mix":
            v1[i] = val_or_child("tex1", [0, 0, 0], 1)
            v2[i] = val_or_child("tex2", [1, 1, 1], 2)
            octv[i] = ps.find_one_float("amount", 0.5)
        elif rec.kind == "checkerboard":
            v1[i] = val_or_child("tex1", [1, 1, 1], 1)
            v2[i] = val_or_child("tex2", [0, 0, 0], 2)
        elif rec.kind == "dots":
            v1[i] = val_or_child("inside", [1, 1, 1], 1)
            v2[i] = val_or_child("outside", [0, 0, 0], 2)
        elif rec.kind == "bilerp":
            v1[i] = ps.find_one_rgb("v00", [0, 0, 0])
            v2[i] = ps.find_one_rgb("v11", [1, 1, 1])
        elif rec.kind == "imagemap":
            fn = ps.find_one_string("filename", "")
            try:
                img = _load_image_any(fn)
                atlas_imgs.append(_resample(img, ATLAS_RES))
                imgid[i] = len(atlas_imgs) - 1
            except (OSError, ValueError) as e:  # missing/unsupported -> gray
                log.warning(f"texture {fn}: {e}; using 0.5 constant")
                kind[i] = TEX_CONST
                v1[i] = [0.5, 0.5, 0.5]
        elif rec.kind == "ptex":
            fn = ps.find_one_string("filename", "")
            gamma = ps.find_one_float("gamma", 2.2)
            try:
                pf = ptexlib.read_ptx(fn)
                if gamma != 1.0:
                    pf.faces = [np.power(np.maximum(f_, 0.0), gamma)
                                for f_ in pf.faces]
                ptex_files.append(pf)
                ptex_tex_slot.append(i)
            except (OSError, ValueError, struct.error, zlib.error) as e:
                log.warning(f"ptex {fn}: {e}; using 0.5 constant")
                kind[i] = TEX_CONST
                v1[i] = [0.5, 0.5, 0.5]
        elif rec.kind in ("fbm", "wrinkled", "windy", "marble"):
            v1[i] = [1.0, 1.0, 1.0]
            if rec.kind == "marble":
                v1[i] = [ps.find_one_float("scale", 1.0)] * 3
                v2[i] = [ps.find_one_float("variation", 0.2)] * 3
    ptex_base = np.full(X, -1, np.int32)
    if len(named_textures) == 0:
        us[:] = 1.0
        vs[:] = 1.0
    elif X == 1:
        # one dummy row, as the reference: "has textures" is kind.shape > 1
        pad = lambda a, v: np.concatenate([a, np.full((1,) + a.shape[1:], v,
                                                      a.dtype)])
        kind, v1, v2 = pad(kind, TEX_CONST), pad(v1, 0.0), pad(v2, 0.0)
        c1, c2, us, vs = pad(c1, -1), pad(c2, -1), pad(us, 1.0), pad(vs, 1.0)
        imgid, octv, omga = pad(imgid, -1), pad(octv, 8.0), pad(omga, 0.5)
        ptex_base = pad(ptex_base, -1)
    atlas = (np.concatenate([_mip_pyramid(im) for im in atlas_imgs])
             if atlas_imgs
             else np.zeros((N_MIPS, ATLAS_RES, ATLAS_RES, 3), np.float32))
    if ptex_files:
        bases, (p_off, p_ru, p_rv, p_tex) = ptexlib.build_face_tables(
            ptex_files)
        for slot, b in zip(ptex_tex_slot, bases):
            ptex_base[slot] = b
    else:
        p_off = np.zeros(1, np.int32)
        p_ru = np.ones(1, np.int32)
        p_rv = np.ones(1, np.int32)
        p_tex = np.zeros((1, 3), np.float32)
    return dict(kind=kind, v1=v1, v2=v2, child1=c1, child2=c2, uscale=us,
                vscale=vs, img=imgid, octaves=octv, omega=omga,
                atlas=atlas, ptex_base=ptex_base, ptex_off=p_off,
                ptex_resu=p_ru, ptex_resv=p_rv, ptex_texels=p_tex), name_to_id


def table_from_numpy(leaves: dict, device) -> TextureTable:
    f = {}
    for k in TextureTable.__dataclass_fields__:
        a = np.asarray(leaves[k])
        a = a.astype(np.int32 if a.dtype.kind in "iub" else np.float32)
        f[k] = torch.as_tensor(a, device=device)
    return TextureTable(**f)


# ---------------------------------------------------------------------------
# Perlin noise (hash-gradient; texture.cpp Noise / FBm / Turbulence roles).
# Integers are u32 values in int64 (ops/lds.py), wrapped as the
# reference's uint32 casts wrap them.
# ---------------------------------------------------------------------------

def _hash3(ix, iy, iz):
    h = (lds.mul32(lds.u32(ix), 0x9E3779B1) ^ lds.mul32(lds.u32(iy), 0x85EBCA77)
         ^ lds.mul32(lds.u32(iz), 0xC2B2AE3D))
    h = h ^ (h >> 15)
    h = lds.mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def _grad(ix, iy, iz, fx, fy, fz):
    h = _hash3(ix, iy, iz) & 15
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def perlin(p):
    """p: (..., 3) -> noise in about [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    ix = pi[..., 0].to(torch.int32)
    iy = pi[..., 1].to(torch.int32)
    iz = pi[..., 2].to(torch.int32)
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    w = pf * pf * pf * (pf * (pf * 6.0 - 15.0) + 10.0)  # smootherstep
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    def g(dx, dy, dz):
        return _grad(ix + dx, iy + dy, iz + dz, fx - dx, fy - dy, fz - dz)

    lerp = lambda t, a, b: a + t * (b - a)
    x00 = lerp(wx, g(0, 0, 0), g(1, 0, 0))
    x10 = lerp(wx, g(0, 1, 0), g(1, 1, 0))
    x01 = lerp(wx, g(0, 0, 1), g(1, 0, 1))
    x11 = lerp(wx, g(0, 1, 1), g(1, 1, 1))
    y0 = lerp(wy, x00, x10)
    y1 = lerp(wy, x01, x11)
    return lerp(wz, y0, y1)


def _octave_points(p, n: int):
    """(n, ..., 3): p times the lacunarity 1.99^i of octave i (each product
    in float32, as the reference scales p once per octave)."""
    lams, lam = [], 1.0
    for _ in range(n):
        lams.append(lam)
        lam *= 1.99
    lam_t = torch.tensor(lams, dtype=p.dtype, device=p.device)
    return p[None] * lam_t.reshape((n,) + (1,) * p.dim())


def _octave_sum(noise, octaves, omega, absolute: bool):
    """sum_i [i < octaves] omega^i (|noise_i|) over the leading octave axis,
    accumulated in octave order as the reference accumulates it."""
    total = torch.zeros(noise.shape[1:], dtype=noise.dtype,
                        device=noise.device)
    o = 1.0
    for i in range(noise.shape[0]):
        n_i = torch.abs(noise[i]) if absolute else noise[i]
        total = total + torch.where(i < octaves, o * n_i,
                                    torch.zeros_like(n_i))
        o = o * omega
    return total


def fbm(p, octaves, omega, max_octaves: int = MAX_OCTAVES):
    return _octave_sum(perlin(_octave_points(p, max_octaves)), octaves, omega,
                       False)


def turbulence(p, octaves, omega, max_octaves: int = MAX_OCTAVES):
    return _octave_sum(perlin(_octave_points(p, max_octaves)), octaves, omega,
                       True)


def _noise_stack(tt: TextureTable, p):
    """Perlin noise at every octave point the table's noise kinds read:
    (MAX_OCTAVES, N) at p * 1.99^i and, with windy, (WIND_OCTAVES, N) at
    (0.1 p) * 1.99^i; one stacked evaluation.  None without noise kinds."""
    if not tt.kinds & set(_NOISE_KINDS):
        return None
    pts = [_octave_points(p, MAX_OCTAVES)]
    if TEX_WINDY in tt.kinds:
        pts.append(_octave_points(0.1 * p, WIND_OCTAVES))
    noise = perlin(torch.cat(pts))
    return noise[:MAX_OCTAVES], noise[MAX_OCTAVES:]


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _eval_leaf(tt: TextureTable, tid, uv, p, noise=None, width=None):
    """Evaluate without nesting (children as the constants v1/v2) at uv
    (N,2) and the world point p (N,3).  noise: ``_noise_stack(tt, p)``;
    width: (N,) UV-space filter footprint for imagemap's trilinear lookup
    (None: the finest level)."""
    kinds = tt.kinds
    kind = tt.kind[tid]
    v1 = tt.v1[tid]
    v2 = tt.v2[tid]
    us = tt.uscale[tid]
    vs = tt.vscale[tid]
    u = uv[..., 0] * us
    v = uv[..., 1] * vs
    out = v1
    is_k = lambda k: (kind == k)[..., None]
    if TEX_CHECKER in kinds:
        check = torch.remainder(
            (torch.floor(u) + torch.floor(v)).to(torch.int32), 2) == 0
        out = torch.where(is_k(TEX_CHECKER),
                          torch.where(check[..., None], v1, v2), out)
    if TEX_UV in kinds:
        uv_rgb = torch.stack([u - torch.floor(u), v - torch.floor(v),
                              torch.zeros_like(u)], dim=-1)
        out = torch.where(is_k(TEX_UV), uv_rgb, out)
    if TEX_DOTS in kinds:
        # one dot per cell, jittered by a hash of the cell (dots.h)
        scell = torch.floor(u + 0.5)
        tcell = torch.floor(v + 0.5)
        hsh = _hash3(scell.to(torch.int32), tcell.to(torch.int32),
                     torch.zeros_like(scell, dtype=torch.int32))
        rnd1 = (hsh & 0xFFFF).to(torch.float32) / 65535.0
        rnd2 = ((hsh >> 16) & 0xFFFF).to(torch.float32) / 65535.0
        has_dot = rnd1 < 0.5
        cx = scell + (rnd1 - 0.5) * 0.5
        cy = tcell + (rnd2 - 0.5) * 0.5
        inside = has_dot & (((u - cx) ** 2 + (v - cy) ** 2) < 0.35 ** 2)
        out = torch.where(is_k(TEX_DOTS),
                          torch.where(inside[..., None], v1, v2), out)
    if TEX_BILERP in kinds:
        # v00 = v1, v11 = v2, the two cross corners at their mean
        fu = u - torch.floor(u)
        fv = v - torch.floor(v)
        bil = (((1 - fu) * (1 - fv))[..., None] * v1
               + (fu * fv)[..., None] * v2
               + ((1 - fu) * fv + fu * (1 - fv))[..., None] * 0.5 * (v1 + v2))
        out = torch.where(is_k(TEX_BILERP), bil, out)
    if TEX_IMAGE in kinds:
        out = torch.where(is_k(TEX_IMAGE), _image_lookup(tt, tid, u, v, us, vs,
                                                          width), out)
    if noise is not None:
        octn = tt.octaves[tid]
        omg = tt.omega[tid]
        nz, nz_wind = noise
        fb = _octave_sum(nz, octn, omg, False)
        turb = _octave_sum(nz, octn, omg, True)
        out = torch.where(is_k(TEX_FBM), v1 * fb[..., None], out)
        out = torch.where(is_k(TEX_WRINKLED), v1 * turb[..., None], out)
        if TEX_WINDY in kinds:
            # windy.h: fbm(0.1 p, .5, 3) * |fbm(p, .5, 6)|
            half = torch.full_like(omg, 0.5)
            wind = _octave_sum(nz_wind, torch.full_like(octn, 3.0), half,
                               False)
            wave = torch.abs(_octave_sum(nz[:WAVE_OCTAVES],
                                         torch.full_like(octn, 6.0), half,
                                         False))
            out = torch.where(is_k(TEX_WINDY),
                              (wind * wave)[..., None] * torch.ones_like(v1),
                              out)
        if TEX_MARBLE in kinds:
            # a sine warp of the turbulence (marble.h's role, no palette)
            mrb = 0.5 + 0.5 * torch.sin(p[..., 1] * v1[..., 0]
                                        + v2[..., 0] * turb)
            out = torch.where(is_k(TEX_MARBLE),
                              mrb[..., None] * torch.ones_like(v1), out)
    amt = tt.octaves[tid][..., None]
    out = torch.where(is_k(TEX_MIX), v1 * (1 - amt) + v2 * amt, out)
    out = torch.where(is_k(TEX_SCALE), v1 * v2, out)
    return out


def _image_lookup(tt: TextureTable, tid, u, v, us, vs, width):
    """Trilinear mip lookup with repeat wrap (mipmap.h MIPMap::Lookup:
    level nLevels-1 + log2(width), bilinear at the two levels around it);
    every level is stored at ATLAS_RES, so the texel addresses share one
    formula."""
    img_id = torch.clamp(tt.img[tid], min=0)
    R = tt.atlas.shape[1]
    flat = tt.atlas.reshape(-1, 3)
    if width is None:
        lvl = torch.zeros_like(u)
    else:
        w = torch.clamp(width * torch.maximum(us, vs), min=1e-8)
        lvl = torch.clamp(torch.log2(w) + float(np.log2(float(R))), 0.0,
                          N_MIPS - 1.0)
    l0 = torch.floor(lvl).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=N_MIPS - 1)
    af = (lvl - l0)[..., None]

    def bil(lv):
        scale = torch.bitwise_left_shift(torch.ones_like(lv), lv)
        r_f = R / scale.to(u.dtype)
        fx = (u - torch.floor(u)) * r_f - 0.5
        fy = (v - torch.floor(v)) * r_f - 0.5
        x0 = torch.floor(fx).to(torch.int32)
        y0 = torch.floor(fy).to(torch.int32)
        ax = fx - x0
        ay = fy - y0
        r_i = R // scale
        x0m = torch.remainder(x0, r_i) * scale
        x1m = torch.remainder(x0 + 1, r_i) * scale
        y0m = torch.remainder(y0, r_i) * scale
        y1m = torch.remainder(y0 + 1, r_i) * scale
        base = (img_id * N_MIPS + lv) * (R * R)
        at = lambda xm, ym: flat[(base + ym * R + xm).long()]
        return (((1 - ax) * (1 - ay))[..., None] * at(x0m, y0m)
                + (ax * (1 - ay))[..., None] * at(x1m, y0m)
                + ((1 - ax) * ay)[..., None] * at(x0m, y1m)
                + (ax * ay)[..., None] * at(x1m, y1m))

    return (1 - af) * bil(l0) + af * bil(l1)


def _eval_ptex(tt: TextureTable, tid_c, uv, face):
    """Bilinear lookup of the hit's face in the flat ptex pool (ptex.cpp's
    eval by faceIndex).  Faces carry a 1-texel border ring from their
    neighbours (``ptex.build_face_tables``), so taps at -1 and res blend
    into the adjacent face."""
    F = tt.ptex_off.shape[0]
    fidx = torch.clamp(tt.ptex_base[tid_c] + face, 0, F - 1).long()
    off = tt.ptex_off[fidx]
    ru = tt.ptex_resu[fidx]
    rv = tt.ptex_resv[fidx]
    fu = torch.clamp(uv[..., 0], 0.0, 1.0) * ru.to(torch.float32) - 0.5
    fv = torch.clamp(uv[..., 1], 0.0, 1.0) * rv.to(torch.float32) - 0.5
    x0 = torch.minimum(torch.clamp(torch.floor(fu).to(torch.int32), min=-1),
                       ru - 1)
    y0 = torch.minimum(torch.clamp(torch.floor(fv).to(torch.int32), min=-1),
                       rv - 1)
    x1 = x0 + 1   # <= ru: lands in the border ring
    y1 = y0 + 1
    ax = torch.clamp(fu - x0, 0.0, 1.0)[..., None]
    ay = torch.clamp(fv - y0, 0.0, 1.0)[..., None]
    P = tt.ptex_texels.shape[0]
    stride = ru + 2   # bordered row stride
    tex = lambda x, y: tt.ptex_texels[
        torch.clamp(off + (y + 1) * stride + (x + 1), 0, P - 1).long()]
    return ((1 - ay) * ((1 - ax) * tex(x0, y0) + ax * tex(x1, y0))
            + ay * ((1 - ax) * tex(x0, y1) + ax * tex(x1, y1)))


def eval_texture(tt: TextureTable, tid, uv, p, width=None, face=None):
    """Evaluate texture ids (N,) at uv (N,2) and the world point p (N,3)
    -> (N,3); ids < 0 give 0.  Nested scale / mix / checkerboard children
    are resolved one level deep.  width: optional (N,) UV-space ray-cone
    footprint (mip selection); face: optional (N,) i32 ptex face index
    (without it a ptex texture reads as its constant row)."""
    tid_c = torch.clamp(tid, min=0).long()
    noise = _noise_stack(tt, p)
    base = _eval_leaf(tt, tid_c, uv, p, noise, width)
    kind = tt.kind[tid_c]
    if face is not None and tt.ptex_texels.shape[0] > 1:
        base = torch.where((kind == TEX_PTEX)[..., None],
                           _eval_ptex(tt, tid_c, uv, face), base)
    if tt.nested:
        c1 = tt.child1[tid_c]
        c2 = tt.child2[tid_c]
        has_child = (c1 >= 0) | (c2 >= 0)
        v1c = torch.where((c1 >= 0)[..., None],
                          _eval_leaf(tt, torch.clamp(c1, min=0).long(), uv, p,
                                     noise, width), tt.v1[tid_c])
        v2c = torch.where((c2 >= 0)[..., None],
                          _eval_leaf(tt, torch.clamp(c2, min=0).long(), uv, p,
                                     noise, width), tt.v2[tid_c])
        u = uv[..., 0] * tt.uscale[tid_c]
        v = uv[..., 1] * tt.vscale[tid_c]
        check = torch.remainder(
            (torch.floor(u) + torch.floor(v)).to(torch.int32), 2) == 0
        nested = torch.where((kind == TEX_SCALE)[..., None], v1c * v2c, base)
        nested = torch.where((kind == TEX_CHECKER)[..., None],
                             torch.where(check[..., None], v1c, v2c), nested)
        amt = tt.octaves[tid_c][..., None]
        nested = torch.where((kind == TEX_MIX)[..., None],
                             v1c * (1 - amt) + v2c * amt, nested)
        base = torch.where(has_child[..., None], nested, base)
    return torch.where((tid >= 0)[..., None], base, torch.zeros_like(base))
