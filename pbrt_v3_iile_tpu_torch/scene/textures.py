"""Texture table: host build + device evaluation (port of ``scene/textures.py``).

Ported kinds: constant, scale, mix, checkerboard and imagemap (one
atlas of N_MIPS block-replicated mip levels per image, trilinear lookup
by ray-cone width).  Ptex, the noise textures (fbm, wrinkled, windy,
marble), dots, uv and bilerp raise NotImplementedError: they wait for
ROADMAP Queue 1's textures item.  The reference module imports jax at
the top, so its numpy helpers are carried here as copies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import log

TEX_CONST = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_CHECKER = 3
TEX_IMAGE = 5

ATLAS_RES = 256
N_MIPS = 6

KIND_IDS = {"constant": TEX_CONST, "scale": TEX_SCALE, "mix": TEX_MIX,
            "checkerboard": TEX_CHECKER, "imagemap": TEX_IMAGE}


@dataclass
class TextureTable:
    kind: torch.Tensor     # (X,) i32
    v1: torch.Tensor       # (X,3)
    v2: torch.Tensor       # (X,3)
    child1: torch.Tensor   # (X,) i32 nested texture id or -1
    child2: torch.Tensor   # (X,) i32
    uscale: torch.Tensor   # (X,)
    vscale: torch.Tensor   # (X,)
    img: torch.Tensor      # (X,) i32 atlas image index or -1
    octaves: torch.Tensor  # (X,) (mix amount)
    omega: torch.Tensor    # (X,)
    atlas: torch.Tensor    # (I*N_MIPS, R, R, 3)

    def leaves(self):
        return {f"textures.{k}": v for k, v in vars(self).items()}


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
    names = list(named_textures.keys())
    name_to_id = {n: i for i, n in enumerate(names)}
    for i, n in enumerate(names):
        rec = named_textures[n]
        ps = rec.params
        if rec.kind not in KIND_IDS:
            raise NotImplementedError(
                f"texture kind {rec.kind!r} is not ported yet (ROADMAP "
                "Queue 1, textures: ptex, noise and procedural kinds)")
        kind[i] = KIND_IDS[rec.kind]
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
    atlas = (np.concatenate([_mip_pyramid(im) for im in atlas_imgs])
             if atlas_imgs
             else np.zeros((N_MIPS, ATLAS_RES, ATLAS_RES, 3), np.float32))
    return dict(kind=kind, v1=v1, v2=v2, child1=c1, child2=c2, uscale=us,
                vscale=vs, img=imgid, octaves=octv, omega=omga,
                atlas=atlas), name_to_id


def table_from_numpy(leaves: dict, device) -> TextureTable:
    f = {}
    for k in TextureTable.__dataclass_fields__:
        a = np.asarray(leaves[k])
        a = a.astype(np.int32 if a.dtype.kind in "iub" else np.float32)
        f[k] = torch.as_tensor(a, device=device)
    return TextureTable(**f)


def _eval_leaf(tt: TextureTable, tid, uv, width=None):
    """Evaluate without nesting (children as the constants v1/v2)."""
    kind = tt.kind[tid]
    v1 = tt.v1[tid]
    v2 = tt.v2[tid]
    us = tt.uscale[tid]
    vs = tt.vscale[tid]
    u = uv[..., 0] * us
    v = uv[..., 1] * vs
    out = v1
    check = torch.remainder((torch.floor(u) + torch.floor(v)).to(torch.int32),
                            2) == 0
    out = torch.where((kind == TEX_CHECKER)[..., None],
                      torch.where(check[..., None], v1, v2), out)

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

    if bool((kind == TEX_IMAGE).any()):
        imgv = (1 - af) * bil(l0) + af * bil(l1)
        out = torch.where((kind == TEX_IMAGE)[..., None], imgv, out)
    amt = tt.octaves[tid][..., None]
    out = torch.where((kind == TEX_MIX)[..., None], v1 * (1 - amt) + v2 * amt,
                      out)
    out = torch.where((kind == TEX_SCALE)[..., None], v1 * v2, out)
    return out


def eval_texture(tt: TextureTable, tid, uv, width=None):
    """Evaluate texture ids (N,) at uv (N,2) -> (N,3); nested scale / mix /
    checkerboard children are resolved one level deep."""
    tid_c = torch.clamp(tid, min=0).long()
    base = _eval_leaf(tt, tid_c, uv, width)
    c1 = tt.child1[tid_c]
    c2 = tt.child2[tid_c]
    has_child = (c1 >= 0) | (c2 >= 0)
    v1c = torch.where((c1 >= 0)[..., None],
                      _eval_leaf(tt, torch.clamp(c1, min=0).long(), uv, width),
                      tt.v1[tid_c])
    v2c = torch.where((c2 >= 0)[..., None],
                      _eval_leaf(tt, torch.clamp(c2, min=0).long(), uv, width),
                      tt.v2[tid_c])
    kind = tt.kind[tid_c]
    u = uv[..., 0] * tt.uscale[tid_c]
    v = uv[..., 1] * tt.vscale[tid_c]
    check = torch.remainder((torch.floor(u) + torch.floor(v)).to(torch.int32),
                            2) == 0
    nested = torch.where((kind == TEX_SCALE)[..., None], v1c * v2c, base)
    nested = torch.where((kind == TEX_CHECKER)[..., None],
                         torch.where(check[..., None], v1c, v2c), nested)
    amt = tt.octaves[tid_c][..., None]
    nested = torch.where((kind == TEX_MIX)[..., None],
                         v1c * (1 - amt) + v2c * amt, nested)
    out = torch.where(has_child[..., None], nested, base)
    return torch.where((tid >= 0)[..., None], out, torch.zeros_like(out))
