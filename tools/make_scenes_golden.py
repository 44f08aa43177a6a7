"""Generates the goldens that hold the port's samplers, integrators,
textures and lights to the JAX package, with the JAX package on the CPU
(``render()`` on the BVH walker, accel "bvh"), and the data files the
scenes read.

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_scenes_golden.py [--only NAME ...]

Writes (the times are this tool's on an 8-core CPU):
  - scenes/atrium_gonio.pfm, scenes/atrium_proj.pfm: the goniometric and
    projection maps of scenes/atrium_features.pbrt; scenes/ptex_faces.ptx:
    the 4-face ptex of the PTEX_SCENE below (make_test_ptx, seed 0);
  - tests/golden/halton_streams.npz (35 s: one JAX program per
    dimension): 4,096 u32 indices (seed 0) and, for each of the 128
    dimensions, the SHA-256 of the float32 bytes of the JAX package's
    ``scrambled_radical_inverse`` and ``halton_dim`` on them, held bit
    for bit by tests/test_torch_lds_halton.py;
  - tests/golden/scenes16_<case>.npz (2-14 s each, mostly
    compilation): the 16^2 renders of TIER1 below, held by
    tests/test_torch_integrators_extra.py;
  - tests/golden/scenes128_<case>.npz (12 s for AO, about 1 min for
    halton-global and whitted, 2.5-3 min for the ptex and textured
    scenes): the 128^2, 16-spp renders of CHIP below, held by
    chip_smoke.py's phase 10.

Each render golden holds the image (float32) and the settings that made
it, so that the port's side reads everything from the file: ``scene``
(a file under scenes/, or the scene's text with ``{repo}`` for the
repository root), ``strip_sampler`` (drop the file's Sampler line, so
the scene gets pbrt's default, halton), ``overrides`` (JSON: attribute
paths of the parsed scene and their values), ``spp``, ``seed`` and
``accel``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
SCENES = os.path.join(REPO, "scenes")
sys.path.insert(0, REPO)

PTEX_SCENE = """
LookAt 0 4 -3  0 0 0.3  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [128] "integer yresolution" [128]
Integrator "path" "integer maxdepth" [4]
WorldBegin
LightSource "distant" "rgb L" [2.5 2.5 2.4] "point from" [1 5 -2] "point to" [0 0 0]
LightSource "infinite" "rgb L" [0.25 0.3 0.35]
AttributeBegin
  AreaLightSource "area" "rgb L" [12 11 10]
  Translate 0 2.2 1.5
  Shape "sphere" "float radius" [0.25]
AttributeEnd
Texture "faces" "color" "ptex" "string filename" "{repo}/scenes/ptex_faces.ptx"
    "float gamma" [1]
Material "matte" "texture Kd" "faces"
Shape "trianglemesh"
  "integer indices" [0 1 2 0 2 3  4 5 6 4 6 7  8 9 10 8 10 11  12 13 14 12 14 15]
  "integer faceIndices" [0 0 1 1 2 2 3 3]
  "point P" [-2 0 -2  0 0 -2  0 0 0  -2 0 0
             0 0 -2  2 0 -2  2 0 0  0 0 0
             -2 0 0  0 0 0  0 0 2  -2 0 2
             0 0 0  2 0 0  2 0 2  0 0 2]
  "float uv" [0 0 1 0 1 1 0 1  0 0 1 0 1 1 0 1  0 0 1 0 1 1 0 1  0 0 1 0 1 1 0 1]
Material "plastic" "rgb Kd" [0.3 0.3 0.35] "rgb Ks" [0.4 0.4 0.4]
    "float roughness" [0.05]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-2 0 2  2 0 2  2 2.5 2  -2 2.5 2]
WorldEnd
"""

# the 16^2 renders of the CPU tests: atrium on the BVH walker at 2-4 spp,
# depth 3 (as tests/test_torch_slice.py renders it) where paths bounce
_R16 = {"film.x_resolution": 16, "film.y_resolution": 16}
_R16D3 = dict(_R16, **{"integrator.max_depth": 3})
TIER1 = {
    "ao_cos": dict(scene="atrium.pbrt", spp=4, seed=0, overrides=dict(
        _R16, **{"integrator.kind": "ambientocclusion",
                 "integrator.cos_sample": True})),
    "ao_uniform": dict(scene="atrium.pbrt", spp=4, seed=0, overrides=dict(
        _R16, **{"integrator.kind": "ambientocclusion",
                 "integrator.cos_sample": False})),
    "whitted": dict(scene="atrium.pbrt", spp=2, seed=0, overrides=dict(
        _R16D3, **{"integrator.kind": "whitted"})),
    "halton": dict(scene="atrium.pbrt", strip_sampler=True, spp=2, seed=0,
                   overrides=_R16D3),
    "halton_global": dict(scene="atrium.pbrt", spp=2, seed=0, overrides=dict(
        _R16D3, **{"sampler.kind": "halton-global"})),
    "maxmindist": dict(scene="atrium.pbrt", spp=2, seed=0, overrides=dict(
        _R16D3, **{"sampler.kind": "maxmindist", "sampler.pixel_samples": 4})),
}
# the 128^2, 16-spp renders of chip_smoke.py's phase 10
_R128 = {"film.x_resolution": 128, "film.y_resolution": 128}
CHIP = {
    "halton_global": dict(scene="atrium.pbrt", spp=16, seed=0, overrides=dict(
        _R128, **{"sampler.kind": "halton-global"})),
    "ao": dict(scene="atrium.pbrt", spp=16, seed=0, overrides=dict(
        _R128, **{"integrator.kind": "ambientocclusion"})),
    "whitted": dict(scene="atrium.pbrt", spp=16, seed=0, overrides=dict(
        _R128, **{"integrator.kind": "whitted"})),
    "features": dict(scene="atrium_features.pbrt", spp=16, seed=0,
                     overrides=_R128),
    "ptex": dict(scene=PTEX_SCENE, spp=16, seed=0, overrides={}),
}


def scene_text(case: dict) -> tuple[str, str]:
    """(scene text, base directory) of a case, {repo} filled in."""
    if case["scene"].endswith(".pbrt"):
        path = os.path.join(SCENES, case["scene"])
        text = open(path).read()
        if case.get("strip_sampler"):
            text = re.sub(r'(?m)^Sampler .*\n', "", text)
        return text, SCENES
    return case["scene"].replace("{repo}", REPO), SCENES


def configure(api, case: dict):
    """The case's scene parsed by ``api`` (either package's scene/api.py),
    with its overrides applied."""
    text, base = scene_text(case)
    sd = api.load_scene_string(text, base)
    for path, value in case["overrides"].items():
        obj = sd
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return sd


def write_data_files():
    """The light maps of atrium_features.pbrt and the ptex of PTEX_SCENE."""
    from pbrt_v3_iile_tpu.scene import ptex as ptexlib
    from pbrt_v3_iile_tpu.utils import image as imglib

    yy, xx = np.mgrid[0:16, 0:32].astype(np.float64)
    theta = (yy + 0.5) / 16 * np.pi
    phi = (xx + 0.5) / 32 * 2 * np.pi
    g = np.sin(theta) ** 2 * (0.6 + 0.4 * np.cos(3 * phi) ** 2)
    imglib.write_pfm(os.path.join(SCENES, "atrium_gonio.pfm"),
                     np.stack([g, 0.9 * g, 0.75 * g], -1).astype(np.float32))
    yy, xx = np.mgrid[0:24, 0:36]
    pal = np.array([[1.0, 0.3, 0.2], [0.3, 1.0, 0.3], [0.3, 0.4, 1.0],
                    [1.0, 1.0, 0.3], [1.0, 1.0, 1.0], [0.3, 1.0, 1.0],
                    [1.0, 0.4, 1.0], [0.8, 0.6, 0.4], [0.6, 0.6, 0.6]])
    proj = pal[(xx // 12) + 3 * (yy // 8)].astype(np.float32)
    proj[(xx < 2) | (xx > 33) | (yy < 2) | (yy > 21)] = 0.02
    imglib.write_pfm(os.path.join(SCENES, "atrium_proj.pfm"), proj)
    ptexlib.make_test_ptx(os.path.join(SCENES, "ptex_faces.ptx"), n_faces=4,
                          res_log2=3, seed=0)


def write_halton_digests():
    import jax.numpy as jnp
    from pbrt_v3_iile_tpu.ops import lds

    idx = np.random.default_rng(0).integers(0, 2 ** 32, 4096,
                                            dtype=np.uint64).astype(np.uint32)
    idx[:64] = np.arange(64)   # the first passes of a render
    digest = lambda a: hashlib.sha256(
        np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()).hexdigest()
    sri, hd = [], []
    for dim in range(lds.N_HALTON_DIMS):
        sri.append(digest(lds.scrambled_radical_inverse(dim, jnp.asarray(idx))))
        hd.append(digest(lds.halton_dim(jnp.asarray(idx), dim)))
    np.savez(os.path.join(GOLDEN, "halton_streams.npz"), idx=idx,
             scrambled_radical_inverse=np.asarray(sri), halton_dim=np.asarray(hd))


def render_case(name: str, case: dict, prefix: str):
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.scene import api as apilib

    sd = configure(apilib, case)
    t0 = time.time()
    img, st = renderlib.render(sd, spp=case["spp"], seed=case["seed"],
                               accel="bvh")
    img = np.asarray(img, np.float32)
    assert np.isfinite(img).all(), name
    np.savez_compressed(
        os.path.join(GOLDEN, f"{prefix}_{name}.npz"), img=img,
        scene=case["scene"], strip_sampler=bool(case.get("strip_sampler")),
        overrides=json.dumps(case["overrides"]), spp=case["spp"],
        seed=case["seed"], accel="bvh")
    print(f"{prefix}_{name}: mean {img.mean():.6f} rays {st['rays']} "
          f"{time.time() - t0:.1f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="data, halton, or <prefix>_<case> names")
    args = ap.parse_args(argv)
    want = lambda n: args.only is None or n in args.only
    if want("data"):
        write_data_files()
    if want("halton"):
        t0 = time.time()
        write_halton_digests()
        print(f"halton_streams: {time.time() - t0:.1f} s", flush=True)
    for prefix, cases in (("scenes16", TIER1), ("scenes128", CHIP)):
        for name, case in cases.items():
            if want(f"{prefix}_{name}"):
                render_case(name, case, prefix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
