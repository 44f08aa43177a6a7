"""Generates the scene and the goldens that hold the port's materials and
transport (participating media and volpath, the exact BSSRDF, hair and
Fourier BSDFs) to the JAX package, with the JAX package on the CPU
(the BVH walker, accel "bvh").

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_transport_golden.py [--only NAME ...]

Writes (the times are this tool's on an 8-core CPU):
  - scenes/atrium_transport.bsdf (under 1 s): a 3-channel Fourier table
    of a tinted glossy reflection lobe over a diffuse base, projected by
    quadrature onto 8 cosine orders on 24 mu nodes, written with the JAX
    package's FourierTable and write_bsdf;
  - scenes/atrium_transport.pbrt (under 1 s): scenes/atrium.pbrt, not cut
    (99,158 triangles), with ``Integrator "volpath"`` at the file's depth
    6 and, each between ``# @<feature>`` and ``# @end`` lines (with the
    atrium original between ``# @else`` and ``# @end`` where the feature
    replaces something): ``fog``, the camera in a thin homogeneous fog
    (g 0.3); ``smoke``, a 32^3 procedural grid (seed 0) inside a
    null-material box with a MediumInterface; ``sss``, the glass vase as
    kdsubsurface (mfp 2 cm; the vase stands on the table, in view, in
    every variant); ``hair``, 2,000 curve strands (seed 0) as cyhair2pbrt
    emits them (cylinders, splitdepth 1) with a hair material on the rug;
    ``fourier``, the bowl with the table above.  ``variant(text,
    features)`` keeps the blocks of the named features;
  - tests/golden/transport16_<case>.npz (the CPU tests): each case
    (``fog``, ``smoke``, ``sss``, ``hair``, ``fourier``: atrium_transport
    with that feature only, ``sss``, ``fourier`` and ``hair`` seen from
    close by; ``all``: every feature) at 16^2, depth 3, 2 spp, seed 0,
    through render() (8-15 s each, mostly compilation);
    ``<case>_compact`` for fog, smoke and all: the compacted pass loop
    at 48x32, 2 passes, seed 7 (30-70 s each); ``bssrdf``:
    tests/test_bssrdf.py's scene with its occluder at 16^2, 4 spp, seed 5
    (10 s);
  - tests/golden/transport128_<case>.npz (chip_smoke.py's phase 11): each
    case at 128^2, 16 spp, seed 0, the file's depth (1-7 min each: hair 5,
    all 7).

Each golden holds the image (float32) and the settings that made it:
``scene`` (a file under scenes/, or the name of a JAX test's scene),
``features`` (JSON list), ``lookat`` (the LookAt that replaces the
file's, or empty), ``overrides`` (JSON: attribute paths of the
parsed scene and their values), ``spp``, ``seed``, ``accel``, ``compact``
(the schedule, or []) and ``rays``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
SCENES = os.path.join(REPO, "scenes")
TRANSPORT = "atrium_transport.pbrt"
FEATURES = ("fog", "smoke", "sss", "hair", "fourier")
COMPACT = (1.0, 1.0, 0.5, 0.25, 0.25, 0.125)
N_STRANDS = 2000
GRID = 32


def variant(text: str, features) -> str:
    """The scene text with the ``# @<feature>`` blocks of ``features``
    kept, the others dropped (and their ``# @else`` parts kept)."""
    out, stack = [], []      # stack: (feature kept?, in the else part?)
    for ln in text.splitlines(keepends=True):
        tag = ln.strip()
        if tag.startswith("# @") and tag != "# @else" and tag != "# @end":
            stack.append([tag[3:] in features, False])
        elif tag == "# @else":
            stack[-1][1] = True
        elif tag == "# @end":
            stack.pop()
        elif all(keep != in_else for keep, in_else in stack):
            out.append(ln)
    return "".join(out)


CASES128 = {f: dict(features=[f]) for f in FEATURES}
CASES128["all"] = dict(features=list(FEATURES))
# at 16^2 the file's view gives the vase, the bowl and the hair a pixel
# or two: their cases look at them from close by
TABLE = "-0.95 1.0 1.0  -1.45 0.78 0.3  0 1 0"
RUG = "-0.55 0.42 1.35  -0.85 0.12 0.7  0 1 0"
CASES16 = dict(CASES128, sss=dict(features=["sss"], lookat=TABLE),
               fourier=dict(features=["fourier"], lookat=TABLE),
               hair=dict(features=["hair"], lookat=RUG))


# ---------------------------------------------------------------------------
# the scene's data
# ---------------------------------------------------------------------------

def fourier_table():
    """A tinted glossy lobe over a diffuse base as a 3-channel Fourier
    table (Y, R, B) of f |mu_i|, reflection only (eta 1)."""
    from pbrt_v3_iile_tpu.ops import fourierbsdf as fb

    n_mu, m = 24, 8
    kd = np.array([0.25, 0.16, 0.09])          # diffuse rgb
    ks = np.array([0.9, 0.62, 0.38])           # lobe rgb (copper-like)
    width = 0.05                               # lobe width in 1 - cos
    mu = np.cos(np.linspace(np.pi, 0.0, n_mu))  # -1 .. 1, denser at the poles
    phi = (np.arange(256) + 0.5) / 256 * np.pi
    t = fb.FourierTable()
    t.eta, t.m_max, t.n_channels = 1.0, m, 3
    t.mu = mu
    t.m = np.zeros((n_mu, n_mu), np.int32)
    t.a_offset = np.zeros((n_mu, n_mu), np.int64)
    t.cdf = np.zeros((n_mu, n_mu))
    pool = []
    lum = np.array([0.212671, 0.715160, 0.072169])
    for i in range(n_mu):
        for o in range(n_mu):
            # pbrt's signs: mu_i = cos(-wi), so reflection has mu_i mu_o < 0
            if not (mu[i] < 0.0 < mu[o]):
                continue
            ci, co = -mu[i], mu[o]
            si, so = np.sqrt(max(1 - ci * ci, 0)), np.sqrt(max(1 - co * co, 0))
            # cos of the angle between wi and wo's mirror direction
            cang = si * so * np.cos(phi) + ci * co
            lobe = np.exp((cang - 1.0) / width) / (2 * np.pi * width)
            f = kd[None, :] / np.pi + ks[None, :] * lobe[:, None] * 0.5
            f = f * ci                                       # f |mu_i|
            ych = f @ lum
            chans = np.stack([ych, f[:, 0], f[:, 2]])        # (3, phi)
            k = np.arange(m)
            basis = np.cos(k[:, None] * phi[None, :])        # (m, phi)
            coef = chans @ basis.T / phi.size                # mean over [0, pi]
            coef[:, 1:] *= 2.0
            t.m[i, o] = m
            t.a_offset[i, o] = sum(len(x) for x in pool)
            pool.append(coef.reshape(-1))
    t.a = np.concatenate(pool)
    return t


def smoke_density(n=GRID, seed=0):
    """(n, n, n) density in [0, 1] (z, y, x): a rising plume of Gaussian
    puffs along a wavy axis, seeded."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    dens = np.zeros((n, n, n))
    for _ in range(24):
        h = rng.uniform(0.05, 0.95)
        cx = 0.5 + 0.18 * np.sin(6.0 * h + rng.uniform(0, 0.6))
        cz = 0.5 + 0.18 * np.cos(5.0 * h)
        r = rng.uniform(0.08, 0.2) * (0.6 + 0.6 * h)
        amp = rng.uniform(0.4, 1.0)
        dens += amp * np.exp(-((x - cx) ** 2 + (y - h) ** 2 + (z - cz) ** 2)
                             / (2 * r * r))
    dens *= np.clip(4.0 * np.minimum(y, 1.0 - y), 0.0, 1.0)   # fade ends
    return np.clip(dens / dens.max(), 0.0, 1.0)


def hair_strands(n=N_STRANDS, seed=0):
    """cyhair2pbrt-style curve statements of n tapered strands rooted in
    a patch of the rug, each one cubic Bezier segment."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        root = np.array([rng.uniform(-1.05, -0.65), 0.03,
                         rng.uniform(0.45, 0.95)])
        height = rng.uniform(0.12, 0.24)
        lean = rng.normal(0.0, 0.05, 3) * np.array([1, 0, 1])
        bend = np.array([rng.normal(0, 0.06), 0.0, rng.normal(0, 0.06)])
        p1 = root + np.array([0, height / 3, 0]) + lean / 3
        p2 = root + np.array([0, 2 * height / 3, 0]) + lean * 0.7 + bend * 0.4
        p3 = root + np.array([0, height, 0]) + lean + bend
        cp = " ".join(f"{v:.5g}" for v in np.concatenate([root, p1, p2, p3]))
        lines.append(f'Shape "curve" "string type" "cylinder" "point P" [{cp}] '
                     f'"integer splitdepth" [1] "float width0" [0.004] '
                     f'"float width1" [0.0008]\n')
    return "".join(lines)


def transport_scene_text() -> str:
    text = open(os.path.join(SCENES, "atrium.pbrt")).read()
    body = text[text.index("LookAt"):]
    head = (
        "# atrium_transport.pbrt -- scenes/atrium.pbrt with materials and\n"
        "# transport (written by tools/make_transport_golden.py): the volpath\n"
        "# integrator, the camera in a thin homogeneous fog, a smoke plume in a\n"
        "# 32^3 density grid inside a null-material box, the glass vase as\n"
        "# kdsubsurface (moved onto the table, in view, in every variant), a\n"
        "# patch of 2,000 hair strands on the rug and the bowl as a Fourier\n"
        "# BSDF (atrium_transport.bsdf).  Each feature sits between\n"
        "# '# @<feature>' and '# @end' lines: make_transport_golden.variant()\n"
        "# keeps the blocks of the features a case names.\n")
    body = body.replace('Integrator "path" "integer maxdepth" [6]',
                        'Integrator "volpath" "integer maxdepth" [6]')
    fog = ('# @fog\n'
           'MakeNamedMedium "fog" "string type" "homogeneous"\n'
           '    "rgb sigma_a" [0.004 0.004 0.004] "rgb sigma_s" [0.045 0.05 0.056]\n'
           '    "float g" [0.3]\n'
           'MediumInterface "" "fog"\n'
           '# @end\n\n')
    body = body.replace("WorldBegin\n", fog + "WorldBegin\n", 1)
    glass_vase = '''AttributeBegin
  Material "glass" "float eta" [1.5]
  Translate -2.2 0.652 0.35
  Scale 0.55 0.55 0.55
  Shape "plymesh" "string filename" ["atrium_vase.ply"]
AttributeEnd
'''
    assert glass_vase in body
    body = body.replace(glass_vase, '''AttributeBegin
# @sss
  Material "kdsubsurface" "rgb Kd" [0.86 0.8 0.72] "float mfp" [0.02]
      "float eta" [1.33]
# @else
  Material "glass" "float eta" [1.5]
# @end
  Translate -1.3 0.652 0.12
  Scale 0.55 0.55 0.55
  Shape "plymesh" "string filename" ["atrium_vase.ply"]
AttributeEnd
''')
    bowl = '''  Material "metal" "float roughness" [0.02]
  Translate -1.55 0.652 0.5'''
    assert bowl in body
    body = body.replace(bowl, '''# @fourier
  Material "fourier" "string bsdffile" "atrium_transport.bsdf"
# @else
  Material "metal" "float roughness" [0.02]
# @end
  Translate -1.55 0.652 0.5''')
    dens = smoke_density()
    vals = " ".join(f"{v:.3g}" for v in dens.reshape(-1))
    smoke = (
        "\n# @smoke\n# ---- a smoke plume: a density grid in a null-material box ----\n"
        "AttributeBegin\n"
        '  MakeNamedMedium "smoke" "string type" "heterogeneous"\n'
        '      "rgb sigma_a" [0.6 0.6 0.6] "rgb sigma_s" [3.4 3.4 3.4]'
        ' "float g" [0.2]\n'
        f'      "integer nx" [{GRID}] "integer ny" [{GRID}] "integer nz" [{GRID}]\n'
        '      "point p0" [-0.95 0.04 -0.95] "point p1" [-0.3 1.9 -0.15]\n'
        f'      "float density" [{vals}]\n'
        '  Material ""\n'
        '  MediumInterface "smoke" "fog"\n'
        '  Shape "trianglemesh" "point P" [-0.95 0.04 -0.95  -0.3 0.04 -0.95'
        '  -0.3 1.9 -0.95  -0.95 1.9 -0.95\n'
        '      -0.95 0.04 -0.15  -0.3 0.04 -0.15  -0.3 1.9 -0.15'
        '  -0.95 1.9 -0.15]\n'
        '      "integer indices" [0 2 1 0 3 2 4 5 6 4 6 7 0 1 5 0 5 4 3 6 2 3 7 6'
        ' 0 7 3 0 4 7 1 2 6 1 6 5]\n'
        "AttributeEnd\n# @end\n")
    hair = ("\n# @hair\n# ---- a patch of hair on the rug (curves as cyhair2pbrt"
            " emits them) ----\nAttributeBegin\n"
            '  Material "hair" "float eumelanin" [1.3] "float beta_m" [0.3]'
            ' "float beta_n" [0.3]\n' + hair_strands() + "AttributeEnd\n# @end\n")
    body = body.replace("\nWorldEnd", smoke + hair + "\nWorldEnd")
    return head + body


def write_scene():
    from pbrt_v3_iile_tpu.ops import fourierbsdf as fb

    fb.write_bsdf(os.path.join(SCENES, "atrium_transport.bsdf"), fourier_table())
    with open(os.path.join(SCENES, TRANSPORT), "w") as f:
        f.write(transport_scene_text())


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

def load_case(api, case: dict):
    """A golden's scene parsed by ``api`` (either package's scene/api.py)
    with its features and overrides."""
    name = case.get("scene", TRANSPORT)
    if name == TRANSPORT:
        text = variant(open(os.path.join(SCENES, TRANSPORT)).read(),
                       case["features"])
        if case.get("lookat"):
            text = re.sub(r"(?m)^LookAt .*$", "LookAt " + case["lookat"],
                          text, count=1)
    else:
        text = JAX_TEST_SCENES[name]()
    sd = api.load_scene_string(text, SCENES)
    for path, value in case.get("overrides", {}).items():
        obj = sd
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return sd


def _bssrdf_scene():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_bssrdf

    return test_bssrdf._scene(test_bssrdf._SSS, test_bssrdf._OCCLUDER)


JAX_TEST_SCENES = {"test_bssrdf.py": _bssrdf_scene}

_R16D3 = {"film.x_resolution": 16, "film.y_resolution": 16,
          "integrator.max_depth": 3}
_R48x32D3 = {"film.x_resolution": 48, "film.y_resolution": 32,
             "integrator.max_depth": 3}
TIER1 = {name: dict(c, overrides=_R16D3, spp=2, seed=0)
         for name, c in CASES16.items()}
for _f in ("fog", "smoke", "all"):
    TIER1[f"{_f}_compact"] = dict(CASES16[_f], overrides=_R48x32D3, spp=2,
                                  seed=7, compact=COMPACT)
TIER1["bssrdf"] = dict(scene="test_bssrdf.py", features=[], spp=4, seed=5,
                       overrides={"film.x_resolution": 16,
                                  "film.y_resolution": 16})
CHIP = {name: dict(c, overrides={"film.x_resolution": 128,
                                 "film.y_resolution": 128}, spp=16, seed=0)
        for name, c in CASES128.items()}


def render_case(case: dict):
    """(image, rays) of the JAX package: render() on the BVH walker, or
    with a compact schedule its compacted pass loop over render_pass_fn."""
    import jax
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.ops import film as jfilm
    from pbrt_v3_iile_tpu.scene import api as japi

    sd = load_case(japi, case)
    if not case.get("compact"):
        img, st = jrender.render(sd, spp=case["spp"], seed=case["seed"],
                                 accel="bvh")
        return np.asarray(img, np.float32), int(st["rays"])
    cfg = jrender.make_integrator_config(sd, accel="bvh")._replace(
        compact_schedule=tuple(case["compact"]))
    scene, cam = jrender.build(sd)
    run = jax.jit(jrender.render_pass_fn(sd, cfg), static_argnums=(4,))
    film = jfilm.new_film(sd.film.y_resolution, sd.film.x_resolution)
    key = jax.random.PRNGKey(case["seed"])
    rays = 0
    for p in range(case["spp"]):
        L, jit_, aux = run(scene, cam, key, p, 0)
        film = jfilm.add_sample_image(film, L, jit_)
        rays += int(aux["rays"])
    return np.asarray(jfilm.resolve(film), np.float32), rays


def write_golden(prefix: str, name: str, case: dict):
    t0 = time.time()
    img, rays = render_case(case)
    assert np.isfinite(img).all(), name
    np.savez_compressed(
        os.path.join(GOLDEN, f"{prefix}_{name}.npz"), img=img,
        scene=case.get("scene", TRANSPORT), features=json.dumps(case["features"]),
        lookat=case.get("lookat", ""),
        overrides=json.dumps(case["overrides"]), spp=case["spp"],
        seed=case["seed"], accel="bvh", compact=json.dumps(case.get("compact", [])),
        rays=rays)
    print(f"{prefix}_{name}: mean {img.mean():.6f} rays {rays} "
          f"{time.time() - t0:.1f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="scene, or <prefix>_<case> names")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    want = lambda n: args.only is None or n in args.only
    if want("scene"):
        write_scene()
    for prefix, cases in (("transport16", TIER1), ("transport128", CHIP)):
        for name, case in cases.items():
            if want(f"{prefix}_{name}"):
                write_golden(prefix, name, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
