"""Generates the scenes and the goldens that hold the port's cameras and
aggregates (object and camera motion blur, the kd-tree aggregate, the
realistic lens camera) to the JAX package, with the JAX package on the CPU.

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_camera_golden.py [--only NAME ...]

Writes:
  - scenes/atrium_motion.pbrt: scenes/atrium.pbrt, not cut (99,158
    triangles), with ``TransformTimes 0 1`` and a shutter of 0-1; the
    camera moves 4 cm and turns 2 degrees between its start and end
    transforms; the seat by the window and its cushion turn 90 degrees
    about the seat's centre (7 sub-keyframes); the bowl on the table
    moves 12 cm;
  - scenes/atrium_lens.pbrt: scenes/atrium.pbrt seen through ``Camera
    "realistic"`` with scenes/lens_wide22.dat (a synthetic lens table,
    written by hand: two biconvex singlets around an aperture stop, about
    22 mm), an 8 mm aperture, focused on the look-at point (4.29 m);
  - tests/golden/camera16_<case>.npz (the CPU tests): ``motion``,
    ``kdtree`` and ``realistic`` at 16^2, depth 3, 2 spp, seed 0, through
    render(); ``motion_compact``: the compacted pass loop at 48x32, depth
    3, 1 pass, seed 7;
  - tests/golden/camera128_<case>.npz (chip_smoke.py's phase 12): each
    case at 128^2, 16 spp, seed 0, the file's depth 6.

The kd-tree case is atrium's own text with ``Accelerator "kdtree"``
inserted before ``WorldBegin``; the port renders it on its kd-tree.  Its
golden is the JAX package's render of the same scene with its BVH
walker: the JAX package's kd-tree walker tests only the first 8
triangles of a leaf (a fault of the reference that the port does not
copy: ops/kdtree.py of the port), so its image leaks light through
atrium's walls (3.3% brighter at 16^2), while the port's kd-tree finds
the BVH's hits ray for ray.  The motion and realistic cases are rendered
by its BVH walker too (the realistic golden holds the port on both
accels).  Each golden holds the image (float32) and the settings that
made it: ``scene`` (a file under scenes/), ``accelerator`` (a line
inserted before WorldBegin, or empty), ``overrides`` (JSON: attribute
paths of the parsed scene and their values), ``spp``, ``seed``,
``accel`` (the port's), ``jax_accel`` (the JAX package's), ``compact``
(the schedule, or []) and ``rays``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
SCENES = os.path.join(REPO, "scenes")
MOTION = "atrium_motion.pbrt"
LENS_SCENE = "atrium_lens.pbrt"
LENS = "lens_wide22.dat"
COMPACT = (1.0, 1.0, 0.5, 0.25, 0.25, 0.125)
FOCUS = 4.29   # |look-at point - eye| of atrium's LookAt, in m


def _atrium_body() -> str:
    text = open(os.path.join(SCENES, "atrium.pbrt")).read()
    return text[text.index("LookAt"):]


def motion_scene_text() -> str:
    body = _atrium_body()
    head = ("# atrium_motion.pbrt -- scenes/atrium.pbrt with motion blur\n"
            "# (written by tools/make_camera_golden.py): a shutter of 0-1, the\n"
            "# camera moving 4 cm and turning 2 degrees, the seat by the window\n"
            "# and its cushion turning 90 degrees about the seat's centre, the\n"
            "# bowl on the table moving 12 cm.\n"
            "TransformTimes 0 1\n")
    cam = 'Camera "perspective" "float fov" [68]'
    assert cam in body
    body = body.replace(cam, (
        "ActiveTransform EndTime\n"
        "Translate 0.04 0 0\n"
        "Rotate 2 0 1 0\n"
        "ActiveTransform All\n"
        + cam + '\n    "float shutteropen" [0] "float shutterclose" [1]'), 1)
    bowl = '  Translate -1.55 0.652 0.5\n'
    assert bowl in body
    body = body.replace(bowl, bowl + ("  ActiveTransform EndTime\n"
                                      "  Translate 0.12 0 0\n"
                                      "  ActiveTransform All\n"), 1)
    seat_old = (
        'Shape "trianglemesh" "point P" [-1.5 0 -2.7 -0.3 0 -2.7 -0.3 0.45 '
        '-2.7 -1.5 0.45 -2.7 -1.5 0 -1.7 -0.3 0 -1.7 -0.3 0.45 -1.7 -1.5 '
        '0.45 -1.7] "integer indices" [0 2 1 0 3 2 4 5 6 4 6 7 0 1 5 0 5 4 '
        '3 6 2 3 7 6 0 7 3 0 4 7 1 2 6 1 6 5]\n'
        'AttributeBegin\n'
        '  Translate -0.9 0.0 -2.2\n'
        '  Shape "plymesh" "string filename" ["atrium_cushion.ply"]\n'
        'AttributeEnd\n')
    assert seat_old in body
    body = body.replace(seat_old, (
        'AttributeBegin\n'
        '  Translate -0.9 0.0 -2.2\n'
        '  ActiveTransform EndTime\n'
        '  Rotate 90 0 1 0\n'
        '  ActiveTransform All\n'
        '  Shape "trianglemesh" "point P" [-0.6 0 -0.5 0.6 0 -0.5 0.6 0.45 '
        '-0.5 -0.6 0.45 -0.5 -0.6 0 0.5 0.6 0 0.5 0.6 0.45 0.5 -0.6 0.45 '
        '0.5] "integer indices" [0 2 1 0 3 2 4 5 6 4 6 7 0 1 5 0 5 4 3 6 '
        '2 3 7 6 0 7 3 0 4 7 1 2 6 1 6 5]\n'
        '  Shape "plymesh" "string filename" ["atrium_cushion.ply"]\n'
        'AttributeEnd\n'), 1)
    return head + body


def lens_scene_text() -> str:
    body = _atrium_body()
    head = ("# atrium_lens.pbrt -- scenes/atrium.pbrt through a realistic lens\n"
            "# camera (written by tools/make_camera_golden.py): the lens table\n"
            f"# {LENS}, an 8 mm aperture, focused on the look-at point.\n")
    cam = 'Camera "perspective" "float fov" [68]'
    assert cam in body
    body = body.replace(cam, (
        f'Camera "realistic" "string lensfile" "{LENS}"\n'
        f'    "float aperturediameter" [8] "float focusdistance" [{FOCUS}]'), 1)
    return head + body


def kdtree_text(text: str) -> str:
    """A scene's text with ``Accelerator "kdtree"`` before WorldBegin."""
    assert "WorldBegin" in text
    return text.replace("WorldBegin", 'Accelerator "kdtree"\n\nWorldBegin', 1)


def write_scenes():
    for name, text in ((MOTION, motion_scene_text()),
                       (LENS_SCENE, lens_scene_text())):
        with open(os.path.join(SCENES, name), "w") as f:
            f.write(text)


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

CASES = {
    "motion": dict(scene=MOTION, accel="bvh"),
    "kdtree": dict(scene="atrium.pbrt", accelerator="kdtree", accel="kdtree",
                   jax_accel="bvh"),
    "realistic": dict(scene=LENS_SCENE, accel="bvh"),
}


def load_case(api, case: dict):
    """A golden's scene parsed by ``api`` (either package's scene/api.py):
    the file, with ``Accelerator "kdtree"`` inserted when the case says
    so, its lens file resolved against scenes/, and its overrides."""
    text = open(os.path.join(SCENES, case["scene"])).read()
    if case.get("accelerator") == "kdtree":
        text = kdtree_text(text)
    sd = api.load_scene_string(text, SCENES)
    lf = sd.camera.lens_file
    if lf and not os.path.isabs(lf):
        # the JAX package's parser keeps the lens file's name as written
        sd.camera.lens_file = os.path.join(SCENES, lf)
    for path, value in case.get("overrides", {}).items():
        obj = sd
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return sd


_R16D3 = {"film.x_resolution": 16, "film.y_resolution": 16,
          "integrator.max_depth": 3}
TIER1 = {name: dict(c, overrides=_R16D3, spp=2, seed=0)
         for name, c in CASES.items()}
TIER1["motion_compact"] = dict(
    CASES["motion"], overrides={"film.x_resolution": 48,
                                "film.y_resolution": 32,
                                "integrator.max_depth": 3},
    spp=1, seed=7, compact=COMPACT)
CHIP = {name: dict(c, overrides={"film.x_resolution": 128,
                                 "film.y_resolution": 128}, spp=16, seed=0)
        for name, c in CASES.items()}


def render_case(case: dict):
    """(image, rays) of the JAX package: render() with the case's JAX
    accel, or with a compact schedule its compacted pass loop over
    render_pass_fn."""
    import jax
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.ops import film as jfilm
    from pbrt_v3_iile_tpu.scene import api as japi

    sd = load_case(japi, case)
    accel = case.get("jax_accel", case["accel"])
    if not case.get("compact"):
        img, st = jrender.render(sd, spp=case["spp"], seed=case["seed"],
                                 accel=accel)
        return np.asarray(img, np.float32), int(st["rays"])
    cfg = jrender.make_integrator_config(sd, accel=accel)._replace(
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
        scene=case["scene"], accelerator=case.get("accelerator", ""),
        overrides=json.dumps(case["overrides"]), spp=case["spp"],
        seed=case["seed"], accel=case["accel"],
        jax_accel=case.get("jax_accel", case["accel"]),
        compact=json.dumps(case.get("compact", [])), rays=rays)
    print(f"{prefix}_{name}: mean {img.mean():.6f} rays {rays} "
          f"{time.time() - t0:.1f} s", flush=True)


def case_from_golden(z) -> dict:
    """The case (settings) a golden was rendered with."""
    return dict(scene=str(z["scene"]), accelerator=str(z["accelerator"]),
                overrides=json.loads(str(z["overrides"])), spp=int(z["spp"]),
                seed=int(z["seed"]), accel=str(z["accel"]),
                compact=json.loads(str(z["compact"])))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="scenes, or <prefix>_<case> names")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    want = lambda n: args.only is None or n in args.only
    if want("scenes"):
        write_scenes()
    for prefix, cases in (("camera16", TIER1), ("camera128", CHIP)):
        for name, case in cases.items():
            if want(f"{prefix}_{name}"):
                write_golden(prefix, name, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
