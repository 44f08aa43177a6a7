"""Generates the probe datasets that the port's generate_examples is held
to, with the JAX package's ``ml/dataset.py::generate_examples`` on the
CPU (the BVH walker, accel "bvh").

Run from the repository root (about 2 minutes on a CPU):
    JAX_PLATFORMS=cpu python tools/make_train_golden.py

Writes two files to tests/golden/, each holding the maps p, d, n, z
(float32), valid, and the settings that made them (the scene, as a file
name under scenes/ or as the scene's text, the probe pixels, hemisphere
side, ground-truth samples and seed), so that the port's side reads
everything from the file:
  - train_interior_v1_bvh_h32_g4_s4_s0.npz: scenes/interior_v1.pbrt
    (atrium stays held out, as scripts/train_pretrained.py holds it), a
    4 x 4 probe grid at linspace(0.05 W, 0.95 W) (the trainer's grid
    formula), 32^2 hemispheres, 4 ground-truth samples, seed 0; held by
    chip_smoke.py's dataset gate;
  - train_box32_bvh_h8_g4_s2_s0.npz: the 32^2 two-wall scene of
    tests/test_train_iile.py, probes at linspace(2, 29, 4) on each side,
    8^2 hemispheres, 2 ground-truth samples, seed 0; held by
    tests/test_torch_dataset.py on the CPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")

BOX32 = """
LookAt 0 2.5 -6  0 2.5 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Integrator "iispt" "integer maxdepth" [4]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [20 20 20]
  Translate 0 4.5 0
  Shape "sphere" "float radius" [0.4]
AttributeEnd
Material "matte" "color Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "point P" [-5 0 -5 5 0 -5 5 0 5 -5 0 5]
  "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.7 0.3 0.3]
Shape "trianglemesh" "point P" [-5 0 3 5 0 3 5 5 3 -5 5 3]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def grid_coords(lo_x, hi_x, lo_y, hi_y, grid):
    gx = np.linspace(lo_x, hi_x, grid).astype(np.int32)
    gy = np.linspace(lo_y, hi_y, grid).astype(np.int32)
    mx, my = np.meshgrid(gx, gy)
    return np.stack([mx, my], -1).reshape(-1, 2)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pbrt_v3_iile_tpu.integrators import render as renderlib
    from pbrt_v3_iile_tpu.ml import dataset as datasetlib
    from pbrt_v3_iile_tpu.ops import camera as camlib
    from pbrt_v3_iile_tpu.scene import api as apilib

    interior = apilib.load_scene(os.path.join(REPO, "scenes", "interior_v1.pbrt"))
    W, H = interior.film.x_resolution, interior.film.y_resolution
    jobs = [
        ("train_interior_v1_bvh_h32_g4_s4_s0.npz", interior,
         dict(scene_file="interior_v1.pbrt"),
         grid_coords(W * 0.05, W * 0.95, H * 0.05, H * 0.95, 4), 32, 4),
        ("train_box32_bvh_h8_g4_s2_s0.npz", apilib.load_scene_string(BOX32),
         dict(scene_text=BOX32), grid_coords(2, 29, 2, 29, 4), 8, 2),
    ]
    seed = 0
    for name, sd, scene_ref, coords, hemi, gt_spp in jobs:
        scene, cam = renderlib.build(sd)
        cam_kind = camlib.KIND.get(sd.camera.kind, 0)
        t0 = time.time()
        gen = jax.jit(lambda scene, key, c: datasetlib.generate_examples(
            scene, cam, cam_kind, key, c, hemi_size=hemi, gt_spp=gt_spp,
            use_pallas=False, accel="bvh"))
        maps = jax.block_until_ready(
            gen(scene, jax.random.PRNGKey(seed), jnp.asarray(coords)))
        seconds = time.time() - t0
        out = {k: np.asarray(maps[k], np.float32) for k in "pdnz"}
        out["valid"] = np.asarray(maps["valid"])
        np.savez_compressed(os.path.join(GOLDEN, name), coords=coords,
                            hemi_size=np.int32(hemi), gt_spp=np.int32(gt_spp),
                            seed=np.int32(seed),
                            **{k: np.str_(v) for k, v in scene_ref.items()},
                            **out)
        print(f"wrote tests/golden/{name} in {seconds:.1f} s: "
              f"{int(out['valid'].sum())} of {len(coords)} probes valid, "
              f"means p {out['p'].mean():.6f} d {out['d'].mean():.6f}")


if __name__ == "__main__":
    main()
