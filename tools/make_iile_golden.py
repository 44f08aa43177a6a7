"""Renders the golden image of chip_smoke.py's first IILE gate with the
JAX package on the CPU.

Run from the repository root (about 90 s on a CPU):
    JAX_PLATFORMS=cpu python tools/make_iile_golden.py

Settings (chip_smoke.py renders the port with the same ones): atrium at
128^2, the BVH walker (use_pallas=False, accel "bvh" on the CPU),
2 indirect tasks, 4 direct passes, 32^2 hemispheres, seed 0 and the
committed pretrained IISPTNet.  Writes the combined, direct and indirect
images as float16 to tests/golden/iile_atrium128_bvh_t2_d4_s0.npz, and
prints their means and the render's time.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden", "iile_atrium128_bvh_t2_d4_s0.npz")
SETTINGS = dict(res=128, indirect_tasks=2, direct_samples=4, hemi_size=32,
                seed=0)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_v3_iile_tpu.integrators import iispt
    from pbrt_v3_iile_tpu.ml import train as trainlib
    from pbrt_v3_iile_tpu.scene import api as apilib

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = SETTINGS["res"]
    net_vars = trainlib.load_pretrained(trainlib.default_pretrained_path())
    t0 = time.time()
    combined, direct, indirect, _ = iispt.render_iile(
        sd, net_vars=net_vars, seed=SETTINGS["seed"],
        indirect_tasks=SETTINGS["indirect_tasks"],
        direct_samples=SETTINGS["direct_samples"],
        hemi_size=SETTINGS["hemi_size"], use_pallas=False)
    seconds = time.time() - t0
    np.savez_compressed(OUT, combined=combined.astype(np.float16),
                        direct=direct.astype(np.float16),
                        indirect=indirect.astype(np.float16))
    print(f"wrote {os.path.relpath(OUT, REPO)} in {seconds:.1f} s: means "
          f"combined {combined.mean():.6f}, direct {direct.mean():.6f}, "
          f"indirect {indirect.mean():.6f}")


if __name__ == "__main__":
    main()
