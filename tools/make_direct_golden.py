"""Generates the golden that holds the port's IILE direct pass to the JAX
package at the file's depth, compacted: the JAX package's
``render_pass_fn`` with the direct pass's config (``nee_all``,
``direct_only``, the compact schedule (1, .5, .25, .25)) on the BVH
walker, on the CPU.

Run from the repository root (about 3 minutes on a CPU, nearly all of it
the depth-6 program's compilation):
    JAX_PLATFORMS=cpu python tools/make_direct_golden.py

Settings: atrium at 48x32 (1,536 lanes, above the 1,024-lane floor of
the per-bounce budget, so the budget roulette runs from bounce 1; at
16^2 the floor leaves the wave uncompacted), depth 6 (the file's), 4
passes keyed fold_in(PRNGKey(0), 5000) as render_iile keys its direct
pass.  Writes tests/golden/direct_atrium48x32_d6_compact_p4.npz: the
resolved image, the per-pass radiance and jitter (the pass's output and
the film's input), and the settings.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden",
                   "direct_atrium48x32_d6_compact_p4.npz")
SETTINGS = dict(width=48, height=32, max_depth=6, passes=4, seed=0,
                key_fold=5000, schedule=(1.0, 0.5, 0.25, 0.25))


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_v3_iile_tpu.integrators import path as jpath
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.ops import film as jfilm
    from pbrt_v3_iile_tpu.scene import api as apilib

    s = SETTINGS
    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd.film.x_resolution, sd.film.y_resolution = s["width"], s["height"]
    assert sd.integrator.max_depth == s["max_depth"]
    cfg = jpath.PathConfig(max_depth=s["max_depth"], nee=True, nee_all=True,
                           direct_only=True, accel="bvh",
                           compact_schedule=s["schedule"])
    scene, cam = jrender.build(sd)
    run = jax.jit(jrender.render_pass_fn(sd, cfg), static_argnums=(4,))
    key = jax.random.fold_in(jax.random.PRNGKey(s["seed"]), s["key_fold"])
    film = jfilm.new_film(s["height"], s["width"])
    Ls, Js = [], []
    t0 = time.time()
    for p in range(s["passes"]):
        L, jit_, _ = run(scene, cam, key, p, 0)
        film = jfilm.add_sample_image(film, L, jit_)
        Ls.append(np.asarray(L))
        Js.append(np.asarray(jit_))
    img = np.asarray(jfilm.resolve(film))
    np.savez_compressed(OUT, img=img, L=np.stack(Ls), jitter=np.stack(Js),
                        **{k: np.asarray(v) for k, v in s.items()})
    print(f"{os.path.basename(OUT)}: mean {img.mean():.6f}, "
          f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
