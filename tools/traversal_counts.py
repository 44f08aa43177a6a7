"""Counts the traversal work of the motion kernel's design on the CPU, at
a small size, before a chip run (no device metric; the port only, no jax).

Run from the repository root:  python3 tools/traversal_counts.py

atrium_motion (scenes/atrium_motion.pbrt) at 48^2, the primary rays of
threefry key 1 with their shutter times: the node visits and triangle
tests of the keyframe-lerping binary walker over the union BVH
(ops/intersect.py::intersect_bvh with time, the CPU path) against the
motion kernel's plain version on the motion tables
(ops/intersect_kernel.py::bvh_traverse_motion_plain: wide-node visits),
and the share of rays on which their prims agree.  chip_smoke.py's phase
8 prints the same counts at full size on the card.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def motion_counts():
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium_motion.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = 48
    scene, cam = renderlib.build(sd, "cpu")
    o, d, _, _, _, _, time = renderlib.make_wave_prep(sd, "cpu")(
        cam, threefry.prng_key(1), 0, 0)
    big = torch.full_like(time, 1e30)
    union, split = {}, {}
    ref = isect.intersect_bvh(scene, o, d, big, time=time, work=union)
    got = K2.bvh_traverse_motion_plain(scene, o, d, big, time, work=split)
    return dict(rays=int(o.shape[0]), union_binary_visits=union["nodes"],
                union_triangle_tests=union["tris"],
                split_wide_visits=split["nodes"],
                split_triangle_tests=split["tris"],
                prim_agree=float((got[1] == ref.prim).float().mean()))


if __name__ == "__main__":
    torch.set_num_threads(4)
    print(json.dumps({"motion_primary_48": motion_counts()}), flush=True)
