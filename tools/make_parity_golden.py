"""Generates the JAX package's outputs that the port's CPU parity tests
compare against, so that those tests compile no JAX program: the JAX
package on the CPU (the BVH walker, accel "bvh"), on the same inputs the
tests give the port.

Run from the repository root (about 4 minutes on an 8-core CPU, nearly
all of it compilation):
    JAX_PLATFORMS=cpu python tools/make_parity_golden.py [--only NAME ...]

Writes to tests/golden/ (the settings are the tests'):
  - parity_slice_scan16.npz: atrium 16^2, depth 3, render() at 2 spp,
    seed 7: the image and the traced ray count
    (tests/test_torch_slice.py::test_scan_render_matches_jax);
  - parity_slice_compact48x32.npz: atrium 48x32, depth 3, the compacted
    pass loop on the BVH walker, 2 passes, seed 7
    (::test_compacted_render_matches_jax);
  - parity_directlighting16.npz: atrium 16^2, directlighting, render()
    at 2 spp, seed 7
    (tests/test_torch_path_variants.py::test_directlighting_render_matches_jax);
  - parity_direct_compact_d1.npz: IILE's direct pass at depth 1,
    compacted, atrium 48x32, 2 passes, key fold_in(PRNGKey(0), 5000)
    (::test_compacted_direct_pass_matches_jax);
  - parity_iile_task16.npz: the stages of the first IILE task at 16^2 with
    8^2 hemispheres, seed 0, and the pretrained IISPTNet (anchors, the
    specular chase, the probe G-buffers, the CNN, the pixel chunk and the
    MIS stage; each stage's inputs and outputs, as arrays named
    "<output>/<field>"), and render_iile with 1 task and 1 direct pass
    (tests/test_torch_iile.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
ATRIUM = os.path.join(REPO, "scenes", "atrium.pbrt")
COMPACT = (1.0, 1.0, 0.5, 0.25, 0.25, 0.125)
DIRECT_COMPACT = (1.0, 0.5, 0.25, 0.25)


def _atrium(w, h, kind="path", depth=None):
    from pbrt_v3_iile_tpu.scene import api as apilib

    sd = apilib.load_scene(ATRIUM)
    sd.film.x_resolution, sd.film.y_resolution = w, h
    sd.integrator.kind = kind
    if depth is not None:
        sd.integrator.max_depth = depth
    return sd


def _passes(sd, cfg, key, n):
    """n passes of render_pass_fn(sd, cfg) accumulated on a film."""
    import jax
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.ops import film as jfilm

    scene, cam = jrender.build(sd)
    run = jax.jit(jrender.render_pass_fn(sd, cfg), static_argnums=(4,))
    film = jfilm.new_film(sd.film.y_resolution, sd.film.x_resolution)
    for p in range(n):
        L, jit_, _ = run(scene, cam, key, p, 0)
        film = jfilm.add_sample_image(film, L, jit_)
    return np.asarray(jfilm.resolve(film))


def slice_scan16():
    from pbrt_v3_iile_tpu.integrators import render as jrender

    img, st = jrender.render(_atrium(16, 16, depth=3), spp=2, seed=7)
    return dict(img=np.asarray(img), rays=st["rays"])


def slice_compact48x32():
    import jax
    from pbrt_v3_iile_tpu.integrators import render as jrender

    sd = _atrium(48, 32, depth=3)
    cfg = jrender.make_integrator_config(sd, accel="bvh")._replace(
        compact_schedule=COMPACT)
    return dict(img=_passes(sd, cfg, jax.random.PRNGKey(7), 2))


def directlighting16():
    from pbrt_v3_iile_tpu.integrators import render as jrender

    img, _ = jrender.render(_atrium(16, 16, "directlighting"), spp=2, seed=7)
    return dict(img=np.asarray(img))


def direct_compact_d1():
    import jax
    from pbrt_v3_iile_tpu.integrators import path as jpath

    sd = _atrium(48, 32, depth=1)
    cfg = jpath.PathConfig(max_depth=1, nee=True, nee_all=True,
                           direct_only=True, accel="bvh",
                           compact_schedule=DIRECT_COMPACT)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5000)
    return dict(img=_passes(sd, cfg, key, 2))


def _flatten(prefix, x, out):
    """Arrays of a (nested) dict / NamedTuple / tuple as "a/b/0" keys."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        for k, v in x.items():
            _flatten(f"{prefix}/{k}" if prefix else k, v, out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = np.asarray(x)


def iile_task16():
    import jax
    import jax.numpy as jnp
    from pbrt_v3_iile_tpu.integrators import iispt as jiispt
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.integrators import schedule as jsched
    from pbrt_v3_iile_tpu.ml import train as jtrain
    from pbrt_v3_iile_tpu.models import iisptnet as jnet
    from pbrt_v3_iile_tpu.utils import vecmath as jvm

    RES, HEMI, SEED = 16, 8, 0
    flax_vars = jtrain.load_pretrained(jtrain.default_pretrained_path())
    sd = _atrium(RES, RES)
    scene, cam = jrender.build(sd)
    task = jsched.compute_schedule(RES, RES, 1)[0]
    ts = task.tilesize
    fns = jiispt._anchor_fns(sd, HEMI, jnet.IISPTNet())
    ff_fn = jiispt._ff_fn(False, "bvh")
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 1000)
    coords = jiispt.task_probe_coords(jnp.int32(0), jnp.int32(0), ts, RES, RES)
    o, d = fns["probe_rays"](cam, key, coords)
    fi = ff_fn(scene, o, d, key)
    pv = fi["found"] & (jvm.luminance(fi["beta"]) > 0.0)
    gb = jiispt._probes_fn(HEMI, False, "bvh")(scene, fi["p"], fi["n"], key)
    R = fns["cnn"](flax_vars, gb.intensity, gb.normals, gb.distance, pv)
    # the task's one chunk, as run_task makes it
    G = jsched.NUMBER_TILES + 1
    li = jnp.arange(8192)
    lx, ly = li % RES, jnp.minimum(li // RES, RES - 1)
    in_img = li < RES * RES
    fo, fd = fns["pixel_rays"](cam, jax.random.fold_in(key, 7), lx, ly)
    ff = ff_fn(scene, fo, fd, jax.random.fold_in(key, 8))
    gi, gj = jnp.clip(lx // ts, 0, G - 2), jnp.clip(ly // ts, 0, G - 2)
    n_ids = jnp.stack([gj * G + gi, (gj + 1) * G + gi + 1, gj * G + gi + 1,
                       (gj + 1) * G + gi], axis=-1)
    mis_in = (R, pv, gb.look, gb.origin, gb.right, gb.up, gb.look,
              coords.astype(jnp.float32), n_ids, lx, ly, in_img, ff["found"],
              ff["beta"], ff["p"], ff["n"], ff["wo"], ff["mat"], ff["uv"])
    rgb, valid = jiispt._mis_stage(scene, cam, *mis_in,
                                   jax.random.fold_in(key, 9), jnp.int32(ts),
                                   HEMI)
    combined, direct, indirect, _ = jiispt.render_iile(
        _atrium(RES, RES), net_vars=flax_vars, seed=SEED, indirect_tasks=1,
        direct_samples=1, hemi_size=HEMI, use_pallas=False)
    out = {}
    _flatten("", dict(coords=coords, o=o, d=d, fi=fi, gb=gb, R=R, fo=fo,
                      fd=fd, ff=ff, mis_in=mis_in, rgb=rgb, valid=valid,
                      ts=ts, render=dict(combined=combined, direct=direct,
                                         indirect=indirect)), out)
    return out


CASES = dict(slice_scan16=slice_scan16, slice_compact48x32=slice_compact48x32,
             directlighting16=directlighting16,
             direct_compact_d1=direct_compact_d1, iile_task16=iile_task16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, choices=list(CASES))
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, fn in CASES.items():
        if args.only is not None and name not in args.only:
            continue
        t0 = time.time()
        out = fn()
        np.savez_compressed(os.path.join(GOLDEN, f"parity_{name}.npz"), **out)
        print(f"parity_{name}: {len(out)} arrays, {time.time() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
