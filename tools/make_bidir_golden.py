"""Generates the goldens that hold the port's bidirectional and photon
transport (BDPT with light tracing, Metropolis, SPPM) and its gradients
to the JAX package, with the JAX package on the CPU.

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_bidir_golden.py [--only NAME ...]

Writes, every render of scenes/atrium.pbrt (resolved as the other golden
tools resolve it) with the integrator and settings of its case:
  - tests/golden/bidir16_<case>.npz (the CPU tests), 16^2, depth 3:
    ``bdpt`` (2 spp, seed 0: the image and the light-tracing splat film
    apart), ``sppm`` (radius 0.05, 4 iterations, seed 0: the image and the
    photon-cell overflow count), ``mlt`` (BDPT-MLT, 16 mutations per
    pixel, the JAX defaults otherwise: seed 3's image, the three
    distances of seed 4's image from it, and a digest of seed 3's final
    chain state), ``pssmlt_eval`` (PSSMLT's f(u), the radiance of 1,024
    paths traced from explicit primary samples drawn from numpy seed 5)
    ``grad`` (tests/test_grad.py's scene, 4 spp, seed 0: the image and
    the gradient of its mean with respect to each DIFF_FIELDS tensor) and
    ``grad_mats`` (GRAD_MATS_SCENE below, as ``grad``: every material
    parameter of DIFF_FIELDS reaches its image);
  - tests/golden/bidir128_<case>.npz (chip_smoke.py's phase 13), 128^2,
    seed 3, the file's depth 6: ``bdpt`` (4 spp; the splat film in
    ``bidir128_bdpt_splat.npz``), ``sppm`` (radius 0.05, 8 iterations),
    ``mlt`` (4 mutations per pixel, as ``mlt`` above), and ``grad64``
    and ``grad64_clusters`` (atrium at 64^2, 2 spp, on the BVH and on the
    clusters: the image and the gradients; the cluster walker's Pluecker
    test moves a few grazing hits, so each accel has its own).

The three distances are chip_smoke.py's image measures (the relative
difference of the means, the largest of the horizontal thirds', and the
4x4-blurred relative L1): a port's MLT render is held no further from
seed 3 than seed 4 is, since one flipped acceptance sends a chain its own
way.  The chain digest is ``chain_digest(u)``, 8 bytes a chain, so that a
run can count the chains whose final state equals the reference's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
SCENES = os.path.join(REPO, "scenes")
RADIUS = 0.05       # SPPM's initial radius: pbrt's default 1.0 is a fifth
                    # of atrium's room, where nearly every cell overflows
N_EVAL = 1024       # PSSMLT paths of pssmlt_eval

# a room whose image depends on every DIFF_FIELDS tensor: an Oren-Nayar
# floor (mat_kd, mat_sigma), a plastic wall (mat_kd, mat_ks, mat_rough),
# a glass pane (mat_kr, mat_kt), a rough metal pane (mat_rough), a mirror
# wall (mat_kr), a point light and an area light (light_L)
GRAD_MATS_SCENE = """
LookAt 0 1.5 -4  0 1 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "integer maxdepth" [6]
WorldBegin
LightSource "point" "color I" [10 10 10] "point from" [0 3 -1]
AttributeBegin
AreaLightSource "diffuse" "color L" [4 4 4]
Shape "trianglemesh" "point P" [-1 3.9 -1 1 3.9 -1 1 3.9 1 -1 3.9 1]
  "integer indices" [0 2 1 0 3 2]
AttributeEnd
Material "matte" "color Kd" [0.6 0.5 0.4] "float sigma" [20]
Shape "trianglemesh" "point P" [-5 0 -5 5 0 -5 5 0 5 -5 0 5]
  "integer indices" [0 1 2 2 3 0]
Material "plastic" "color Kd" [0.3 0.4 0.5] "color Ks" [0.4 0.4 0.4]
  "float roughness" [0.2]
Shape "trianglemesh" "point P" [-5 0 2 5 0 2 5 5 2 -5 5 2]
  "integer indices" [0 1 2 2 3 0]
Material "glass" "color Kr" [0.9 0.9 0.9] "color Kt" [0.8 0.9 0.7]
  "float index" [1.5]
Shape "trianglemesh" "point P" [-1.5 0.2 0 -0.2 0.2 0 -0.2 1.8 0 -1.5 1.8 0]
  "integer indices" [0 1 2 2 3 0]
Material "metal" "float roughness" [0.1]
Shape "trianglemesh" "point P" [0.2 0.2 0.5 1.5 0.2 0.5 1.5 1.8 0.5 0.2 1.8 0.5]
  "integer indices" [0 1 2 2 3 0]
Material "mirror" "color Kr" [0.8 0.8 0.8]
Shape "trianglemesh" "point P" [-5 0 -5 -5 0 5 -5 5 5 -5 5 -5]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def chain_digest(u) -> np.ndarray:
    """(C,) uint64: the first 8 bytes of blake2b of each chain's float32
    primary samples."""
    u = np.ascontiguousarray(np.asarray(u, np.float32))
    return np.array([int.from_bytes(hashlib.blake2b(row.tobytes(),
                                                    digest_size=8).digest(),
                                    "little") for row in u], np.uint64)


def image_distances(img, ref) -> dict:
    """chip_smoke.py's image measures of img against ref: the relative
    difference of the means, the largest relative difference of the three
    horizontal thirds' means, and the 4x4-blurred relative L1."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    g = abs(img.mean() - ref.mean()) / ref.mean()
    res = img.shape[0]
    h = res // 3
    regions = [abs(img[lo:hi].mean() - ref[lo:hi].mean())
               / max(ref[lo:hi].mean(), 1e-3)
               for lo, hi in ((0, h), (h, 2 * h), (2 * h, res))]
    n = res // 4 * 4
    blur = lambda x: x[:n, :n].reshape(n // 4, 4, n // 4, 4, 3).mean((1, 3))
    rel = np.abs(blur(img) - blur(ref)).mean() / blur(ref).mean()
    return dict(global_rel=float(g), region_rel=float(max(regions)),
                blur_rel_l1=float(rel))


def load_case(api, case: dict):
    """A case's scene parsed by ``api`` (either package's scene/api.py) with
    its overrides (attribute paths of the parsed scene)."""
    if case.get("scene") == "grad_test":
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from test_grad import SCENE
        sd = api.load_scene_string(SCENE)
    elif case.get("scene") == "grad_mats":
        sd = api.load_scene_string(GRAD_MATS_SCENE)
    else:
        sd = api.load_scene_string(open(os.path.join(SCENES, "atrium.pbrt")).read(),
                                   SCENES)
    for path, value in case.get("overrides", {}).items():
        obj = sd
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return sd


def _over(res, kind, depth=None, **extra):
    o = {"film.x_resolution": res, "film.y_resolution": res,
         "integrator.kind": kind}
    if depth is not None:
        o["integrator.max_depth"] = depth
    o.update(extra)
    return o


TIER1 = {
    "bdpt": dict(mode="bdpt", overrides=_over(16, "bdpt", 3), spp=2, seed=0),
    "sppm": dict(mode="sppm", overrides=_over(
        16, "sppm", 3, **{"integrator.initial_radius": RADIUS}), iterations=4,
        seed=0),
    "mlt": dict(mode="mlt", overrides=_over(16, "mlt", 3), mpp=16, seed=3,
                seed_b=4),
    "pssmlt_eval": dict(mode="pssmlt_eval", overrides=_over(16, "mlt", 3),
                        u_seed=5),
    "grad": dict(mode="grad", scene="grad_test", overrides={}, spp=4, seed=0),
    "grad_mats": dict(mode="grad", scene="grad_mats", overrides={}, spp=4,
                      seed=0),
}
CHIP = {
    "bdpt": dict(mode="bdpt", overrides=_over(128, "bdpt"), spp=4, seed=3),
    "sppm": dict(mode="sppm", overrides=_over(
        128, "sppm", **{"integrator.initial_radius": RADIUS}), iterations=8,
        seed=3),
    "mlt": dict(mode="mlt", overrides=_over(128, "mlt"), mpp=4, seed=3,
                seed_b=4),
    "grad64": dict(mode="grad", overrides=_over(64, "path"), spp=2, seed=3),
    "grad64_clusters": dict(mode="grad", overrides=_over(64, "path"), spp=2,
                            seed=3, accel="clusters"),
}


def _bdpt(case):
    """(image, splat film / spp) of the JAX package's bdpt render loop."""
    import jax
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.ops import film as jfilm
    from pbrt_v3_iile_tpu.scene import api as japi

    sd = load_case(japi, case)
    H, W = sd.film.y_resolution, sd.film.x_resolution
    cfg = jrender.make_integrator_config(sd, accel="bvh")
    scene, cam = jrender.build(sd)
    run = jax.jit(jrender.render_pass_fn(sd, cfg), static_argnums=(4,))
    film = jfilm.new_film(H, W)
    splat = np.zeros((H * W, 3), np.float64)
    key = jax.random.PRNGKey(case["seed"])
    rays = 0
    for p in range(case["spp"]):
        L, jit_, aux = run(scene, cam, key, p, 0)
        film = jfilm.add_sample_image(film, L, jit_)
        splat += np.asarray(aux["splat"])[:H * W]
        rays += int(aux["rays"])
    splat = (splat / case["spp"]).astype(np.float32).reshape(H, W, 3)
    img = np.asarray(jfilm.resolve(film), np.float32) + splat
    return dict(img=img, splat=splat, rays=rays)


def _sppm(case):
    from pbrt_v3_iile_tpu.integrators import sppm as jsppm
    from pbrt_v3_iile_tpu.scene import api as japi

    img, st = jsppm.render_sppm(load_case(japi, case),
                                n_iterations=case["iterations"],
                                seed=case["seed"])
    return dict(img=np.asarray(img, np.float32), dropped=int(st["dropped"]))


def _mlt_run(sd, mpp, seed):
    """(image, stats, final chain state u) of the JAX package's Metropolis:
    render_mlt's bootstrap and chain scan (integrators/mlt.py:153-236) as
    written there, the scan also returning the chains' u."""
    import jax
    import jax.numpy as jnp
    from pbrt_v3_iile_tpu.integrators import mlt as jmlt
    from pbrt_v3_iile_tpu.ops import camera as jcam
    from pbrt_v3_iile_tpu.scene import device as jdev
    from pbrt_v3_iile_tpu.utils import vecmath as jvm

    H, W = sd.film.y_resolution, sd.film.x_resolution
    cfg = jmlt.MLTConfig(max_depth=sd.integrator.max_depth,
                         p_large=sd.integrator.mlt_p_large,
                         sigma=sd.integrator.mlt_sigma)
    scene = jdev.build_device_scene(sd)
    cam = jcam.make_camera(sd.camera, sd.film)
    cam_kind = jcam.KIND.get(sd.camera.kind, 0)
    has_lens = sd.camera.lens_radius > 0.0
    D = jmlt._dims(cfg)
    eval_fn = lambda u: jmlt._eval_bdpt(scene, cam, cam_kind, has_lens, u,
                                        cfg.max_depth)
    k_boot, k_sel, k_run = jax.random.split(jax.random.PRNGKey(seed), 3)

    @jax.jit
    def bootstrap(k):
        u = jax.random.uniform(k, (cfg.n_bootstrap, D))
        L, _ = eval_fn(u)
        return u, jvm.luminance(jnp.abs(L))

    u_boot, I_boot = bootstrap(k_boot)
    b = float(jnp.mean(I_boot))
    idx = jax.random.categorical(
        k_sel, jnp.log(jnp.maximum(I_boot, 1e-20)), shape=(cfg.n_chains,))
    u0 = u_boot[idx]
    n_steps = max(1, mpp * H * W // cfg.n_chains)

    def splat(film, film_xy, w, L):
        px = jnp.clip((film_xy[:, 0] * W).astype(jnp.int32), 0, W - 1)
        py = jnp.clip((film_xy[:, 1] * H).astype(jnp.int32), 0, H - 1)
        return film.at[py, px].add(w[:, None] * L)

    @jax.jit
    def chain_scan(u0, k):
        L0, xy0 = eval_fn(u0)
        I0 = jvm.luminance(jnp.abs(L0))
        film0 = jnp.zeros((H, W, 3), jnp.float32)

        def step(carry, k_step):
            u, L, I, xy, film = carry
            u_new, _ = jmlt._mutate(u, k_step, cfg.sigma, cfg.p_large)
            L_new, xy_new = eval_fn(u_new)
            I_new = jvm.luminance(jnp.abs(L_new))
            a = jnp.minimum(1.0, I_new / jnp.maximum(I, 1e-20))
            w_new = jnp.where(I_new > 0.0, a / jnp.maximum(I_new, 1e-20), 0.0)
            w_cur = jnp.where(I > 0.0, (1.0 - a) / jnp.maximum(I, 1e-20), 0.0)
            film = splat(film, xy_new, w_new, L_new)
            film = splat(film, xy, w_cur, L)
            accept = jax.random.uniform(jax.random.fold_in(k_step, 7),
                                        a.shape) < a
            u = jnp.where(accept[:, None], u_new, u)
            L = jnp.where(accept[:, None], L_new, L)
            I = jnp.where(accept, I_new, I)
            xy = jnp.where(accept[:, None], xy_new, xy)
            return (u, L, I, xy, film), None

        (u, _, _, _, film), _ = jax.lax.scan(
            step, (u0, L0, I0, xy0, film0), jax.random.split(k, n_steps))
        return film, u

    film, u = chain_scan(u0, k_run)
    done = n_steps * cfg.n_chains
    img = np.asarray(film) * (b * H * W / done)
    return (np.asarray(img, np.float32), dict(b=b, mutations=done),
            np.asarray(u))


def _mlt(case):
    from pbrt_v3_iile_tpu.scene import api as japi

    from pbrt_v3_iile_tpu.integrators import mlt as jmlt

    sd = load_case(japi, case)
    img, st, u = _mlt_run(sd, case["mpp"], case["seed"])
    img_b, _, _ = _mlt_run(sd, case["mpp"], case["seed_b"])
    if sd.film.x_resolution <= 16:
        ref, _ = jmlt.render_mlt(sd, mutations_per_pixel=case["mpp"],
                                 seed=case["seed"])
        print("mlt: the copied chain scan against render_mlt: max |diff| "
              f"{float(np.abs(np.asarray(ref) - img).max())}", flush=True)
    return dict(img=img, b=float(st["b"]), mutations=int(st["mutations"]),
                u_digest=chain_digest(u), u_shape=np.array(u.shape),
                spread=json.dumps(image_distances(img_b, img)),
                mean_b=float(img_b.mean()))


def pssmlt_u(case, max_depth: int) -> np.ndarray:
    """The explicit primary samples of pssmlt_eval: (N_EVAL, 4 +
    (max_depth + 1) * 10) uniforms of numpy seed u_seed."""
    rng = np.random.default_rng(case["u_seed"])
    return rng.random((N_EVAL, 4 + (max_depth + 1) * 10), dtype=np.float32)


def _pssmlt_eval(case):
    import jax
    import jax.numpy as jnp
    from pbrt_v3_iile_tpu.integrators import mlt as jmlt
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.ops import camera as jcam
    from pbrt_v3_iile_tpu.scene import api as japi

    sd = load_case(japi, case)
    md = sd.integrator.max_depth
    cfg = jrender.make_integrator_config(sd, accel="bvh")._replace(
        max_depth=md, nee=True, nee_all=False, direct_only=False, staged=False)
    scene, cam = jrender.build(sd)
    u = pssmlt_u(case, md)
    L, xy = jax.jit(lambda u: jmlt._eval(scene, cam, 0, False, u, cfg))(
        jnp.asarray(u))
    return dict(L=np.asarray(L, np.float32))


def _grad(case):
    import jax
    from pbrt_v3_iile_tpu.integrators import grad as jgrad
    from pbrt_v3_iile_tpu.integrators import render as jrender
    from pbrt_v3_iile_tpu.scene import api as japi

    sd = load_case(japi, case)
    accel = case.get("accel", "bvh")
    cfg = jrender.make_integrator_config(sd, accel=accel)
    scene, cam = jrender.build(sd, with_clusters=accel == "clusters")
    img, grads = jgrad.make_image_and_grad_fn(sd, cfg=cfg, spp=case["spp"])(
        scene, cam, jax.random.PRNGKey(case["seed"]))
    return dict(img=np.asarray(img, np.float32),
                **{f"grad_{k}": np.asarray(v, np.float32)
                   for k, v in grads.items()})


MODES = dict(bdpt=_bdpt, sppm=_sppm, mlt=_mlt, pssmlt_eval=_pssmlt_eval,
             grad=_grad)


def write_golden(prefix: str, name: str, case: dict):
    t0 = time.time()
    out = MODES[case["mode"]](case)
    meta = dict(case=json.dumps(case))
    if prefix == "bidir128" and "splat" in out:
        np.savez_compressed(os.path.join(GOLDEN, f"{prefix}_{name}_splat.npz"),
                            splat=out.pop("splat"), **meta)
    np.savez_compressed(os.path.join(GOLDEN, f"{prefix}_{name}.npz"), **out,
                        **meta)
    img = out.get("img", out.get("L"))
    assert np.isfinite(img).all(), name
    print(f"{prefix}_{name}: mean {img.mean():.6f} "
          f"{ {k: v for k, v in out.items() if np.ndim(v) == 0} } "
          f"{time.time() - t0:.1f} s", flush=True)


def case_of(z) -> dict:
    """The case (settings) a golden was made with."""
    return json.loads(str(z["case"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="<prefix>_<case> names")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    for prefix, cases in (("bidir16", TIER1), ("bidir128", CHIP)):
        for name, case in cases.items():
            if args.only is None or f"{prefix}_{name}" in args.only:
                write_golden(prefix, name, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
