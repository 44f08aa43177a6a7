"""Train IISPTNet on probe data generated on the device, and optionally
render IILE with the trained net: the reference workflow (render_reference
-> main_train.py -> iispt render, tools/training_batch_generate.py) in
one command (port of ``scripts/train_demo.py`` and
``scripts/train_pretrained.py``).

Usage:
  python -m pbrt_v3_iile_tpu_torch.cli.train [--scene S.pbrt | --scenes
      interior_v1,interior_v2,interior_v3,box] [--grid 14] [--reps 3]
      [--gt-spp 128] [--hemi 32] [--steps 1500] [--workdir DIR] [--out NPZ]
      [--render] [--device cuda|cpu] [--seed 0]

Each scene gets a grid x grid probe grid over its film (pixels
linspace(0.05 W, 0.95 W, grid), shifted by 2 pixels a rep), ``reps``
jittered reps of it, and gt_spp hemispherical renders per probe for the
ground truth.  Dataset shards (``ds_<tag>.npz``) and the training state
(``train_state.pt``: net, Adam's state, step count) are kept in the work
directory, and a second run resumes from them.  The trained net is
written as a flat float16 npz (``--out``), the committed model's
format; ``--render`` then renders the first scene with IILE beside it.
Named scenes: ``interior_v1..3`` and ``atrium`` (``scenes/``; atrium is
held out of the default corpus for quality evaluation) and ``box``, a
Cornell-style box.  The recipe is the reference's: Adam 6e-5, L1,
batch 32, from a flax-style initialization.

Keys, as ``scripts/train_pretrained.py`` keys them at ``--seed 0``: the
net is initialized from seed INIT_SEED + seed (the JAX recipe's
``PRNGKey(1)``; torch draws the distribution of flax's initialization,
not its bits), and the training rounds, one epoch each, draw their
batches with ``fold_in(prng_key(TRAIN_SEED + seed), steps done)`` (the
recipe's ``fold_in(PRNGKey(11), len(losses))``), so the same examples
give the JAX trainer's batches.  Generation keys scene ``tag`` with
``fold_in(prng_key(seed), crc32(tag))``: the recipe's
``PRNGKey(hash(tag))`` changes with each process's string-hash salt.
Training stops after exactly ``--steps`` steps, where the JAX recipe
finishes the epoch it is in.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_WORKDIR = os.path.join(REPO, "build", "iispt_train")
INIT_SEED, TRAIN_SEED = 1, 11   # scripts/train_pretrained.py's PRNGKey(1), PRNGKey(11)

DEMO_SCENE = """
LookAt 0 2.5 -6  0 2.5 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [128] "integer yresolution" [128]
Integrator "iispt" "integer maxdepth" [5]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [30 30 30]
  Translate 0 4.7 0
  Shape "sphere" "float radius" [0.4]
AttributeEnd
Material "matte" "color Kd" [0.65 0.65 0.65]
# floor / ceiling / back / left (red) / right (green)
Shape "trianglemesh" "point P" [-3 0 -7 3 0 -7 3 0 3 -3 0 3] "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-3 5 -7 3 5 -7 3 5 3 -3 5 3] "integer indices" [0 2 1 2 0 3]
Shape "trianglemesh" "point P" [-3 0 3 3 0 3 3 5 3 -3 5 3] "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.7 0.15 0.15]
Shape "trianglemesh" "point P" [-3 0 -7 -3 0 3 -3 5 3 -3 5 -7] "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.15 0.7 0.15]
Shape "trianglemesh" "point P" [3 0 -7 3 0 3 3 5 3 3 5 -7] "integer indices" [0 2 1 2 0 3]
Material "plastic" "color Kd" [0.3 0.3 0.5] "color Ks" [0.4 0.4 0.4] "float roughness" [0.05]
Shape "trianglemesh" "point P" [-1.5 0 0 0 0 0.8 0 2 0.8 -1.5 2 0] "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def probe_grid(width: int, height: int, grid: int):
    """(grid^2, 2) int32 film pixels: linspace(0.05, 0.95) of each side."""
    gx = np.linspace(width * 0.05, width * 0.95, grid).astype(np.int32)
    gy = np.linspace(height * 0.05, height * 0.95, grid).astype(np.int32)
    mx, my = np.meshgrid(gx, gy)
    return np.stack([mx, my], -1).reshape(-1, 2)


def gen_scene_examples(tag, sd, key, grid, reps, gt_spp, hemi, workdir,
                       device, log=print):
    """Raw examples (numpy dicts p, d, n, z) of one scene: reps jittered
    probe grids, rep r keyed fold_in(key, r) and shifted by 2r pixels;
    probes that found no surface or whose ground truth is not finite are
    dropped.  Kept in (and resumed from) workdir/ds_<tag>.npz as float16."""
    import torch

    from ..integrators import render as renderlib
    from ..ml import dataset as datasetlib
    from ..ops import camera as camlib
    from ..ops import threefry

    shard_path = os.path.join(workdir, f"ds_{tag}.npz")
    if os.path.exists(shard_path):
        with np.load(shard_path) as z:
            out = [{k: z[f"{k}{i}"].astype(np.float32) for k in "pdnz"}
                   for i in range(int(z["n"]))]
        log(f"[{tag}] resumed {len(out)} examples from {shard_path}")
        return out

    accel = renderlib.resolve_accel(sd, None, device)
    scene, cam = renderlib.build(sd, device, with_clusters=accel == "clusters",
                                 with_kdtree=accel == "kdtree")
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    base = probe_grid(sd.film.x_resolution, sd.film.y_resolution, grid)
    out = []
    t0 = time.time()
    for rep in range(reps):
        coords = torch.as_tensor(base + rep * 2, device=device)
        maps = datasetlib.generate_examples(
            scene, cam, cam_kind, threefry.fold_in(key, rep), coords,
            hemi_size=hemi, gt_spp=gt_spp, accel=accel)
        m = {k: v.cpu().numpy() for k, v in maps.items()}
        for i in range(coords.shape[0]):
            if m["valid"][i] and np.isfinite(m["p"][i]).all():
                out.append({k: m[k][i] for k in "pdnz"})
        log(f"[{tag}] rep {rep + 1}/{reps}: {len(out)} examples "
            f"({time.time() - t0:.1f}s, accel {accel})")

    blob = {"n": np.int32(len(out))}
    for i, ex in enumerate(out):
        for k in "pdnz":
            blob[f"{k}{i}"] = ex[k].astype(np.float16)
    np.savez_compressed(shard_path, **blob)
    log(f"[{tag}] saved {len(out)} examples -> {shard_path}")
    return out


def load_named_scene(name: str):
    """A scene description by name (``box``, ``atrium``, ``interior_vN``)
    or by path; atrium's film is cut to 384^2 as the JAX trainer cuts it."""
    from ..scene import api as apilib

    if name == "box":
        return apilib.load_scene_string(DEMO_SCENE)
    path = name if name.endswith(".pbrt") else os.path.join(
        REPO, "scenes", f"{name}.pbrt")
    sd = apilib.load_scene(path)
    if name == "atrium":
        sd.film.x_resolution = sd.film.y_resolution = 384
    return sd


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrt-iile-torch-train",
        description="Train IISPTNet on probes generated by the PyTorch port")
    ap.add_argument("--scene", default=None, help="one .pbrt scene file")
    ap.add_argument("--scenes", default="interior_v1,interior_v2,interior_v3,box",
                    help="comma-separated named scenes (without --scene)")
    ap.add_argument("--grid", type=int, default=14, help="probe grid per side")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gt-spp", type=int, default=128)
    ap.add_argument("--hemi", type=int, default=32)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR,
                    help="dataset shards and the resumable training state")
    ap.add_argument("--out", default=None,
                    help="trained net, flat npz (default: "
                         "WORKDIR/iispt_trained.npz)")
    ap.add_argument("--render", action="store_true",
                    help="render IILE with the trained net afterwards")
    ap.add_argument("--device", default="cuda", help="torch device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from ..ml import train as trainlib
    from ..ops import threefry

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    os.makedirs(args.workdir, exist_ok=True)
    out = args.out or os.path.join(args.workdir, "iispt_trained.npz")
    log = lambda msg: print(msg, flush=True)
    key = threefry.prng_key(args.seed)

    t_start = time.time()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    names = [args.scene] if args.scene else args.scenes.split(",")
    raws = []
    for name in names:
        tag = os.path.splitext(os.path.basename(name))[0]
        raws += gen_scene_examples(
            tag, load_named_scene(name), threefry.fold_in(key, zlib.crc32(tag.encode())),
            args.grid, args.reps, args.gt_spp, args.hemi, args.workdir,
            device, log)
    log(f"dataset: {len(raws)} examples")

    state = trainlib.init_training(
        torch.Generator().manual_seed(INIT_SEED + args.seed),
        hemi_size=args.hemi, device=device)
    resume = os.path.join(args.workdir, "train_state.pt")
    done = 0
    if os.path.exists(resume):
        state, done = trainlib.load_state(resume, state)
        log(f"resumed the training state at step {done} from {resume}")
    train_key = threefry.prng_key(TRAIN_SEED + args.seed)
    losses = []
    t0 = time.time()
    while done < args.steps:
        state, ls = trainlib.train(
            raws, state, threefry.fold_in(train_key, done), max_epochs=1,
            time_budget_s=1e9, log_every=50, log=log,
            max_steps=args.steps - done)
        if not ls:
            raise SystemExit(f"{len(raws)} examples make no batch of "
                             f"{trainlib.BATCH_SIZE}")
        losses += ls
        done += len(ls)
        trainlib.save_state(resume, state, done)
        log(f"steps {done}: loss {np.mean(ls[-20:]):.5f} "
            f"({time.time() - t0:.0f}s)")
    if losses:
        secs = time.time() - t0
        log(f"loss first {float(np.mean(losses[:20]))} -> "
            f"last {float(np.mean(losses[-20:]))}; {len(losses)} steps in "
            f"{secs:.1f}s ({len(losses) / secs:.2f} steps/s)")

    trainlib.save_pretrained(out, state)
    peak = (f", device memory peak {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB"
            if device.type == "cuda" else "")
    log(f"saved {out}: wall {time.time() - t_start:.1f}s{peak}")

    if args.render:
        from ..integrators import iispt as iisptlib
        from ..utils import image as imglib

        sd = load_named_scene(names[0])
        combined, direct, indirect, stats = iisptlib.render_iile(
            sd, net=state["net"], indirect_tasks=4, direct_samples=8,
            hemi_size=args.hemi, device=device)
        path = os.path.splitext(out)[0] + "_iile.exr"
        imglib.write_exr(path, combined)
        log(f"rendered {path}: indirect mean {indirect.mean():.5f}, direct "
            f"mean {direct.mean():.5f}, {stats['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
