"""Command-line renderer of the PyTorch port.

Usage:
  python -m pbrt_v3_iile_tpu_torch.cli.main scene.pbrt [out.pfm] \
      [--integrator path|volpath|directlighting|whitted|ambientocclusion|\
                    iispt] \
      [--spp N] [--seed S] [--accel bvh|clusters|kdtree] [--compact] \
      [--device cuda|cpu] [--quick] [--verbose | --quiet] [--stats] \
      [--filmCheckpoint FILE [--checkpointEvery N]] \
      [--iileIndirect N] [--iileDirect N] [--iispt_hemi_size N] \
      [--weights NPZ] [--checkpoint FILE] [--iileControl DIR] \
      [--outfile PATH]

``--quick`` renders at a quarter of the resolution (at least 64) and a
quarter of the samples; ``--stats`` prints the render's stats as JSON
and the per-stage wall times and counters of ``utils/stats.py`` on
stderr; ``--filmCheckpoint`` saves the film every ``--checkpointEvery``
passes and resumes from the file when it exists.

``iispt`` renders with IILE and also writes ``iispt_direct.exr`` and
``iispt_indirect.exr`` beside the output, printing ``#INDPROGRESS!<f>``
and ``#DIRECTPROGRESS!<f>`` as the tasks and direct passes finish, and
``#FINISH!`` at the end, as the reference's launcher expects.  With
``--iileControl DIR`` it also writes ``out_direct.pfm``,
``out_indirect.pfm`` and ``out_combined.pfm`` there and prints
``#REFRESH!`` (the reference's directoryControlThread, iispt.cpp:749-787).
``--checkpoint`` renders with a trained net: a ``ml/train.py``
checkpoint pickle, or a flat npz (``.npz``).

``volpath`` renders participating media (homogeneous and grid-density);
``path`` renders them too when the scene has any, as the reference does.

``--accel kdtree`` renders on the kd-tree (built for the render whether or
not the scene has an ``Accelerator "kdtree"`` line); a scene with object
motion renders on the BVH's motion variant, and ``Camera "realistic"``
traces its lens table (``lensfile``, resolved against the scene's
directory).

Scenes are parsed by the port's own ``scene/api.py`` and images written
through its ``utils/image.py`` (.pfm, .png tonemapped, .exr).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def write_output(path: str, img):
    from ..utils import image as imglib

    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        imglib.write_pfm(path, img)
    elif ext == ".png":
        imglib.write_png_tonemapped(path, img)
    elif ext == ".exr":
        imglib.write_exr(path, img)
    else:
        imglib.write_exr(path + ".exr", img)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pbrt-iile-torch",
        description="PyTorch/CUDA port of the pbrt_v3_iile_tpu path tracer")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("out", nargs="?", default=None, help="output image")
    ap.add_argument("--outfile", default=None,
                    help="output image (overrides the positional one)")
    ap.add_argument("--spp", type=int, default=None,
                    help="override the sampler's pixelsamples")
    ap.add_argument("--integrator", default=None,
                    choices=["path", "volpath", "directlighting", "whitted",
                             "ambientocclusion", "iispt"],
                    help="override the scene's integrator")
    ap.add_argument("--iileIndirect", "--iileIndirectTasks", type=int,
                    default=16, dest="iile_indirect", help="IILE indirect tasks")
    ap.add_argument("--iileDirect", "--iileDirectSamples", type=int,
                    default=16, dest="iile_direct",
                    help="IILE progressive direct passes")
    ap.add_argument("--iispt_hemi_size", type=int, default=32,
                    help="IILE probe hemisphere resolution")
    ap.add_argument("--weights", default=None,
                    help="IISPTNet npz (default: the committed pretrained "
                         "model)")
    ap.add_argument("--checkpoint", default=None,
                    help="IISPTNet checkpoint for iispt: a training pickle "
                         "(ml/train.py save_checkpoint) or a flat .npz")
    ap.add_argument("--iileControl", default=None,
                    help="control directory for IILE's preview images")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accel", default=None,
                    choices=["bvh", "clusters", "kdtree"],
                    help="aggregate (default: the scene file's Accelerator, "
                         "else clusters on CUDA and bvh on CPU)")
    ap.add_argument("--compact", action="store_true",
                    help="compacted-wavefront path loop")
    ap.add_argument("--device", default="cuda", help="torch device")
    ap.add_argument("--stats", action="store_true",
                    help="print render stats and per-stage times on stderr")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution, a quarter of the samples")
    ap.add_argument("--verbose", action="store_true", help="verbose logging")
    ap.add_argument("--quiet", action="store_true", help="errors only")
    ap.add_argument("--filmCheckpoint", default=None,
                    help="film checkpoint file for resumable renders")
    ap.add_argument("--checkpointEvery", type=int, default=16,
                    help="passes between film checkpoints")
    args = ap.parse_args(argv)

    from ..scene import api as apilib
    from ..integrators import render as renderlib
    from ..utils import log as loglib
    from ..utils import stats as statslib

    if args.verbose:
        loglib.set_verbosity(loglib.VERBOSE)
    elif args.quiet:
        loglib.set_verbosity(loglib.ERROR)
    statslib.enable(args.stats)
    sd = apilib.load_scene(args.scene)
    if args.integrator:
        sd.integrator.kind = args.integrator
    if args.quick:
        sd.film.x_resolution = max(64, sd.film.x_resolution // 4)
        sd.film.y_resolution = max(64, sd.film.y_resolution // 4)
        sd.sampler.pixel_samples = max(1, sd.sampler.pixel_samples // 4)
    out = args.outfile or args.out or sd.film.filename
    if sd.integrator.kind == "iispt":
        from ..integrators import iispt as iisptlib
        from ..utils import image as imglib

        def report(phase, done, total):
            token = "#INDPROGRESS!" if phase == "indirect" else "#DIRECTPROGRESS!"
            print(f"{token}{done / total}", flush=True)

        weights, net = args.weights, None
        if args.checkpoint and args.checkpoint.lower().endswith(".npz"):
            weights = args.checkpoint
        elif args.checkpoint:
            from ..ml import train as trainlib

            net = trainlib.load_checkpoint(args.checkpoint)
        img, direct, indirect, stats = iisptlib.render_iile(
            sd, weights=weights, net=net, seed=args.seed,
            indirect_tasks=args.iile_indirect, direct_samples=args.iile_direct,
            hemi_size=args.iispt_hemi_size, report=report, accel=args.accel,
            device=args.device)
        base = os.path.dirname(os.path.abspath(out))
        imglib.write_exr(os.path.join(base, "iispt_direct.exr"), direct)
        imglib.write_exr(os.path.join(base, "iispt_indirect.exr"), indirect)
        if args.iileControl:
            os.makedirs(args.iileControl, exist_ok=True)
            for name, im in (("direct", direct), ("indirect", indirect),
                             ("combined", img)):
                imglib.write_pfm(os.path.join(args.iileControl,
                                              f"out_{name}.pfm"), im)
            print("#REFRESH!", flush=True)
        write_output(out, img)
        print("#FINISH!", flush=True)
    else:
        img, stats = renderlib.render(sd, spp=args.spp, seed=args.seed,
                                      accel=args.accel, compact=args.compact,
                                      device=args.device,
                                      checkpoint=args.filmCheckpoint,
                                      checkpoint_every=args.checkpointEvery)
        write_output(out, img)
    if args.stats:
        print(json.dumps(stats), file=sys.stderr)
        print(statslib.report(), file=sys.stderr)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
