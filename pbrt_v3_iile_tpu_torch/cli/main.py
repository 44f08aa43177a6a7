"""Command-line renderer of the PyTorch port (path integrator).

Usage:
  python -m pbrt_v3_iile_tpu_torch.cli.main scene.pbrt [out.pfm] \
      [--spp N] [--seed S] [--accel bvh|clusters] [--compact] \
      [--device cuda|cpu] [--outfile PATH]

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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accel", default=None, choices=["bvh", "clusters"],
                    help="aggregate (default: clusters on CUDA, bvh on CPU)")
    ap.add_argument("--compact", action="store_true",
                    help="compacted-wavefront path loop")
    ap.add_argument("--device", default="cuda", help="torch device")
    ap.add_argument("--stats", action="store_true",
                    help="print render stats as JSON on stderr")
    args = ap.parse_args(argv)

    from ..scene import api as apilib

    from ..integrators import render as renderlib

    sd = apilib.load_scene(args.scene)
    out = args.outfile or args.out or sd.film.filename
    img, stats = renderlib.render(sd, spp=args.spp, seed=args.seed,
                                  accel=args.accel, compact=args.compact,
                                  device=args.device)
    write_output(out, img)
    if args.stats:
        print(json.dumps(stats), file=sys.stderr)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
