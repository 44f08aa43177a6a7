"""Readings that a cell's limits are set from, in one process.

    python benchmark/calibrate.py --workload NAME --seeds 1,2,3 \
        --control-seeds 4,5,6 --half-spp-seeds 7,8,9 [--out FILE]

For each of ``--seeds`` the program renders one frame of the cell and the
reference its two halves from that seed, and the frame's numbers are
printed.  For each of ``--control-seeds`` the control does the same in the
program's place: the reference itself, computed in the precision that the
configuration names under ``control`` (the nearest below the one it
states), at the cell's pixel samples.  For each of ``--half-spp-seeds``
the program renders its frame with half the traffic's pixel samples, a
fault that keeps the image's expectation.  One JSON line each, on standard
output and appended to FILE.  Set-up runs once; no time is measured.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import compare, harness
    from benchmark.drivers import path_frames as pf

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--half-spp-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env(ROOT))
    _, _, tr, cfg = harness.load_cell(args.workload)
    dev = torch.device("cuda")

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    runs = [("program", s, tr["spp"]) for s in seeds(args.seeds)]
    runs += [("half_spp", s, tr["spp"] // 2) for s in seeds(args.half_spp_seeds)]
    prog = pf.Cell(ROOT, cfg, tr, dev) if runs else None
    frames = []
    for kind, s, spp in runs:
        t0 = time.perf_counter()
        img, rays = prog.frame(pf.derive_seed(s, "frame", 0), spp=spp)
        frames.append((kind, s, spp, time.perf_counter() - t0, rays, img))
    if prog is not None:
        prog.free()
    for kind, s, spp, frame_s, rays, img in frames:
        t0 = time.perf_counter()
        a, b = pf.reference_halves(ROOT, cfg, tr, pf.derive_seed(s, "reference"), dev)
        n = compare.frame_numbers(torch.from_numpy(img).to(dev), a, b, tr["tiles"])
        emit(dict(kind=kind, seed=s, spp=spp, frame_s=frame_s,
                  reference_s=time.perf_counter() - t0, rays=rays, **n))
    ctrl_dtype = getattr(torch, cfg["control"])
    for s in seeds(args.control_seeds):
        t0 = time.perf_counter()
        ctrl = pf.reference_image(ROOT, cfg, tr, pf.derive_seed(s, "control"),
                                  tr["spp"], dev, dtype=ctrl_dtype)
        t1 = time.perf_counter()
        a, b = pf.reference_halves(ROOT, cfg, tr, pf.derive_seed(s, "reference"), dev)
        n = compare.frame_numbers(ctrl, a, b, tr["tiles"])
        emit(dict(kind="control", dtype=cfg["control"], seed=s, spp=tr["spp"],
                  control_s=t1 - t0, **n))


if __name__ == "__main__":
    main()
