"""Readings that an IILE cell's limits are set from, in one process.

    python benchmark/calibrate_iile.py --workload NAME --seeds 1,2,3 \
        [--half-seeds 4,5] [--zeroed-seeds 6,7] [--control-seeds 8,9] \
        [--tf32-seeds 10,11] [--out FILE]

For each of ``--seeds`` the program renders one frame of the cell and the
reference its two frames from that seed, and the frame's numbers are
printed with its ``cnn_map_rel``.  The faults, each judged the same way:
``--half-seeds`` renders half the traffic's tasks and direct passes (the
image's expectation kept, its noise doubled); ``--zeroed-seeds`` zeroes
the radiance maps the hemisphere MIS reads (the indirect image lost, the
kept maps sound).  The controls: ``--control-seeds`` puts the reference,
computed in the configuration's ``control`` precision, in the program's
place for the frame check; ``--tf32-seeds`` renders the program's frame
with TF32 on in the U-Net, for ``cnn_map_rel`` alone.  One JSON line each,
on standard output and appended to FILE.  Set-up runs once; no time is
measured but each frame's own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def tf32_convolutions(device):
    """The control of ``cnn_map_rel``: TF32 on in the U-Net's convolutions
    and products, in place of ``iisptnet.fp32_convolutions``."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=True):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def main(argv=None):
    sys.path.insert(0, ROOT)
    from benchmark import compare, harness
    from benchmark.drivers import iile_frames as fr

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    for k in ("seeds", "half-seeds", "zeroed-seeds", "control-seeds", "tf32-seeds"):
        ap.add_argument(f"--{k}", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env(ROOT))
    _, _, tr, cfg = harness.load_cell(args.workload)
    dev = torch.device(args.device)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    from pbrt_v3_iile_tpu_torch.integrators import iispt
    from pbrt_v3_iile_tpu_torch.models import iisptnet

    prog = fr.Cell(ROOT, cfg, tr, dev)
    warm = tr["warmup"]
    prog.frame(fr.derive_seed(0, "warmup"), tasks=warm["indirect_tasks"],
               direct=warm["direct_samples"])
    prog.maps.clear()
    mis, fp32 = iispt._mis_stage, iisptnet.fp32_convolutions

    def zeroed(scene, cam, R, *a, **k):
        return mis(scene, cam, torch.zeros_like(R), *a, **k)

    runs = []
    for kind, group in (("program", args.seeds), ("half", args.half_seeds),
                        ("zeroed", args.zeroed_seeds), ("tf32", args.tf32_seeds)):
        for s in seeds(group):
            tasks = direct = None
            if kind == "half":
                tasks, direct = tr["indirect_tasks"] // 2, tr["direct_samples"] // 2
            if kind == "zeroed":
                iispt._mis_stage = zeroed
            if kind == "tf32":
                iisptnet.fp32_convolutions = tf32_convolutions
            try:
                fr._sync(dev)
                t0 = time.perf_counter()
                img = prog.frame(fr.derive_seed(s, "frame", 0), tasks=tasks, direct=direct)
                fr._sync(dev)
                frame_s = time.perf_counter() - t0
            finally:
                iispt._mis_stage = mis
                iisptnet.fp32_convolutions = fp32
            runs.append((kind, s, frame_s, img, prog.maps[-1]))
    maps = prog.maps
    prog.free()
    del prog
    ref = fr.Reference(ROOT, cfg, tr, dev)
    for kind, s, frame_s, img, m in runs:
        if kind == "tf32":
            emit(dict(kind=kind, seed=s, frame_s=frame_s, cnn_map_rel=ref.map_rel(m)))
            continue
        t0 = time.perf_counter()
        a, b = ref.pair(fr.derive_seed(s, "reference"))
        n, _, _ = fr.judge_frames([img], [m], a, b, ref, tr)
        emit(dict(kind=kind, seed=s, frame_s=frame_s,
                  reference_s=time.perf_counter() - t0, **n[0]))
    del maps
    ctrl_ref = fr.Reference(ROOT, cfg, tr, dev, dtype=getattr(torch, cfg["control"]))
    for s in seeds(args.control_seeds):
        t0 = time.perf_counter()
        ctrl = ctrl_ref.frame(fr.derive_seed(s, "control")).float()
        t1 = time.perf_counter()
        a, b = ref.pair(fr.derive_seed(s, "reference"))
        n = compare.frame_numbers(ctrl, a, b, tr["tiles"])
        emit(dict(kind="control", dtype=cfg["control"], seed=s, control_s=t1 - t0, **n))


if __name__ == "__main__":
    main()
