"""Held-out evaluation of IISPTNet weights on atrium, on one NVIDIA GPU:
the committed net against a net the port trained.

Run from the repository root on a machine with a GPU:

    python3 tools/eval_nets_torch.py [--trained NPZ]

For each net, in turns (committed, trained, committed, trained), the
atrium 512^2 IILE render at the CLI's defaults
(``integrators/iispt.py::render_iile``: 16 tasks, 16 direct passes, 32^2
probes, accel ``clusters``, seed 0), after one 128^2 warmup render: wall
seconds (the scene build included, as the CLI runs it) and
render_iile's own seconds, PSNR and SSIM (``utils/metrics.py``) against
the 320-spp path reference ``tests/golden/atrium_gt_oracle_path320_512.npz``.  Then
``ml/evalstats.py::compare_predictions`` for both nets on chip_smoke.py
phase 9(f)'s 64 atrium probes (an 8 x 8 grid over the 512^2 film, key
``prng_key(4)``, gt_spp 16, 32^2 hemispheres, clusters).  atrium is held
out of the training corpus.  One ``[name] {json}`` line per reading; the
last line is nvidia-smi's name and power limit.  Readings, no limits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REPS = 2   # renders of each net


def line(tag, **kw):
    print(f"[{tag}] " + json.dumps(kw), flush=True)


def main(argv=None):
    from pbrt_v3_iile_tpu_torch.cli import train as clitrain
    from pbrt_v3_iile_tpu_torch.integrators import iispt
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ml import dataset as datasetlib
    from pbrt_v3_iile_tpu_torch.ml import evalstats
    from pbrt_v3_iile_tpu_torch.models import weights
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.utils import metrics

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trained", default=weights.TRAINED_NPZ,
                    help="the trained net's npz (default: the committed H100 net)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this tool needs a GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "unavailable"
    nets = {"committed": weights.DEFAULT_NPZ, "trained": args.trained}

    def atrium(side):
        sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
        sd.film.x_resolution = sd.film.y_resolution = side
        return sd

    gt = np.load(os.path.join(REPO, "tests", "golden",
                              "atrium_gt_oracle_path320_512.npz"))["img"]
    iispt.render_iile(atrium(128), weights=nets["committed"], device=dev)  # warmup
    readings = {name: [] for name in nets}
    for rep in range(REPS):
        for name, path in nets.items():
            torch.cuda.synchronize()
            t0 = time.time()
            c, d, i, st = iispt.render_iile(atrium(512), weights=path, device=dev)
            torch.cuda.synchronize()
            r = dict(net=name, rep=rep, wall_seconds=time.time() - t0,
                     render_seconds=st["seconds"], accel=st["accel"],
                     tasks=st["tasks"],
                     finite=bool(all(np.isfinite(x).all() for x in (c, d, i))),
                     means=[float(c.mean()), float(d.mean()), float(i.mean())],
                     psnr=metrics.psnr(c, gt), ssim=metrics.ssim(c, gt),
                     psnr_direct_only=metrics.psnr(d, gt))
            readings[name].append(r)
            line(f"eval_iile512_{name}", **r, power=smi)
    line("eval_iile512_summary", power=smi, **{
        name: dict(psnr=[r["psnr"] for r in rs], ssim=[r["ssim"] for r in rs],
                   wall_seconds=[r["wall_seconds"] for r in rs])
        for name, rs in readings.items()})

    # the evaluation statistics on held-out atrium probes
    sd = atrium(512)
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    coords = clitrain.probe_grid(512, 512, 8)
    raw = datasetlib.generate_examples(
        scene, cam, camlib.KIND.get(sd.camera.kind, 0), threefry.prng_key(4),
        torch.as_tensor(coords, device=dev), hemi_size=32, gt_spp=16,
        accel="clusters")
    for name, path in nets.items():
        stats = evalstats.compare_predictions(raw, weights.load_iisptnet(path, dev))
        line(f"eval_evalstats_atrium_{name}", probes=int(coords.shape[0]),
             valid=int(raw["valid"].sum()), gt_spp=16, means=stats["means"],
             p_values=stats["p_values"])
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
