"""Offline tool CLIs of the port: metrics, tonemap, convert, benchmark,
bsdftest, histogram, flipnz (port of ``cli/tools.py``).

Replaces the reference's tool scripts:
- `metrics`   = tools/ssim_cmd.py + pfm.py metrics (SSIM/PSNR/L1/entropy)
- `tonemap`   = tools/cpfm (PFM->LDR with auto/manual exposure) +
                tools/pfm_to_png.py
- `convert`   = src/tools/imgtool.cpp convert (formats only)
- `benchmark` = tools/progressive_iile_render.py /
                progressive_path_render.py (render a scene at increasing
                task counts / spp, record wall time + quality), through
                the port's render() and render_iile()
- `bsdftest`  = src/tools/bsdftest.cpp (three reflectance estimators per
                model), its uniforms drawn through ops/threefry.py with
                the JAX package's keys, so its estimates are the JAX
                tool's
- `histogram` = tools/gen_histograms.py, `flipnz` = tools/flipNZ.py

``benchmark`` and ``bsdftest`` take ``--device`` (the card unless the
caller asks for the CPU); the others are host code.

Usage: python -m pbrt_v3_iile_tpu_torch.cli.tools <metrics|tonemap|convert|
       benchmark|bsdftest|histogram|flipnz> ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(path):
    from ..utils import image as imglib

    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "pfm":
        return imglib.read_pfm(path)
    if ext == "exr":
        return imglib.read_exr(path)
    if ext == "png":
        return imglib.read_png(path).astype(np.float32) / 255.0
    if ext == "npy":
        return np.load(path)
    raise ValueError(f"unknown image format {path}")


def cmd_metrics(argv):
    from ..utils import metrics as m

    ap = argparse.ArgumentParser(prog="tools metrics")
    ap.add_argument("image")
    ap.add_argument("reference")
    args = ap.parse_args(argv)
    a = _load(args.image)
    b = _load(args.reference)
    print(json.dumps({
        "l1": m.l1(a, b),
        "mse": m.mse(a, b),
        "psnr_db": m.psnr(a, b),
        "ssim": m.ssim(a, b),
        "entropy_kb": m.compressed_entropy_kb(a),
    }))
    return 0


def cmd_tonemap(argv):
    from ..utils import image as imglib

    ap = argparse.ArgumentParser(prog="tools tonemap")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--exposure", type=float, default=None,
                    help="stops; default auto (ref: tools/cpfm autoexposure)")
    ap.add_argument("--gamma", type=float, default=2.2)
    args = ap.parse_args(argv)
    img = _load(args.input)
    if args.exposure is None:
        # auto exposure: map the 90th percentile to 0.8 (cpfm-style)
        p90 = float(np.percentile(img, 90))
        scale = 0.8 / max(p90, 1e-9)
    else:
        scale = 2.0 ** args.exposure
    ldr = np.clip(img * scale, 0.0, 1.0) ** (1.0 / args.gamma)
    imglib.write_png(args.output, ldr)
    print(f"wrote {args.output}")
    return 0


def cmd_convert(argv):
    """Image format conversion (imgtool-convert equivalent,
    ref: src/tools/imgtool.cpp convert)."""
    from ..utils import image as imglib

    ap = argparse.ArgumentParser(prog="tools convert")
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    img = _load(args.input)
    ext = args.output.rsplit(".", 1)[-1].lower()
    if ext == "pfm":
        imglib.write_pfm(args.output, img)
    elif ext == "exr":
        imglib.write_exr(args.output, img)
    elif ext == "png":
        imglib.write_png_tonemapped(args.output, img)
    elif ext == "npy":
        np.save(args.output, img)
    else:
        raise SystemExit(f"unknown output format {ext}")
    print(f"wrote {args.output}")
    return 0


def cmd_benchmark(argv):
    import time

    from ..integrators import render as renderlib
    from ..scene import api as apilib
    from ..utils import metrics as m

    ap = argparse.ArgumentParser(prog="tools benchmark")
    ap.add_argument("scene")
    ap.add_argument("--mode", choices=["path", "iile"], default="path")
    ap.add_argument("--spp-list", default="1,4,16,64")
    ap.add_argument("--tasks-list", default="0,1,8,16,64")
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--out", default="bench_results.json")
    ap.add_argument("--device", default="cuda", help="torch device")
    args = ap.parse_args(argv)

    sd = apilib.load_scene(args.scene)
    results = []
    if args.mode == "path":
        ref_img, _ = renderlib.render(sd, spp=args.ref_spp, device=args.device)
        for spp in [int(x) for x in args.spp_list.split(",")]:
            t0 = time.time()
            img, stats = renderlib.render(sd, spp=spp, device=args.device)
            results.append(dict(spp=spp, seconds=time.time() - t0,
                                psnr_db=m.psnr(img, ref_img),
                                entropy_kb=m.compressed_entropy_kb(img),
                                mrays_per_s=stats["mrays_per_s"]))
            print(json.dumps(results[-1]), flush=True)
    else:
        from ..integrators import iispt as iisptlib
        for tasks in [int(x) for x in args.tasks_list.split(",")]:
            t0 = time.time()
            combined, _, _, stats = iisptlib.render_iile(
                sd, indirect_tasks=tasks, direct_samples=16,
                device=args.device)
            results.append(dict(tasks=tasks, seconds=time.time() - t0,
                                entropy_kb=m.compressed_entropy_kb(combined)))
            print(json.dumps(results[-1]), flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return 0


BSDF_MODELS = "matte,oren,plastic,metal,substrate,uber,translucent,disney"


def bsdf_estimates(models=BSDF_MODELS, n: int = 1 << 15, theta: float = 30.0,
                   device="cuda") -> dict:
    """bsdftest's numbers for each model name (comma-separated): the
    hemispherical-directional reflectance by uniform-hemisphere sampling,
    by cosine sampling and by the BSDF's own sampling (reflection only),
    and the largest relative gap between sample()'s pdf and evaluate()'s
    on the sampled directions.  Draws: uniform(fold_in(PRNGKey(7), i)) for
    i = 1..4, as the JAX tool draws them.  Unknown names are left out."""
    import torch

    from ..ops import bsdf as bsdflib
    from ..ops import sampling as smp
    from ..ops import threefry
    from ..scene import api as apilib

    kinds = {
        "matte": (apilib.MAT_MATTE, {}),
        "oren": (apilib.MAT_MATTE, dict(sigma=20.0)),
        "plastic": (apilib.MAT_PLASTIC, {}),
        "metal": (apilib.MAT_METAL, {}),
        "substrate": (apilib.MAT_SUBSTRATE, {}),
        "uber": (apilib.MAT_UBER, {}),
        "translucent": (apilib.MAT_TRANSLUCENT, {}),
        "disney": (apilib.MAT_DISNEY, {}),
    }
    dev = torch.device(device)
    key = threefry.prng_key(7)
    th = np.deg2rad(theta)
    wo = torch.tensor([[np.sin(th), 0.0, np.cos(th)]], dtype=torch.float32,
                      device=dev).expand(n, 3).contiguous()
    rows = lambda v: torch.tensor([v], dtype=torch.float32,
                                  device=dev).expand(n, 3).contiguous()
    full = lambda v: torch.full((n,), float(v), dtype=torch.float32, device=dev)
    uniform = lambda i, shape: threefry.uniform(threefry.fold_in(key, i), shape,
                                                dev)
    cpu = lambda t: t.to("cpu", torch.float32).numpy()
    out = {}
    for name in models.split(","):
        if name not in kinds:
            continue
        kind, over = kinds[name]
        p = bsdflib.BsdfParams(
            kind=torch.full((n,), kind, dtype=torch.int32, device=dev),
            kd=rows([0.6, 0.4, 0.2]), ks=rows([0.25, 0.25, 0.25]),
            kr=rows([0.9, 0.9, 0.9]), kt=rows([1.0, 1.0, 1.0]),
            alpha=full(0.15), eta=full(1.5), metal_eta=rows([0.2, 0.92, 1.1]),
            metal_k=rows([3.9, 2.45, 2.14]), sigma=full(over.get("sigma", 0.0)),
            aux=torch.zeros((n, 8), dtype=torch.float32, device=dev))

        # (a) uniform hemisphere: rho ~ E[f cos / (1/2pi)]
        wi_u = smp.uniform_sample_hemisphere(uniform(1, (n, 2)))
        f_u, _ = bsdflib.evaluate(p, wo, wi_u)
        rho_uniform = cpu((f_u * wi_u[:, 2:3] * (2.0 * np.pi)).mean(dim=0))
        # (b) cosine sampling: rho ~ E[f pi]
        wi_c = smp.cosine_sample_hemisphere(uniform(2, (n, 2)))
        f_c, _ = bsdflib.evaluate(p, wo, wi_c)
        rho_cosine = cpu((f_c * np.pi).mean(dim=0))
        # (c) importance sampling: rho ~ E[f cos / pdf] (reflection only)
        s = bsdflib.sample(p, wo, uniform(3, (n,)), uniform(4, (n, 2)))
        w = torch.abs(s.wi[:, 2:3]) / torch.clamp(s.pdf, min=1e-9)[:, None]
        refl = s.valid & (s.wi[:, 2] > 0.0) & ~s.is_specular
        rho_imp = cpu(torch.where(refl[:, None], s.f * w,
                                  torch.zeros_like(s.f)).mean(dim=0))
        # pdf consistency on the non-specular samples
        _, pdf_e = bsdflib.evaluate(p, wo, s.wi)
        m = cpu(refl).astype(bool)
        pd_s, pd_e = cpu(s.pdf)[m], cpu(pdf_e)[m]
        pdf_err = float((np.abs(pd_s - pd_e) / np.maximum(pd_e, 1e-6)).max()
                        if m.any() else 0.0)
        err_ab = np.abs(rho_uniform - rho_cosine).max()
        err_ac = np.abs(rho_uniform - rho_imp).max()
        out[name] = dict(rho_uniform=rho_uniform, rho_cosine=rho_cosine,
                         rho_imp=rho_imp, pdf_err=pdf_err,
                         ok=bool(err_ab < 0.03 and err_ac < 0.05
                                 and pdf_err < 1e-3))
    return out


def cmd_bsdftest(argv):
    """BSDF sampling-consistency harness (the src/tools/bsdftest.cpp
    role): for each model, estimate hemispherical-directional reflectance
    three ways — uniform-hemisphere sampling, cosine sampling, and the
    BSDF's own importance sampling — and report agreement.  Also checks
    sample()'s pdf against evaluate()'s pdf on the sampled directions.
    """
    ap = argparse.ArgumentParser(prog="tools bsdftest")
    ap.add_argument("--n", type=int, default=1 << 15)
    ap.add_argument("--models", default=BSDF_MODELS)
    ap.add_argument("--theta", type=float, default=30.0,
                    help="viewing angle from the normal, degrees")
    ap.add_argument("--device", default="cuda", help="torch device")
    args = ap.parse_args(argv)

    est = bsdf_estimates(args.models, args.n, args.theta, args.device)
    failures = 0
    for name in args.models.split(","):
        if name not in est:
            print(f"{name:12s} SKIP (unknown model)")
            continue
        e = est[name]
        failures += 0 if e["ok"] else 1
        print(f"{name:12s} rho_uniform={e['rho_uniform'].round(4)} "
              f"rho_cos={e['rho_cosine'].round(4)} "
              f"rho_imp={e['rho_imp'].round(4)} "
              f"pdf_err={e['pdf_err']:.2e} {'OK' if e['ok'] else 'FAIL'}")
    return 1 if failures else 0


def cmd_histogram(argv):
    """Luminance histogram of an image (tools/gen_histograms.py role):
    prints bucket counts + summary stats for exposure debugging."""
    ap = argparse.ArgumentParser(prog="tools histogram")
    ap.add_argument("image")
    ap.add_argument("--buckets", type=int, default=16)
    ap.add_argument("--log", action="store_true",
                    help="log-spaced buckets")
    args = ap.parse_args(argv)
    img = _load(args.image)
    lum = (img * np.array([0.212671, 0.715160, 0.072169])).sum(axis=-1)
    lo, hi = float(lum.min()), float(lum.max())
    print(f"min {lo:.5g}  max {hi:.5g}  mean {float(lum.mean()):.5g}  "
          f"median {float(np.median(lum)):.5g}")
    if args.log:
        edges = np.geomspace(max(lo, 1e-6), max(hi, 1e-6),
                             args.buckets + 1)
    else:
        edges = np.linspace(lo, hi + 1e-9, args.buckets + 1)
    counts, _ = np.histogram(lum, bins=edges)
    width = max(counts.max(), 1)
    for c, e0, e1 in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * int(40 * c / width)
        print(f"[{e0:10.4g},{e1:10.4g}) {c:8d} {bar}")
    return 0


def cmd_flipnz(argv):
    """Flip the sign of normal-map Z channels in PFM files
    (tools/flipNZ.py role — fixes handedness of exported normal maps)."""
    from ..utils import image as imglib

    ap = argparse.ArgumentParser(prog="tools flipnz")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    for path in args.inputs:
        img = np.asarray(imglib.read_pfm(path)).copy()
        img[..., 2] = -img[..., 2]
        imglib.write_pfm(path, img)
        print(f"flipped NZ: {path}")
    return 0


COMMANDS = dict(metrics=cmd_metrics, tonemap=cmd_tonemap, convert=cmd_convert,
                benchmark=cmd_benchmark, bsdftest=cmd_bsdftest,
                histogram=cmd_histogram, flipnz=cmd_flipnz)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown tool {cmd}")
        return 1
    return COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
