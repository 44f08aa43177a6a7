"""Prediction-quality statistics (port of ``ml/evalstats.py``; the
reference's ml/main_compute_test_statistics.py and Doc.md "P values
using kruskal"): three estimators of the ground-truth hemisphere, the
raw 1-spp render, a gaussian-blurred 1-spp render and the CNN's
prediction, compared by per-example L1 and SSIM, with Kruskal-Wallis
tests of the differences.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import iisptnet
from ..models import transforms as nnx
from ..utils import metrics as metricslib


def _blur_batch(imgs: np.ndarray) -> np.ndarray:
    """Per-channel separable gaussian blur of (P, H, W, 3) maps (the
    reference compares against a gaussian-filtered 1-spp baseline)."""
    r = min(5, imgs.shape[1] // 2 - 1)
    k = metricslib._gaussian_kernel(radius=max(r, 1))
    return np.stack([
        np.stack([metricslib._blur(im[..., c], k)
                  for c in range(im.shape[-1])], axis=-1)
        for im in imgs])


def compare_predictions(raw: dict, net) -> dict:
    """raw: maps p, d, n, z and valid (tensors or numpy), as
    ``ml.dataset.generate_examples`` returns them; net: an ``IISPTNet``,
    run in eval mode in fp32 on its own device.

    Returns {groups: {low, blur, pred: {l1: [...], ssim: [...]}}, means,
    p_values}; the p-values are the reference's low-vs-pred and
    blur-vs-pred Kruskal comparisons, and low-vs-blur."""
    from scipy import stats as sstats

    a = lambda v: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    valid = a(raw["valid"]).astype(bool)
    gt = a(raw["p"])[valid]
    low = a(raw["d"])[valid]
    blur = _blur_batch(low)

    dev = next(net.parameters()).device
    t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    x_in, aux = nnx.probe_to_network_input(t(low), t(a(raw["n"])[valid]),
                                           t(a(raw["z"])[valid]))
    net.eval()
    with torch.no_grad(), iisptnet.fp32_convolutions(dev):
        y = net(x_in)
    pred = nnx.network_output_to_radiance(y, aux).cpu().numpy()

    groups = {}
    for name, est in (("low", low), ("blur", blur), ("pred", pred)):
        groups[name] = dict(
            l1=[metricslib.l1(e, g) for e, g in zip(est, gt)],
            ssim=[metricslib.ssim(e, g) for e, g in zip(est, gt)],
        )

    out = dict(groups=groups, means={}, p_values={})
    for metric in ("l1", "ssim"):
        out["means"][metric] = {k: float(np.mean(v[metric]))
                                for k, v in groups.items()}
        for ga, gb in (("low", "pred"), ("blur", "pred"), ("low", "blur")):
            xa, xb = groups[ga][metric], groups[gb][metric]
            if len(xa) >= 2 and (np.ptp(xa) > 0 or np.ptp(xb) > 0):
                _, p = sstats.kruskal(xa, xb)
            else:
                p = 1.0
            out["p_values"][f"{metric}:{ga}_vs_{gb}"] = float(p)
    return out


def report(stats: dict) -> str:
    lines = ["Prediction quality statistics (Kruskal-Wallis):"]
    for metric, means in stats["means"].items():
        row = "  ".join(f"{k}={v:.4f}" for k, v in means.items())
        lines.append(f"  {metric:5s} means: {row}")
    for k, p in stats["p_values"].items():
        lines.append(f"  p[{k}] = {p:.3e}")
    return "\n".join(lines)
