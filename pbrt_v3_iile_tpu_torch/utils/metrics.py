"""Image quality metrics: L1, MSE, PSNR, SSIM, compressed-entropy.

Replaces the reference's metric tooling (ref: tools/ssim_cmd.py,
ml/pfm.py:298-396 ssim/l1/cross-correlation, tools chart entropy proxy —
'entropy' there is the gzip-compressed image size in kB used as a noise
proxy in charts_*.py).
"""

from __future__ import annotations

import zlib

import numpy as np


def l1(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(d * d))


def psnr(img: np.ndarray, ref: np.ndarray) -> float:
    """PSNR in dB vs reference peak (ref charts use converged-image peak)."""
    m = mse(img, ref)
    peak = float(ref.max()) if ref.max() > 0 else 1.0
    if m <= 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def _gaussian_kernel(radius: int = 5, sigma: float = 1.5):
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _blur(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view

    r = len(kern) // 2
    pad = np.pad(img, ((r, r), (r, r)), mode="reflect")
    h = sliding_window_view(pad, len(kern), axis=1)[:, :, :] @ kern
    v = sliding_window_view(h.T, len(kern), axis=1) @ kern
    return v.T[: img.shape[0], : img.shape[1]]


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Mean SSIM on luminance (ref: ml/pfm.py ssim semantics)."""
    if a.ndim == 3:
        a = a.mean(axis=-1)
    if b.ndim == 3:
        b = b.mean(axis=-1)
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    L = max(a.max(), b.max(), 1e-9)
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    k = _gaussian_kernel()
    mu_a = _blur(a, k)
    mu_b = _blur(b, k)
    s_aa = _blur(a * a, k) - mu_a ** 2
    s_bb = _blur(b * b, k) - mu_b ** 2
    s_ab = _blur(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


def compressed_entropy_kb(img: np.ndarray) -> float:
    """Noise proxy used by the reference charts: compressed size in kB
    of the tonemapped image (tools/charts_*.py 'entropy')."""
    from . import image as imglib

    ldr = (np.clip(imglib.gamma_correct(np.clip(img, 0, 1)), 0, 1)
           * 255).astype(np.uint8)
    return len(zlib.compress(ldr.tobytes(), 6)) / 1024.0
