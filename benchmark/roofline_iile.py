"""IISPTNet's least time on the chip: the operations its forward pass must
compute and the bytes it must move, at ``roofline.bound``'s peaks.

The U-Net of pbrt-v3-IILE at width K (7 -> 3 channels on hemi x hemi
maps): 3x3 convolutions K and K at the full size, 2K and 2K at a half,
4K and 4K at a quarter, 8K and 4K at an eighth; the decoder's 3x3
convolutions 8K -> 4K and 4K -> 2K at a quarter, 4K -> 2K and 2K -> K at
a half, 2K -> K and K -> K at the full size; a 1x1 convolution K -> 3.
Operations are the convolutions' multiply-adds, two each.  Bytes are
what no schedule can avoid: the weights read once and each probe's
7-channel input and 3-channel output, in float32.
"""

from __future__ import annotations

K = 64
IN_CHANNELS, OUT_CHANNELS = 7, 3


def layers(k: int = K):
    """[(in channels, out channels, kernel side, map side divisor)]."""
    return [(IN_CHANNELS, k, 3, 1), (k, k, 3, 1), (k, 2 * k, 3, 2), (2 * k, 2 * k, 3, 2),
            (2 * k, 4 * k, 3, 4), (4 * k, 4 * k, 3, 4), (4 * k, 8 * k, 3, 8),
            (8 * k, 4 * k, 3, 8),
            (8 * k, 4 * k, 3, 4), (4 * k, 2 * k, 3, 4), (4 * k, 2 * k, 3, 2),
            (2 * k, k, 3, 2), (2 * k, k, 3, 1), (k, k, 3, 1),
            (k, OUT_CHANNELS, 1, 1)]


def probe_flops(hemi: int = 32, k: int = K) -> int:
    """Operations of one probe's forward pass."""
    return sum(2 * (hemi // s) ** 2 * ks * ks * ci * co for ci, co, ks, s in layers(k))


def weight_count(k: int = K) -> int:
    """Convolution weights and biases, and the four vectors of each of the
    five BatchNorm layers (2K, 4K, 8K, 4K, 2K channels)."""
    conv = sum(ks * ks * ci * co + co for ci, co, ks, _ in layers(k))
    return conv + 4 * (2 + 4 + 8 + 4 + 2) * k


def iisptnet_work(probes: int, hemi: int = 32, k: int = K) -> dict:
    """The forward pass over ``probes`` probes -> dict(probes, flops, bytes)."""
    io = probes * hemi * hemi * (IN_CHANNELS + OUT_CHANNELS)
    return dict(probes=probes, flops=probes * probe_flops(hemi, k),
                bytes=4 * (weight_count(k) + io))
