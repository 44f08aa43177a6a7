"""How a rendered frame is judged against the reference's images.

The reference renders two independent images of the same estimand, A and
B; their mean is the reference image.  The numbers compared, each against
its limit in the workload file:

- ``global_rel``: the largest relative difference, over the three
  channels, of the frame's mean from the reference's;
- ``tile_dev``: over a grid of tiles, the largest difference of a tile's
  mean (channels summed) from the reference's, as a share of the
  reference image's mean (channels summed), so that a dark tile's noise
  weighs no more than a bright tile's;
- ``noise_ratio``: the frame's per-pixel variance over that of one
  reference half, the median over the tiles.  With channels summed, the
  mean of (F - A)(F - B) over a tile estimates the frame's variance plus
  its squared bias, since A and B are independent of the frame and of each
  other; the mean of (A - B)^2 / 2 estimates one half's variance.  The
  means above cannot see a frame that takes fewer samples than the
  traffic states; its variance grows as the samples fall, and so does
  this ratio;
- ``nonfinite_px``: pixels of the frame that are not finite (limit 0).

A frame whose numbers are all within their limits is correct.
"""

from __future__ import annotations

import torch


def tile_means(img, tiles):
    """(H, W, C) -> (ty, tx, C) means over a tx-by-ty grid of tiles; H and
    W must divide."""
    tx, ty = tiles
    H, W, C = img.shape
    if H % ty or W % tx:
        raise ValueError(f"a {W}x{H} film does not split into {tx}x{ty} tiles")
    return img.reshape(ty, H // ty, tx, W // tx, C).mean(dim=(1, 3))


def frame_numbers(frame, ref_a, ref_b, tiles) -> dict:
    """frame and the reference's halves, (H, W, 3) float tensors on one
    device -> the numbers."""
    frame = frame.double()
    a, b = ref_a.double(), ref_b.double()
    ref = 0.5 * (a + b)
    finite = torch.isfinite(frame).all(-1)
    nonfinite = int((~finite).sum())
    f = torch.where(finite[..., None], frame, torch.zeros_like(frame))
    g_f, g_r = f.mean(dim=(0, 1)), ref.mean(dim=(0, 1))
    global_rel = float((torch.abs(g_f - g_r) / g_r).max())
    t_f, t_r = tile_means(f, tiles).sum(-1), tile_means(ref, tiles).sum(-1)
    tile_dev = float((torch.abs(t_f - t_r) / g_r.sum()).max())
    fs, as_, bs = f.sum(-1), a.sum(-1), b.sum(-1)
    prod = ((fs - as_) * (fs - bs))[..., None]
    half_var = (0.5 * (as_ - bs) ** 2)[..., None]
    num, den = tile_means(prod, tiles).flatten(), tile_means(half_var, tiles).flatten()
    ratio = num[den > 0] / den[den > 0]
    noise_ratio = float(ratio.median()) if ratio.numel() else float("inf")
    return dict(global_rel=global_rel, tile_dev=tile_dev, noise_ratio=noise_ratio,
                nonfinite_px=nonfinite)


def judge(per_frame: list, limits: dict):
    """Per-frame numbers -> (worst of each number, frames failed)."""
    worst = {k: max(n[k] for n in per_frame) for k in limits}
    failed = sum(any(not (n[k] <= limits[k]) for k in limits) for n in per_frame)
    return worst, failed
