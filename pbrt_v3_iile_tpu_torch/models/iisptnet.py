"""IISPTNet, the IILE indirect-illumination U-Net (port of
``models/iisptnet.py``).

A 7 -> 3 channel U-Net on hemispherical G-buffers: encoders of K, 2K, 4K
and 8K channels with 2x2 max-pool downsamples, LeakyReLU(0.2) then
BatchNorm (eval mode), bilinear 2x upsamples, skip concatenations,
3x3 decoder blocks, a 1x1 convolution and a ReLU.  The interface takes
and returns (B, H, W, C) as the reference does; inside it runs NCHW.

The reference's decoder blocks are flax ``ConvTranspose(3x3, "SAME")`` at
stride 1, which does not flip its kernel: each is exactly a 3x3
convolution with padding 1 of the same HWIO kernel, so every layer here
is an ``nn.Conv2d``.  Layer names follow flax's creation order
(``conv0`` is ``Conv_0``, ``convt0`` is ``ConvTranspose_0``, ``bn0`` is
``BatchNorm_0``), which ``models/weights.py`` maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

K = 64

def layer_shapes(k: int = K):
    """(in, out) channels of the convolutions and the decoder blocks, and
    the BatchNorm widths, in flax's creation order, for width k."""
    return dict(
        conv=[(7, k), (k, k), (k, 2 * k), (2 * k, 2 * k), (2 * k, 4 * k),
              (4 * k, 4 * k), (4 * k, 8 * k), (8 * k, 4 * k), (k, 3)],
        convt=[(8 * k, 4 * k), (4 * k, 2 * k), (4 * k, 2 * k), (2 * k, k),
               (2 * k, k), (k, k)],
        bn=[2 * k, 4 * k, 8 * k, 4 * k, 2 * k])


class IISPTNet(nn.Module):
    def __init__(self, k: int = K):
        super().__init__()
        self.k = k
        shapes = layer_shapes(k)
        self.conv = nn.ModuleList(
            nn.Conv2d(ci, co, 1 if i == 8 else 3, padding=0 if i == 8 else 1)
            for i, (ci, co) in enumerate(shapes["conv"]))
        self.convt = nn.ModuleList(nn.Conv2d(ci, co, 3, padding=1)
                                   for ci, co in shapes["convt"])
        self.bn = nn.ModuleList(nn.BatchNorm2d(c, eps=1e-5)
                                for c in shapes["bn"])

    def forward(self, x):
        """x: (B, H, W, 7) -> (B, H, W, 3); H and W divisible by 8."""
        c, ct, bn = self.conv, self.convt, self.bn
        lrelu = lambda v: F.leaky_relu(v, 0.2)
        pool = lambda v: F.max_pool2d(v, 2, 2)
        up2 = lambda v: F.interpolate(v, scale_factor=2, mode="bilinear",
                                      align_corners=False)
        x = x.permute(0, 3, 1, 2)
        x0 = lrelu(c[1](lrelu(c[0](x))))
        x1 = lrelu(c[3](bn[0](lrelu(c[2](pool(x0))))))
        x2 = lrelu(c[5](bn[1](lrelu(c[4](pool(x1))))))
        x3 = up2(lrelu(c[7](bn[2](lrelu(c[6](pool(x2)))))))
        x4 = up2(lrelu(ct[1](bn[3](lrelu(ct[0](torch.cat([x3, x2], 1)))))))
        x5 = up2(lrelu(ct[3](bn[4](lrelu(ct[2](torch.cat([x4, x1], 1)))))))
        x6 = lrelu(ct[5](lrelu(ct[4](torch.cat([x5, x0], 1)))))
        return F.relu(c[8](x6)).permute(0, 2, 3, 1)


def forward_flops(hemi_size: int = 32, k: int = K) -> int:
    """Multiply-add operations (x2) of one probe's forward pass, counted
    from the layer shapes: what the convolutions must compute."""
    s = layer_shapes(k)
    side = ([hemi_size, hemi_size, hemi_size // 2, hemi_size // 2,
             hemi_size // 4, hemi_size // 4, hemi_size // 8, hemi_size // 8,
             hemi_size],
            [hemi_size // 4, hemi_size // 4, hemi_size // 2, hemi_size // 2,
             hemi_size, hemi_size])
    flops = 0
    for (ci, co), n in zip(s["conv"], side[0]):
        flops += 2 * n * n * (1 if co == 3 else 9) * ci * co
    for (ci, co), n in zip(s["convt"], side[1]):
        flops += 2 * n * n * 9 * ci * co
    return flops
