"""IISPTNet, the IILE indirect-illumination U-Net (port of
``models/iisptnet.py``).

A 7 -> 3 channel U-Net on hemispherical G-buffers: encoders of K, 2K, 4K
and 8K channels with 2x2 max-pool downsamples, LeakyReLU(0.2) then
BatchNorm, bilinear 2x upsamples, skip concatenations, 3x3 decoder
blocks, a 1x1 convolution and a ReLU.  The interface takes and returns
(B, H, W, C) as the reference does; inside it runs NCHW.

In training mode (``net.train()``) BatchNorm follows flax's
``nn.BatchNorm(momentum=0.9)``: the batch is normalized by its biased
variance, computed as E[x^2] - E[x]^2 and clipped at zero, and the
running statistics move by 0.1 towards the batch mean and that same
biased variance (``torch.nn.BatchNorm2d`` would store the unbiased
one).  ``init_params`` draws the weights as flax initializes them.

The reference's decoder blocks are flax ``ConvTranspose(3x3, "SAME")`` at
stride 1, which does not flip its kernel: each is exactly a 3x3
convolution with padding 1 of the same HWIO kernel, so every layer here
is an ``nn.Conv2d``.  Layer names follow flax's creation order
(``conv0`` is ``Conv_0``, ``convt0`` is ``ConvTranspose_0``, ``bn0`` is
``BatchNorm_0``), which ``models/weights.py`` maps.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

K = 64
BN_MOMENTUM = 0.9    # flax's convention: the running stats keep 0.9
BN_EPS = 1e-5

def layer_shapes(k: int = K):
    """(in, out) channels of the convolutions and the decoder blocks, and
    the BatchNorm widths, in flax's creation order, for width k."""
    return dict(
        conv=[(7, k), (k, k), (k, 2 * k), (2 * k, 2 * k), (2 * k, 4 * k),
              (4 * k, 4 * k), (4 * k, 8 * k), (8 * k, 4 * k), (k, 3)],
        convt=[(8 * k, 4 * k), (4 * k, 2 * k), (4 * k, 2 * k), (2 * k, k),
               (2 * k, k), (k, k)],
        bn=[2 * k, 4 * k, 8 * k, 4 * k, 2 * k])


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over (B, C, H, W) with flax's training semantics (module
    docstring); eval mode normalizes by the running statistics."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


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
        self.bn = nn.ModuleList(BatchNorm(c) for c in shapes["bn"])

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


def init_params(net: IISPTNet, generator: torch.Generator) -> IISPTNet:
    """Draw ``net``'s weights as flax initializes ``IISPTNet``: every
    convolution kernel from ``lecun_normal`` (a normal truncated at 2
    standard deviations, scaled so that its standard deviation is
    1/sqrt(fan_in), fan_in = kernel area x input channels), zero biases,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1.  The
    draws come from ``generator`` on the CPU (the distribution of flax's
    initialization, not its bits).  Returns ``net``."""
    # flax's variance_scaling: the truncated normal's stddev is divided by
    # that of a standard normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for conv in (*net.conv, *net.convt):
            w = conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = 1.0 / math.sqrt(fan_in) / trunc_std
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            w.copy_(draw)
            conv.bias.zero_()
        for bn in net.bn:
            bn.reset_parameters()
    return net


@contextlib.contextmanager
def fp32_convolutions(device):
    """Full fp32 convolutions and products on the card (no TF32) inside
    the block, the previous settings restored after it."""
    if torch.device(device).type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
