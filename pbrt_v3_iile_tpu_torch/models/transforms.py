"""Normalization transforms between probe G-buffers and IISPTNet (port of
``models/transforms.py``).

The downstream transforms map a probe's radiance, camera-space normals
and hit distance to the net's 7 input channels (log space, scaled by the
probe's mean); the upstream transform maps the net's output back to
radiance and matches each channel's mean to the probe's
(iisptrenderrunner.cpp normalizeMapsDownstream / transformMapsUpstream).
Tensors are (..., H, W, C), as in the reference.
"""

from __future__ import annotations

import torch


def positive_log(x):
    """log(max(x + 1, 1))."""
    return torch.log(torch.clamp(x + 1.0, min=1.0))


def positive_log_inverse(y):
    return torch.exp(torch.clamp(y, min=0.0)) - 1.0


def _safe_div(x, d):
    pos = d > 0.0
    return torch.where(pos, x / torch.where(pos, d, torch.ones_like(d)), x)


def intensity_downstream_half(x, mean):
    """Divide by 10 * mean, then positive_log (the target space)."""
    return positive_log(_safe_div(x, 10.0 * mean))


def intensity_downstream_full(x, mean):
    """The probe intensity input: the half sequence, minus 0.1."""
    return intensity_downstream_half(x, mean) - 0.1


def intensity_upstream(y, mean):
    return positive_log_inverse(y) * (10.0 * mean)


def distance_downstream(z, mean):
    """+1, / (10 (mean + 1)), positive_log, -0.1."""
    d = 10.0 * (mean + 1.0)
    d = torch.where(d == 0.0, torch.ones_like(d), d)
    return positive_log((z + 1.0) / d) - 0.1


def normals_downstream(n):
    return torch.clamp(n, -1.0, 1.0)


def probe_to_network_input(intensity, normals, distance):
    """intensity, normals (..., H, W, 3), distance (..., H, W, 1) ->
    (x (..., H, W, 7), aux): aux holds each probe's channel means
    (..., 3) and overall mean (...,) for the upstream transform."""
    chan_means = torch.mean(intensity, dim=(-3, -2))
    overall = torch.mean(intensity, dim=(-3, -2, -1))
    om = overall[..., None, None, None]
    x_int = intensity_downstream_full(intensity, om)
    x_nrm = normals_downstream(normals)
    zmean = torch.mean(distance, dim=(-3, -2, -1))[..., None, None, None]
    x_dst = distance_downstream(distance, zmean)
    x = torch.cat([x_int, x_nrm, x_dst], dim=-1)
    return x, dict(chan_means=chan_means, overall_mean=overall)


def network_output_to_radiance(y, aux):
    """positive_log_inverse, then scale each channel to the probe's mean."""
    lin = positive_log_inverse(y)
    actual = torch.mean(lin, dim=(-3, -2))
    target = aux["chan_means"]
    mul = torch.where(actual > 1e-10, target / torch.clamp(actual, min=1e-10),
                      torch.zeros_like(actual))
    return lin * mul[..., None, None, :]
