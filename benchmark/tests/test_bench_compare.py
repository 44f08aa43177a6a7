"""The numbers compared: ``noise_ratio`` follows the frame's variance over
one reference half's, whatever the image's expectation."""

import pytest
import torch

from benchmark import compare


def _images(var_f, var_r, seed=2**31 + 5, bias=0.0):
    """A frame and two reference halves of one expectation, with
    per-pixel variances var_f and var_r (channels summed)."""
    mu = 1.0 + torch.rand((120, 240, 1), generator=torch.Generator().manual_seed(7),
                          dtype=torch.float64).expand(-1, -1, 3)
    g = torch.Generator().manual_seed(seed)

    def noisy(var):
        return mu + (var / 3) ** 0.5 * torch.randn((120, 240, 3), generator=g,
                                                   dtype=torch.float64)

    return noisy(var_f) + bias, noisy(var_r), noisy(var_r)


@pytest.mark.parametrize("var_f, var_r", [(0.01, 0.08), (0.02, 0.08), (0.05, 0.05)])
def test_noise_ratio_follows_the_variance(var_f, var_r):
    f, a, b = _images(var_f, var_r)
    n = compare.frame_numbers(f, a, b, (12, 6))
    assert n["noise_ratio"] == pytest.approx(var_f / var_r, rel=0.15)
    assert n["global_rel"] < 0.01 and n["nonfinite_px"] == 0


def test_half_the_samples_doubles_the_ratio_while_the_means_hold():
    f16, a, b = _images(0.01, 0.08)
    f8, _, _ = _images(0.02, 0.08, seed=2**31 + 6)
    n16, n8 = (compare.frame_numbers(f, a, b, (12, 6)) for f in (f16, f8))
    assert n8["noise_ratio"] / n16["noise_ratio"] == pytest.approx(2.0, rel=0.2)
    assert abs(n8["global_rel"] - n16["global_rel"]) < 0.01


def test_a_bias_raises_the_ratio_and_the_means():
    f, a, b = _images(0.01, 0.08, bias=0.5)
    n = compare.frame_numbers(f, a, b, (12, 6))
    assert n["noise_ratio"] > 1.0 and n["global_rel"] > 0.2
