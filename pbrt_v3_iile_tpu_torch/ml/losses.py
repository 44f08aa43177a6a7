"""Training losses: L1, relative L1 and relative MSE (port of
``ml/losses.py``; the reference's ml/iispt_loss.py L1Loss, RelL1Loss and
RelMSELoss).  The relative variants divide each pixel's error by the
target's magnitude (plus EPS) so that bright pixels do not dominate; the
reference trainer uses plain L1 (ml/main_train.py:23).
"""

from __future__ import annotations

import torch

EPS = 1e-2  # (ref: iispt_loss.py denominator stabilizer)


def l1(out, target):
    return torch.mean(torch.abs(out - target))


def rel_l1(out, target, eps: float = EPS):
    return torch.mean(torch.abs(out - target) / (torch.abs(target) + eps))


def rel_mse(out, target, eps: float = EPS):
    d = out - target
    return torch.mean(d * d / (target * target + eps))


LOSSES = {"l1": l1, "rel_l1": rel_l1, "rel_mse": rel_mse}


def get(name: str):
    return LOSSES[name]
