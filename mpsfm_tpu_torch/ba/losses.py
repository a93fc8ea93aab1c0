"""Robust loss functions (Ceres-compatible) for IRLS-weighted Gauss-Newton
(port of mpsfm_tpu/ba/losses.py).

TRIVIAL / CAUCHY / SOFT_L1, each with a scale ``a``. ``rho(s)`` takes the
*squared* residual norm s, as in Ceres; the IRLS weight is ``rho'(s)``.
"""

from __future__ import annotations

import torch

TRIVIAL, SOFT_L1, CAUCHY = 0, 1, 2

LOSS_IDS = {"trivial": TRIVIAL, "softl1": SOFT_L1, "soft_l1": SOFT_L1, "SOFT_L1": SOFT_L1, "cauchy": CAUCHY}


def _a2(s, a):
    return torch.clamp(torch.as_tensor(a, dtype=s.dtype, device=s.device) ** 2, min=1e-12)


def rho(loss_id: int, s, a):
    """Robust cost of squared residual s with scale a."""
    if loss_id == TRIVIAL:
        return s
    a2 = _a2(s, a)
    if loss_id == SOFT_L1:
        return 2.0 * a2 * (torch.sqrt(1.0 + s / a2) - 1.0)
    if loss_id == CAUCHY:
        return a2 * torch.log1p(s / a2)
    raise ValueError(loss_id)


def rho_prime(loss_id: int, s, a):
    """d rho / d s — the IRLS weight."""
    if loss_id == TRIVIAL:
        return torch.ones_like(s)
    a2 = _a2(s, a)
    if loss_id == SOFT_L1:
        return 1.0 / torch.sqrt(1.0 + s / a2)
    if loss_id == CAUCHY:
        return 1.0 / (1.0 + s / a2)
    raise ValueError(loss_id)
