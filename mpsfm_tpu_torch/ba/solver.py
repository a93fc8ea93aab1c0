"""LM helpers shared by the BA solvers (port of the helpers of
mpsfm_tpu/ba/solver.py that the dense solver and the device depth rows
use; the sparse slot-table solver is not ported yet)."""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.geometry.rotations import quat_mul, quat_normalize, so3_exp_quat


def _apply_cam_update(quat, t, delta):
    """delta (C,6): [omega, dt]."""
    dq = so3_exp_quat(delta[:, :3])
    return quat_normalize(quat_mul(dq, quat)), t + delta[:, 3:]


def inv3x3(M, eps=1e-12):
    """Batched closed-form 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([Cc, -(a * h - b * g), a * e - b * d], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _rotmat_cols(quat):
    """Rotation matrix entries of (C,4) quats as 9 (C,) tensors (row-major)."""
    w, x, y, z = quat.unbind(-1)
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )
