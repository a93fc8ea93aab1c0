"""Batched homography estimation for the two-view classification (port of
mpsfm_tpu/estimators/homography.py).

The host-side `decompose_homography_np` (OpenCV's decomposeHomographyMat)
is not here: its only caller is registration, which comes with the port of
the mapper.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.estimators.essential import _normalize_points
from mpsfm_tpu_torch.geometry.linalg import nullspace_vector, nullspace_vector_minimal


def homography_from_four_points(xy1, xy2, mask=None, minimal: bool = False):
    """DLT homography from >= 4 correspondences xy (..., N, 2), normalized by
    H[2, 2]. minimal=True (exactly 4 points) takes the QR nullspace."""
    if mask is None:
        mask = torch.ones(xy1.shape[:-1], dtype=torch.bool, device=xy1.device)
    p1, T1 = _normalize_points(xy1, mask)
    p2, T2 = _normalize_points(xy2, mask)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], dim=-1)
    rows_b = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    if minimal:
        h = nullspace_vector_minimal(A)
    else:
        h = nullspace_vector(A, torch.cat([mask, mask], dim=-1).to(A.dtype))
    H = torch.linalg.inv_ex(T2)[0] @ h.unflatten(-1, (3, 3)) @ T1
    h22 = H[..., 2, 2]
    return H / torch.where(h22.abs() < 1e-12, 1e-12, h22)[..., None, None]


def homography_transfer_error_sq(H, xy1, xy2):
    """Squared forward transfer error |H p1 - p2|². H (..., 3, 3), xy (..., N, 2)."""
    ones = torch.ones_like(xy1[..., :1])
    q = torch.cat([xy1, ones], -1) @ H.transpose(-1, -2)
    w = torch.where(q[..., 2].abs() < 1e-12, 1e-12, q[..., 2])
    return ((q[..., :2] / w[..., None] - xy2) ** 2).sum(-1)
