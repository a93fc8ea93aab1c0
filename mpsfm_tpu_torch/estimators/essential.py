"""Batched essential-matrix estimation primitives (port of
mpsfm_tpu/estimators/essential.py).

Hypotheses come from the normalized 8-point algorithm projected onto the
essential manifold; scoring is the squared Sampson error in normalized
image coordinates. Every function is batched over leading dims (the JAX
package's vmap axes).
"""

from __future__ import annotations

import math

import torch

from mpsfm_tpu_torch.geometry.linalg import det3, nullspace_vector, nullspace_vector_minimal, svd3x3
from mpsfm_tpu_torch.geometry.rotations import Rigid3d, matrix_to_quat
from mpsfm_tpu_torch.geometry.triangulation import triangulate_two_view


def _normalize_points(xy, mask):
    """Hartley normalization with masked statistics. xy (..., N, 2), mask
    (..., N). Returns (normalized xy, T (..., 3, 3))."""
    w = mask.to(xy.dtype)
    n = w.sum(-1).clamp_min(1.0)
    mean = (xy * w[..., None]).sum(-2) / n[..., None]
    d = torch.sqrt(((xy - mean[..., None, :]) ** 2).sum(-1)) * w
    scale = math.sqrt(2.0) / (d.sum(-1) / n).clamp_min(1e-12)
    T = torch.zeros((*xy.shape[:-2], 3, 3), dtype=xy.dtype, device=xy.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -scale * mean[..., 0]
    T[..., 1, 2] = -scale * mean[..., 1]
    T[..., 2, 2] = 1.0
    return (xy - mean[..., None, :]) * scale[..., None, None], T


def essential_from_eight_points(xy1, xy2, mask=None, minimal: bool = False):
    """8-point algorithm on normalized image coords (..., N, 2), N >= 8,
    projected onto the essential manifold (singular values 1, 1, 0).
    minimal=True (exactly 8 points, a RANSAC sample) takes the QR nullspace;
    mask (..., N) weights the others. Returns E (..., 3, 3)."""
    if mask is None:
        mask = torch.ones(xy1.shape[:-1], dtype=torch.bool, device=xy1.device)
    p1, T1 = _normalize_points(xy1, mask)
    p2, T2 = _normalize_points(xy2, mask)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    # p2ᵀ E p1 = 0 with E row-major flattened
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)
    if minimal:
        F = nullspace_vector_minimal(A)
    else:
        F = nullspace_vector(A, mask.to(A.dtype))
    F = T2.transpose(-1, -2) @ F.unflatten(-1, (3, 3)) @ T1  # de-normalize
    U, _, Vt = svd3x3(F)
    return U @ torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype, device=F.device)) @ Vt


def sampson_error_sq(E, xy1, xy2):
    """Squared Sampson distance in normalized coords. E (..., 3, 3), xy (..., N, 2)."""
    ones = torch.ones_like(xy1[..., :1])
    p1 = torch.cat([xy1, ones], -1)
    p2 = torch.cat([xy2, ones], -1)
    Ep1 = p1 @ E.transpose(-1, -2)  # (..., N, 3): E p1
    Etp2 = p2 @ E  # Eᵀ p2
    num = (p2 * Ep1).sum(-1) ** 2
    den = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return num / den.clamp_min(1e-12)


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def decompose_essential(E, xy1, xy2, mask):
    """E (..., 3, 3) -> cam2_from_cam1 by cheirality voting over the four
    candidates. xy1, xy2 (..., N, 2) normalized coords of (ideally inlier)
    matches, mask (..., N). Returns (pose2 Rigid3d, votes (..., 4), best (...)).
    Ties resolve to the first candidate, as jnp.argmax does."""
    U, _, Vt = svd3x3(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)  # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    # every candidate against every match: (..., 4, N)
    shape = (*cands_t.shape[:-1], xy1.shape[-2])
    q = matrix_to_quat(cands_R)[..., None, :].expand(*shape, 4)
    tt = cands_t[..., None, :].expand(*shape, 3)
    ident = Rigid3d.identity(shape, dtype=E.dtype, device=E.device)
    X = triangulate_two_view(ident, Rigid3d(q, tt), xy1[..., None, :, :].expand(*shape, 2),
                             xy2[..., None, :, :].expand(*shape, 2))
    z1 = X[..., 2]
    z2 = (X * cands_R[..., None, 2, :]).sum(-1) + cands_t[..., None, 2]
    good = (z1 > 1e-6) & (z2 > 1e-6) & mask[..., None, :]
    votes = good.sum(-1)
    best = torch.argmax(votes, dim=-1)
    Rb = torch.take_along_dim(cands_R, best[..., None, None, None], dim=-3)[..., 0, :, :]
    tb = torch.take_along_dim(cands_t, best[..., None, None], dim=-2)[..., 0, :]
    return Rigid3d(matrix_to_quat(Rb), tb), votes, best
