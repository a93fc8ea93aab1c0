"""Batched triangulation and angle / cheirality checks (port of
mpsfm_tpu/geometry/triangulation.py)."""

from __future__ import annotations

import math

import torch

from mpsfm_tpu_torch.geometry.linalg import eigh, nullspace_vector
from mpsfm_tpu_torch.geometry.projection import Camera, cam_from_img
from mpsfm_tpu_torch.geometry.rotations import Rigid3d, projection_center, quat_to_matrix


def _pose_matrix(pose: Rigid3d):
    """(..., 3, 4) projection matrix [R|t] in normalized camera coords."""
    return torch.cat([quat_to_matrix(pose.quat), pose.t[..., :, None]], dim=-1)


def triangulate_two_view(pose1: Rigid3d, pose2: Rigid3d, xy1_norm, xy2_norm):
    """DLT triangulation of normalized image points, batched over leading
    dims: the nullspace vector of the stacked 4×4 constraints. Returns
    world xyz (..., 3)."""
    P1 = _pose_matrix(pose1)
    P2 = _pose_matrix(pose2)
    rows = torch.stack(
        [
            xy1_norm[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            xy1_norm[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            xy2_norm[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            xy2_norm[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )
    X = nullspace_vector(rows)
    w = X[..., 3]
    w = torch.where(w.abs() < 1e-12, 1e-12 * torch.where(w < 0, -1.0, 1.0), w)
    return X[..., :3] / w[..., None]


def triangulate_two_view_px(pose1, pose2, cam1: Camera, cam2: Camera, xy1, xy2):
    return triangulate_two_view(pose1, pose2, cam_from_img(cam1, xy1), cam_from_img(cam2, xy2))


def triangulate_nview(poses_mat, xy_norm, mask):
    """N-view DLT: poses_mat (..., N, 3, 4), xy_norm (..., N, 2), mask (..., N).
    The smallest eigenvector of Σ_i m_i A_iᵀA_i, with each view's two rows
    adjacent (the JAX function under vmap). Returns (xyz (..., 3), ok (...))."""
    a0 = xy_norm[..., 0, None] * poses_mat[..., 2, :] - poses_mat[..., 0, :]
    a1 = xy_norm[..., 1, None] * poses_mat[..., 2, :] - poses_mat[..., 1, :]
    A = torch.stack([a0, a1], dim=-2).flatten(-3, -2)  # (..., 2N, 4)
    m = torch.repeat_interleave(mask.to(A.dtype), 2, dim=-1)
    AtA = (A * m[..., None]).transpose(-1, -2) @ A
    _, v = eigh(AtA)
    X = v[..., :, 0]
    wh = X[..., 3]
    wh = torch.where(wh.abs() < 1e-12, 1e-12, wh)
    ok = mask.sum(-1) >= 2
    return X[..., :3] / wh[..., None], ok


def triangulation_angle(center1, center2, xyz):
    """Angle (radians) between the rays from two camera centers to xyz, with
    the reference's law-of-cosines on norms (kept for parity)."""
    baseline = torch.linalg.norm(center1 - center2, dim=-1)
    r1 = torch.linalg.norm(xyz - center1, dim=-1)
    r2 = torch.linalg.norm(xyz - center2, dim=-1)
    denom = 2.0 * torch.sqrt(r1 * r2)
    nom = r1 + r2 - baseline
    cosang = torch.where(denom > 0, nom / denom.clamp_min(1e-12), 1.0)
    ang = torch.arccos(cosang.clamp(-1.0, 1.0)).abs()
    return torch.minimum(ang, math.pi - ang)


def pair_triangulation_angle(pose1: Rigid3d, pose2: Rigid3d, xyz):
    return triangulation_angle(projection_center(pose1), projection_center(pose2), xyz)


def point_depth(pose: Rigid3d, xyz):
    """Depth of world points in the camera frame (third row of [R|t] @ X)."""
    R = quat_to_matrix(pose.quat)
    return (R[..., 2, :] * xyz).sum(-1) + pose.t[..., 2]


def has_positive_depth(pose: Rigid3d, xyz, eps=2.2e-16):
    return point_depth(pose, xyz) >= eps
