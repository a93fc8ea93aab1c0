"""Quaternion / SE(3) math on torch tensors (port of
mpsfm_tpu/geometry/rotations.py).

All functions are batched over leading dims. Quaternions are (w, x, y, z)
and represent world->cam rotations, matching COLMAP's Rigid3d. A pose
("cam_from_world") is the pair ``(quat, t)`` with x_cam = R(quat) x_world + t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpsfm_tpu_torch import resolve_device


class Rigid3d(NamedTuple):
    """SE(3) transform: x_out = R(quat) x_in + t. quat (...,4) wxyz, t (...,3)."""

    quat: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cuda"):
        dev = resolve_device(device)
        q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev).expand(*batch_shape, 4)
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=dev)
        return Rigid3d(q.clone(), t)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-30)


def quat_conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    w = q[..., :1]
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix (...,3,3) -> quaternion (...,4) wxyz. Branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate quaternions (un-normalized), one per pivot choice
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    idx = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4 cand,4)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega):
    """Axis-angle (...,3) -> quaternion. Safe at omega=0 via Taylor expansion."""
    theta_sq = (omega**2).sum(-1, keepdim=True)
    theta = torch.sqrt(theta_sq + 1e-32)
    half = 0.5 * theta
    small = theta_sq < 1e-12
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small[..., 0], 1.0 - theta_sq[..., 0] / 8.0, torch.cos(half[..., 0]))
    return torch.cat([w[..., None], sinc_half * omega], dim=-1)


def rigid_transform(pose: Rigid3d, points):
    """Apply pose to points (...,3)."""
    return quat_rotate(pose.quat, points) + pose.t


def rigid_inverse(pose: Rigid3d) -> Rigid3d:
    qinv = quat_conj(pose.quat)
    return Rigid3d(qinv, -quat_rotate(qinv, pose.t))


def rigid_compose(a: Rigid3d, b: Rigid3d) -> Rigid3d:
    """Returns a∘b: (a∘b)(x) = a(b(x))."""
    return Rigid3d(quat_normalize(quat_mul(a.quat, b.quat)), quat_rotate(a.quat, b.t) + a.t)


def projection_center(pose: Rigid3d):
    """Camera center in world frame for a cam_from_world pose."""
    return -quat_rotate(quat_conj(pose.quat), pose.t)


def apply_local_update(pose: Rigid3d, omega, dt) -> Rigid3d:
    """Left-perturbation retraction of the LM solver: R' = exp(omega) R,
    t' = t + dt."""
    dq = so3_exp_quat(omega)
    return Rigid3d(quat_normalize(quat_mul(dq, pose.quat)), pose.t + dt)
