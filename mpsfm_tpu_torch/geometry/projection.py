"""Camera models and projection on torch tensors (port of
mpsfm_tpu/geometry/projection.py).

PINHOLE (fx, fy, cx, cy) and SIMPLE_PINHOLE (f, cx, cy), batched over
leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpsfm_tpu_torch.geometry.rotations import Rigid3d, quat_conj, quat_rotate

PINHOLE = 1
SIMPLE_PINHOLE = 0


class Camera(NamedTuple):
    """Pinhole camera. fx, fy, cx, cy are tensors (scalars or batched)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 0
    height: int = 0

    @staticmethod
    def from_params(params, width=0, height=0):
        """params (..., 3) SIMPLE_PINHOLE or (..., 4) PINHOLE, a tensor."""
        if params.shape[-1] == 3:
            f, cx, cy = params.unbind(-1)
            return Camera(f, f, cx, cy, width, height)
        fx, fy, cx, cy = params[..., :4].unbind(-1)
        return Camera(fx, fy, cx, cy, width, height)

    def calibration_matrix(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            dim=-2,
        )


def cam_from_img(camera: Camera, xy):
    """Pixel coords (..., 2) -> normalized image-plane coords (..., 2)."""
    return torch.stack(
        [(xy[..., 0] - camera.cx) / camera.fx, (xy[..., 1] - camera.cy) / camera.fy], dim=-1
    )


def img_from_cam(camera: Camera, xy_norm):
    """Normalized image-plane coords (..., 2) -> pixel coords (..., 2)."""
    return torch.stack(
        [xy_norm[..., 0] * camera.fx + camera.cx, xy_norm[..., 1] * camera.fy + camera.cy], dim=-1
    )


def project_points(pose: Rigid3d, camera: Camera, points3d, eps=1e-9):
    """World points (..., 3) -> (pixels (..., 2), depth (...))."""
    p_cam = quat_rotate(pose.quat, points3d) + pose.t
    z = p_cam[..., 2]
    zs = torch.where(z.abs() < eps, torch.sign(z) * eps + (z == 0) * eps, z)
    return img_from_cam(camera, p_cam[..., :2] / zs[..., None]), z


def lift_to_cam(camera: Camera, xy, depth):
    """Pixels (..., 2) + depth (...) -> camera-frame 3D points (..., 3)."""
    xy_norm = cam_from_img(camera, xy)
    return torch.cat([xy_norm, torch.ones_like(xy_norm[..., :1])], -1) * depth[..., None]


def lift_to_world(pose: Rigid3d, camera: Camera, xy, depth):
    """Pixels + depth -> world points, via the inverse of cam_from_world."""
    qinv = quat_conj(pose.quat)
    return quat_rotate(qinv, lift_to_cam(camera, xy, depth) - pose.t)


def unproject_depth_map(pose: Rigid3d, camera: Camera, depth):
    """Dense depth map (H, W) -> world points (H, W, 3)."""
    H, W = depth.shape
    x = torch.arange(W, dtype=depth.dtype, device=depth.device)
    y = torch.arange(H, dtype=depth.dtype, device=depth.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return lift_to_world(pose, camera, torch.stack([xx, yy], dim=-1), depth)
