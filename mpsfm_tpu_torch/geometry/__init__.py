"""Geometry primitives (port of mpsfm_tpu/geometry)."""

from mpsfm_tpu_torch.geometry.rotations import (
    Rigid3d,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    matrix_to_quat,
    so3_exp_quat,
    rigid_compose,
    rigid_inverse,
    rigid_transform,
)
from mpsfm_tpu_torch.geometry.projection import (
    Camera,
    cam_from_img,
    img_from_cam,
    project_points,
    unproject_depth_map,
)
from mpsfm_tpu_torch.geometry.triangulation import (
    triangulate_two_view,
    triangulate_nview,
    triangulation_angle,
    point_depth,
)

__all__ = [
    "Rigid3d",
    "quat_conj",
    "quat_mul",
    "quat_normalize",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "so3_exp_quat",
    "rigid_compose",
    "rigid_inverse",
    "rigid_transform",
    "Camera",
    "cam_from_img",
    "img_from_cam",
    "project_points",
    "unproject_depth_map",
    "triangulate_two_view",
    "triangulate_nview",
    "triangulation_angle",
    "point_depth",
]
