"""Bilinear map sampling at keypoints (host numpy, vectorized; a copy of
mpsfm_tpu/utils/interp.py).

Replaces the reference's torch.grid_sample float64 path
(mpsfm/sfm/scene/image/mixins/priorutils.py:49-66): samples any per-image
map at continuous pixel coordinates with bilinear interpolation and
border clamping (align_corners=False semantics: pixel centers at +0.5).
"""

from __future__ import annotations

import numpy as np


def sample_bilinear(data: np.ndarray, xy: np.ndarray, scale_xy=(1.0, 1.0)) -> np.ndarray:
    """Sample data (H,W) or (H,W,K) at xy (N,2) pixel coords (original image
    frame); scale_xy maps image coords -> grid coords (sx, sy)."""
    H, W = data.shape[:2]
    x = np.asarray(xy[:, 0], np.float64) * scale_xy[0] - 0.5
    y = np.asarray(xy[:, 1], np.float64) * scale_xy[1] - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0
    x0c = np.clip(x0, 0, W - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    y0c = np.clip(y0, 0, H - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    if data.ndim == 2:
        v00, v01 = data[y0c, x0c], data[y0c, x1c]
        v10, v11 = data[y1c, x0c], data[y1c, x1c]
        return (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )
    v00, v01 = data[y0c, x0c], data[y0c, x1c]
    v10, v11 = data[y1c, x0c], data[y1c, x1c]
    fx = fx[:, None]
    fy = fy[:, None]
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def sample_nearest(data: np.ndarray, xy: np.ndarray, scale_xy=(1.0, 1.0)) -> np.ndarray:
    H, W = data.shape[:2]
    x = np.clip(np.round(np.asarray(xy[:, 0]) * scale_xy[0] - 0.5).astype(np.int64), 0, W - 1)
    y = np.clip(np.round(np.asarray(xy[:, 1]) * scale_xy[1] - 0.5).astype(np.int64), 0, H - 1)
    return data[y, x]


def resize_bilinear(data: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize-equivalent bilinear resize (H,W[,K]) -> out_hw."""
    H2, W2 = out_hw
    ys = (np.arange(H2) + 0.5) * data.shape[0] / H2
    xs = (np.arange(W2) + 0.5) * data.shape[1] / W2
    xx, yy = np.meshgrid(xs, ys)
    xy = np.stack([xx.ravel(), yy.ravel()], -1)
    out = sample_bilinear(data, xy)
    return out.reshape(H2, W2, *data.shape[2:])


def resize_nearest(data: np.ndarray, out_hw) -> np.ndarray:
    H2, W2 = out_hw
    ys = (np.arange(H2) + 0.5) * data.shape[0] / H2
    xs = (np.arange(W2) + 0.5) * data.shape[1] / W2
    xx, yy = np.meshgrid(xs, ys)
    xy = np.stack([xx.ravel(), yy.ravel()], -1)
    out = sample_nearest(data, xy)
    return out.reshape(H2, W2, *data.shape[2:])
