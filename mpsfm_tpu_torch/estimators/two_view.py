"""Two-view geometry estimation and classification, batched over pairs
(port of mpsfm_tpu/estimators/two_view.py).

Estimates the essential and homography models of every pair, classifies
the pair (CALIBRATED, PLANAR_OR_PANORAMIC or DEGENERATE), recovers the
relative pose and reports the inliers and the median triangulation angle.
The pairs are padded to power-of-two match buckets, one batched call per
bucket, and normalized on the host, as in the JAX package.

The samples of every pair come from one torch.Generator seeded by `seed`,
on the device of the computation, drawn pair after pair (so the card and
the CPU draw differently for the same seed); `indices` gives them instead.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.estimators.ransac import ransac_essential, ransac_homography, sample_indices
from mpsfm_tpu_torch.geometry.rotations import Rigid3d, quat_rotate
from mpsfm_tpu_torch.geometry.triangulation import pair_triangulation_angle, triangulate_two_view


class TwoViewConfig(enum.IntEnum):
    """COLMAP-compatible two-view configuration classes."""

    UNDEFINED = 0
    DEGENERATE = 1
    CALIBRATED = 2
    UNCALIBRATED = 3
    PLANAR = 4
    PANORAMIC = 5
    PLANAR_OR_PANORAMIC = 6
    WATERMARK = 7
    MULTIPLE = 8


# COLMAP defaults for two-view geometry classification.
MIN_NUM_INLIERS = 15
MAX_H_INLIER_RATIO = 0.8


def _estimate_pair(idx_e, idx_h, xy1n, xy2n, valid, e_thresh_sq, h_thresh_sq):
    """Two-view estimation of pairs batched over leading dims: idx_e (...,
    num_hyp, 8) and idx_h (..., num_hyp, 4) samples, xy (..., N, 2), valid
    (..., N), thresholds (...). Returns a dict of tensors (with the essential
    RANSAC's winning hypothesis, best, which the JAX package does not return)."""
    out_e = ransac_essential(idx_e, xy1n, xy2n, valid, e_thresh_sq)
    out_h = ransac_homography(idx_h, xy1n, xy2n, valid, h_thresh_sq)
    # median triangulation angle over the essential inliers
    n = xy1n.shape[-2]
    pose1 = Rigid3d.identity(xy1n.shape[:-1], dtype=xy1n.dtype, device=xy1n.device)
    pose2 = Rigid3d(out_e["pose"].quat[..., None, :], out_e["pose"].t[..., None, :])
    X = triangulate_two_view(pose1, Rigid3d(pose2.quat.expand_as(pose1.quat), pose2.t.expand_as(pose1.t)),
                             xy1n, xy2n)
    ang = pair_triangulation_angle(pose1, pose2, X)
    ang_sorted = torch.sort(torch.where(out_e["inlier_mask"], ang, torch.inf), dim=-1).values
    k = out_e["num_inliers"].clamp_min(1)
    median_ang = torch.take_along_dim(ang_sorted, ((k - 1) // 2).clamp(0, n - 1)[..., None], dim=-1)[..., 0]

    num_e, num_h = out_e["num_inliers"], out_h["num_inliers"]
    degenerate = num_e < MIN_NUM_INLIERS
    planar = (num_h.to(torch.float32) > MAX_H_INLIER_RATIO * num_e.to(torch.float32)) & ~degenerate
    config = torch.where(degenerate, int(TwoViewConfig.DEGENERATE),
                         torch.where(planar, int(TwoViewConfig.PLANAR_OR_PANORAMIC), int(TwoViewConfig.CALIBRATED)))
    return {
        "config": config,
        "num_inliers": num_e,
        "num_h_inliers": num_h,
        "inlier_mask": out_e["inlier_mask"],
        "pose": out_e["pose"],
        "tri_angle": median_ang,
        "E": out_e["E"],
        "best": out_e["best"],
    }


class TwoViewGeometry:
    """Host-side result of two-view verification for one pair (numpy)."""

    __slots__ = ["config", "inlier_matches", "pose", "tri_angle", "E", "num_inliers"]

    def __init__(self, config, inlier_matches, pose, tri_angle, E, num_inliers):
        self.config = TwoViewConfig(int(config))
        self.inlier_matches = inlier_matches  # (M, 2) int array of keypoint index pairs
        self.pose = pose  # cam2_from_cam1 (Rigid3d of numpy arrays), unit baseline
        self.tri_angle = float(tri_angle)
        self.E = E
        self.num_inliers = int(num_inliers)

    def invert(self):
        q = np.asarray(self.pose.quat)
        qinv = q * np.array([1.0, -1, -1, -1])
        t = torch.as_tensor(np.asarray(self.pose.t), dtype=torch.float32)
        tinv = -quat_rotate(torch.as_tensor(qinv, dtype=torch.float32), t).numpy()
        return TwoViewGeometry(
            self.config,
            self.inlier_matches[:, ::-1],
            Rigid3d(qinv, tinv),
            self.tri_angle,
            self.E.T if self.E is not None else None,
            self.num_inliers,
        )


def _next_bucket(n, minimum=64):
    b = minimum
    while b < n:
        b *= 2
    return b


def estimate_two_view_geometry(cam1, cam2, kps1, kps2, matches, max_error_px: float = 4.0,
                               num_hyp: int = 512, seed: int = 0, device="cuda") -> TwoViewGeometry:
    """Single-pair host API (pads and calls the batched estimation)."""
    return estimate_two_view_geometry_batch(
        [(cam1, cam2, kps1, kps2, matches)], max_error_px=max_error_px, num_hyp=num_hyp, seed=seed, device=device
    )[0]


def estimate_two_view_geometry_batch(pairs, max_error_px: float = 4.0, num_hyp: int = 512, seed: int = 0,
                                     indices=None, device="cuda"):
    """Verify many pairs, one batched call per match-count bucket (powers
    of two).

    pairs: list of (cam1, cam2, kps1 (N1, 2) px, kps2, matches (M, 2) int);
    a camera is anything with fx, fy, cx, cy convertible to float.
    indices: optional list, per pair, of its (idx_e (num_hyp, 8), idx_h
    (num_hyp, 4)) samples into its padded matches (None for a pair of fewer
    than 8 matches); drawn from `seed` otherwise. Returns a list of
    TwoViewGeometry."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed) if indices is None else None
    results: list = [None] * len(pairs)
    buckets: dict = {}
    for i, (_, _, _, _, matches) in enumerate(pairs):
        m = len(matches)
        if m < 8:
            results[i] = TwoViewGeometry(
                TwoViewConfig.DEGENERATE, np.zeros((0, 2), np.int64),
                Rigid3d(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)), 0.0, None, 0,
            )
            continue
        buckets.setdefault(_next_bucket(m), []).append(i)

    for bucket, idxs in buckets.items():
        xy1 = np.zeros((len(idxs), bucket, 2), np.float32)
        xy2 = np.zeros((len(idxs), bucket, 2), np.float32)
        valid = np.zeros((len(idxs), bucket), bool)
        thr = np.zeros((len(idxs),), np.float32)
        for j, i in enumerate(idxs):
            cam1, cam2, kps1, kps2, matches = pairs[i]
            m = len(matches)
            p1 = kps1[matches[:, 0]]
            p2 = kps2[matches[:, 1]]
            xy1[j, :m, 0] = (p1[:, 0] - float(cam1.cx)) / float(cam1.fx)
            xy1[j, :m, 1] = (p1[:, 1] - float(cam1.cy)) / float(cam1.fy)
            xy2[j, :m, 0] = (p2[:, 0] - float(cam2.cx)) / float(cam2.fx)
            xy2[j, :m, 1] = (p2[:, 1] - float(cam2.cy)) / float(cam2.fy)
            valid[j, :m] = True
            f1 = 0.5 * (float(cam1.fx) + float(cam1.fy))
            f2 = 0.5 * (float(cam2.fx) + float(cam2.fy))
            # px threshold -> normalized units (mean of the two cameras)
            thr[j] = (0.5 * (max_error_px / f1 + max_error_px / f2)) ** 2
        valid_t = torch.as_tensor(valid, device=dev)
        if indices is None:
            draws = [(sample_indices(gen, num_hyp, 8, valid_t[j]), sample_indices(gen, num_hyp, 4, valid_t[j]))
                     for j in range(len(idxs))]
        else:
            draws = [tuple(torch.as_tensor(np.asarray(a), device=dev) for a in indices[i]) for i in idxs]
        thr_t = torch.as_tensor(thr, device=dev)
        out = _estimate_pair(torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws]),
                             torch.as_tensor(xy1, device=dev), torch.as_tensor(xy2, device=dev), valid_t,
                             thr_t, thr_t)
        out = {k: (Rigid3d(v.quat.cpu().numpy(), v.t.cpu().numpy()) if isinstance(v, Rigid3d) else v.cpu().numpy())
               for k, v in out.items() if k != "best"}
        for j, i in enumerate(idxs):
            matches = pairs[i][4]
            mask = out["inlier_mask"][j][: len(matches)]
            results[i] = TwoViewGeometry(
                out["config"][j],
                np.asarray(matches)[mask],
                Rigid3d(out["pose"].quat[j], out["pose"].t[j]),
                np.rad2deg(out["tri_angle"][j]),
                out["E"][j],
                out["num_inliers"][j],
            )
    return results
