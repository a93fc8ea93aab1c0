"""Fixed-budget batched RANSAC (port of mpsfm_tpu/estimators/ransac.py).

A fixed budget of hypotheses is solved at once, every hypothesis is scored
against every (masked) correspondence in one pass, and the winner is
refit on its inliers. torch cannot reproduce `jax.random`, so each RANSAC
takes its samples `idx` (..., num_hyp, sample_size) as an argument;
`sample_indices` draws them from an explicit torch.Generator. Ties at the
argmax resolve to the first hypothesis, as in the JAX package.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.estimators.essential import (
    decompose_essential,
    essential_from_eight_points,
    sampson_error_sq,
)
from mpsfm_tpu_torch.estimators.homography import (
    homography_from_four_points,
    homography_transfer_error_sq,
)
from mpsfm_tpu_torch.estimators.pnp import (
    pnp_from_plane,
    pnp_from_six_points,
    refine_pose_gn,
    reprojection_residuals,
)
from mpsfm_tpu_torch.geometry.rotations import Rigid3d
from mpsfm_tpu_torch.geometry.triangulation import point_depth


def sample_indices(generator, num_hyp, sample_size, valid_mask):
    """(num_hyp, sample_size) samples of the valid entries of valid_mask (N,),
    each without replacement, drawn on the generator's device."""
    w = valid_mask.to(device=generator.device, dtype=torch.float32)
    return torch.multinomial(w.expand(num_hyp, -1), sample_size, replacement=False, generator=generator)


def _take(a, idx):
    """a (..., N, D) at idx (..., H, k) -> (..., H, k, D)."""
    return torch.take_along_dim(a[..., None, :, :], idx[..., None].long(), dim=-2)


def _pick(a, best):
    """a (..., H, ...) at best (...) -> (..., ...)."""
    idx = best.reshape(*best.shape, *([1] * (a.dim() - best.dim())))
    return torch.take_along_dim(a, idx, dim=best.dim()).squeeze(best.dim())


def _thresh(thresh_sq, like):
    return torch.as_tensor(thresh_sq, dtype=like.dtype, device=like.device)


def _where(cond, a, b):
    """torch.where with cond (...) broadcast over a's trailing dims."""
    return torch.where(cond.reshape(*cond.shape, *([1] * (a.dim() - cond.dim()))), a, b)


def ransac_essential(idx, xy1_norm, xy2_norm, valid_mask, thresh_sq):
    """Essential-matrix RANSAC on normalized coords, batched over leading dims.

    idx (..., num_hyp, 8) samples; xy1_norm, xy2_norm (..., N, 2) (padded);
    valid_mask (..., N), False for padding; thresh_sq (...) the squared
    Sampson threshold in normalized units. Returns a dict with E, pose
    (cam2_from_cam1, unit baseline), inlier_mask, num_inliers,
    cheirality_votes and best (the winning hypothesis; not in the JAX
    package's dict)."""
    thr = _thresh(thresh_sq, xy1_norm)[..., None]
    Es = essential_from_eight_points(_take(xy1_norm, idx), _take(xy2_norm, idx), minimal=True)
    errs = sampson_error_sq(Es, xy1_norm[..., None, :, :], xy2_norm[..., None, :, :])  # (..., H, N)
    inl = (errs < thr[..., None]) & valid_mask[..., None, :]
    best = torch.argmax(inl.sum(-1), dim=-1)
    E0, inl0 = _pick(Es, best), _pick(inl, best)
    # local optimization: refit on the inliers with the full (masked) 8-point
    E1 = essential_from_eight_points(xy1_norm, xy2_norm, inl0)
    inl1 = (sampson_error_sq(E1, xy1_norm, xy2_norm) < thr) & valid_mask
    better = inl1.sum(-1) >= inl0.sum(-1)
    E = _where(better, E1, E0)
    inlier_mask = _where(better, inl1, inl0)
    pose, votes, _ = decompose_essential(E, xy1_norm, xy2_norm, inlier_mask)
    return {"E": E, "pose": pose, "inlier_mask": inlier_mask, "num_inliers": inlier_mask.sum(-1),
            "cheirality_votes": votes, "best": best}


def ransac_homography(idx, xy1_norm, xy2_norm, valid_mask, thresh_sq):
    """Homography RANSAC (forward transfer error), batched over leading dims;
    idx (..., num_hyp, 4). Returns a dict with H, inlier_mask, num_inliers
    and best."""
    thr = _thresh(thresh_sq, xy1_norm)[..., None]
    Hs = homography_from_four_points(_take(xy1_norm, idx), _take(xy2_norm, idx), minimal=True)
    errs = homography_transfer_error_sq(Hs, xy1_norm[..., None, :, :], xy2_norm[..., None, :, :])
    inl = (errs < thr[..., None]) & valid_mask[..., None, :]
    best = torch.argmax(inl.sum(-1), dim=-1)
    H0, inl0 = _pick(Hs, best), _pick(inl, best)
    H1 = homography_from_four_points(xy1_norm, xy2_norm, inl0)
    inl1 = (homography_transfer_error_sq(H1, xy1_norm, xy2_norm) < thr) & valid_mask
    better = inl1.sum(-1) >= inl0.sum(-1)
    return {"H": _where(better, H1, H0), "inlier_mask": _where(better, inl1, inl0),
            "num_inliers": torch.maximum(inl1.sum(-1), inl0.sum(-1)), "best": best}


def _pnp_errs(pose: Rigid3d, xyz, xy_norm):
    """Squared normalized reprojection errors, inf behind the camera."""
    e = (reprojection_residuals(pose, xyz, xy_norm) ** 2).sum(-1)
    return torch.where(point_depth(pose, xyz) > 0, e, torch.inf)


def ransac_pnp(idx, xyz, xy_norm, valid_mask, thresh_sq, refine_iters: int = 10):
    """Absolute-pose RANSAC + Gauss-Newton refinement on the inliers.

    idx (num_hyp, 6) samples; xyz (N, 3) world points; xy_norm (N, 2)
    normalized image coords; thresh_sq the squared reprojection threshold in
    normalized units. Each sample gives two hypotheses, the 6-point DLT and
    the planar solver, scored together (DLT first; best < num_hyp is a DLT
    hypothesis). Returns a dict with pose (cam_from_world), inlier_mask,
    num_inliers and best."""
    thr = _thresh(thresh_sq, xyz)
    s3, s2 = xyz[idx.long()], xy_norm[idx.long()]
    dlt = pnp_from_six_points(s3, s2, minimal=True)
    pl = pnp_from_plane(s3, s2)
    poses = Rigid3d(torch.cat([dlt.quat, pl.quat]), torch.cat([dlt.t, pl.t]))
    errs = _pnp_errs(Rigid3d(poses.quat[:, None], poses.t[:, None]), xyz, xy_norm)  # (2H, N)
    inl = torch.isfinite(errs) & (errs < thr) & valid_mask
    best = torch.argmax(inl.sum(-1))
    pose0, inl0 = Rigid3d(poses.quat[best], poses.t[best]), inl[best]
    pose = refine_pose_gn(pose0, xyz, xy_norm, inl0.to(xyz.dtype), iters=refine_iters)
    inl1 = (_pnp_errs(pose, xyz, xy_norm) < thr) & valid_mask
    better = inl1.sum() >= inl0.sum()
    pose = Rigid3d(torch.where(better, pose.quat, pose0.quat), torch.where(better, pose.t, pose0.t))
    inlier_mask = torch.where(better, inl1, inl0)
    # a second refinement round on the updated inlier set
    pose = refine_pose_gn(pose, xyz, xy_norm, inlier_mask.to(xyz.dtype), iters=refine_iters)
    inl2 = (_pnp_errs(pose, xyz, xy_norm) < thr) & valid_mask
    return {"pose": pose, "inlier_mask": inl2, "num_inliers": inl2.sum(), "best": best}
