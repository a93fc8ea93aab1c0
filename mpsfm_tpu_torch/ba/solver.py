"""BA problem layout and LM helpers (port of the parts of
mpsfm_tpu/ba/solver.py that the dense solver, the device depth rows and
the point covariances use; the sparse slot-table LM solver and the
block-sparse Schur tables are not ported yet).

`BAData` is the padded flat problem with camera-major observations; its
index fields are int64 tensors, its optional per-(point, camera) tables
may be None. `make_slot_tables` / `make_pc_tables` are the host (numpy)
builders of its gather tables, `_assemble` the residuals, IRLS weights
and analytic Jacobians with the observation axis last.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.geometry.rotations import quat_mul, quat_normalize, so3_exp_quat


class BAData(NamedTuple):
    """Padded flat BA problem (the JAX package's BAData without `bs`).

    Observations are camera-major padded: No = C·Sc rows, rows
    [c·Sc, (c+1)·Sc) belong to camera c (padding rows have valid 0), so
    per-camera reductions are reshape-sums. Per-point reductions gather
    through the slot tables r_pt_slots[p, k] (the k-th observation of
    point p; padded entries masked by r_pt_slot_mask)."""

    # cameras (C,)
    quat: torch.Tensor  # (C,4)
    t: torch.Tensor  # (C,3)
    cam_dof: torch.Tensor  # (C,6) float 0/1, per-dim freedom mask
    fx: torch.Tensor  # (C,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    # points (P,)
    xyz: torch.Tensor  # (P,3)
    point_var: torch.Tensor  # (P,) float 0/1
    # reprojection observations (No,)
    r_cam: torch.Tensor  # (No,) int64
    r_pt: torch.Tensor  # (No,) int64
    r_uv: torch.Tensor  # (No,2)
    r_valid: torch.Tensor  # (No,) float 0/1
    r_mag: torch.Tensor  # (No,) loss magnitude (1/kp_std²)
    r_scale: torch.Tensor  # (No,) robust scale (px)
    # depth observations (Nd,)
    d_cam: torch.Tensor
    d_pt: torch.Tensor
    d_logtarget: torch.Tensor  # (Nd,) log prior depth
    d_valid: torch.Tensor
    d_mag: torch.Tensor  # d²/σ²
    d_scale: torch.Tensor  # m·σ/d
    # point-reduction slot tables (gather-based segment sums)
    r_pt_slots: torch.Tensor  # (P, Tp) int64 into reprojection obs
    r_pt_slot_mask: torch.Tensor  # (P, Tp) f32
    d_pt_slots: torch.Tensor  # (P, Tdp)
    d_pt_slot_mask: torch.Tensor
    # per-(point, camera) slot tables of the dense-Schur coupling blocks
    # (a point is observed at most once per camera); None when absent
    pc_r_slot: torch.Tensor | None = None  # (P, C) int64 into reprojection obs
    pc_r_mask: torch.Tensor | None = None  # (P, C) f32
    pc_d_slot: torch.Tensor | None = None  # (P, C) int64 into depth obs
    pc_d_mask: torch.Tensor | None = None  # (P, C) f32


def make_slot_tables(ids, num_segments: int, pad_width: int | None = None):
    """Host helper: (slots (num_segments, K) int32, mask f32) such that
    (vals[slots] * mask).sum(1) segment-sums vals. Padded entries point at
    index 0 and are masked (gathered values must be finite)."""
    ids = np.asarray(ids, np.int64)
    counts = np.bincount(ids, minlength=num_segments) if len(ids) else np.zeros(num_segments, np.int64)
    K = max(int(counts.max()) if len(ids) else 1, 1)
    if pad_width is not None:
        K = max(K, pad_width)
    slots = np.zeros((num_segments, K), np.int32)
    mask = np.zeros((num_segments, K), np.float32)
    order = np.argsort(ids, kind="stable")
    starts = np.searchsorted(ids[order], np.arange(num_segments))
    for s in range(num_segments):
        c = counts[s]
        if c:
            slots[s, :c] = order[starts[s]: starts[s] + c]
            mask[s, :c] = 1.0
    return slots, mask


def make_pc_tables(pt_ids, valid, num_points: int, num_cams: int, rows_per_cam: int):
    """Host helper: per-(point, camera) slot tables for camera-major obs
    (row n belongs to camera n // rows_per_cam). Returns (None, None) when
    a point appears twice in one camera (the SfM track invariant fails)."""
    slot = np.zeros((num_points, num_cams), np.int32)
    mask = np.zeros((num_points, num_cams), np.float32)
    n = np.where(np.asarray(valid) > 0)[0]
    p = np.asarray(pt_ids)[n]
    c = n // rows_per_cam
    if len(n) and len(np.unique(p.astype(np.int64) * num_cams + c)) != len(n):
        return None, None
    slot[p, c] = n
    mask[p, c] = 1.0
    return slot, mask


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


def _seg_reduce_last(vals, slots, mask):
    """Segment sum along the last axis: vals (..., N), slots (S, K) -> (..., S)."""
    return (vals[..., slots] * mask).sum(-1)


def _cam_reduce_last(vals, C: int):
    """Per-camera sum along the last axis for camera-major obs: (..., C·S) -> (..., C)."""
    return vals.reshape(*vals.shape[:-1], C, -1).sum(-1)


def _cam_expand_last(x, No: int):
    """x (..., C) -> (..., No) for camera-major obs rows (broadcast, no gather)."""
    C = x.shape[-1]
    return x[..., :, None].expand(*x.shape[:-1], C, No // C).reshape(*x.shape[:-1], No)


def _assemble(data: BAData, quat, t, xyz, reproj_loss: int, depth_loss: int):
    """Residuals, IRLS weights, analytic Jacobians and the total cost, with
    the observation axis last: J_r (2,9,No), r_res (No,2), w_r (No,), J_d
    (9,Nd), d_res (Nd,), w_d (Nd,), cost.

    Left perturbation R' = exp(ω)R, t' = t + dt: p = R X + t, ∂p/∂ω =
    −[p − t]ₓ, ∂p/∂dt = I, ∂p/∂X = R; r = (fx px/pz + cx − u, fy py/pz +
    cy − v); depth r = log(pz) − log d with ∂r/∂p = (0, 0, 1/pz)."""
    quat = quat_normalize(quat)
    No = data.r_cam.shape[0]
    Nd = data.d_cam.shape[0]
    R = _rotmat_cols(quat)

    # ---- reprojection ----
    Re = [_cam_expand_last(r, No) for r in R]
    te = [_cam_expand_last(t[:, k], No) for k in range(3)]
    fxe, fye, cxe, cye = (_cam_expand_last(v, No) for v in (data.fx, data.fy, data.cx, data.cy))
    X = xyz[data.r_pt]
    X0, X1, X2 = X[:, 0], X[:, 1], X[:, 2]
    px = Re[0] * X0 + Re[1] * X1 + Re[2] * X2 + te[0]
    py = Re[3] * X0 + Re[4] * X1 + Re[5] * X2 + te[1]
    pz = Re[6] * X0 + Re[7] * X1 + Re[8] * X2 + te[2]
    pzs = torch.where(pz.abs() < 1e-8, torch.full_like(pz, 1e-8), pz)
    inv_z = 1.0 / pzs
    ru = fxe * px * inv_z + cxe - data.r_uv[:, 0]
    rv = fye * py * inv_z + cye - data.r_uv[:, 1]
    s_r = ru * ru + rv * rv
    w_r = data.r_mag * losses.rho_prime(reproj_loss, s_r, data.r_scale) * data.r_valid
    cost_r = (data.r_mag * losses.rho(reproj_loss, s_r, data.r_scale) * data.r_valid).sum()

    a0 = fxe * inv_z
    a2 = -fxe * px * inv_z * inv_z
    b1 = fye * inv_z
    b2 = -fye * py * inv_z * inv_z
    qx, qy, qz = px - te[0], py - te[1], pz - te[2]
    zeros = torch.zeros_like(px)

    def drdomega(a0_, a1_, a2_):  # row a times −[q]ₓ
        return a2_ * qy - a1_ * qz, a0_ * qz - a2_ * qx, a1_ * qx - a0_ * qy

    def drdX(a0_, a1_, a2_):  # row times R
        return (
            a0_ * Re[0] + a1_ * Re[3] + a2_ * Re[6],
            a0_ * Re[1] + a1_ * Re[4] + a2_ * Re[7],
            a0_ * Re[2] + a1_ * Re[5] + a2_ * Re[8],
        )

    rowu_w, rowv_w = drdomega(a0, zeros, a2), drdomega(zeros, b1, b2)
    rowu_X, rowv_X = drdX(a0, zeros, a2), drdX(zeros, b1, b2)
    dof = [_cam_expand_last(data.cam_dof[:, k], No) for k in range(6)]
    pv_r = data.point_var[data.r_pt]
    J_r = torch.stack([
        torch.stack([rowu_w[0] * dof[0], rowu_w[1] * dof[1], rowu_w[2] * dof[2],
                     a0 * dof[3], zeros * dof[4], a2 * dof[5],
                     rowu_X[0] * pv_r, rowu_X[1] * pv_r, rowu_X[2] * pv_r]),
        torch.stack([rowv_w[0] * dof[0], rowv_w[1] * dof[1], rowv_w[2] * dof[2],
                     zeros * dof[3], b1 * dof[4], b2 * dof[5],
                     rowv_X[0] * pv_r, rowv_X[1] * pv_r, rowv_X[2] * pv_r]),
    ])  # (2,9,No)

    # ---- depth ----
    Re_d = [_cam_expand_last(r, Nd) for r in R]
    te_d = [_cam_expand_last(t[:, k], Nd) for k in range(3)]
    Xd = xyz[data.d_pt]
    pxd = Re_d[0] * Xd[:, 0] + Re_d[1] * Xd[:, 1] + Re_d[2] * Xd[:, 2] + te_d[0]
    pyd = Re_d[3] * Xd[:, 0] + Re_d[4] * Xd[:, 1] + Re_d[5] * Xd[:, 2] + te_d[1]
    pzd = Re_d[6] * Xd[:, 0] + Re_d[7] * Xd[:, 1] + Re_d[8] * Xd[:, 2] + te_d[2]
    pzc = pzd.clamp_min(1e-8)
    d_res = torch.log(pzc) - data.d_logtarget
    s_d = d_res * d_res
    w_d = data.d_mag * losses.rho_prime(depth_loss, s_d, data.d_scale) * data.d_valid
    cost_d = (data.d_mag * losses.rho(depth_loss, s_d, data.d_scale) * data.d_valid).sum()

    inv_zd = torch.where(pzd > 1e-8, 1.0 / pzc, torch.zeros_like(pzc))
    qxd, qyd = pxd - te_d[0], pyd - te_d[1]
    zerosd = torch.zeros_like(pxd)
    dofd = [_cam_expand_last(data.cam_dof[:, k], Nd) for k in range(6)]
    pv_d = data.point_var[data.d_pt]
    J_d = torch.stack([
        inv_zd * qyd * dofd[0], -inv_zd * qxd * dofd[1], zerosd * dofd[2],
        zerosd * dofd[3], zerosd * dofd[4], inv_zd * dofd[5],
        inv_zd * Re_d[6] * pv_d, inv_zd * Re_d[7] * pv_d, inv_zd * Re_d[8] * pv_d,
    ])  # (9,Nd)

    return {
        "J_r": J_r, "r_res": torch.stack([ru, rv], -1), "w_r": w_r,
        "J_d": J_d, "d_res": d_res, "w_d": w_d, "cost": cost_r + cost_d,
    }
