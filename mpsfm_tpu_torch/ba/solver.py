"""Batched Levenberg-Marquardt bundle adjustment over the slot-table
BAData with Schur-complement reduced solves (port of mpsfm_tpu/ba/solver.py).

`BAData` is the padded flat problem with camera-major observations; its
index fields are int64 tensors, its optional per-(point, camera) tables
and block-sparse Schur tables (`bs`, ba/schur_sparse.py) may be None.
`make_slot_tables` / `make_pc_tables` are the host (numpy) builders of
its gather tables, `_assemble` the residuals, IRLS weights and analytic
Jacobians with the observation axis last (the point covariances' input),
`_assemble_ne` the normal equations of the LM.

`solve_ba` picks the reduced solve of S Δc = rhs, S = Hcc − W Hpp⁻¹ Wᵀ,
as the JAX package picks it:
  * dense Schur (`_dense_schur_solve`) when the per-(point, camera)
    tables exist and C ≤ dense_schur_max_cams: S formed as one product,
    S + 1e-7·I solved by ba/cholesky.cholesky_solve — the kernel K1 on a
    CUDA tensor (the JAX package's Pallas K1 computes this solve), its
    plain version on a CPU one;
  * explicit block-sparse Schur CG (ba/schur_sparse.py) when `bs` exists;
  * matrix-free PCG (`_schur_pcg`) otherwise.
The LM loop is a host loop that reads one pair of flags per iteration
(the accept test and the rel_tol latch), where the JAX package keeps a
while_loop on the device; the CGs read their stopping condition every
schur_sparse.READ_EVERY iterations (schur_sparse.masked_pcg).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.ba.cholesky import cholesky_solve
from mpsfm_tpu_torch.ba.schur_sparse import (
    BlockSchurTables,
    build_schur_blocks,
    inv_spd,
    masked_pcg,
    pm_backsub,
    pm_coupling_table,
    pm_reduced_rhs,
    schur_cg_blocks,
)
from mpsfm_tpu_torch.geometry.rotations import quat_mul, quat_normalize, quat_rotate, so3_exp_quat


class BAData(NamedTuple):
    """Padded flat BA problem (the JAX package's BAData).

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
    # explicit block-sparse Schur structure of the large-scene path
    # (ba/schur_sparse.py); None => matrix-free PCG
    bs: BlockSchurTables | None = None


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


def _seg_reduce(vals, slots, mask):
    """Segment sum via gather: vals (N, ...), slots (S, K) -> (S, ...)."""
    m = mask.reshape(*mask.shape, *([1] * (vals.dim() - 1)))
    return (vals[slots] * m).sum(1)


def _cam_reduce(vals, C: int):
    """Per-camera segment sum for camera-major padded obs: dense reshape."""
    return vals.reshape(C, -1, *vals.shape[1:]).sum(1)


def _reproj_residual(quat, t, X, fx, fy, cx, cy, uv):
    """One observation's reprojection residual (2,)."""
    p = quat_rotate(quat, X) + t
    z = p[2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.stack([fx * p[0] / zs + cx - uv[0], fy * p[1] / zs + cy - uv[1]])


def _depth_residual(quat, t, X, logtarget):
    """One observation's log-depth residual."""
    z = quat_rotate(quat, X)[2] + t[2]
    return torch.log(z.clamp_min(1e-8)) - logtarget


def _segment_sum(vals, ids, num: int):
    return torch.zeros((num, *vals.shape[1:]), dtype=vals.dtype, device=vals.device).index_add_(0, ids, vals)


def _cam_expand(x, No: int):
    """Per-camera values broadcast to camera-major obs rows: x (C, ...) -> (No, ...)."""
    C = x.shape[0]
    return x[:, None].expand(C, No // C, *x.shape[1:]).reshape(No, *x.shape[1:])


def _cam_broadcast_rows(x, N: int):
    """x (C, k) -> (N, k) camera-major row broadcast (no gather)."""
    C = x.shape[0]
    return x[:, None, :].expand(C, N // C, x.shape[1]).reshape(N, x.shape[1])


def _cost_only(data: BAData, quat, t, xyz, reproj_loss: int, depth_loss: int):
    """Residuals + robust cost without Jacobians (the trial step's cost)."""
    quat = quat_normalize(quat)
    No = data.r_cam.shape[0]
    Nd = data.d_cam.shape[0]
    R = _rotmat_cols(quat)

    Re = [_cam_expand_last(r, No) for r in R]
    te = [_cam_expand_last(t[:, k], No) for k in range(3)]
    X = xyz[data.r_pt]
    px = Re[0] * X[:, 0] + Re[1] * X[:, 1] + Re[2] * X[:, 2] + te[0]
    py = Re[3] * X[:, 0] + Re[4] * X[:, 1] + Re[5] * X[:, 2] + te[1]
    pz = Re[6] * X[:, 0] + Re[7] * X[:, 1] + Re[8] * X[:, 2] + te[2]
    inv_z = 1.0 / torch.where(pz.abs() < 1e-8, torch.full_like(pz, 1e-8), pz)
    ru = _cam_expand_last(data.fx, No) * px * inv_z + _cam_expand_last(data.cx, No) - data.r_uv[:, 0]
    rv = _cam_expand_last(data.fy, No) * py * inv_z + _cam_expand_last(data.cy, No) - data.r_uv[:, 1]
    s_r = ru * ru + rv * rv
    cost = (data.r_mag * losses.rho(reproj_loss, s_r, data.r_scale) * data.r_valid).sum()

    Re_d = [_cam_expand_last(r, Nd) for r in R]
    te_d = [_cam_expand_last(t[:, k], Nd) for k in range(3)]
    Xd = xyz[data.d_pt]
    pzd = Re_d[6] * Xd[:, 0] + Re_d[7] * Xd[:, 1] + Re_d[8] * Xd[:, 2] + te_d[2]
    d_res = torch.log(pzd.clamp_min(1e-8)) - data.d_logtarget
    s_d = d_res * d_res
    return cost + (data.d_mag * losses.rho(depth_loss, s_d, data.d_scale) * data.d_valid).sum()


def _assemble_ne(data: BAData, quat, t, xyz, reproj_loss: int, depth_loss: int):
    """Fused assembly + normal equations. Elementwise math on (No,)
    component vectors; per-camera sums are reshape-sums of the
    camera-major rows; the 9 point-side products (6 of Hpp, 3 of g_p) are
    one (No, 9) row table summed through the point slot tables; the
    dense-Schur coupling T[p,c] is one (P, C) row gather of the (No, 18)
    W table through pc_*_slot (a point is observed at most once a camera).

    Returns (Hcc (C,6,6), Hpp (P,3,3), g_c (C,6), g_p (P,3),
    Wr_rows (No,18), Wd_rows (Nd,18), T (P,C,6,3) or None)."""
    quat = quat_normalize(quat)
    C = quat.shape[0]
    P = xyz.shape[0]
    No = data.r_cam.shape[0]
    Nd = data.d_cam.shape[0]
    R = _rotmat_cols(quat)

    # ---- reprojection side ----
    Re = [_cam_expand_last(r, No) for r in R]
    te = [_cam_expand_last(t[:, k], No) for k in range(3)]
    X = xyz[data.r_pt]
    X0, X1, X2 = X[:, 0], X[:, 1], X[:, 2]
    px = Re[0] * X0 + Re[1] * X1 + Re[2] * X2 + te[0]
    py = Re[3] * X0 + Re[4] * X1 + Re[5] * X2 + te[1]
    pz = Re[6] * X0 + Re[7] * X1 + Re[8] * X2 + te[2]
    fxe = _cam_expand_last(data.fx, No)
    fye = _cam_expand_last(data.fy, No)
    inv_z = 1.0 / torch.where(pz.abs() < 1e-8, torch.full_like(pz, 1e-8), pz)
    ru = fxe * px * inv_z + _cam_expand_last(data.cx, No) - data.r_uv[:, 0]
    rv = fye * py * inv_z + _cam_expand_last(data.cy, No) - data.r_uv[:, 1]
    s_r = ru * ru + rv * rv
    w_r = data.r_mag * losses.rho_prime(reproj_loss, s_r, data.r_scale) * data.r_valid

    a0 = fxe * inv_z
    a2 = -fxe * px * inv_z * inv_z
    b1 = fye * inv_z
    b2 = -fye * py * inv_z * inv_z
    qx, qy, qz = px - te[0], py - te[1], pz - te[2]
    zeros = torch.zeros_like(px)
    dof = [_cam_expand_last(data.cam_dof[:, k], No) for k in range(6)]
    pv_r = data.point_var[data.r_pt]
    # camera-side rows (u and v residuals), dof-masked
    ju = [(a2 * qy) * dof[0], (a0 * qz - a2 * qx) * dof[1], (-a0 * qy) * dof[2], a0 * dof[3], zeros, a2 * dof[5]]
    jv = [(b2 * qy - b1 * qz) * dof[0], (-b2 * qx) * dof[1], (b1 * qx) * dof[2], zeros, b1 * dof[4], b2 * dof[5]]
    # point-side rows (row of dr/dp times R), point_var-masked
    jpu = [(a0 * Re[0] + a2 * Re[6]) * pv_r, (a0 * Re[1] + a2 * Re[7]) * pv_r, (a0 * Re[2] + a2 * Re[8]) * pv_r]
    jpv = [(b1 * Re[3] + b2 * Re[6]) * pv_r, (b1 * Re[4] + b2 * Re[7]) * pv_r, (b1 * Re[5] + b2 * Re[8]) * pv_r]

    # ---- depth side ----
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
    inv_zd = torch.where(pzd > 1e-8, 1.0 / pzc, torch.zeros_like(pzc))
    zerosd = torch.zeros_like(pxd)
    dofd = [_cam_expand_last(data.cam_dof[:, k], Nd) for k in range(6)]
    pv_d = data.point_var[data.d_pt]
    jd = [(inv_zd * (pyd - te_d[1])) * dofd[0], (-inv_zd * (pxd - te_d[0])) * dofd[1], zerosd,
          zerosd, zerosd, inv_zd * dofd[5]]
    jpd = [inv_zd * Re_d[6] * pv_d, inv_zd * Re_d[7] * pv_d, inv_zd * Re_d[8] * pv_d]

    # ---- camera-side reductions (reshape sums) ----
    hcc = {}
    for i in range(6):
        for j in range(i, 6):
            hcc[(i, j)] = (_cam_reduce_last(w_r * (ju[i] * ju[j] + jv[i] * jv[j]), C)
                           + _cam_reduce_last(w_d * (jd[i] * jd[j]), C))
    Hcc = torch.stack([torch.stack([hcc[(min(i, j), max(i, j))] for j in range(6)], -1) for i in range(6)], -2)
    g_c = torch.stack([_cam_reduce_last(w_r * (ju[i] * ru + jv[i] * rv), C)
                       + _cam_reduce_last(w_d * (jd[i] * d_res), C) for i in range(6)], -1)

    # ---- point-side row tables + slot gathers ----
    def point_rows(wu_, wv_, pu, pv, resu, resv):
        # [pp00, pp01, pp02, pp11, pp12, pp22, gp0, gp1, gp2]
        cols = [wu_ * (pu[i] * pu[j]) + wv_ * (pv[i] * pv[j]) for i in range(3) for j in range(i, 3)]
        cols += [wu_ * (pu[i] * resu) + wv_ * (pv[i] * resv) for i in range(3)]
        return torch.stack(cols, -1)  # (N, 9)

    prow_r = point_rows(w_r, w_r, jpu, jpv, ru, rv)
    prow_d = point_rows(w_d, torch.zeros_like(w_d), jpd, jpd, d_res, d_res)
    pr = (prow_r[data.r_pt_slots] * data.r_pt_slot_mask[..., None]).sum(1)
    pr = pr + (prow_d[data.d_pt_slots] * data.d_pt_slot_mask[..., None]).sum(1)  # (P,9)
    s00, s01, s02, s11, s12, s22 = (pr[:, k] for k in range(6))
    Hpp = torch.stack([torch.stack([s00, s01, s02], -1), torch.stack([s01, s11, s12], -1),
                       torch.stack([s02, s12, s22], -1)], -2)  # (P,3,3)
    g_p = pr[:, 6:9]

    # ---- W coupling row tables ----
    Wr_rows = torch.stack([w_r * (ju[i] * jpu[j] + jv[i] * jpv[j]) for i in range(6) for j in range(3)], -1)
    Wd_rows = torch.stack([w_d * (jd[i] * jpd[j]) for i in range(6) for j in range(3)], -1)

    T = None
    if data.pc_r_slot is not None:
        T = Wr_rows[data.pc_r_slot] * data.pc_r_mask[..., None]
        T = (T + Wd_rows[data.pc_d_slot] * data.pc_d_mask[..., None]).reshape(P, C, 6, 3)
    return Hcc, Hpp, g_c, g_p, Wr_rows, Wd_rows, T


def _schur_pcg(data: BAData, Hcc_aug, Hpp_inv, Wr_rows, Wd_rows, rhs, cg_iters: int, cg_tol, x0=None):
    """PCG on S x = rhs with S = Hcc_aug − W Hpp_inv Wᵀ, matrix-free, with
    the block-Jacobi preconditioner Hcc_aug⁻¹. x0: the warm start (the
    previous LM iteration's camera step). Returns (x, iterations)."""
    C = Hcc_aug.shape[0]
    No, Nd = Wr_rows.shape[0], Wd_rows.shape[0]
    Wr = Wr_rows.reshape(No, 6, 3)
    Wd = Wd_rows.reshape(Nd, 6, 3)

    def S_mv(x):  # x (C,6)
        y_r = (Wr * _cam_broadcast_rows(x, No)[:, :, None]).sum(1)  # (No,3)
        y_d = (Wd * _cam_broadcast_rows(x, Nd)[:, :, None]).sum(1)
        yp = (y_r[data.r_pt_slots] * data.r_pt_slot_mask[..., None]).sum(1)
        yp = yp + (y_d[data.d_pt_slots] * data.d_pt_slot_mask[..., None]).sum(1)  # (P,3)
        zp = torch.einsum("pij,pj->pi", Hpp_inv, yp)
        back_r = (Wr * zp[data.r_pt][:, None, :]).sum(-1)  # (No,6)
        back_d = (Wd * zp[data.d_pt][:, None, :]).sum(-1)
        back = back_r.reshape(C, -1, 6).sum(1) + back_d.reshape(C, -1, 6).sum(1)
        return torch.einsum("cij,cj->ci", Hcc_aug, x) - back

    return masked_pcg(S_mv, inv_spd(Hcc_aug), rhs, cg_iters, cg_tol, x0)


def _schur_coupling(T, Hpp_inv):
    """T Hpp⁻¹ Tᵀ (6C × 6C) of the per-(point, camera) coupling T (P,C,6,3),
    formed densely: the contraction is one product."""
    P, C = T.shape[:2]
    K = 6 * C
    U = T.reshape(P, K, 3)
    TB = torch.bmm(U, Hpp_inv)  # (P, 6C, 3)
    return TB.permute(1, 0, 2).reshape(K, 3 * P) @ U.permute(1, 0, 2).reshape(K, 3 * P).T


def _reduced_solve(S_red, Hcc_aug, rhs):
    """S = Hcc_aug − S_red (Hcc_aug on the 6×6 diagonal blocks), S + 1e-7·I
    solved by ba/cholesky.cholesky_solve: K1 on a CUDA tensor, its plain
    version on a CPU one. Returns Δc (C,6)."""
    C = Hcc_aug.shape[0]
    K = 6 * C
    S = (-S_red).reshape(C, 6, C, 6)
    ii = torch.arange(C, device=S.device)
    S[ii, :, ii, :] += Hcc_aug
    S = S.reshape(K, K) + 1e-7 * torch.eye(K, dtype=S.dtype, device=S.device)
    return cholesky_solve(S, rhs.reshape(K)).reshape(C, 6)


def _dense_schur_solve(T, Hcc_aug, Hpp_inv, rhs):
    """S = Hcc_aug − T Hpp⁻¹ Tᵀ formed densely (6C × 6C) and solved
    (_reduced_solve). Returns (Δc (C,6), 0)."""
    x = _reduced_solve(_schur_coupling(T, Hpp_inv), Hcc_aug, rhs)
    return x, torch.zeros((), dtype=torch.int32, device=rhs.device)


def _backsub_rows(data: BAData, Wr, Wd, Hpp_inv, g_p, delta_c):
    """Δp = −Hpp⁻¹ (g_p + Wᵀ Δc) through the observation rows and the point
    slot tables; Wr (No,6,3), Wd (Nd,6,3)."""
    wtd_r = (Wr * _cam_broadcast_rows(delta_c, Wr.shape[0])[:, :, None]).sum(1)  # (No,3)
    wtd_d = (Wd * _cam_broadcast_rows(delta_c, Wd.shape[0])[:, :, None]).sum(1)
    wtd = (wtd_r[data.r_pt_slots] * data.r_pt_slot_mask[..., None]).sum(1)
    wtd = wtd + (wtd_d[data.d_pt_slots] * data.d_pt_slot_mask[..., None]).sum(1)  # (P,3)
    return -torch.einsum("pij,pj->pi", Hpp_inv, g_p + wtd) * data.point_var[:, None]


def solve_ba(
    data: BAData,
    reproj_loss: int = losses.SOFT_L1,
    depth_loss: int = losses.CAUCHY,
    max_iters: int = 20,
    cg_iters: int = 32,
    cg_tol: float = 1e-2,
    lm_lambda0: float = 1e-4,
    rel_tol: float = 1e-6,
    dense_schur_max_cams: int = 512,
):
    """Run LM. Returns (quat, t, xyz, info) with info = {cost0, cost,
    accepted, cost_history (max_iters,), cg_iters (max_iters,) int32}.

    The JAX package's schedule: a step is taken iff it lowers the cost
    (λ /= 3, floor 1e-10), else λ *= 10 (cap 1e6); the loop ends after
    max_iters steps or at the first accepted step whose relative cost
    change is below rel_tol; cost_history keeps cost0 in the slots after
    an early end. The normal equations (and, on the block-Schur route,
    the coupling table and the blocks G at the new λ) are rebuilt only on
    accepted steps. The CG routes solve to the Eisenstat–Walker tolerance
    clip(sqrt(‖rhs‖ / ‖rhs₀‖), 1e-4, cg_tol), warm-started from the
    previous step; the block-Schur CG gets max(cg_iters, 64) iterations."""
    C = data.quat.shape[0]
    dtype, dev = data.xyz.dtype, data.xyz.device
    use_dense = data.pc_r_slot is not None and C <= dense_schur_max_cams
    use_bs = data.bs is not None and not use_dense
    frozen_c = 1.0 - data.cam_dof  # (C,6)
    frozen_p = (1.0 - data.point_var)[:, None]  # (P,1)

    def ne_of(quat, t, xyz):
        return _assemble_ne(data, quat, t, xyz, reproj_loss, depth_loss)

    def cost_of(quat, t, xyz):
        return _cost_only(data, quat, t, xyz, reproj_loss, depth_loss)

    def hpp_inv_of(Hpp, lam):
        dp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        return inv3x3(Hpp + torch.diag_embed(lam * dp + 1e-8 + frozen_p))

    def bs_tables_of(ne, lam):
        """(V, G) at the given normal equations and λ: rebuilt on accepted
        steps only; rejected steps reuse G with the stale λ in its point
        damping (the LM accept test gates every step)."""
        V = pm_coupling_table(ne[4], ne[5], data.bs)
        return V, build_schur_blocks(V, hpp_inv_of(ne[1], lam), data.bs)

    quat, t, xyz = data.quat, data.t, data.xyz
    cost0 = cost_of(quat, t, xyz)
    cost = cost0
    lam = np.float32(lm_lambda0)  # the JAX package keeps λ in float32
    accepted = 0
    hist = cost0.repeat(max_iters)
    cg_hist = torch.zeros(max_iters, dtype=torch.int32, device=dev)
    ne = ne_of(quat, t, xyz)
    bs_cache = bs_tables_of(ne, float(lam)) if use_bs else None
    rhs0_norm = None
    delta_prev = torch.zeros((C, 6), dtype=dtype, device=dev)
    for it in range(max_iters):
        Hcc, Hpp, g_c, g_p, Wr_rows, Wd_rows, T = ne
        No, Nd = Wr_rows.shape[0], Wd_rows.shape[0]
        Wr = Wr_rows.reshape(No, 6, 3)
        Wd = Wd_rows.reshape(Nd, 6, 3)
        # LM augmentation (Marquardt scaling) + identity rows for frozen dims
        dc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_aug = Hcc + torch.diag_embed(float(lam) * dc + 1e-8 + frozen_c)
        Hpp_inv = hpp_inv_of(Hpp, float(lam))

        if use_bs:
            V, G = bs_cache
            rhs, _hp = pm_reduced_rhs(V, Hpp_inv, g_c, g_p, data.bs)
        else:
            # reduced rhs: −(g_c − W Hpp⁻¹ g_p)
            hp = torch.einsum("pij,pj->pi", Hpp_inv, g_p)
            red_r = (Wr * hp[data.r_pt][:, None, :]).sum(-1).reshape(C, -1, 6).sum(1)
            red_d = (Wd * hp[data.d_pt][:, None, :]).sum(-1).reshape(C, -1, 6).sum(1)
            rhs = -(g_c - red_r - red_d)

        rhs_norm = torch.sqrt((rhs * rhs).sum())
        if rhs0_norm is None:
            rhs0_norm = rhs_norm
        if use_dense:
            delta_c, cg_used = _dense_schur_solve(T, Hcc_aug, Hpp_inv, rhs)
        else:
            tol_eff = torch.clamp(torch.sqrt(rhs_norm / rhs0_norm.clamp_min(1e-30)), 1e-4, cg_tol)
            if use_bs:
                delta_c, cg_used = schur_cg_blocks(G, data.bs, Hcc_aug, rhs, max(cg_iters, 64), tol_eff,
                                                   x0=delta_prev)
            else:
                delta_c, cg_used = _schur_pcg(data, Hcc_aug, Hpp_inv, Wr_rows, Wd_rows, rhs, cg_iters, tol_eff,
                                              x0=delta_prev)
        delta_c = delta_c * data.cam_dof

        # back-substitution: Δp = −Hpp⁻¹ (g_p + Wᵀ Δc)
        if use_bs:
            delta_p = pm_backsub(V, Hpp_inv, g_p, delta_c, data.point_var, data.bs)
        else:
            delta_p = _backsub_rows(data, Wr, Wd, Hpp_inv, g_p, delta_c)

        quat_new, t_new = _apply_cam_update(quat, t, delta_c)
        xyz_new = xyz + delta_p
        new_cost = cost_of(quat_new, t_new, xyz_new)
        rel = (cost - new_cost).abs() / cost.clamp_min(1e-30)
        improved, small = torch.stack([(new_cost < cost) & torch.isfinite(new_cost), rel < rel_tol]).tolist()
        done = improved and small  # the loop's one read
        if improved:
            quat, t, xyz, cost = quat_new, t_new, xyz_new, new_cost
            accepted += 1
            lam = max(lam / np.float32(3.0), np.float32(1e-10))
            ne = ne_of(quat, t, xyz)
            if use_bs:
                bs_cache = bs_tables_of(ne, float(lam))
        else:
            lam = min(lam * np.float32(10.0), np.float32(1e6))
        hist[it] = cost
        cg_hist[it] = cg_used
        delta_prev = delta_c
        if done:
            break
    info = {"cost0": cost0, "cost": cost, "accepted": accepted, "cost_history": hist, "cg_iters": cg_hist}
    return quat, t, xyz, info
