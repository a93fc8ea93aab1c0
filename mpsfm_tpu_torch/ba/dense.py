"""Dense cross-product bundle adjustment (port of mpsfm_tpu/ba/dense.py).

The whole LM iteration is expressed on dense (C, P) observation grids
with a validity weight of 0 for absent observations: per-observation
residuals and Jacobians are elementwise (C,P) math from broadcast camera
rows and point columns, per-camera and per-point reductions are sums over
one axis, and the camera-point coupling blocks T are the dense Schur
coupling, so the reduced camera system is S = Hcc − T·Hpp⁻¹·Tᵀ, one
(6C, 3P)×(3P, 6C) product.

The reduced solve S·Δc = rhs goes through ba/cholesky.cholesky_solve: the
hand-written kernel K1 for CUDA tensors, its plain torch version for CPU
ones. The LM loop is a host loop that reads one flag per iteration (the
accept decision), where the JAX package keeps a while_loop on device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.ba.cholesky import cholesky_solve
from mpsfm_tpu_torch.ba.solver import _apply_cam_update, _rotmat_cols, inv3x3
from mpsfm_tpu_torch.geometry.rotations import quat_normalize


class DenseBAData(NamedTuple):
    """Dense (C, P) BA problem. Invalid observations carry weight 0."""

    quat: torch.Tensor  # (C,4)
    t: torch.Tensor  # (C,3)
    cam_dof: torch.Tensor  # (C,6)
    fx: torch.Tensor  # (C,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    xyz: torch.Tensor  # (P,3)
    point_var: torch.Tensor  # (P,)
    uv_x: torch.Tensor  # (C,P) observed keypoint x
    uv_y: torch.Tensor  # (C,P) observed keypoint y
    r_w: torch.Tensor  # (C,P) magnitude * valid (1/kp_std², 0 if absent)
    r_scale: torch.Tensor  # (C,P) robust loss scale
    d_logt: torch.Tensor  # (C,P) log prior depth target
    d_w: torch.Tensor  # (C,P) d²/σ² * valid
    d_scale: torch.Tensor  # (C,P) robust scale m·σ/d


def _project(quat, t, xyz):
    """Dense (C,P) camera-frame coords."""
    R = _rotmat_cols(quat)  # 9 x (C,)
    Rb = [r[:, None] for r in R]
    tb = [t[:, k][:, None] for k in range(3)]
    X0, X1, X2 = xyz[:, 0][None, :], xyz[:, 1][None, :], xyz[:, 2][None, :]
    px = Rb[0] * X0 + Rb[1] * X1 + Rb[2] * X2 + tb[0]
    py = Rb[3] * X0 + Rb[4] * X1 + Rb[5] * X2 + tb[1]
    pz = Rb[6] * X0 + Rb[7] * X1 + Rb[8] * X2 + tb[2]
    return Rb, tb, px, py, pz


def _safe_z(pz):
    return torch.where(pz.abs() < 1e-8, torch.full_like(pz, 1e-8), pz)


def _cost_only(data: DenseBAData, quat, t, xyz, reproj_loss: int, depth_loss: int):
    quat = quat_normalize(quat)
    _, _, px, py, pz = _project(quat, t, xyz)
    inv_z = 1.0 / _safe_z(pz)
    ru = data.fx[:, None] * px * inv_z + data.cx[:, None] - data.uv_x
    rv = data.fy[:, None] * py * inv_z + data.cy[:, None] - data.uv_y
    s_r = ru * ru + rv * rv
    cost = (data.r_w * losses.rho(reproj_loss, s_r, data.r_scale)).sum()
    d_res = torch.log(pz.clamp_min(1e-8)) - data.d_logt
    return cost + (data.d_w * losses.rho(depth_loss, d_res * d_res, data.d_scale)).sum()


def _assemble_ne_dense(data: DenseBAData, quat, t, xyz, reproj_loss: int, depth_loss: int):
    """Returns (Hcc (C,6,6), g_c (C,6), hpp6 (6,P), g_p (P,3), Tflat (6C,3,P))."""
    quat = quat_normalize(quat)
    C = quat.shape[0]
    P = xyz.shape[0]
    Rb, tb, px, py, pz = _project(quat, t, xyz)

    inv_z = 1.0 / _safe_z(pz)
    fxb, fyb = data.fx[:, None], data.fy[:, None]
    ru = fxb * px * inv_z + data.cx[:, None] - data.uv_x
    rv = fyb * py * inv_z + data.cy[:, None] - data.uv_y
    s_r = ru * ru + rv * rv
    w_r = data.r_w * losses.rho_prime(reproj_loss, s_r, data.r_scale)

    a0 = fxb * inv_z
    a2 = -fxb * px * inv_z * inv_z
    b1 = fyb * inv_z
    b2 = -fyb * py * inv_z * inv_z
    qx = px - tb[0]
    qy = py - tb[1]
    qz = pz - tb[2]
    zeros = torch.zeros_like(px)
    dof = [data.cam_dof[:, k][:, None] for k in range(6)]
    pv = data.point_var[None, :]
    ju = [
        (a2 * qy) * dof[0], (a0 * qz - a2 * qx) * dof[1], (-a0 * qy) * dof[2],
        a0 * dof[3], zeros, a2 * dof[5],
    ]
    jv = [
        (b2 * qy - b1 * qz) * dof[0], (-b2 * qx) * dof[1], (b1 * qx) * dof[2],
        zeros, b1 * dof[4], b2 * dof[5],
    ]
    jpu = [(a0 * Rb[0] + a2 * Rb[6]) * pv, (a0 * Rb[1] + a2 * Rb[7]) * pv, (a0 * Rb[2] + a2 * Rb[8]) * pv]
    jpv = [(b1 * Rb[3] + b2 * Rb[6]) * pv, (b1 * Rb[4] + b2 * Rb[7]) * pv, (b1 * Rb[5] + b2 * Rb[8]) * pv]

    # depth side (shares px..pz)
    pzc = pz.clamp_min(1e-8)
    d_res = torch.log(pzc) - data.d_logt
    w_d = data.d_w * losses.rho_prime(depth_loss, d_res * d_res, data.d_scale)
    inv_zd = torch.where(pz > 1e-8, 1.0 / pzc, zeros)
    jd = [(inv_zd * qy) * dof[0], (-inv_zd * qx) * dof[1], zeros, zeros, zeros, inv_zd * dof[5]]
    jpd = [inv_zd * Rb[6] * pv, inv_zd * Rb[7] * pv, inv_zd * Rb[8] * pv]

    hcc = {}
    for i in range(6):
        for j in range(i, 6):
            hcc[(i, j)] = (w_r * (ju[i] * ju[j] + jv[i] * jv[j]) + w_d * (jd[i] * jd[j])).sum(-1)
    Hcc = torch.stack(
        [torch.stack([hcc[(min(i, j), max(i, j))] for j in range(6)], -1) for i in range(6)], -2
    )
    g_c = torch.stack(
        [(w_r * (ju[i] * ru + jv[i] * rv) + w_d * (jd[i] * d_res)).sum(-1) for i in range(6)], -1
    )

    hpp = {}
    for i in range(3):
        for j in range(i, 3):
            hpp[(i, j)] = (w_r * (jpu[i] * jpu[j] + jpv[i] * jpv[j]) + w_d * (jpd[i] * jpd[j])).sum(0)
    g_p = torch.stack(
        [(w_r * (jpu[i] * ru + jpv[i] * rv) + w_d * (jpd[i] * d_res)).sum(0) for i in range(3)], -1
    )

    # coupling blocks (C,6,3,P) -> (6C,3,P), row k = c*6 + i
    Tflat = torch.stack(
        [
            torch.stack([w_r * (ju[i] * jpu[m] + jv[i] * jpv[m]) + w_d * (jd[i] * jpd[m]) for m in range(3)], 1)
            for i in range(6)
        ],
        1,
    ).reshape(C * 6, 3, P)
    hpp6 = torch.stack([hpp[(0, 0)], hpp[(0, 1)], hpp[(0, 2)], hpp[(1, 1)], hpp[(1, 2)], hpp[(2, 2)]], 0)
    return Hcc, g_c, hpp6, g_p, Tflat


def _lm_step(data: DenseBAData, ne, lam: float):
    """Schur-reduced LM step at damping lam: (Δc (C,6), Δp (P,3))."""
    Hcc, g_c, hpp6, g_p, Tflat = ne
    C = Hcc.shape[0]
    K = 6 * C
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    frozen_c = 1.0 - data.cam_dof
    dc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    Hcc_aug = Hcc + (lam * dc + 1e-8 + frozen_c)[:, :, None] * eye6
    frozen_p = 1.0 - data.point_var
    s00, s01, s02, s11, s12, s22 = hpp6
    a00 = s00 * (1 + lam) + 1e-8 + frozen_p
    a11 = s11 * (1 + lam) + 1e-8 + frozen_p
    a22 = s22 * (1 + lam) + 1e-8 + frozen_p
    Hpp_aug = torch.stack(
        [
            torch.stack([a00, s01, s02], -1),
            torch.stack([s01, a11, s12], -1),
            torch.stack([s02, s12, a22], -1),
        ],
        -2,
    )  # (P,3,3)
    Hpp_inv = inv3x3(Hpp_aug)

    # TB (K,3,P): T contracted with Hpp⁻¹ per point
    Bt = Hpp_inv.permute(1, 2, 0)  # (3,3,P)
    TB = torch.stack(
        [Tflat[:, 0] * Bt[0, m][None] + Tflat[:, 1] * Bt[1, m][None] + Tflat[:, 2] * Bt[2, m][None] for m in range(3)],
        1,
    )

    # rhs = -(g_c - T Hpp⁻¹ g_p)
    hpT = torch.einsum("pij,pj->pi", Hpp_inv, g_p).T  # (3,P)
    red = (Tflat[:, 0] * hpT[0][None] + Tflat[:, 1] * hpT[1][None] + Tflat[:, 2] * hpT[2][None]).sum(-1)
    rhs = -(g_c.reshape(K) - red)

    # S = Hcc_aug (block diagonal) − TB·Tᵀ
    P = Tflat.shape[2]
    S = -(TB.reshape(K, 3 * P) @ Tflat.reshape(K, 3 * P).T)
    S = S.reshape(C, 6, C, 6)
    ii = torch.arange(C, device=S.device)
    S[ii, :, ii, :] += Hcc_aug
    S = S.reshape(K, K) + 1e-7 * torch.eye(K, dtype=S.dtype, device=S.device)
    delta_c = cholesky_solve(S, rhs).reshape(C, 6) * data.cam_dof

    # back-substitution: Δp = −Hpp⁻¹ (g_p + Tᵀ Δc)
    wtd = torch.einsum("k,kmp->mp", delta_c.reshape(K), Tflat)  # (3,P)
    delta_p = -torch.einsum("pij,pj->pi", Hpp_inv, g_p + wtd.T) * data.point_var[:, None]
    return delta_c, delta_p


def solve_ba_dense(
    data: DenseBAData,
    reproj_loss: int = losses.SOFT_L1,
    depth_loss: int = losses.CAUCHY,
    max_iters: int = 20,
    lm_lambda0: float = 1e-4,
    rel_tol: float = 1e-6,
):
    """LM with dense-Schur direct solve. Returns (quat, t, xyz, info) with
    info = {cost0, cost, accepted, cost_history (max_iters,)}.

    Same schedule as the JAX package: a step is taken iff it lowers the
    cost (λ /= 3, floor 1e-10), else λ *= 10 (cap 1e6); the loop ends
    after max_iters steps or at the first accepted step whose relative
    cost change is below rel_tol. cost_history keeps cost0 in the slots
    after an early end, as the JAX while_loop leaves them."""
    quat, t, xyz = data.quat, data.t, data.xyz
    cost0 = _cost_only(data, quat, t, xyz, reproj_loss, depth_loss)
    cost = cost0
    lam = np.float32(lm_lambda0)  # the JAX package keeps λ in float32
    accepted = 0
    hist = cost0.repeat(max_iters)
    ne = _assemble_ne_dense(data, quat, t, xyz, reproj_loss, depth_loss)
    for it in range(max_iters):
        delta_c, delta_p = _lm_step(data, ne, float(lam))
        quat_new, t_new = _apply_cam_update(quat, t, delta_c)
        xyz_new = xyz + delta_p
        new_cost = _cost_only(data, quat_new, t_new, xyz_new, reproj_loss, depth_loss)
        improved = bool((new_cost < cost) & torch.isfinite(new_cost))  # the loop's one read
        done = False
        if improved:
            done = bool(((cost - new_cost).abs() / cost.clamp_min(1e-30)) < rel_tol)
            quat, t, xyz, cost = quat_new, t_new, xyz_new, new_cost
            accepted += 1
            lam = max(lam / np.float32(3.0), np.float32(1e-10))
            ne = _assemble_ne_dense(data, quat, t, xyz, reproj_loss, depth_loss)
        else:
            lam = min(lam * np.float32(10.0), np.float32(1e6))
        hist[it] = cost
        if done:
            break
    info = {"cost0": cost0, "cost": cost, "accepted": accepted, "cost_history": hist}
    return quat, t, xyz, info


def densify(data, C: int, P: int, device="cuda") -> DenseBAData:
    """DenseBAData on `device` from a sparse camera-major bundle given as
    numpy arrays (any object with the JAX package's BAData field names:
    quat, t, cam_dof, fx, fy, cx, cy, xyz, point_var, r_cam, r_pt, r_uv,
    r_valid, r_mag, r_scale, d_cam, d_pt, d_logtarget, d_valid, d_mag,
    d_scale): the observations are scattered into (C,P) grids on the host."""
    dev = resolve_device(device)
    r_cam = np.asarray(data.r_cam)
    r_pt = np.asarray(data.r_pt)
    valid = np.asarray(data.r_valid) > 0
    uv = np.zeros((C, P, 2), np.float32)
    r_w = np.zeros((C, P), np.float32)
    r_scale = np.ones((C, P), np.float32)
    uv[r_cam[valid], r_pt[valid]] = np.asarray(data.r_uv)[valid]
    r_w[r_cam[valid], r_pt[valid]] = np.asarray(data.r_mag)[valid]
    r_scale[r_cam[valid], r_pt[valid]] = np.asarray(data.r_scale)[valid]

    d_cam = np.asarray(data.d_cam)
    d_pt = np.asarray(data.d_pt)
    dvalid = np.asarray(data.d_valid) > 0
    d_logt = np.zeros((C, P), np.float32)
    d_w = np.zeros((C, P), np.float32)
    d_scale = np.ones((C, P), np.float32)
    d_logt[d_cam[dvalid], d_pt[dvalid]] = np.asarray(data.d_logtarget)[dvalid]
    d_w[d_cam[dvalid], d_pt[dvalid]] = np.asarray(data.d_mag)[dvalid]
    d_scale[d_cam[dvalid], d_pt[dvalid]] = np.asarray(data.d_scale)[dvalid]

    def dv(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return DenseBAData(
        quat=dv(data.quat), t=dv(data.t), cam_dof=dv(data.cam_dof),
        fx=dv(data.fx), fy=dv(data.fy), cx=dv(data.cx), cy=dv(data.cy),
        xyz=dv(data.xyz), point_var=dv(data.point_var),
        uv_x=dv(uv[..., 0]), uv_y=dv(uv[..., 1]), r_w=dv(r_w), r_scale=dv(r_scale),
        d_logt=dv(d_logt), d_w=dv(d_w), d_scale=dv(d_scale),
    )
