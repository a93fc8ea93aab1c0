"""Schur-based per-point 3x3 covariances (port of mpsfm_tpu/ba/covariance.py).

With H = [[Hcc, W], [Wᵀ, Hpp]] from the trivial-loss reprojection system,
the point block of H⁻¹ is

    cov_p = B_p⁻¹ + B_p⁻¹ T_pᵀ S⁻¹ T_p B_p⁻¹,

with B_p = Hpp_p (3x3), T_p the stacked camera-point coupling column of
point p and S = Hcc − Σ_p T_p B_p⁻¹ T_pᵀ the reduced camera system
(6C × 6C). S_red is one plain matrix product (TF32 off, as everywhere in
the port); S + 1e-8·I is factored once and solved for all 3P right-hand
sides through ba/cholesky.cholesky_solve, i.e. K1 with many right-hand
sides on the card. Gauge: frozen camera dims (cam_dof 0) get identity
rows, as in the BA.

The host wrapper `calculate_point_covs` (which stores the covariances
into a reconstruction) is not ported: it needs the scene state.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.ba.cholesky import cholesky_solve
from mpsfm_tpu_torch.ba.solver import BAData, _assemble, _cam_reduce_last, _seg_reduce_last, inv3x3


def point_covariances(data: BAData):
    """(P,3,3) covariances of all (padded) points. T comes from the
    per-(point, camera) slot table when the problem has one (a gather),
    else from a scatter-add of the observation rows."""
    C = data.quat.shape[0]
    P = data.xyz.shape[0]
    dtype, dev = data.xyz.dtype, data.xyz.device

    asm = _assemble(data, data.quat, data.t, data.xyz, losses.TRIVIAL, losses.TRIVIAL)
    J_r, w_r = asm["J_r"], asm["w_r"]  # (2,9,No), (No,)
    Jc, Jp = J_r[:, :6], J_r[:, 6:]

    hcc_rows = torch.einsum("rin,rjn->ijn", Jc * w_r, Jc)  # (6,6,No)
    Hcc_blocks = _cam_reduce_last(hcc_rows, C).permute(2, 0, 1)  # (C,6,6)
    prow = torch.einsum("rin,rjn->ijn", Jp * w_r, Jp)  # (3,3,No)
    Hpp = _seg_reduce_last(prow, data.r_pt_slots, data.r_pt_slot_mask).permute(2, 0, 1)  # (P,3,3)
    W_rows = torch.einsum("rin,rjn->nij", Jc * w_r, Jp)  # (No,6,3)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hcc_blocks = Hcc_blocks + (1.0 - data.cam_dof + 1e-6)[:, :, None] * eye6
    Binv = inv3x3(Hpp + ((1.0 - data.point_var)[:, None] + 1e-6)[:, :, None] * eye3)

    if data.pc_r_slot is not None:
        T = (W_rows.reshape(-1, 18)[data.pc_r_slot] * data.pc_r_mask[..., None]).reshape(P, 6 * C, 3)
    else:
        No = W_rows.shape[0]
        flat_rows = (data.r_cam[:, None] * 6 + torch.arange(6, device=dev)[None, :]).reshape(-1)
        flat_pt = data.r_pt.repeat_interleave(6)
        T = torch.zeros((P, 6 * C, 3), dtype=dtype, device=dev)
        T.index_put_((flat_pt, flat_rows), W_rows.reshape(No * 6, 3), accumulate=True)

    Hcc = torch.block_diag(*Hcc_blocks)
    TB = torch.einsum("pkj,pjl->pkl", T, Binv)  # (P,6C,3)
    rhs = TB.permute(1, 0, 2).reshape(6 * C, P * 3)
    S = Hcc - rhs @ T.permute(1, 0, 2).reshape(6 * C, P * 3).T
    X = cholesky_solve(S + 1e-8 * torch.eye(6 * C, dtype=dtype, device=dev), rhs)
    X = X.reshape(6 * C, P, 3).permute(1, 0, 2)
    return Binv + torch.einsum("pkl,pkm->plm", TB, X)
