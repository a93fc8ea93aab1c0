"""Batched absolute-pose (PnP) estimation primitives (port of
mpsfm_tpu/estimators/pnp.py).

Hypotheses come from a 6-point DLT with SO(3) projection and, for
coplanar points, from the plane -> image homography; refinement is a
fixed-iteration damped Gauss-Newton on the SE(3) tangent space over the
(weighted) inliers. The solvers are batched over leading dims.
"""

from __future__ import annotations

import math

import torch

from mpsfm_tpu_torch.geometry.linalg import det3, eigh, nullspace_vector, nullspace_vector_minimal, svd3x3
from mpsfm_tpu_torch.geometry.rotations import Rigid3d, apply_local_update, matrix_to_quat, quat_rotate


def _sign(cond):
    """-1 where cond, else 1 (float32)."""
    return torch.where(cond, -1.0, 1.0)


def _dlt_normalize(xyz, mask):
    """Centroid / scale world normalization for DLT conditioning.
    xyz (..., N, 3), mask (..., N) -> (normalized xyz, c (..., 3), s (...))."""
    w = mask.to(xyz.dtype)
    n = w.sum(-1).clamp_min(1.0)
    c = (xyz * w[..., None]).sum(-2) / n[..., None]
    d = torch.sqrt(((xyz - c[..., None, :]) ** 2).sum(-1)) * w
    s = math.sqrt(3.0) / (d.sum(-1) / n).clamp_min(1e-12)
    return (xyz - c[..., None, :]) * s[..., None, None], c, s


def _dlt_system(Xn, xy_norm):
    """The (..., 2N, 12) DLT system, each point's two rows adjacent (the
    leading n-1 rows must span the row space for the QR nullspace)."""
    X, Y, Z = Xn.unbind(-1)
    u, v = xy_norm.unbind(-1)
    o = torch.ones_like(X)
    z = torch.zeros_like(X)
    rows_a = torch.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u], dim=-1)
    rows_b = torch.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v], dim=-1)
    return torch.stack([rows_a, rows_b], dim=-2).flatten(-3, -2)


def _pose_from_P(P, Xn, mask, c, s):
    """[R|t] up to scale (..., 3, 4), in the normalized world frame ->
    cam_from_world in the original frame: sign fix, SO(3) projection, scale
    recovery, un-normalization."""
    depths = (Xn * P[..., None, 2, :3]).sum(-1) + P[..., None, 2, 3]
    P = P * _sign(torch.where(mask, depths, 0.0).sum(-1) < 0)[..., None, None]
    U, sv, Vt = svd3x3(P[..., :, :3])
    sign = _sign(det3(U @ Vt) < 0)
    R = U @ Vt * sign[..., None, None]
    sigma = sv.mean(-1) * sign
    sigma = torch.where(sigma.abs() < 1e-12, 1e-12, sigma)
    t = P[..., :, 3] / sigma[..., None]
    # x_cam = R (s (X - c)) + t = (sR) X + (t - s R c)
    t_w = t / s[..., None] - (R @ c[..., :, None])[..., 0]
    return Rigid3d(matrix_to_quat(R), t_w)


def pnp_from_six_points(xyz, xy_norm, mask=None, minimal: bool = False):
    """DLT-PnP: world points (..., N, 3), normalized image coords (..., N, 2),
    N >= 6. Degenerate for coplanar points (see pnp_from_plane). Returns
    cam_from_world."""
    if mask is None:
        mask = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
    Xn, c, s = _dlt_normalize(xyz, mask)
    A = _dlt_system(Xn, xy_norm)
    if minimal:
        P = nullspace_vector_minimal(A)
    else:
        P = nullspace_vector(A, torch.repeat_interleave(mask, 2, dim=-1).to(A.dtype))
    return _pose_from_P(P.unflatten(-1, (3, 4)), Xn, mask, c, s)


def pnp_from_plane(xyz, xy_norm):
    """Homography-based planar PnP for coplanar points (..., N, 3): fit the
    points' plane, DLT the in-plane -> image homography, decompose
    H = λ[r1 r2 | t] with SO(3) projection. Returns cam_from_world."""
    c = xyz.mean(-2)
    Xc = xyz - c[..., None, :]
    _, V = eigh(Xc.transpose(-1, -2) @ Xc)  # ascending: V[..., :, 0] = plane normal
    e2, e1 = V[..., :, 1], V[..., :, 2]
    nrm = torch.linalg.cross(e1, e2, dim=-1)  # a right-handed plane frame
    uv = Xc @ torch.stack([e1, e2], -1)  # (..., N, 2) in-plane coordinates
    s = math.sqrt(2.0) / torch.sqrt((uv**2).sum(-1)).mean(-1).clamp_min(1e-12)
    u, v = uv[..., 0] * s[..., None], uv[..., 1] * s[..., None]
    x, y = xy_norm.unbind(-1)
    o = torch.ones_like(u)
    z = torch.zeros_like(u)
    rows_a = torch.stack([u, v, o, z, z, z, -x * u, -x * v, -x], dim=-1)
    rows_b = torch.stack([z, z, z, u, v, o, -y * u, -y * v, -y], dim=-1)
    A = torch.stack([rows_a, rows_b], dim=-2).flatten(-3, -2)
    Hn = nullspace_vector_minimal(A).unflatten(-1, (3, 3))
    # undo the uv conditioning: H maps raw in-plane coords -> image
    H = Hn * torch.stack([s, s, torch.ones_like(s)], -1)[..., None, :]
    # cheirality: the sample's projective depths must be positive
    zi = H[..., None, 2, 0] * uv[..., 0] + H[..., None, 2, 1] * uv[..., 1] + H[..., None, 2, 2]
    H = H * _sign(zi.sum(-1) < 0)[..., None, None]
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = (0.5 * (torch.linalg.norm(h1, dim=-1) + torch.linalg.norm(h2, dim=-1))).clamp_min(1e-12)
    r1, r2 = h1 / lam[..., None], h2 / lam[..., None]
    M = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], -1)
    U, _, Vt = svd3x3(M)
    sgn = _sign(det3(U @ Vt) < 0)
    Vt = torch.cat([Vt[..., :2, :], Vt[..., 2:, :] * sgn[..., None, None]], -2)
    R_p = U @ Vt
    # x_cam = R_p [e1ᵀ; e2ᵀ; nᵀ](X - c) + h3/λ  ->  cam_from_world
    R_cw = R_p @ torch.stack([e1, e2, nrm], -2)
    t_cw = h3 / lam[..., None] - (R_cw @ c[..., :, None])[..., 0]
    return Rigid3d(matrix_to_quat(R_cw), t_cw)


def reprojection_residuals(pose: Rigid3d, xyz, xy_norm):
    """Residuals in the normalized image plane (..., N, 2)."""
    p_cam = quat_rotate(pose.quat, xyz) + pose.t
    z = p_cam[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    return p_cam[..., :2] / zs[..., None] - xy_norm


def _resid_jacobian(pose: Rigid3d, xyz, xy_norm):
    """Residuals (N, 2) and their Jacobian (N, 2, 6) with respect to the
    left-perturbation update (omega, dt) at zero: p = exp(ω) R X + t + dt, so
    dp/dω = -[R X]×, dp/ddt = I (the JAX package takes jacfwd of the same
    function)."""
    y = quat_rotate(pose.quat, xyz)
    p = y + pose.t
    z = p[..., 2]
    live = z.abs() >= 1e-9  # a clamped depth is a constant
    zs = torch.where(live, z, 1e-9)
    r = p[..., :2] / zs[..., None] - xy_norm
    zero = torch.zeros_like(z)
    inv = 1.0 / zs
    dz = torch.where(live, -inv * inv, 0.0)
    drdp = torch.stack([
        torch.stack([inv, zero, p[..., 0] * dz], -1),
        torch.stack([zero, inv, p[..., 1] * dz], -1),
    ], -2)  # (N, 2, 3)
    y0, y1, y2 = y.unbind(-1)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(*y.shape[:-1], 3, 3)
    dpdw = torch.stack([
        torch.stack([zero, y2, -y1], -1),
        torch.stack([-y2, zero, y0], -1),
        torch.stack([y1, -y0, zero], -1),
    ], -2)
    return r, drdp @ torch.cat([dpdw, eye], -1)


def refine_pose_gn(pose: Rigid3d, xyz, xy_norm, weights, iters: int = 10, damping: float = 1e-6):
    """Fixed-iteration damped Gauss-Newton pose refinement on SE(3) of one
    pose (quat (4,), t (3,)) over xyz (N, 3), xy_norm (N, 2) with weights
    (N,): a 0/1 inlier mask or robust weights. A step that is not finite is
    skipped."""
    wfull = torch.repeat_interleave(weights, 2)
    damp = damping * torch.eye(6, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        r, J = _resid_jacobian(pose, xyz, xy_norm)
        r, J = r.reshape(-1), J.reshape(-1, 6)
        Jw = J * wfull[:, None]
        delta = -torch.linalg.solve_ex(Jw.T @ J + damp, (Jw.T @ r)[:, None])[0][:, 0]
        delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
        pose = apply_local_update(pose, delta[:3], delta[3:])
    return pose
