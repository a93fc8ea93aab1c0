"""Batched homography estimation for the two-view classification, and the
host-side decomposition of a calibrated homography that registration's
planar init uses (port of mpsfm_tpu/estimators/homography.py).

The JAX package decomposes with OpenCV's decomposeHomographyMat (K = I);
the card's host has no OpenCV, so `decompose_homography_np` is the same
analytic Malis-Vargas decomposition written in numpy float64.
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch.estimators.essential import _normalize_points
from mpsfm_tpu_torch.geometry.linalg import nullspace_vector, nullspace_vector_minimal


def homography_from_four_points(xy1, xy2, mask=None, minimal: bool = False):
    """DLT homography from >= 4 correspondences xy (..., N, 2), normalized by
    H[2, 2]. minimal=True (exactly 4 points) takes the QR nullspace."""
    if mask is None:
        mask = torch.ones(xy1.shape[:-1], dtype=torch.bool, device=xy1.device)
    p1, T1 = _normalize_points(xy1, mask)
    p2, T2 = _normalize_points(xy2, mask)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], dim=-1)
    rows_b = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    if minimal:
        h = nullspace_vector_minimal(A)
    else:
        h = nullspace_vector(A, torch.cat([mask, mask], dim=-1).to(A.dtype))
    H = torch.linalg.inv_ex(T2)[0] @ h.unflatten(-1, (3, 3)) @ T1
    h22 = H[..., 2, 2]
    return H / torch.where(h22.abs() < 1e-12, 1e-12, h22)[..., None, None]


def homography_transfer_error_sq(H, xy1, xy2):
    """Squared forward transfer error |H p1 - p2|². H (..., 3, 3), xy (..., N, 2)."""
    ones = torch.ones_like(xy1[..., :1])
    q = torch.cat([xy1, ones], -1) @ H.transpose(-1, -2)
    w = torch.where(q[..., 2].abs() < 1e-12, 1e-12, q[..., 2])
    return ((q[..., :2] / w[..., None] - xy2) ** 2).sum(-1)


def _minor_opposite(S, row, col):
    """-(the 2×2 minor of S at (row, col))."""
    r = [i for i in range(3) if i != row]
    c = [j for j in range(3) if j != col]
    return S[r[0], c[1]] * S[r[1], c[0]] - S[r[0], c[0]] * S[r[1], c[1]]


def _sign_nonneg(x):
    return 1.0 if x >= 0 else -1.0


def _rotation_from(Hn, tstar, n, v):
    """R = Hn (I - (2/v) t* nᵀ), flipped to det +1."""
    R = Hn @ (np.eye(3) - (2.0 / v) * np.outer(tstar, n))
    return -R if np.linalg.det(R) < 0 else R


def decompose_homography_np(H):
    """Calibrated homography (normalized coords) -> candidate
    (R, t_unit, n) triples, host-side (init-time only): the analytic
    decomposition of Malis and Vargas ("Deeper understanding of the
    homography decomposition for vision-based control", INRIA RR-6303,
    2007), as OpenCV's decomposeHomographyMat computes it with K = I.
    H is scaled by its middle singular value; a rotation (HᵀH = I) gives
    one candidate with t = n = 0, else four: (Ra, ±ta, ±na) and
    (Rb, ±tb, ±nb). t is returned at unit norm."""
    Hn = np.asarray(H, np.float64)
    Hn = Hn / np.linalg.svd(Hn, compute_uv=False)[1]
    S = Hn.T @ Hn - np.eye(3)
    if np.abs(S).max() < 1e-3:
        return [(Hn, np.zeros(3), np.zeros(3))]
    M00, M11, M22 = (max(_minor_opposite(S, i, i), 0.0) for i in range(3))
    rt00, rt11, rt22 = np.sqrt(M00), np.sqrt(M11), np.sqrt(M22)
    e01, e02, e12 = (_sign_nonneg(_minor_opposite(S, i, j)) for i, j in ((0, 1), (0, 2), (1, 2)))
    # the candidate normals from the row of S with the largest |S_ii|
    i = int(np.argmax(np.abs(np.diag(S))))  # the first on ties, as OpenCV picks it
    if i == 0:
        npa = np.array([S[0, 0], S[0, 1] + rt22, S[0, 2] + e12 * rt11])
        npb = np.array([S[0, 0], S[0, 1] - rt22, S[0, 2] - e12 * rt11])
    elif i == 1:
        npa = np.array([S[0, 1] + rt22, S[1, 1], S[1, 2] - e02 * rt00])
        npb = np.array([S[0, 1] - rt22, S[1, 1], S[1, 2] + e02 * rt00])
    else:
        npa = np.array([S[0, 2] + e01 * rt11, S[1, 2] + rt00, S[2, 2]])
        npb = np.array([S[0, 2] - e01 * rt11, S[1, 2] - rt00, S[2, 2]])
    trace = float(np.trace(S))
    # OpenCV takes this square root in float32 (sqrtf)
    v = 2.0 * float(np.sqrt(np.float32(max(1.0 + trace - M00 - M11 - M22, 0.0))))
    r = np.sqrt(max(2.0 + trace + v, 0.0))
    n_t = np.sqrt(max(2.0 + trace - v, 0.0))
    na, nb = npa / np.linalg.norm(npa), npb / np.linalg.norm(npb)
    esr = _sign_nonneg(S[i, i]) * r
    ta_star = 0.5 * n_t * (esr * nb - n_t * na)
    tb_star = 0.5 * n_t * (esr * na - n_t * nb)
    out = []
    for tstar, n in ((ta_star, na), (tb_star, nb)):
        R = _rotation_from(Hn, tstar, n, v)
        t = R @ tstar
        nrm = np.linalg.norm(t)
        t = t / nrm if nrm > 1e-9 else t
        out += [(R, t, n), (R, -t, -n)]
    return out
