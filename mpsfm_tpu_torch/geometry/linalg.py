"""Small-matrix linear algebra of the minimal solvers (port of
mpsfm_tpu/geometry/linalg.py).

The same formulations as the JAX package, on the library's batched
solvers: a nullspace vector of a tall A is the smallest eigenvector of AᵀA
polished by shifted inverse iteration; that of a minimal system the last
column of the complete QR of Aᵀ; the SVD of a 3×3 comes from eigh(MᵀM)
with a cross-product completion. Eigenvector and QR column signs are the
library's, so they may differ from the JAX package's: every caller is
sign-free or fixes the sign itself.
"""

from __future__ import annotations

import torch

# cuSOLVER's batched symmetric eigensolver refuses large batches: on an H100
# with CUDA 12.8, 16 384 3×3 or 4×4 matrices pass and 32 768 fail with
# CUSOLVER_STATUS_INVALID_VALUE. Larger batches go through in chunks.
EIGH_CHUNK = 16384


def eigh(S):
    """torch.linalg.eigh of symmetric S (..., n, n), ascending, for a batch of
    any size (in chunks of EIGH_CHUNK matrices)."""
    batch = S.shape[:-2]
    if batch.numel() <= EIGH_CHUNK:
        return torch.linalg.eigh(S)
    parts = [torch.linalg.eigh(c) for c in S.reshape(-1, *S.shape[-2:]).split(EIGH_CHUNK)]
    return torch.cat([w for w, _ in parts]).reshape(*batch, -1), torch.cat([v for _, v in parts]).reshape(S.shape)


def det3(M):
    """Determinant of 3×3 matrices (..., 3, 3), as (row0 × row1)·row2."""
    return (torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1) * M[..., 2, :]).sum(-1)


def smallest_eigvec(S):
    """Eigenvector of the smallest eigenvalue of symmetric S (..., n, n)."""
    _, v = eigh(S)  # ascending eigenvalues
    return v[..., :, 0]


def nullspace_vector(A, weights=None, polish_iters: int = 2):
    """Unit vector x minimizing ||diag(w) A x|| for tall A (..., m, n):
    eigh(AᵀA) and `polish_iters` shifted inverse-iteration steps."""
    if weights is not None:
        A = A * weights[..., :, None]
    AtA = A.transpose(-1, -2) @ A
    v = smallest_eigvec(AtA)
    n = AtA.shape[-1]
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    shifted = AtA + (1e-6 / n) * tr * torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    for _ in range(polish_iters):
        v = torch.linalg.solve_ex(shifted, v[..., None])[0][..., 0]  # a singular system gives non-finite values, as in JAX
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-30)
    return v


def nullspace_vector_minimal(A):
    """Exact-nullspace vector of a minimal system A (..., n-1, n): the last
    column of the complete QR of Aᵀ."""
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    return Q[..., :, -1]


def svd3x3(M, eps=1e-12):
    """SVD of a 3×3 (..., 3, 3) via eigh(MᵀM): (U, s, Vt), singular values
    descending, U's last column completed by a cross product so that it is
    well defined when s2 ≈ 0, and U, V proper rotations. The JAX package
    keeps eigh's V, whose determinant depends on the backend's eigenvector
    signs; where it is -1 there, its U Vᵀ is not M's rotation (ROADMAP.md,
    queue 3)."""
    G = M.transpose(-1, -2) @ M
    w, V = eigh(G)  # ascending
    w = w.flip(-1)
    V = V.flip(-1)
    # a proper V (last column flipped where det V < 0): with U's cross-product
    # column, U Vᵀ is then the rotation closest to M whatever sign eigh gives
    V = torch.cat([V[..., :2], V[..., 2:] * torch.sign(det3(V))[..., None, None]], -1)
    s = torch.sqrt(w.clamp_min(0.0))
    MV = M @ V
    u0 = MV[..., :, 0] / s[..., 0, None].clamp_min(eps)
    u1 = MV[..., :, 1] / s[..., 1, None].clamp_min(eps)
    u0 = u0 / torch.linalg.norm(u0, dim=-1, keepdim=True).clamp_min(eps)
    u1 = u1 - (u0 * u1).sum(-1, keepdim=True) * u0
    u1 = u1 / torch.linalg.norm(u1, dim=-1, keepdim=True).clamp_min(eps)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)
