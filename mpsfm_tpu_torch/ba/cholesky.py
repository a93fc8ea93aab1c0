"""Cholesky solve of the BA's reduced camera system (K1; counterpart of
mpsfm_tpu/ba/pallas_cholesky.py).

`cholesky_solve(S, rhs)` returns x = S⁻¹·rhs for one SPD (K,K) matrix,
read from its lower triangle, and rhs (K,) or (K,N). On a CUDA tensor a
(K,) rhs launches the hand-written kernel csrc/cholesky.cu (blocked
Cholesky with 32-wide panels + blocked triangular solves, one launch,
sm_90a; the dense BA's reduced solve) and a (K,N) rhs csrc/cholesky_many.cu
(the same factorization, then the substitutions over tiles of 32 columns;
the point covariances' reduced solve). On a CPU tensor either runs
`cholesky_solve_plain`, the same blocked order in torch. There is no
fallback between the two: a CUDA tensor reaches a kernel or the call
raises. KERNEL.launches and KERNEL_MANY.launches count the calls of each.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.kernels import I, P, Kernel, stream_ptr

MAX_K = 4096  # CHOL_MAX_K of csrc/cholesky.cu (shared-memory vector)
NB = 32  # panel width (CHOL_NB of csrc/cholesky.cu)

KERNEL = Kernel("cholesky", "cholesky.cu", {"chol_solve_f32": [P, P, P, P, I, P]})
KERNEL_MANY = Kernel("cholesky_many", "cholesky_many.cu", {"chol_solve_many_f32": [P, P, P, P, I, I, P]})


def _solve_lower(L: torch.Tensor, b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """L⁻¹·b (or L⁻ᵀ·b) for a small lower-triangular block L and b (n,) or (n,m)."""
    A = L.T if transpose else L
    B = b[:, None] if b.dim() == 1 else b
    x = torch.linalg.solve_triangular(A, B, upper=transpose)
    return x[:, 0] if b.dim() == 1 else x


def cholesky_solve_plain(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in torch: right-looking blocked Cholesky of
    the lower triangle with NB-wide panels (the last one ragged) — per
    panel the diagonal block column by column with d = sqrt(max(djj,
    1e-20)), the panel's triangular solve L₂₁ = A₂₁·L₁₁⁻ᵀ and the trailing
    update A₂₂ −= L₂₁·L₂₁ᵀ — then blocked forward and backward
    substitution. (The kernel runs each block of the forward substitution
    inside the panel loop; every block of y gets the same updates in the
    same order either way.)"""
    K = S.shape[0]
    A = torch.tril(S)
    for c0 in range(0, K, NB):
        c1 = min(c0 + NB, K)
        D = A[c0:c1, c0:c1]
        for j in range(c1 - c0):
            d = torch.sqrt(torch.clamp(D[j, j], min=1e-20))
            D[j, j] = d
            l = D[j + 1:, j] / d
            D[j + 1:, j] = l
            D[j + 1:, j + 1:] -= torch.outer(l, l)
        L11 = torch.tril(D)
        A[c0:c1, c0:c1] = L11
        if c1 < K:
            L21 = _solve_lower(L11, A[c1:, c0:c1].T).T
            A[c1:, c0:c1] = L21
            A[c1:, c1:] -= L21 @ L21.T  # only the lower triangle is read again
    y = rhs.clone()
    for c0 in range(0, K, NB):
        c1 = min(c0 + NB, K)
        y[c0:c1] = _solve_lower(A[c0:c1, c0:c1], y[c0:c1])
        y[c1:] -= A[c1:, c0:c1] @ y[c0:c1]
    for c0 in reversed(range(0, K, NB)):
        c1 = min(c0 + NB, K)
        y[c0:c1] -= A[c1:, c0:c1].T @ y[c1:]
        y[c0:c1] = _solve_lower(A[c0:c1, c0:c1], y[c0:c1], transpose=True)
    return y


def cholesky_solve(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve S x = rhs for SPD S (K,K) f32; rhs (K,) or (K,N) f32."""
    if S.dim() != 2 or S.shape[0] != S.shape[1] or rhs.dim() not in (1, 2) or rhs.shape[0] != S.shape[0]:
        raise ValueError(f"cholesky_solve: S {tuple(S.shape)} and rhs {tuple(rhs.shape)} do not match")
    if S.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError("cholesky_solve: float32 only")
    if S.device != rhs.device:
        raise ValueError("cholesky_solve: S and rhs on different devices")
    if S.device.type == "cpu":
        return cholesky_solve_plain(S, rhs)
    if S.device.type != "cuda":
        raise ValueError(f"cholesky_solve: unsupported device {S.device}")
    K = S.shape[0]
    if K > MAX_K:
        raise ValueError(f"cholesky_solve: K={K} exceeds the kernel's {MAX_K}")
    S = S.contiguous()
    rhs = rhs.contiguous()
    work = torch.empty_like(S)
    x = torch.empty_like(rhs)
    if rhs.dim() == 1:
        KERNEL.call("chol_solve_f32", S.data_ptr(), rhs.data_ptr(), work.data_ptr(), x.data_ptr(), K, stream_ptr(S))
        KERNEL.launches += 1
    elif rhs.shape[1] > 0:
        KERNEL_MANY.call("chol_solve_many_f32", S.data_ptr(), rhs.data_ptr(), work.data_ptr(), x.data_ptr(),
                         K, rhs.shape[1], stream_ptr(S))
        KERNEL_MANY.launches += 1
    return x
