"""Cholesky solve of the BA's reduced camera system (K1; counterpart of
mpsfm_tpu/ba/pallas_cholesky.py).

`cholesky_solve(S, rhs)` returns x = S⁻¹·rhs for one SPD (K,K) matrix.
On a CUDA tensor it launches the hand-written kernel csrc/cholesky.cu
(right-looking Cholesky + both triangular solves in one launch, sm_90a);
on a CPU tensor it runs `cholesky_solve_plain`, the same right-looking
algorithm step by step in torch. There is no fallback between the two:
a CUDA tensor reaches the kernel or the call raises.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.kernels import I, P, Kernel, stream_ptr

MAX_K = 4096  # CHOL_MAX_K of csrc/cholesky.cu (shared-memory vector)

KERNEL = Kernel("cholesky", "cholesky.cu", {"chol_solve_f32": [P, P, P, P, I, P]})


def cholesky_solve_plain(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Right-looking rank-1 Cholesky with d = sqrt(max(djj, 1e-20)), then
    forward and backward substitution — the kernel's algorithm in torch."""
    K = S.shape[0]
    A = S.clone()
    for j in range(K):
        d = torch.sqrt(torch.clamp(A[j, j], min=1e-20))
        A[j, j] = d
        l = A[j + 1:, j] / d
        A[j + 1:, j] = l
        A[j + 1:, j + 1:] -= torch.outer(l, l)
    y = rhs.clone()
    for j in range(K):
        y[j] = y[j] / A[j, j]
        y[j + 1:] -= y[j] * A[j + 1:, j]
    for j in range(K - 1, -1, -1):
        y[j] = y[j] / A[j, j]
        y[:j] -= y[j] * A[j, :j]
    return y


def cholesky_solve(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve S x = rhs for SPD S (K,K) f32; rhs (K,) f32."""
    if S.dim() != 2 or S.shape[0] != S.shape[1] or rhs.shape != (S.shape[0],):
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
    KERNEL.call("chol_solve_f32", S.data_ptr(), rhs.data_ptr(), work.data_ptr(), x.data_ptr(), K, stream_ptr(S))
    KERNEL.launches += 1
    return x
