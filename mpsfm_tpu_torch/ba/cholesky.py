"""Cholesky solve of the BA's reduced camera system (K1; counterpart of
mpsfm_tpu/ba/pallas_cholesky.py).

`cholesky_solve(S, rhs)` returns x = S⁻¹·rhs for one SPD (K,K) matrix,
read from its lower triangle, and rhs (K,) or (K,N). On a CUDA tensor a
(K,) rhs launches the hand-written kernel csrc/cholesky.cu (blocked
Cholesky with 32-wide panels + blocked triangular solves, one launch,
sm_90a; the dense BA's reduced solve) and a (K,N) rhs csrc/cholesky_many.cu
(the same factorization, L's 32×32 tiles packed with each diagonal block
inverted, then register-tiled blocked substitutions over tiles of 64
columns; the point covariances' reduced solve). The factorization takes
one of two routes by K (`route`): below GRID_MIN_K one block of 256
threads (`chol_solve_kernel`), at and above it one cooperative launch
over every SM (`chol_grid_kernel`: panels split by rows over the CTAs,
the trailing update in 64×64 tiles dealt to them, a grid barrier after
each). Both factor with the same arithmetic in the same order (the same
L bit for bit); the grid route's backward substitution sums in another
order. On a CPU tensor
either runs `cholesky_solve_plain`, the same blocked order in torch. There
is no fallback: a CUDA tensor reaches its route's kernel or the call
raises, and a refused cooperative launch is not retried on one block.
KERNEL.launches, KERNEL_GRID.launches and KERNEL_MANY.launches count the
launches of the one-block solve, the grid solve and the many-rhs solve.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.kernels import I, P, Kernel, Launches, stream_ptr

MAX_K = 4096  # CHOL_MAX_K of csrc/cholesky.cu (shared-memory vector)
NB = 32  # panel width (CHOL_NB of csrc/cholesky.cu)
# The crossover of the two routes: the smallest K that takes the grid route. chip_smoke.k1_crossover in two
# calls on H100 80GB HBM3 at 700 W, min-max of 6 turns a route, one block / grid, in ms: K = 96 0.0497-0.0513 /
# 0.0402-0.0408 and 0.0496-0.0510 / 0.0382-0.0641 (host-bound: the grid's turns spread across the one
# block's); 192 0.1025-0.1049 / 0.0711-0.0721 and 0.1023-0.1035 / 0.0677-0.0695; 384 0.287-0.290 / 0.134-0.139;
# 1024 2.89-2.91 / 0.348-0.370. From 192 the grid route won every turn of both calls; below it (K = 48 in the
# pipeline and the dense modes, 96 in the mapping) one block.
GRID_MIN_K = 192

KERNEL = Kernel("cholesky", "cholesky.cu", {"chol_solve_f32": [P, P, P, P, I, P],
                                            "chol_solve_grid_f32": [P, P, P, P, P, I, P]})
KERNEL_GRID = Launches("cholesky_grid")  # chol_grid_kernel, in KERNEL's library
KERNEL_MANY = Kernel("cholesky_many", "cholesky_many.cu", {"chol_solve_many_f32": [P, P, P, P, I, I, P, P]})


def route(K: int) -> str:
    """The factorization's route at K: "grid" (the cooperative launch over
    every SM) from GRID_MIN_K on, else "block" (one block)."""
    return "grid" if K >= GRID_MIN_K else "block"


def grid_ld(K: int) -> int:
    """The grid route's row stride of U: K rounded up to 4 floats (grid_ld of csrc/cholesky.cu)."""
    return -(-K // 4) * 4


def work_floats(K: int, many: bool, grid: bool) -> int:
    """Floats of the kernels' workspace at K. One rhs: U = Lᵀ (K×K), or on
    the grid route U with rows grid_ld(K) apart, then y and 1/L[j][j]. Many
    right-hand sides: the packed 32×32 tiles of L's lower triangle in two
    layouts (F, G), then U (K×K), or on the grid route U as above and
    1/L[j][j]."""
    ld = grid_ld(K)
    u = (K * ld + (1 if many else 2) * ld) if grid else K * K
    if not many:
        return u
    nblk = -(-K // NB)
    return 2 * nblk * (nblk + 1) // 2 * NB * NB + u


def _solve_lower(L: torch.Tensor, b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """L⁻¹·b (or L⁻ᵀ·b) for a small lower-triangular block L and b (n,) or (n,m)."""
    A = L.T if transpose else L
    B = b[:, None] if b.dim() == 1 else b
    x = torch.linalg.solve_triangular(A, B, upper=transpose)
    return x[:, 0] if b.dim() == 1 else x


def cholesky_factor_plain(S: torch.Tensor) -> torch.Tensor:
    """The kernel's factorization in torch: right-looking blocked Cholesky
    of the lower triangle with NB-wide panels (the last one ragged) — per
    panel the diagonal block column by column with d = sqrt(max(djj,
    1e-20)), the panel's triangular solve L₂₁ = A₂₁·L₁₁⁻ᵀ and the trailing
    update A₂₂ −= L₂₁·L₂₁ᵀ. Returns a (K,K) matrix whose lower triangle is
    L (its strict upper triangle is not read)."""
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
    return A


def cholesky_solve_plain(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in torch: cholesky_factor_plain, then blocked
    forward and backward substitution. (The kernel runs each block of the
    forward substitution inside the panel loop; every block of y gets the
    same updates in the same order either way.)"""
    K = S.shape[0]
    A = cholesky_factor_plain(S)
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


def solve_on_route(S: torch.Tensor, rhs: torch.Tensor, grid: bool) -> torch.Tensor:
    """The kernels on CUDA tensors S (K,K) and rhs (K,) or (K,N), both
    contiguous float32, with the factorization on the given route:
    `cholesky_solve` passes route(K); chip_smoke.py times both routes with it
    to place GRID_MIN_K."""
    K = S.shape[0]
    many = rhs.dim() == 2
    work = torch.empty(work_floats(K, many, grid), dtype=S.dtype, device=S.device)
    # the grid barrier's counter, then the backward substitution's 64-bit hand-off words (one per row of x)
    bar = torch.zeros(2 + 64 * -(-K // NB), dtype=torch.int32, device=S.device) if grid else None
    x = torch.empty_like(rhs)
    if many:
        if rhs.shape[1] > 0:
            KERNEL_MANY.call("chol_solve_many_f32", S.data_ptr(), rhs.data_ptr(), work.data_ptr(), x.data_ptr(),
                             K, rhs.shape[1], bar.data_ptr() if grid else None, stream_ptr(S))
            KERNEL_MANY.launches += 1
    elif grid:
        KERNEL.call("chol_solve_grid_f32", S.data_ptr(), rhs.data_ptr(), work.data_ptr(), bar.data_ptr(),
                    x.data_ptr(), K, stream_ptr(S))
        KERNEL_GRID.launches += 1
    else:
        KERNEL.call("chol_solve_f32", S.data_ptr(), rhs.data_ptr(), work.data_ptr(), x.data_ptr(), K, stream_ptr(S))
        KERNEL.launches += 1
    return x


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
    return solve_on_route(S.contiguous(), rhs.contiguous(), route(K) == "grid")
