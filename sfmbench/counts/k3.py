"""Kernel K3 (deflated Jacobi-PCG of diag(H⁻¹) at query pixels): the
operations and bytes one call needs, from its shapes. Operations: for each
right-hand side (B lanes × K queries), 33 a pixel an iteration (the
5-point operator, the Jacobi step, the deflation's projection and the
reductions) and 31 a pixel for the coarse start. Bytes: the maps (ex, ey,
pa, M⁻¹, and H·Z's three planes) read once, the queries and the diagonal
entries once, in 4-byte words."""

from __future__ import annotations


def flops(B, K, H, W, iters):
    return B * K * H * W * (33 * iters + 31)


def bytes_moved(B, K, H, W):
    return 4 * (7 * B * H * W + 9 * B + 3 * B * K)


TARGET = ("mpsfm_tpu_torch.integration.bini", "deflated_pcg")
KERNELS = {"float32": ("bini_diag_kernel",)}


def record(args, kwargs, out):
    _, dfl, rows, _, iters = args[:5]
    B, K = rows.shape
    H, W = dfl.minv.shape[-2:]
    return {"shape": (B, K, H, W, int(iters)), "precision": "float32"}


def least_s(rec, peaks):
    B, K, H, W, iters = rec["shape"]
    return peaks.least_s(flops(B, K, H, W, iters), bytes_moved(B, K, H, W), "float32")
