"""Deflated Jacobi-PCG of indicator right-hand sides: diag(H⁻¹) of the
BiNI operator at query pixels (K3, a kernel of the port with no TPU
counterpart: the JAX package runs this solve, `_diag_inverse_at_impl` at
mpsfm_tpu/integration/bini.py:592-664, as XLA ops in a scan over chunks of
128 queries).

For each lane b and query pixel q, with the operator H of the IRLS
weights at z (edge form, bini_fused.Stencil), e_q the indicator of q,
M⁻¹ = 1/clip(diag H, 1e-5), the deflation basis Z = {1, x, y} over
linspace(-1, 1) axes, HZ = H·Z and E⁻¹ = inv(ZᵀHZ + 1e-10·tr·I):

    x = Z·E⁻¹·Zᵀe_q,  r = e_q − H·x,  z = P(M⁻¹ r),  p = z
    repeat cg_max_iter times (no tolerance test):
        α = rᵀz / pᵀHp;  x += α p;  r −= α H p
        z = P(M⁻¹ r);  β = rᵀz_new / rᵀz_old;  p = z + β p
    var = x[q],  with P(V) = V − Z·E⁻¹·(HZ)ᵀV

(guards: a divisor below 1e-30 in magnitude becomes 1e-30). The set-up
(`deflation`) is torch for both routes; `deflated_pcg` runs the iterations
on the kernel csrc/bini_diag.cu for CUDA tensors (one thread-block cluster
of C CTAs per lane and group of R right-hand sides, C and R from `plan`,
p and r of a band in the CTA's shared memory or, where a band does not fit
it, in a global workspace; one launch per call; KERNEL.launches counts the
launches) and on
`deflated_pcg_plain` for CPU tensors, never one for the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from mpsfm_tpu_torch.integration.bini_fused import Stencil, _guard, _sum2, matvec
from mpsfm_tpu_torch.kernels import I, P, Kernel, stream_ptr

KERNEL = Kernel("bini_diag", "bini_diag.cu", {
    "bini_diag_pcg": [P] * 12 + [I] * 9 + [P],
    "bini_diag_active_clusters": [I] * 5 + [P],
})

# constants of csrc/bini_diag.cu (tests/test_torch_diag_inverse.py reads them
# there): CTA threads, the most right-hand sides a cluster and CTAs a
# cluster (the portable cluster size), and a CTA's shared memory
THREADS = 512
R_MAX = 8
C_MAX = 8
SMEM_BYTES = 232448


class Plan(NamedTuple):
    """K3's launch shape for one grid: clusters of C CTAs, each CTA a band
    of bh rows, R right-hand sides a cluster, smem bytes a CTA, and
    whether p and r of a band live in global memory (gmem) rather than in
    the CTA's shared memory."""

    C: int
    R: int
    bh: int
    smem: int
    gmem: bool = False


def smem_bytes(H: int, W: int, C: int, R: int, gmem: bool = False) -> int:
    """Shared memory of one CTA: p and r of its band for R right-hand
    sides (none in global mode), and two parities of (warp partials, the
    CTA's partial, the cluster's sum) of 3R sums."""
    bh = -(-H // C)
    return 4 * ((0 if gmem else 2 * R * bh * W) + 2 * (THREADS // 32 + 2) * 3 * R)


def plan(H: int, W: int) -> Plan:
    """C and R for an H×W grid: R is the most right-hand sides whose bands
    fit a CTA (at most R_MAX), and C the smallest power of two ≤ C_MAX
    that reaches it. The bands of 145×193 (the main path) take C = 8,
    R = 7; 387×387 takes C = 8, R = 1. Where C = 8, R = 1 does not fit (a
    band of more than 29 002 pixels) the bands go to global memory:
    C = 8, R = R_MAX, gmem."""
    fits = {C: max((R for R in range(1, R_MAX + 1) if smem_bytes(H, W, C, R) <= SMEM_BYTES), default=0)
            for C in (1, 2, 4, 8)}
    R = fits[C_MAX]
    if R == 0:
        return Plan(C_MAX, R_MAX, -(-H // C_MAX), smem_bytes(H, W, C_MAX, R_MAX, gmem=True), gmem=True)
    C = min(c for c, r in fits.items() if r == R)
    return Plan(C, R, -(-H // C), smem_bytes(H, W, C, R))


def workspace(pl: Plan, W: int, groups: int, active: int) -> tuple[int, int]:
    """(clusters launched, floats of the global workspace) for `groups`
    groups of R right-hand sides, `active` clusters co-resident. Global
    mode: min(groups, active) clusters loop over the groups, each CTA with
    its slice of 2·R·bh·W floats (p and r of its band). Shared-memory
    mode: one cluster a group, no workspace."""
    if not pl.gmem:
        return groups, 0
    slots = min(groups, active)
    return slots, slots * pl.C * 2 * pl.R * pl.bh * W


def pad_queries(rows, cols, R: int):
    """rows, cols (B,K) padded with pixel (0, 0) to a multiple of R queries
    (the kernel's groups); the padded queries' outputs are dropped."""
    pad = -rows.shape[1] % R
    if pad == 0:
        return rows, cols
    zeros = rows.new_zeros((rows.shape[0], pad))
    return torch.cat([rows, zeros], 1), torch.cat([cols, zeros.to(cols.dtype)], 1)


def active_clusters(H: int, W: int, device=None, pl: Plan | None = None) -> int:
    """How many clusters of `pl` (plan(H, W) by default) the card holds at
    once (cudaOccupancyMaxActiveClusters)."""
    pl = plan(H, W) if pl is None else pl
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        KERNEL.call("bini_diag_active_clusters", H, W, pl.C, pl.R, int(pl.gmem), ctypes.addressof(out))
    return out.value


class Deflation(NamedTuple):
    """What every right-hand side of a lane shares."""

    minv: torch.Tensor  # (B,H,W) Jacobi M⁻¹
    lin_x: torch.Tensor  # (W,) x axis of Z
    lin_y: torch.Tensor  # (H,) y axis of Z
    hz: torch.Tensor  # (B,3,H,W) H·Z
    einv: torch.Tensor  # (B,3,3) E⁻¹


def linspace_f32(n: int, device=None) -> torch.Tensor:
    """linspace(-1, 1, n) in float32, rounded as the JAX package's jitted
    jnp.linspace is: step = iota · (1/(n−1)) (XLA turns the division by a
    constant into a product), −1·(1 − step) + 1·step, and the last entry
    exactly 1. torch.linspace differs from it in the last bit in most
    entries."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=torch.float32, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * float(np.float32(1.0) / np.float32(n - 1))
    out = -1.0 * (1.0 - step) + step
    return torch.cat([out, torch.ones(1, dtype=torch.float32, device=device)])


def basis(lin_x, lin_y) -> torch.Tensor:
    """Z (3,H,W): the constant, x and y ramps."""
    H, W = lin_y.shape[0], lin_x.shape[0]
    one = torch.ones((H, W), dtype=lin_x.dtype, device=lin_x.device)
    return torch.stack([one, one * lin_x[None, :], lin_y[:, None] * one])


def deflation(st: Stencil, dg) -> Deflation:
    """The per-lane set-up of the deflated PCG from the operator (B,H,W)
    and its diagonal."""
    _, H, W = dg.shape
    lin_x, lin_y = linspace_f32(W, dg.device), linspace_f32(H, dg.device)
    Z = basis(lin_x, lin_y)
    hz = matvec(Stencil(*(f[:, None] for f in st)), Z[None])  # (B,3,H,W)
    E = torch.einsum("mhw,bnhw->bmn", Z, hz)
    tr = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    # a lane whose operator is 0 (no weight anywhere) gives a non-finite E⁻¹, as jnp.linalg.inv does;
    # torch.linalg.inv would raise for the whole batch
    einv = torch.linalg.inv_ex(E + 1e-10 * tr[:, None, None] * torch.eye(3, dtype=E.dtype, device=E.device))[0]
    return Deflation(1.0 / torch.clamp(dg, min=1e-5), lin_x, lin_y, hz, einv)


def project(dfl: Deflation, Z, V):
    """V − Z·E⁻¹·(HZ)ᵀV for V (B,K,H,W): removes the Z components of a
    preconditioned residual (keeps the search directions H-orthogonal to
    the deflation space)."""
    g = torch.einsum("bmhw,bkhw->bkm", dfl.hz, V)
    return V - torch.einsum("bkm,mhw->bkhw", g @ dfl.einv, Z)


def deflated_pcg_plain(st: Stencil, dfl: Deflation, rows, cols, iters: int, chunk: int = 128):
    """x[q] of the deflated PCG for rows/cols (B,K) query pixels, in chunks
    of `chunk` queries (a memory bound only: the right-hand sides are
    independent). Returns (B,K)."""
    Bn, K = rows.shape
    _, H, W = dfl.minv.shape
    Z = basis(dfl.lin_x, dfl.lin_y)
    stc = Stencil(*(f[:, None] for f in st))
    minv = dfl.minv[:, None]
    out = torch.empty((Bn, K), dtype=dfl.minv.dtype, device=dfl.minv.device)
    for k0 in range(0, K, chunk):
        r, c = rows[:, k0:k0 + chunk].long(), cols[:, k0:k0 + chunk].long()
        n = r.shape[1]
        bi = torch.arange(Bn, device=r.device)[:, None].expand(Bn, n)
        ki = torch.arange(n, device=r.device)[None, :].expand(Bn, n)
        e = torch.zeros((Bn, n, H, W), dtype=out.dtype, device=out.device)
        e[bi, ki, r, c] = 1.0
        coef = Z[:, r, c].permute(1, 2, 0) @ dfl.einv  # (Zᵀe)·E⁻¹, (B,n,3)
        x = torch.einsum("bkm,mhw->bkhw", coef, Z)
        res = e - matvec(stc, x)
        zv = project(dfl, Z, minv * res)
        pv = zv
        rz = _sum2(res * zv)
        for _ in range(iters):
            Ap = matvec(stc, pv)
            alpha = rz / _guard(_sum2(pv * Ap))
            x = x + alpha[..., None, None] * pv
            res = res - alpha[..., None, None] * Ap
            zv = project(dfl, Z, minv * res)
            rz_new = _sum2(res * zv)
            beta = rz_new / _guard(rz)
            pv = zv + beta[..., None, None] * pv
            rz = rz_new
        out[:, k0:k0 + n] = x[bi, ki, r, c]
    return out


def _pcg_cuda(st: Stencil, dfl: Deflation, rows, cols, iters: int, pl: Plan | None = None):
    """The kernel's x[q] (B,K), with plan(H, W) or, in the tests only, the
    launch shape `pl`."""
    Bn, H, W = dfl.minv.shape
    maps = (st.ex, st.ey, st.pa, dfl.minv)
    for t in (*maps, dfl.hz, dfl.einv, dfl.lin_x, dfl.lin_y):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError("bini_diag kernel: float32 CUDA tensors expected")
    if any(t.shape != (Bn, H, W) for t in maps) or dfl.hz.shape != (Bn, 3, H, W) or dfl.einv.shape != (Bn, 3, 3):
        raise ValueError("bini_diag kernel: maps (B,H,W), hz (B,3,H,W) and einv (B,3,3) expected")
    if rows.shape != cols.shape or rows.dim() != 2 or rows.shape[0] != Bn or not rows.is_cuda or not cols.is_cuda:
        raise ValueError("bini_diag kernel: rows and cols (B,K) on the card expected")
    pl = plan(H, W) if pl is None else pl
    Kq = rows.shape[1]
    if Bn * Kq == 0:
        return torch.empty((Bn, Kq), dtype=torch.float32, device=rows.device)
    rows, cols = pad_queries(rows, cols, pl.R)
    groups = Bn * rows.shape[1] // pl.R
    slots, ws_floats = workspace(pl, W, groups, active_clusters(H, W, rows.device, pl) if pl.gmem else 0)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=rows.device)
    out = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)
    ex, ey, pa, minv, hz, einv, lx, ly = (t.contiguous() for t in (*maps, dfl.hz, dfl.einv, dfl.lin_x, dfl.lin_y))
    r32, c32 = (t.to(torch.int32).contiguous() for t in (rows, cols))
    with torch.cuda.device(out.device):
        KERNEL.call(
            "bini_diag_pcg", ex.data_ptr(), ey.data_ptr(), pa.data_ptr(), minv.data_ptr(), hz.data_ptr(),
            einv.data_ptr(), lx.data_ptr(), ly.data_ptr(), r32.data_ptr(), c32.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws_floats else None, iters, Bn, H, W, rows.shape[1], pl.C, pl.R, int(pl.gmem), slots,
            stream_ptr(out),
        )
    KERNEL.launches += 1
    return out[:, :Kq]


def deflated_pcg(st: Stencil, dfl: Deflation, rows, cols, iters: int, chunk: int = 128):
    """The deflated PCG's x[q] (B,K): the kernel for CUDA tensors,
    deflated_pcg_plain (in chunks of `chunk` queries) for CPU ones."""
    if dfl.minv.device.type == "cpu":
        return deflated_pcg_plain(st, dfl, rows, cols, iters, chunk)
    return _pcg_cuda(st, dfl, rows, cols, iters)
