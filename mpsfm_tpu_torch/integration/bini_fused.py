"""BiNI stencil, Jacobi-PCG core and fixed-budget solve (K2; counterpart
of mpsfm_tpu/integration/bini_pallas.py).

The stencil is in edge form. The reference's masked one-sided
differences, D+ᵀ(a+ D+ v) + D-ᵀ(a- D- v) per axis, collapse to one weight
per edge between neighbouring pixels: ex(y,x) = a+(y,x)·c_x(y,x) +
a-(y,x+1)·c_x(y,x+1) for the edge (y,x)-(y,x+1), 0 on the last column (ey
likewise down the rows), so that

    (A v)(i) = pa(i)·v(i) + Σ_{edges i-j} e_ij·(v(i) − v(j)),
    b(i)     = hx(y,x−1) − hx(y,x) + hy(y−1,x) − hy(y,x) + pb(i),
    diag(i)  = pa(i) + ex(y,x−1) + ex(y,x) + ey(y−1,x) + ey(y,x),

with pa = λ1·prec_prior + λ2·prec_sparse, pb = λ1·prec_prior·z_prior +
λ2·prec_sparse·z_sparse and hx = −(a+·n_x + a-(x+1)·n_x(x+1)). No padding:
the boundary is handled by the edge weights, exactly as the reference's
`_masks` handle it (the TPU kernel padded to (8,128) tiles instead).

Two entry points run on the kernel csrc/bini.cu for CUDA tensors and on
their plain torch versions for CPU tensors, never one for the other:

  pcg(...)             batched Jacobi-PCG with a per-lane relative
                       tolerance and active flag — the core that the main
                       path's IRLS (bini._bini_solve_impl) runs;
  bini_solve_fused()   the fixed-budget solve of bini_solve_pallas: max_iter
                       IRLS rounds × min(cg_max_iter, 500) PCG iterations.

KERNEL.launches counts PCG solves launched on the card (one per pcg()
call; bini_solve_fused launches one per IRLS round).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from mpsfm_tpu_torch.kernels import F, I, P, Kernel, stream_ptr

KERNEL = Kernel(
    "bini",
    "bini.cu",
    {
        "bini_setup": [P] * 9 + [F] + [P] * 6 + [I] * 4 + [P],
        "bini_pcg_init": [P] * 11 + [I] * 4 + [P],
        "bini_pcg_iters": [P] * 14 + [I, I, F] + [I] * 4 + [P],
    },
)

THREADS = 256  # THREADS of csrc/bini.cu
PALLAS_CG_CAP = 500  # bini_pallas.py clamps the fused kernel's CG budget
CHUNK = 64  # PCG iterations between host checks for "every lane stopped"


# ---- stencil ----

def _dxp(z):  # forward difference in x; valid on cols [0, W-2]
    return Fn.pad(z[..., :, 1:] - z[..., :, :-1], (0, 1))


def _dxm(z):  # backward difference in x; valid on cols [1, W-1]
    return Fn.pad(z[..., :, 1:] - z[..., :, :-1], (1, 0))


def _dyp(z):
    return Fn.pad(z[..., 1:, :] - z[..., :-1, :], (0, 0, 0, 1))


def _dym(z):
    return Fn.pad(z[..., 1:, :] - z[..., :-1, :], (0, 0, 1, 0))


def weights(z, k):
    """Bilateral one-sided weights toward the smoother side."""
    wx = torch.sigmoid(k * (_dxm(z) ** 2 - _dxp(z) ** 2))
    wy = torch.sigmoid(k * (_dym(z) ** 2 - _dyp(z) ** 2))
    return wx, wy


class Stencil(NamedTuple):
    """One IRLS round's operator A, (...,H,W) each."""

    ex: torch.Tensor  # weight of edge (y,x)-(y,x+1); 0 on the last column
    ey: torch.Tensor  # weight of edge (y,x)-(y+1,x); 0 on the last row
    pa: torch.Tensor  # λ1·prec_prior + λ2·prec_sparse


def edges(cx, cy, nx, ny, px, py, pa, wx, wy):
    """(Stencil, hx, hy) for the weights wx, wy (hx, hy: rhs edge fluxes)."""
    apx = wx[..., :, :-1] * px[..., :, :-1] * cx[..., :, :-1]  # a+ at (y,x)
    amx = (1.0 - wx[..., :, 1:]) * px[..., :, 1:] * cx[..., :, 1:]  # a- at (y,x+1)
    ex = Fn.pad(apx * cx[..., :, :-1] + amx * cx[..., :, 1:], (0, 1))
    hx = Fn.pad(-(apx * nx[..., :, :-1] + amx * nx[..., :, 1:]), (0, 1))
    apy = wy[..., :-1, :] * py[..., :-1, :] * cy[..., :-1, :]
    amy = (1.0 - wy[..., 1:, :]) * py[..., 1:, :] * cy[..., 1:, :]
    ey = Fn.pad(apy * cy[..., :-1, :] + amy * cy[..., 1:, :], (0, 0, 0, 1))
    hy = Fn.pad(-(apy * ny[..., :-1, :] + amy * ny[..., 1:, :]), (0, 0, 0, 1))
    return Stencil(ex, ey, pa), hx, hy


def _prev_x(a):  # a(y, x-1), 0 at x = 0
    return Fn.pad(a[..., :, :-1], (1, 0))


def _prev_y(a):  # a(y-1, x), 0 at y = 0
    return Fn.pad(a[..., :-1, :], (0, 0, 1, 0))


def rhs(hx, hy, pb):
    return _prev_x(hx) - hx + _prev_y(hy) - hy + pb


def diag(st: Stencil):
    """Diagonal of A (Jacobi preconditioner)."""
    return st.pa + _prev_x(st.ex) + st.ex + _prev_y(st.ey) + st.ey


def matvec(st: Stencil, v):
    fx = st.ex * (Fn.pad(v[..., :, 1:], (0, 1)) - v)  # e·(v(x+1) − v(x)); 0 on the last column
    fy = st.ey * (Fn.pad(v[..., 1:, :], (0, 0, 0, 1)) - v)
    return st.pa * v + _prev_x(fx) - fx + _prev_y(fy) - fy


def _guard(v):
    return torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)


def _sum2(a):
    return a.sum((-2, -1))


def pcg_plain(st: Stencil, b, dg, x0, max_iter: int, tol: float, active):
    """Batched Jacobi-PCG on (B,H,W): lane l iterates while active[l] and
    ‖r‖ > tol·(‖b‖ + 1e-30) (no test when tol < 0), at most max_iter
    times; a stopped lane keeps its x. Returns (x, iterations (B,) int32)."""
    minv = 1.0 / torch.clamp(dg, min=1e-5)
    x = x0.clone()
    r = b - matvec(st, x0)
    zv = minv * r
    p = zv
    rz = _sum2(r * zv)
    bnorm = torch.sqrt(_sum2(b * b)) + 1e-30
    iters = torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)
    for _ in range(max_iter):
        live = active if tol < 0 else active & (torch.sqrt(_sum2(r * r)) > tol * bnorm)
        if tol >= 0 and not bool(live.any()):
            break
        Ap = matvec(st, p)
        alpha = rz / _guard(_sum2(p * Ap))
        lv = live[:, None, None]
        x = torch.where(lv, x + alpha[:, None, None] * p, x)
        r = torch.where(lv, r - alpha[:, None, None] * Ap, r)
        zv = minv * r
        rz_new = _sum2(r * zv)
        beta = rz_new / _guard(rz)
        p = torch.where(lv, zv + beta[:, None, None] * p, p)
        rz = torch.where(live, rz_new, rz)
        iters += live.to(torch.int32)
    return x, iters


# ---- the kernel ----

def _nbl(H: int, W: int) -> int:
    """Blocks per lane: ~4 pixels per thread, at most 1024 partials a lane."""
    return max(1, min(1024, -(-H * W // (THREADS * 4))))


def _check_maps(*ts):
    shape = ts[0].shape
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.shape != shape or t.dim() != 3:
            raise ValueError("bini kernel: (B,H,W) float32 CUDA tensors of one shape expected")


def _pcg_cuda(st: Stencil, b, dg, x0, max_iter: int, tol: float, active):
    _check_maps(st.ex, st.ey, st.pa, b, dg, x0)
    Bn, H, W = x0.shape
    nbl = _nbl(H, W)
    maps = [t.contiguous() for t in (st.ex, st.ey, st.pa, b, dg)]
    ex, ey, pa, b, dg = maps
    x = x0.contiguous().clone()
    r, zv, minv, p0, p1, ap = (torch.empty_like(x) for _ in range(6))
    part = torch.empty((6, Bn, nbl), dtype=torch.float32, device=x.device)
    act = active.to(device=x.device, dtype=torch.int32).contiguous()
    live = torch.ones(Bn, dtype=torch.int32, device=x.device)
    iters = torch.zeros(Bn, dtype=torch.int32, device=x.device)
    s = stream_ptr(x)
    KERNEL.call(
        "bini_pcg_init", ex.data_ptr(), ey.data_ptr(), pa.data_ptr(), b.data_ptr(), dg.data_ptr(),
        x.data_ptr(), r.data_ptr(), zv.data_ptr(), minv.data_ptr(), part.data_ptr(), act.data_ptr(),
        Bn, H, W, nbl, s,
    )
    step = max_iter if tol < 0 else CHUNK
    it = 0
    while it < max_iter:
        n = min(step, max_iter - it)
        KERNEL.call(
            "bini_pcg_iters", ex.data_ptr(), ey.data_ptr(), pa.data_ptr(), minv.data_ptr(),
            x.data_ptr(), r.data_ptr(), zv.data_ptr(), p0.data_ptr(), p1.data_ptr(), ap.data_ptr(),
            part.data_ptr(), act.data_ptr(), live.data_ptr(), iters.data_ptr(),
            it, n, float(tol), Bn, H, W, nbl, s,
        )
        it += n
        # every lane stopped before the last iteration: the rest are no-ops
        if it < max_iter and not bool(live.any()):
            break
    KERNEL.launches += 1
    return x, iters


def pcg(st: Stencil, b, dg, x0, max_iter: int, tol: float, active):
    """Jacobi-PCG core: the kernel for CUDA tensors, pcg_plain for CPU ones."""
    if x0.device.type == "cpu":
        return pcg_plain(st, b, dg, x0, max_iter, tol, active)
    return _pcg_cuda(st, b, dg, x0, max_iter, tol, active)


# ---- fixed-budget solve (bini_solve_pallas semantics) ----

def _anchor_terms(inp, p):
    pa = p.lambda1 * inp.prec_prior + p.lambda2 * inp.prec_sparse
    pb = p.lambda1 * inp.prec_prior * inp.z_prior + p.lambda2 * inp.prec_sparse * inp.z_sparse
    return pa, pb


def bini_solve_fused_plain(inp, p):
    """max_iter IRLS rounds × min(cg_max_iter, 500) PCG iterations, no
    tolerance and no energy abort. inp fields (B,H,W); returns z (B,H,W)."""
    pa, pb = _anchor_terms(inp, p)
    cg = min(p.cg_max_iter, PALLAS_CG_CAP)
    z = inp.z0
    active = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    for _ in range(p.max_iter):
        wx, wy = weights(z, p.k)
        st, hx, hy = edges(inp.c_x, inp.c_y, inp.nx, inp.ny, inp.prec_x, inp.prec_y, pa, wx, wy)
        z, _ = pcg_plain(st, rhs(hx, hy, pb), diag(st), z, cg, -1.0, active)
    return z


def _fused_cuda(inp, p):
    fields = [inp.z0, inp.c_x, inp.c_y, inp.nx, inp.ny, inp.prec_x, inp.prec_y]
    _check_maps(*fields)
    pa, pb = (t.contiguous() for t in _anchor_terms(inp, p))
    z0, cx, cy, nx, ny, px, py = (t.contiguous() for t in fields)
    Bn, H, W = z0.shape
    nbl = _nbl(H, W)
    ex, ey, hx, hy, b, dg = (torch.empty_like(z0) for _ in range(6))
    active = torch.ones(Bn, dtype=torch.bool, device=z0.device)
    cg = min(p.cg_max_iter, PALLAS_CG_CAP)
    z = z0
    for _ in range(p.max_iter):
        KERNEL.call(
            "bini_setup", z.data_ptr(), cx.data_ptr(), cy.data_ptr(), nx.data_ptr(), ny.data_ptr(),
            px.data_ptr(), py.data_ptr(), pa.data_ptr(), pb.data_ptr(), float(p.k),
            ex.data_ptr(), ey.data_ptr(), hx.data_ptr(), hy.data_ptr(), b.data_ptr(), dg.data_ptr(),
            Bn, H, W, nbl, stream_ptr(z),
        )
        z, _ = _pcg_cuda(Stencil(ex, ey, pa), b, dg, z, cg, -1.0, active)
    return z


def bini_solve_fused(inp, p):
    """Fixed-budget BiNI solve of a batch: the counterpart of
    bini_solve_pallas. inp: BiniInputs with (B,H,W) fields; returns z (B,H,W)."""
    if inp.z0.device.type == "cpu":
        return bini_solve_fused_plain(inp, p)
    return _fused_cuda(inp, p)
