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

On the card a PCG solve is one launch of a persistent kernel per group of
lanes (plan_groups): every iteration runs inside it, and the host reads
nothing until it returns. KERNEL.launches counts those launches (one per
pcg() call while the batch fits the card as one group; bini_solve_fused
launches one per IRLS round and group).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from mpsfm_tpu_torch.kernels import F, I, P, Kernel, stream_ptr

KERNEL = Kernel(
    "bini",
    "bini.cu",
    {
        "bini_setup": [P] * 9 + [F] + [P] * 6 + [I] * 4 + [P],
        "bini_pcg_capacity": [I, I, ctypes.POINTER(ctypes.c_int)],
        "bini_pcg": [P] * 13 + [I, F] + [I] * 6 + [P],
    },
)

# constants of csrc/bini.cu (_capacity checks the PCG's three against the library)
THREADS = 256  # setup kernels
PCG_THREADS = 512  # threads per CTA of the persistent PCG
PPT_CAP = 14  # pixels a PCG thread owns at most (main path: 14 at 8 × 290×387)
NPART = 4  # partial sums per CTA
PALLAS_CG_CAP = 500  # bini_pallas.py clamps the fused kernel's CG budget


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
    """Blocks per lane of the setup kernels: ~4 pixels per thread."""
    return max(1, min(1024, -(-H * W // (THREADS * 4))))


class LaneGroup(NamedTuple):
    """Lanes [lane0, lane0 + lanes) solved by one persistent PCG launch."""

    lane0: int
    lanes: int
    cpl: int  # CTAs per lane
    ppt: int  # pixels per thread


def plan_groups(B: int, n_pix: int, max_ctas: int) -> list[LaneGroup]:
    """Split B lanes of n_pix pixels into groups whose CTAs are all resident
    at once (at most max_ctas), each lane on whole CTAs of PCG_THREADS
    threads owning at most PPT_CAP pixels each. Groups are as few and as
    even as possible; within a group each lane is spread over as many CTAs
    as fit. Raises ValueError when one lane alone does not fit."""
    cpl_min = -(-n_pix // (PCG_THREADS * PPT_CAP))
    if cpl_min > max_ctas:
        raise ValueError(f"bini PCG: an image of {n_pix} pixels needs {cpl_min} co-resident CTAs; "
                         f"the card holds {max_ctas}")
    n_groups = -(-B // (max_ctas // cpl_min)) if B else 0
    groups, lane0 = [], 0
    for g in range(n_groups):
        lanes = (B - lane0) // (n_groups - g)
        ppt = -(-n_pix // (max_ctas // lanes * PCG_THREADS))
        groups.append(LaneGroup(lane0, lanes, -(-n_pix // (ppt * PCG_THREADS)), ppt))
        lane0 += lanes
    return groups


@functools.lru_cache(maxsize=None)
def _capacity(dev: int, W: int) -> int:
    """CTAs of the PCG kernel that card `dev` holds at once for images W
    wide (the planner's only question to the card; tests substitute it).
    Raises when this module's copy of the kernel's layout is not the
    library's."""
    out = (ctypes.c_int * 4)()
    KERNEL.call("bini_pcg_capacity", dev, W, out)
    layout = (PCG_THREADS, PPT_CAP, NPART)
    if tuple(out[1:]) != layout:
        raise RuntimeError(f"bini.cu's PCG layout (threads, pixel cap, partials) {tuple(out[1:])} "
                           f"is not bini_fused.py's {layout}")
    return out[0]


def _check_maps(*ts):
    shape = ts[0].shape
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.shape != shape or t.dim() != 3:
            raise ValueError("bini kernel: (B,H,W) float32 CUDA tensors of one shape expected")


def _pcg_cuda(st: Stencil, b, dg, x0, max_iter: int, tol: float, active):
    """One persistent-kernel launch per lane group; no host read in between."""
    _check_maps(st.ex, st.ey, st.pa, b, dg, x0)
    Bn, H, W = x0.shape
    N = H * W
    dev = x0.device.index
    groups = plan_groups(Bn, N, _capacity(dev, W))
    ex, ey, pa, b, dg = (t.contiguous() for t in (st.ex, st.ey, st.pa, b, dg))
    x = x0.contiguous().clone()
    zg, p0, p1 = (torch.empty_like(x) for _ in range(3))
    act = active.to(device=x.device, dtype=torch.int32).contiguous()
    iters = torch.zeros(Bn, dtype=torch.int32, device=x.device)
    bar = torch.zeros(Bn, dtype=torch.int32, device=x.device)  # lane barrier counters
    s = stream_ptr(x)
    for g in groups:
        part = torch.empty((g.lanes, NPART, g.cpl), dtype=torch.float32, device=x.device)
        maps = (t.data_ptr() + 4 * g.lane0 * N for t in (ex, ey, pa, b, dg, x, zg, p0, p1))
        KERNEL.call(
            "bini_pcg", *maps, part.data_ptr(), *(t.data_ptr() + 4 * g.lane0 for t in (bar, act, iters)),
            max_iter, float(tol), g.lanes, H, W, g.cpl, g.ppt, dev, s,
        )
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
