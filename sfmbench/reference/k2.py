"""Plain batched Jacobi-PCG, the benchmark's frozen reference of kernel K2
(the BiNI depth integration's linear solve of one IRLS round): for each
lane l with operator A (edge weights ex, ey and diagonal part pa),
right-hand side b, diagonal dg and start x0, M⁻¹ = 1/clip(dg, 1e-5):

    r = b − A x0,  z = M⁻¹ r,  p = z
    while lane l is active and ‖r‖ > tol·(‖b‖ + 1e-30), at most max_iter times:
        α = rᵀz / pᵀAp;  x += α p;  r −= α A p
        z = M⁻¹ r;  β = rᵀz_new / rᵀz_old;  p = z + β p

(divisors below 1e-30 in magnitude become 1e-30; a stopped lane keeps its
x), in float32.

`compare` reruns it on the operands of a late K2 call of the window, as
the window handed them to the kernel (the program's own state:
the IRLS weights that made them are held apart), and holds the kernel's
solution against it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def matvec(ex, ey, pa, v):
    fx = ex * (F.pad(v[..., :, 1:], (0, 1)) - v)
    fy = ey * (F.pad(v[..., 1:, :], (0, 0, 0, 1)) - v)
    return pa * v + F.pad(fx[..., :, :-1], (1, 0)) - fx + F.pad(fy[..., :-1, :], (0, 0, 1, 0)) - fy


def _guard(v):
    return torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)


def _sum2(a):
    return a.sum((-2, -1))


def pcg(ex, ey, pa, b, dg, x0, max_iter, tol, active):
    """(x (B,H,W), iterations (B,)) in the operands' dtype."""
    minv = 1.0 / torch.clamp(dg, min=1e-5)
    x = x0.clone()
    r = b - matvec(ex, ey, pa, x0)
    z = minv * r
    p = z
    rz = _sum2(r * z)
    bnorm = torch.sqrt(_sum2(b * b)) + 1e-30
    iters = torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)
    for _ in range(max_iter):
        live = active if tol < 0 else active & (torch.sqrt(_sum2(r * r)) > tol * bnorm)
        if tol >= 0 and not bool(live.any()):
            break
        Ap = matvec(ex, ey, pa, p)
        alpha = rz / _guard(_sum2(p * Ap))
        lv = live[:, None, None]
        x = torch.where(lv, x + alpha[:, None, None] * p, x)
        r = torch.where(lv, r - alpha[:, None, None] * Ap, r)
        z = minv * r
        rz_new = _sum2(r * z)
        p = torch.where(lv, z + (rz_new / _guard(rz))[:, None, None] * p, p)
        rz = torch.where(live, rz_new, rz)
        iters += live.to(torch.int32)
    return x, iters


def compare(ctx):
    """k2_gap: in the newest kept K2 call (the scene's last and first ones,
    of the sampled scene, then of the window's others) in which the
    reference moves an active lane from its start (the last rounds of an
    integration often start converged, where a solve that returns its
    start would pass), else the newest: over the
    active lanes, the largest distance of the kernel's solution to the
    reference's over the distance the reference moved (at least 1e-6 of
    its solution's norm), so that a solve that returns its start, or stops
    short, reads near 1. The control: the reference in bfloat16, the
    precision below float32 for arithmetic outside matrix products (the
    stencil has none)."""
    calls = ctx.window_calls("k2")
    if not calls:
        return {}
    with torch.no_grad():
        for pos, ((st, b, dg, x0, max_iter, tol, active, *_), (x, iters)) in enumerate(calls):
            args = (st.ex, st.ey, st.pa, b, dg, x0)
            ref, it_ref = pcg(*args, max_iter, tol, active)
            if bool(((it_ref > 0) & active).any()):
                break
        else:
            pos, ((st, b, dg, x0, max_iter, tol, active, *_), (x, iters)) = 0, calls[0]
            args = (st.ex, st.ey, st.pa, b, dg, x0)
            ref, it_ref = pcg(*args, max_iter, tol, active)
        if ctx.control:
            got, it_got = pcg(*(a.to(torch.bfloat16) for a in args), max_iter, tol, active)
            got = got.float()
        else:
            got, it_got = x.float(), iters
        if not bool(torch.isfinite(got).all()):
            return {"k2_gap": float("inf")}
        moved = (ref - x0).flatten(1).norm(dim=1)
        scale = torch.maximum(moved, 1e-6 * ref.flatten(1).norm(dim=1)).clamp(min=1e-30)
        gap = ((got - ref).flatten(1).norm(dim=1) / scale)[active]
    g = float(gap.max()) if gap.numel() else 0.0
    ctx.note(f"k2: call {pos + 1} of {len(calls)} kept (newest first), lanes {tuple(x0.shape)}, "
             f"active {int(active.sum())}, max_iter {max_iter}, tol {tol}, iterations {it_got.tolist()} "
             f"(reference {it_ref.tolist()}), moved {[float('%.4g' % v) for v in moved]}, "
             f"gap by lane {[float('%.4g' % v) for v in gap]}")
    return {"k2_gap": g}
