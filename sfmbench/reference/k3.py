"""Plain deflated Jacobi-PCG of indicator right-hand sides, the benchmark's
frozen reference of kernel K3: diag(H⁻¹) of the BiNI operator at query
pixels. For lane b and query q, with the operator's edge weights (ex, ey)
and diagonal part pa, M⁻¹ the Jacobi preconditioner, the deflation basis
Z = {1, x, y}, HZ = H·Z and E⁻¹ = (ZᵀHZ + 1e-10·tr·I)⁻¹:

    x = Z·E⁻¹·Zᵀe_q,  r = e_q − H·x,  z = P(M⁻¹ r),  p = z
    `iters` times: α = rᵀz / pᵀHp; x += α p; r −= α H p;
                   z = P(M⁻¹ r); β = rᵀz_new / rᵀz_old; p = z + β p
    var = x[q],  P(V) = V − Z·E⁻¹·(HZ)ᵀV

(divisors below 1e-30 in magnitude become 1e-30), in float32.

`compare` recomputes it on a seeded sample of the queries of a late K3
call of the window, from the operator and deflation that the window
handed the kernel (the program's own state), and holds each of the
kernel's diagonal entries against the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SAMPLE = 64  # queries a lane


def matvec(ex, ey, pa, v):
    fx = ex * (F.pad(v[..., :, 1:], (0, 1)) - v)
    fy = ey * (F.pad(v[..., 1:, :], (0, 0, 0, 1)) - v)
    return pa * v + F.pad(fx[..., :, :-1], (1, 0)) - fx + F.pad(fy[..., :-1, :], (0, 0, 1, 0)) - fy


def _guard(v):
    return torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)


def pcg(ex, ey, pa, minv, lin_x, lin_y, hz, einv, rows, cols, iters, dtype=torch.float32):
    """x[q] (B, K) for rows/cols (B, K), computed in `dtype`."""
    mm = torch.matmul
    B, K = rows.shape
    H, W = minv.shape[-2:]
    one = torch.ones((H, W), dtype=lin_x.dtype, device=lin_x.device)
    Z = torch.stack([one, one * lin_x[None, :], lin_y[:, None] * one])
    ex, ey, pa, minv = (t[:, None] for t in (ex, ey, pa, minv))
    bi = torch.arange(B, device=rows.device)[:, None].expand(B, K)
    ki = torch.arange(K, device=rows.device)[None, :].expand(B, K)
    r, c = rows.long(), cols.long()
    e = torch.zeros((B, K, H, W), dtype=dtype, device=rows.device)
    e[bi, ki, r, c] = 1.0
    Zf = Z.reshape(3, H * W)

    def project(V):
        g = mm(V.reshape(B, K, H * W), hz.reshape(B, 3, H * W).transpose(1, 2))  # (B,K,3)
        return V - mm(mm(g, einv), Zf).reshape(B, K, H, W)

    x = mm(mm(Z[:, r, c].permute(1, 2, 0), einv), Zf).reshape(B, K, H, W)
    res = e - matvec(ex, ey, pa, x)
    z = project(minv * res)
    p = z
    rz = (res * z).sum((-2, -1))
    for _ in range(iters):
        Ap = matvec(ex, ey, pa, p)
        alpha = rz / _guard((p * Ap).sum((-2, -1)))
        x = x + alpha[..., None, None] * p
        res = res - alpha[..., None, None] * Ap
        z = project(minv * res)
        rz_new = (res * z).sum((-2, -1))
        p = z + (rz_new / _guard(rz))[..., None, None] * p
        rz = rz_new
    return x[bi, ki, r, c]


FLOOR = 1e-3  # of the median |reference entry|: the smallest scale an entry's gap is taken against
MOVED = 1e-2  # the least move from the deflated start that makes a call tell a solve from its start


def entry_gap(got, ref):
    """(largest |got − ref| / max(|ref|, FLOOR · median |ref|) over the
    entries finite on both sides, their number). Entries that are NaN on
    both sides agree (a lane whose operator is 0 has no inverse on either
    side) and are not counted; an entry finite on one side only, or no
    entry to compare, reads infinite."""
    both = torch.isnan(got) & torch.isnan(ref)
    got, ref = got[~both].double(), ref[~both].double()
    n = int(got.numel())
    if n == 0 or not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        return float("inf"), n
    scale = torch.clamp(ref.abs(), min=max(FLOOR * float(ref.abs().median()), 1e-30))
    return float(((got - ref).abs() / scale).max()), n


def compare(ctx):
    """k3_gap: the largest gap of a diagonal entry of the kernel's to the
    reference's, each over its own reference entry (floored at FLOOR times
    the median), on SAMPLE queries a lane drawn from the seed, in the
    newest kept K3 call (of the sampled scene, then of the window's others)
    in which the reference's iterations move some sampled entry by MOVED
    or more from the deflated start, else the newest; no entry to compare
    fails. The control: the reference in bfloat16, the precision below
    float32 for arithmetic outside matrix products (TF32 would touch only
    the deflation's 3-column products)."""
    calls = [c for c in ctx.window_calls("k3") if c[0][2].numel()]
    if not calls:
        return {}
    with torch.no_grad():
        for pos, ((st, dfl, rows, cols, iters, *_), out) in enumerate(calls + calls[:1]):
            B, K = rows.shape
            pick = torch.as_tensor(ctx.rng.choice(K, min(SAMPLE, K), replace=False), device=rows.device)
            args = (*st, dfl.minv, dfl.lin_x, dfl.lin_y, dfl.hz, dfl.einv, rows[:, pick], cols[:, pick])
            ref = pcg(*args, iters)
            moved, _ = entry_gap(pcg(*args, 0), ref)
            if moved >= MOVED or pos >= len(calls):
                break
        got = pcg(*[a.to(torch.bfloat16) if a.is_floating_point() else a for a in args], iters,
                  dtype=torch.bfloat16).float() if ctx.control else out[:, pick].float()
    gap, n = entry_gap(got, ref)
    ctx.note(f"k3: call {pos % len(calls) + 1} of {len(calls)} kept (newest first), {n} of {got.numel()} entries "
             f"compared (lanes {B}, queries {K}, iterations {iters}); the iterations move them {moved:.3e} from "
             f"the deflated start")
    return {"k3_gap": gap}
