"""Plain dense solve, the benchmark's frozen reference of kernel K1 (the
Cholesky solve of the bundle adjustment's reduced camera system S x = b,
one right-hand side or many): torch.linalg.solve in float64 on the
operands of a late K1 call of the window, as the window handed them to
the kernel (the program's own state: the bundle that made S and b
is held apart, through the poses and K3).

`compare` holds the kernel's solution by its backward error on those
operands, the measure that does not swing with S's condition number (up
to about 1e9 in the mapper's bundles, so that the float32 forward error of
any solver may read near 1), and notes its forward gap to the float64
solve beside it.
"""

from __future__ import annotations

import torch


def tf32(t):
    """t (float32) rounded to TF32's 10-bit mantissa."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def backward_error(S, x, b):
    """Largest over the columns of ‖S x − b‖∞ / (‖S‖∞ ‖x‖∞ + ‖b‖∞), in
    float64; infinite where x is not finite."""
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    r = (S @ x - b).abs().amax(0)
    den = torch.linalg.matrix_norm(S, ord=float("inf")) * x.abs().amax(0) + b.abs().amax(0)
    return float((r / den.clamp(min=1e-300)).max())


def compare(ctx):
    """k1_berr: the backward error of the kernel's solution in the newest
    kept K1 call, of the sampled scene and then of the window's others,
    whose right-hand side is not 0 (else x = 0 holds trivially) and whose S
    is positive definite in float64 (the kernel's precondition: a bundle's
    float32 Schur complement can lose it, and then the Cholesky solve has
    no answer to hold); no such call reads infinite. The
    control: the solve in float32 on operands rounded to TF32, with TF32
    on, the precision below the configuration's float32 with TF32 off."""
    calls = ctx.window_calls("k1")
    for skipped, ((S, rhs, *_), x) in enumerate(calls):
        S64 = S.double()
        if bool(rhs.abs().max() > 0) and int(torch.linalg.cholesky_ex(S64).info) == 0:
            break
    else:
        ctx.note(f"k1: none of the {len(calls)} kept calls has a positive definite S and a right-hand side")
        return {"k1_berr": float("inf")} if calls else {}
    many = rhs.dim() == 2
    b64 = (rhs if many else rhs[:, None]).double()
    with torch.no_grad():
        if ctx.control:
            with ctx.lower_precision():
                got = torch.linalg.solve(tf32(S.float()), tf32(b64.float()))
        else:
            got = x if many else x[:, None]
        got = got.double()
        ref = torch.linalg.solve(S64, b64)
        fwd = float(((got - ref).norm(dim=0) / ref.norm(dim=0).clamp(min=1e-300)).max())
    berr = backward_error(S64, got, b64)
    ctx.note(f"k1: call -{skipped + 1} of {len(calls)} kept, K {S.shape[0]}, {b64.shape[1]} right-hand side(s), "
             f"backward error {berr:.3e}, forward gap to the float64 solve {fwd:.3e} "
             f"(its backward error {backward_error(S64, ref, b64):.3e})")
    return {"k1_berr": berr}
