"""Plain masked multi-head attention, the benchmark's frozen reference of
kernel K4: softmax(q kᵀ · scale) v over (B, N, H, hd) heads, a padded key
(mask False) weighing 0, in float32.

`compare` recomputes it on the operands of the last K4 call of the sampled
scene, as the window handed them to the kernel (the program's own state:
the nets that made q, k and v are held apart), and holds the kernel's
output against it.
"""

from __future__ import annotations

import torch


def attention(q, k, v, mask, scale, rnd=lambda t: t):
    qf, kf, vf = (rnd(t.float()) for t in (q, k, v))
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    logits = torch.where(mask[:, None, None, :], logits, torch.full((), -1e9, device=q.device))
    return torch.einsum("bhnm,bmhd->bnhd", rnd(torch.softmax(logits, -1)), vf)


def lower(dtype):
    """The rounding one precision below the operands' type: float8 (e4m3)
    below bfloat16, TF32's 10-bit mantissa below float32."""
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.float8_e4m3fn).to(torch.float32)
    return lambda t: (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def rel_gap(got, ref):
    """Largest |got − ref| over the largest finite |ref|. Entries that are
    NaN on both sides agree (a lane whose operator is 0 has no inverse on
    either side); a non-finite entry on one side only reads infinite."""
    both = torch.isnan(got) & torch.isnan(ref)
    got, ref = got[~both], ref[~both]
    if got.numel() == 0:
        return 0.0
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def compare(ctx):
    """k4_gap: the largest gap of the kernel's output to the reference over
    the largest magnitude of the reference's, per route (dtype), worst
    route. The control: the reference with its operands and softmax weights
    rounded one precision lower."""
    gaps = []
    for (q, k, v, mask, scale), out in ctx.kernel_calls("attention"):
        with torch.no_grad():
            ref = attention(q, k, v, mask, scale)
            got = attention(q, k, v, mask, scale, lower(q.dtype)) if ctx.control else out.float()
        gaps.append(rel_gap(got, ref))
    return {"k4_gap": max(gaps)} if gaps else {}
