"""LightGlue's masked multi-head attention (K4; counterpart of the TPU
flash attention behind mpsfm_tpu/extraction/matchers/lightglue.py:
LightGlue._attention).

`attention(q, k, v, kv_mask, sm_scale)` returns softmax(q kᵀ · sm_scale) v
with q (B, N, H, hd), k and v (B, M, H, hd), kv_mask (B, M) bool (False =
a padded key, whose logit is -1e9) and out (B, N, H, hd) in q's dtype.
On a CUDA tensor it launches one of K4's two hand-written kernels, by
dtype, both for hd 16 and 64 (and the float32 one for hd 48):

- bfloat16 operands (LightGlue's default): csrc/attention_tc.cu, the
  tensor-core route. The flash algorithm on wgmma with TMA-staged tiles:
  one CTA a (128 queries, head, batch element), two consumer warpgroups,
  K and V tiles of 64 keys through a 3-stage ring, Q·Kᵀ and P·V on the
  tensor cores with float32 accumulators, running max and sum; P is
  rounded to bfloat16 for P·V, as the JAX package's bfloat16 paths do,
  and the result once to bfloat16. hd 64 takes 128-byte swizzled tiles,
  hd 16 32-byte ones. KERNEL_TC.launches counts its launches.
- float32 operands (the parity setting, and every attention of MASt3R,
  the two-view and warp nets, DepthAnythingV2 and RoMa's DINOv2):
  csrc/attention.cu, the flash algorithm on the CUDA cores in float32
  (TF32 stays off). At hd 64 one CTA of 256 threads a (64 queries, head,
  batch element): each 64 × 64 logit tile and the 64 × 64 accumulator
  register-blocked in 4 × 4 sub-tiles a thread, the 16 threads of a row in
  one warp (row max by shuffles, one rescale a key tile), K and V through a
  2-stage cp.async ring, P through shared memory. At hd 16 and 48 (the
  trained prior's default net, 96 = 2 × 48) one query row a thread.
  KERNEL.launches counts its launches.

Both skip a 64-key tile without a real key (its weights are exactly 0)
unless the batch element has none. On a CPU tensor the wrapper runs
`attention_plain`, the JAX package's einsum path in float32. There is no
fallback between them: a CUDA tensor reaches its dtype's kernel or the
call raises.

Gradients: where q, k or v requires one, the float32 route runs as
`_AttentionF32`, an autograd Function whose forward is the route above and
whose backward is the gradient of the plain version's einsum + softmax
path in torch ops (`attention_grads`: the logits recomputed from the saved
q and k), as the JAX package differentiates its einsum path in XLA ops. The
bfloat16 route is inference-only and raises if asked for a gradient.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.kernels import F, I, P, Kernel, stream_ptr

KERNEL = Kernel("attention", "attention.cu", {"attention_f32": [P, P, P, P, P, I, I, I, I, I, F, P]})
KERNEL_TC = Kernel("attention_tc", "attention_tc.cu", {"attention_bf16": [P, P, P, P, P, I, I, I, I, I, F, P]})
HEAD_DIMS = {torch.float32: (16, 48, 64), torch.bfloat16: (16, 64)}  # each kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)


def attention_plain(q, k, v, kv_mask, sm_scale):
    """The JAX package's einsum path (lightglue.py:389-391) in float32 on
    the given inputs: logits × scale, masked keys set to -1e9, softmax over
    the keys, the product with v; the result in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * sm_scale
    logits = torch.where(kv_mask[:, None, None, :], logits, torch.full((), -1e9, device=q.device))
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, -1), vf).to(q.dtype)


def attention_grads(q, k, v, kv_mask, sm_scale, g):
    """The gradients (dq, dk, dv) of attention_plain's float32 function at
    (q, k, v) for the output gradient g, in torch ops: the softmax weights P
    recomputed from q and k, dv = Pᵀg, dS = P ∘ (g vᵀ - rowsum(P ∘ g vᵀ)),
    zero at masked keys (the gradient of the where), dq = dS k · scale,
    dk = dSᵀ q · scale."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    live = kv_mask[:, None, None, :]
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * sm_scale
    p = torch.softmax(torch.where(live, logits, torch.full((), -1e9, device=q.device)), -1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, gf)
    dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
    ds = torch.where(live, p * (dp - (dp * p).sum(-1, keepdim=True)), torch.zeros((), device=q.device)) * sm_scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _AttentionF32(torch.autograd.Function):
    """The float32 route with a gradient: forward through `_forward` (the
    kernel on a CUDA tensor, the plain version on a CPU one), backward by
    `attention_grads` from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, sm_scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.sm_scale = sm_scale
        return _forward(q, k, v, kv_mask, sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        return (*attention_grads(q, k, v, kv_mask, ctx.sm_scale, g), None, None)


def attention(q, k, v, kv_mask, sm_scale):
    """softmax(q kᵀ · sm_scale) v with a key-padding mask (see the module)."""
    B, N, H, hd = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, hd) or v.shape != k.shape or tuple(kv_mask.shape) != (B, M):
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} and mask "
                         f"{tuple(kv_mask.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES or kv_mask.dtype != torch.bool:
        raise TypeError(f"attention: q, k, v in one of {list(DTYPES)} and a bool mask, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {kv_mask.dtype}")
    if len({t.device for t in (q, k, v, kv_mask)}) != 1:
        raise ValueError("attention: q, k, v and the mask on different devices")
    if M == 0:
        raise ValueError("attention: no keys")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype != torch.float32:
            raise ValueError("attention: the bfloat16 route is inference-only; a gradient needs float32 operands")
        return _AttentionF32.apply(q, k, v, kv_mask, sm_scale)
    return _forward(q, k, v, kv_mask, sm_scale)


def _forward(q, k, v, kv_mask, sm_scale):
    """The checked call's route: the plain version on a CPU tensor, the
    dtype's kernel on a CUDA one."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    B, N, H, hd = q.shape
    M = k.shape[1]
    if hd not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"attention: head width {hd}; the {q.dtype} kernel has {HEAD_DIMS[q.dtype]}")
    if q.dtype == torch.bfloat16 and not sm_scale > 0:  # the tensor-core kernel takes row maxima of unscaled logits
        raise ValueError(f"attention: the bfloat16 kernel takes a positive scale, not {sm_scale}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B == 0 or N == 0:
        return out
    # contiguous, and 16-byte aligned for the tensor-core route's TMA
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    kernel, fn = (KERNEL_TC, "attention_bf16") if q.dtype == torch.bfloat16 else (KERNEL, "attention_f32")
    kernel.call(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.contiguous().data_ptr(), out.data_ptr(),
                B, N, M, H, hd, float(sm_scale), stream_ptr(q))
    kernel.launches += 1
    return out


def attention_flops(N, H, hd, kv_mask):
    """FLOP the function needs: the logits and the product with v, N·M'·hd
    FMA each, M' a batch element's real keys (a masked key's weight is 0;
    a batch element without a real key weighs all of its M keys)."""
    real = kv_mask.sum(1)
    keys = int(torch.where(real > 0, real, kv_mask.shape[1]).sum())
    return 4 * H * N * keys * hd
