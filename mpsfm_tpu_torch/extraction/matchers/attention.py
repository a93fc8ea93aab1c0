"""LightGlue's masked multi-head attention (K4; counterpart of the TPU
flash attention behind mpsfm_tpu/extraction/matchers/lightglue.py:
LightGlue._attention).

`attention(q, k, v, kv_mask, sm_scale)` returns softmax(q kᵀ · sm_scale) v
with q (B, N, H, hd), k and v (B, M, H, hd), kv_mask (B, M) bool (False =
a padded key, whose logit is -1e9) and out (B, N, H, hd) in q's dtype.
On a CUDA tensor it launches the hand-written kernel csrc/attention.cu
(the flash algorithm: one CTA a (query tile of 64, head, batch element),
key tiles of 64 staged in shared memory and skipped when they hold no real
key, float32 running max, sum and accumulator; hd 16 or 64, in float32:
bfloat16 operands reach it as their float32 values and the result is
rounded back, as the plain version does). On a CPU tensor it runs
`attention_plain`, the JAX package's einsum path in float32. There is
no fallback between the two: a CUDA tensor reaches the kernel or the call
raises. KERNEL.launches counts the kernel's launches.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.kernels import F, I, P, Kernel, stream_ptr

KERNEL = Kernel("attention", "attention.cu", {"attention_f32": [P, P, P, P, P, I, I, I, I, I, F, P]})
HEAD_DIMS = (16, 64)  # the kernel's instantiations: the tests' LightGlue and the official one
DTYPES = (torch.float32, torch.bfloat16)


def attention_plain(q, k, v, kv_mask, sm_scale):
    """The JAX package's einsum path (lightglue.py:389-391) in float32 on
    the given inputs: logits × scale, masked keys set to -1e9, softmax over
    the keys, the product with v; the result in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * sm_scale
    logits = torch.where(kv_mask[:, None, None, :], logits, torch.full((), -1e9, device=q.device))
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, -1), vf).to(q.dtype)


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
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention: head width {hd}; the kernel has {HEAD_DIMS}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out.to(q.dtype)
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    kv_mask = kv_mask.contiguous()
    KERNEL.call("attention_f32", qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
                B, N, M, H, hd, float(sm_scale), stream_ptr(q))
    KERNEL.launches += 1
    return out.to(q.dtype)


def attention_flops(N, H, hd, kv_mask):
    """FLOP the function needs: the logits and the product with v, N·M'·hd
    FMA each, M' a batch element's real keys (a masked key's weight is 0;
    a batch element without a real key weighs all of its M keys)."""
    real = kv_mask.sum(1)
    keys = int(torch.where(real > 0, real, kv_mask.shape[1]).sum())
    return 4 * H * N * keys * hd
