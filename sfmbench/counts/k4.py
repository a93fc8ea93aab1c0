"""Kernel K4 (masked multi-head attention): the operations and bytes one
call needs, from its shapes. Operations: the logits and the product with v,
N·M'·hd multiply-adds each, M' a batch element's real keys (a masked key
weighs 0; an element without a real key weighs all M): 4·H·hd·N·ΣM'.
Bytes: q, k, v and the output once each in the operands' type, and the
mask."""

from __future__ import annotations


def real_keys(mask_rows):
    """Σ over the batch of each element's real keys (all M where it has none)."""
    return sum(n if n > 0 else m for n, m in mask_rows)


def flops(B, N, M, H, hd, keys):
    return 4 * H * hd * N * keys


def bytes_moved(B, N, M, H, hd, itemsize):
    return itemsize * H * hd * (2 * B * N + 2 * B * M) + B * M


# the program's entry to the kernel (both routes) and the kernels' names in a device trace, by route
TARGET = ("mpsfm_tpu_torch.extraction.matchers.attention", "_forward")
KERNELS = {"bfloat16": ("attention_tc_kernel",), "float32": ("attention_tile_kernel", "attention_row_kernel")}


def record(args, kwargs, out):
    q, k, _, mask = args[:4]
    B, N, H, hd = q.shape
    return {"shape": (B, N, k.shape[1], H, hd), "precision": str(q.dtype).replace("torch.", ""),
            "itemsize": q.element_size(), "mask": mask}


def least_s(rec, peaks):
    """The call's least time on the chip (the mask is read here, after the
    window, so that the traced window does not wait on it)."""
    B, N, M, H, hd = rec["shape"]
    n = rec["mask"].sum(1).tolist()
    keys = real_keys([(int(x), M) for x in n])
    return peaks.least_s(flops(B, N, M, H, hd, keys), bytes_moved(B, N, M, H, hd, rec["itemsize"]), rec["precision"])
