"""The resize and layer helpers of mpsfm_tpu/extraction/nets/depth_anything.py
that Metric3Dv2, DSINE and RoMa import (its :50-131), as the port's own
copy. Tensors are channels last (B, H, W, C), as in the JAX package; the
DepthAnythingV2 class itself is not ported yet (ROADMAP queue 1 item 6).

Every resize is a static separable interpolation matrix (one contraction
a side) replicating torch.nn.functional.interpolate's coordinates,
including DINOv2's position-embedding scale override.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _cubic_kernel(x, a=-0.75):
    """torch bicubic kernel (a=-0.75)."""
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
    )


def _interp_matrix(n_src, n_dst, mode="bilinear", align_corners=False, scale=None):
    """(n_dst, n_src) separable interpolation matrix replicating
    torch.nn.functional.interpolate's coordinate conventions. `scale`
    overrides the implied scale factor (DINOv2's +0.1 offset trick)."""
    W = np.zeros((n_dst, n_src), np.float64)
    if n_dst == 1 or n_src == 1:
        W[:] = 1.0 / n_src if not align_corners else 0.0
        if align_corners:
            W[:, 0] = 1.0
        return W
    if align_corners:
        src = np.arange(n_dst) * (n_src - 1) / (n_dst - 1)
    else:
        s = scale if scale is not None else n_dst / n_src
        src = (np.arange(n_dst) + 0.5) / s - 0.5
    if mode == "bilinear":
        lo = np.floor(src).astype(int)
        frac = src - lo
        for j in range(n_dst):
            i0 = min(max(lo[j], 0), n_src - 1)
            i1 = min(max(lo[j] + 1, 0), n_src - 1)
            W[j, i0] += 1 - frac[j]
            W[j, i1] += frac[j]
    else:  # bicubic
        base = np.floor(src).astype(int)
        for j in range(n_dst):
            for k in range(-1, 3):
                idx = base[j] + k
                W[j, min(max(idx, 0), n_src - 1)] += _cubic_kernel(src[j] - idx)
    return W


def _resize(x, hw, mode="bilinear", align_corners=False, scales=None):
    """(B,H,W,C) -> (B,h,w,C) with static separable matrices."""
    _, H, W0, _ = x.shape
    h, w = hw
    if (H, W0) == (h, w):
        return x
    Wh = torch.as_tensor(_interp_matrix(H, h, mode, align_corners, scales[0] if scales else None), dtype=x.dtype,
                         device=x.device)
    Ww = torch.as_tensor(_interp_matrix(W0, w, mode, align_corners, scales[1] if scales else None), dtype=x.dtype,
                         device=x.device)
    return torch.einsum("hH,bHWc,wW->bhwc", Wh, x, Ww)


def _ln(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _same_pad(n, k, s):
    """XLA's 'SAME' padding (low, high) of one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w_oihw, b=None, stride=1, pad="SAME", groups=1):
    """NHWC conv with a torch-layout (O,I/groups,kh,kw) kernel, XLA's 'SAME'
    or 'VALID' padding. 'SAME' puts the odd pixel of a padding on the bottom
    and right (a stride-2 3×3 conv of an even side pads (0, 1)), where
    torch's padding=1 would pad both sides and shift the map."""
    y = x.permute(0, 3, 1, 2)
    kh, kw = w_oihw.shape[2:]
    if pad == "SAME":
        (t, bo), (lft, r) = _same_pad(y.shape[2], kh, stride), _same_pad(y.shape[3], kw, stride)
        if t == bo and lft == r:
            y = F.conv2d(y, w_oihw, b, stride, padding=(t, lft), groups=groups)
        else:
            y = F.conv2d(F.pad(y, (lft, r, t, bo)), w_oihw, b, stride, groups=groups)
    else:
        y = F.conv2d(y, w_oihw, b, stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _deconv_block(x, w_iohw, b, f):
    """ConvTranspose2d with kernel == stride == f (pure pixel expansion)."""
    B, h, w, _ = x.shape
    y = torch.einsum("bhwc,copq->bhpwqo", x, w_iohw)  # (B,h,f,w,f,O)
    return y.reshape(B, h * f, w * f, w_iohw.shape[1]) + b
