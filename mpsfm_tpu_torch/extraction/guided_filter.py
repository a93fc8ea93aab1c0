"""Confidence-weighted guided upsampling for sky masks (port of
mpsfm_tpu/extraction/guided_filter.py).

Behavioral port of the algorithm the reference uses to upsample the
320x320 sky probability to full resolution
(mpsfm/extraction/imagewise/mask/models/skyseg.py:109-146, after
google/sky-optimization): fit a local affine model mask ~ a.rgb + b on a
confidence-weighted coarse grid (closed-form 3x3 LDL solve per cell),
smooth-upsample the affine coefficients, and re-apply them against the
full-resolution guide image — edges in the output follow the GUIDE's
edges instead of the low-res probability's blur.

Every function works on float64 tensors on their device, (H, W) or
(H, W, C) channels last. The JAX package's module runs in numpy float64
with OpenCV's sepFilter2D and resize; their arithmetic is kept here:
`_down2` is the separable [1, 3, 3, 1] / 8 filter with anchor 1 and a
replicated border, each tap added in turn; `resize_linear` is
INTER_LINEAR, which torch's bilinear interpolation (no corner alignment,
no antialiasing) matches to float64 rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _bias(x, b=0.8):
    return x / (((1.0 / b) - 2.0) * (1.0 - x) + 1.0)


def probability_to_confidence(prob, low=0.3, high=0.5, eps=0.01):
    """Confidence of the binary decision: high near 0 or 1, ~eps in the
    ambiguous band (skyseg.py:18-29)."""
    conf = torch.where(prob < low, _bias((low - prob) / low), torch.zeros_like(prob))
    conf = torch.where(prob > high, _bias((prob - high) / (1.0 - high)), conf)
    return torch.clamp(conf, min=eps)


def resize_linear(X, shape):
    """OpenCV's resize INTER_LINEAR of X (H, W[, C]) to shape (h, w), in X's
    dtype: torch's bilinear interpolation without corner alignment or
    antialiasing takes the same taps, in float64 as OpenCV computes them
    (torch's float32 path places them in float32)."""
    Y = (X.permute(2, 0, 1)[None] if X.ndim == 3 else X[None, None]).to(torch.float64).contiguous()
    Y = F.interpolate(Y, size=(int(shape[0]), int(shape[1])), mode="bilinear", align_corners=False, antialias=False)
    Y = Y.to(X.dtype)
    return Y[0].permute(1, 2, 0) if X.ndim == 3 else Y[0, 0]


def _area_tab(n_src, n_dst, scale):
    """OpenCV's computeResizeAreaTab as a (n_dst, n_src) matrix: each output
    pixel the mean of its box [d·scale, (d+1)·scale) of input pixels, the
    edge pixels weighted by their covered fraction (float32 weights, as
    OpenCV keeps them)."""
    A = np.zeros((n_dst, n_src), np.float64)
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            A[d, s1 - 1] = np.float32((s1 - f1) / cell)
        A[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            A[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return A


def _area_linear_tab(n_src, n_dst, scale, inv):
    """OpenCV's INTER_AREA taps off the area path (a side enlarged): two taps
    at floor(d·scale), the second weighted by the fraction of the output
    pixel past the input pixel's end (float32, as OpenCV computes it), the
    border clamped."""
    A = np.zeros((n_dst, n_src), np.float64)
    for d in range(n_dst):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(np.floor(f))
        if s < 0:
            s, f = 0, np.float32(0.0)
        if s >= n_src - 1:
            s, f = n_src - 1, np.float32(0.0)
        A[d, s] += np.float32(1.0) - f
        if f:
            A[d, s + 1] += f
    return A


def resize_area(X, shape):
    """OpenCV's resize INTER_AREA of X (H, W[, C]) to shape (h, w), in X's
    dtype, computed in float64: where neither side grows, the box filter
    with fractional edge weights (computeResizeAreaTab; an integer ratio, its
    fast path, is the same plain block mean); else OpenCV's area-mode linear
    taps on both sides."""
    H, W = X.shape[:2]
    h, w = int(shape[0]), int(shape[1])
    inv_x, inv_y = w / W, h / H
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx >= 1 and sy >= 1:
        Ay, Ax = _area_tab(H, h, sy), _area_tab(W, w, sx)
    else:
        Ay, Ax = _area_linear_tab(H, h, sy, inv_y), _area_linear_tab(W, w, sx, inv_x)
    Ay, Ax = (torch.as_tensor(a, device=X.device) for a in (Ay, Ax))
    Y = torch.einsum("hH,HW...,wW->hw...", Ay, X.to(torch.float64), Ax)
    return Y.to(X.dtype)


def _filter4_even(X, dim):
    """[1, 3, 3, 1] / 8 along dim at the even positions 0, 2, ..., taps at
    offsets -1 .. 2 (anchor 1), the border replicated, the taps added in
    turn."""
    n = X.shape[dim]
    m = (n + 1) // 2
    P = X.index_select(dim, torch.clamp(torch.arange(-1, n + 2, device=X.device), 0, n - 1))
    out = None
    for j, k in enumerate((0.125, 0.375, 0.375, 0.125)):
        term = k * P.narrow(dim, j, 2 * m - 1)[(slice(None),) * dim + (slice(None, None, 2),)]
        out = term if out is None else out + term
    return out


def _down2(X):
    """OpenCV's sepFilter2D with [1, 3, 3, 1] / 8, anchor (1, 1) and a
    replicated border, at every second pixel."""
    return _filter4_even(_filter4_even(X, 1), 0)


def _resize(X, shape):
    """Antialiased resize: halve while >=2x too large, then bilinear."""
    X = X.to(torch.float64)
    while X.shape[0] >= 2 * shape[0] and X.shape[1] >= 2 * shape[1]:
        X = _down2(X)
    return resize_linear(X, shape)


def _weighted_down(X, conf, target):
    num = _resize(X * (conf[..., None] if X.ndim == 3 else conf), target)
    den = _resize(conf, target)
    if X.ndim == 3:
        den = den[..., None]
    return num / den


def _outer6(X, Y):
    """Upper-triangular entries of the per-pixel 3x3 outer product."""
    i, j = (torch.as_tensor(a, device=X.device) for a in np.triu_indices(3))
    return X[..., i] * Y[..., j]


def _ldl3(A6, b3):
    """Per-pixel solve of the SPD 3x3 system given its 6 upper-tri
    entries (closed-form LDL, skyseg.py solve_image_ldl3)."""
    a11, a12, a13, a22, a23, a33 = [A6[..., k] for k in range(6)]
    b1, b2, b3v = [b3[..., k] for k in range(3)]
    d1 = a11
    l12 = a12 / d1
    d2 = a22 - l12 * a12
    l13 = a13 / d1
    l23 = (a23 - l13 * a12) / d2
    d3 = a33 - l13 * a13 - l23 * l23 * d2
    y1 = b1
    y2 = b2 - l12 * y1
    y3 = b3v - l13 * y1 - l23 * y2
    x3 = y3 / d3
    x2 = y2 / d2 - l23 * x3
    x1 = y1 / d1 - l12 * x2 - l13 * x3
    return torch.stack([x1, x2, x3], -1)


def _smooth_up(X, size):
    steps = max(1, int(round(float(np.max(0.5 * np.log2(np.array(size) / np.array(X.shape[:2])))))))
    per = np.array(X.shape[:2], np.float64) * (np.array(size) / np.array(X.shape[:2])) / steps
    for s in range(1, steps + 1):
        X = _resize(X, np.round(s * per).astype(int))
    return X


def guided_upsample(reference, source, kernel_size, confidence=None,
                    eps_luma=1e-2, eps_chroma=1e-2, clip_output=True):
    """reference (H,W,3) float tensor in [0,1]; source: low-res probability
    (h,w), on the reference's device. Returns the probability upsampled to
    (H,W) following the guide's edges (exact algorithm of
    skyseg.py:109-146), float64."""
    reference = reference.to(torch.float64)
    source = source.to(torch.float64)
    if any(np.array(source.shape) < np.array(reference.shape[:2])):
        source = _resize(source, reference.shape[:2])
    if confidence is None:
        confidence = probability_to_confidence(source)

    small = (np.array(reference.shape[:2]) / kernel_size).round().astype(int)
    small = np.maximum(small, 1)
    ref_s = _weighted_down(reference, confidence, small)
    src_s = _weighted_down(source, confidence, small)

    outer = _weighted_down(_outer6(reference, reference), confidence, small)
    covar = outer - _outer6(ref_s, ref_s)
    var = _weighted_down(reference * source[..., None], confidence, small)
    resid_s = var - ref_s * src_s[..., None]
    eps = torch.zeros(6, dtype=torch.float64, device=covar.device)
    eps[0], eps[3], eps[5] = eps_luma**2, eps_chroma**2, eps_chroma**2
    covar = covar + eps

    affine = _ldl3(covar, resid_s)
    residual = src_s - (affine * ref_s).sum(-1)
    affine = _smooth_up(affine, reference.shape[:2])
    residual = _smooth_up(residual, reference.shape[:2])
    out = (affine * reference).sum(-1) + residual
    return torch.clamp(out, 0.0, 1.0) if clip_output else out
