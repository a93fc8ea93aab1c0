"""Classical corner detector + patch descriptors (port of
mpsfm_tpu/extraction/features/classical.py).

Lets the full pipeline run end-to-end on real images when no pretrained
SuperPoint checkpoint is available: Shi-Tomasi corner response from a
Sobel structure tensor, maxpool NMS, top-k, and multi-scale oriented
SIFT-class patch descriptors. Torch ops on the caller's device, over a
batch of same-shape images at once; the JAX package's XLA convolutions,
reduce_window and top_k become F.conv2d (zero padding, a cross-correlation
as XLA's), F.max_pool2d (−inf padding) and torch.topk. Float32 with TF32
off (the package's policy), so the card and the CPU differ only in the
order of their sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device


def simple_nms(scores, radius: int):
    """Iterated maxpool NMS (SuperGlue's simple_nms) of (B, H, W) scores
    (port of mpsfm_tpu/extraction/features/superpoint.py:simple_nms)."""

    def maxpool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == maxpool(scores)
    for _ in range(2):
        supp_mask = maxpool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == maxpool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def _conv2(img, k):
    """'SAME' cross-correlation of (B, H, W) with one odd (kh, kw) kernel,
    zero padding."""
    return F.conv2d(img[:, None], k[None, None], padding=(k.shape[0] // 2, k.shape[1] // 2))[:, 0]


def _gauss_kernel(sigma, radius, dev):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _take(src, yy, xx):
    """src (B, H, W) at integer (B, ...) coordinates -> (B, ...)."""
    B, H, W = src.shape
    flat = (yy * W + xx).reshape(B, -1)
    return torch.gather(src.reshape(B, -1), 1, flat).reshape(yy.shape)


def _bilinear(src, yy, xx):
    """Bilinear sample src (B, H, W) at float coords (B, ...) -> same shape."""
    _, H, W = src.shape
    y0 = torch.clamp(torch.floor(yy).long(), 0, H - 1)
    x0 = torch.clamp(torch.floor(xx).long(), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)
    fx = torch.clamp(xx - x0, 0.0, 1.0)
    return (
        _take(src, y0, x0) * (1 - fy) * (1 - fx)
        + _take(src, y0, x1) * (1 - fy) * fx
        + _take(src, y1, x0) * fy * (1 - fx)
        + _take(src, y1, x1) * fy * fx
    )


def _soft_bins(ang, n):
    """Linear weights of angles (radians, ...) over n circular bins ->
    (..., n)."""
    o = torch.remainder(ang / (2 * math.pi) * n, float(n))
    o0 = torch.floor(o)
    f = o - o0
    bins = torch.arange(n, dtype=torch.float32, device=ang.device)
    return (bins == torch.remainder(o0, n)[..., None]) * (1 - f[..., None]) + (
        bins == torch.remainder(o0 + 1, n)[..., None]
    ) * f[..., None]


def _dominant_orientation(mag, theta, ys, xs, radius=8):
    """SIFT dominant orientation: gaussian-weighted 36-bin gradient
    histogram in a (2r+1)^2 window, circular smoothing, parabolic peak
    refinement. ys, xs (B, K) -> (B, K) radians."""
    _, H, W = mag.shape
    dev = mag.device
    offs = torch.arange(-radius, radius + 1, device=dev)
    py = torch.clamp(ys[..., None, None] + offs[:, None], 0, H - 1).expand(*ys.shape, len(offs), len(offs))
    px = torch.clamp(xs[..., None, None] + offs[None, :], 0, W - 1).expand(*ys.shape, len(offs), len(offs))
    mk = _take(mag, py, px)
    tk = _take(theta, py, px)
    d = offs.float() / radius
    gw = torch.exp(-0.5 * (d[:, None] ** 2 + d[None, :] ** 2) / (0.5**2))
    mk = mk * gw
    hist = (_soft_bins(tk, 36) * mk[..., None]).sum((2, 3))  # (B, K, 36)
    # circular smoothing [1,4,6,4,1]/16 twice
    for _ in range(2):
        hist = (
            6 * hist
            + 4 * (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1))
            + (torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1))
        ) / 16.0
    peak = torch.argmax(hist, -1)
    hp = torch.gather(hist, -1, peak[..., None])[..., 0]
    hl = torch.gather(hist, -1, torch.remainder(peak - 1, 36)[..., None])[..., 0]
    hr = torch.gather(hist, -1, torch.remainder(peak + 1, 36)[..., None])[..., 0]
    delta = 0.5 * (hl - hr) / torch.clamp(hl - 2 * hp + hr, min=1e-12)
    delta = torch.clamp(-delta, -0.5, 0.5)
    return (peak.float() + delta) * (2 * math.pi / 36.0)


def _sift_patch_descriptor(mag, theta, ys, xs, ang, step):
    """Rotation-aware SIFT descriptor: 16x16 gradient samples on a grid
    rotated by the dominant orientation `ang` (spacing `step`), gradient
    orientations taken relative to `ang`; 4x4 cells x 8 bins, bilinear
    cell/bin weighting, gaussian window, clip-0.2 renorm. (B, K) keypoints
    -> (B, K, 128)."""
    B, K = ys.shape
    dev = mag.device
    u = (torch.arange(16, dtype=torch.float32, device=dev) - 7.5) * step
    ca = torch.cos(ang)[..., None, None]
    sa = torch.sin(ang)[..., None, None]
    du = u[:, None]
    dv = u[None, :]
    dx = dv * ca - du * sa
    dy = dv * sa + du * ca
    yy = ys[..., None, None].float() + dy
    xx = xs[..., None, None].float() + dx
    mk = _bilinear(mag, yy, xx)  # (B, K, 16, 16)
    tk = _bilinear(theta, yy, xx) - ang[..., None, None]
    # gaussian window over the patch
    d = (torch.arange(16, dtype=torch.float32, device=dev) - 7.5) / 8.0
    gw = torch.exp(-0.5 * (d[:, None] ** 2 + d[None, :] ** 2) / (0.5**2))
    mk = mk * gw
    wbin = _soft_bins(tk, 8) * mk[..., None]  # (B, K, 16, 16, 8)
    # bilinear cell weights along each axis: sample i -> cell coord i/4 - 0.5
    pos = (torch.arange(16, dtype=torch.float32, device=dev) + 0.5) / 4.0 - 0.5
    cells = torch.arange(4, dtype=torch.float32, device=dev)
    cw = torch.clamp(1.0 - torch.abs(pos[:, None] - cells[None, :]), min=0.0)  # (16, 4)
    desc = torch.einsum("bkyxo,yr,xc->bkrco", wbin, cw, cw).reshape(B, K, 128)
    # SIFT normalization: L2 -> clip 0.2 -> L2
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)


_SOBEL = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0


def _octave_features(img, n_kps: int, nms_radius: int, threshold: float):
    """Shi-Tomasi detection + oriented two-scale SIFT descriptors on one
    octave of (B, H, W) images. Returns (kps (B,n,2) octave px, vals,
    desc (B,n,256), valid)."""
    B, H, W = img.shape
    dev = img.device
    sobel_x = torch.as_tensor(_SOBEL, device=dev)
    gx = _conv2(img, sobel_x)
    gy = _conv2(img, sobel_x.T.contiguous())
    g = _gauss_kernel(1.5, 3, dev)
    Ixx = _conv2(gx * gx, g)
    Iyy = _conv2(gy * gy, g)
    Ixy = _conv2(gx * gy, g)
    # Shi-Tomasi: smaller eigenvalue of the structure tensor
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    lam_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    b = 16
    mask = torch.zeros_like(lam_min)
    mask[:, b:-b, b:-b] = 1.0
    resp = simple_nms(lam_min * mask, nms_radius)

    # ties: only responses above the threshold are kept; an exact tie among
    # them at the quota's edge is the one place torch.topk's order can differ
    vals, idx = torch.topk(resp.reshape(B, -1), n_kps, dim=1)
    ys = idx // W
    xs = idx % W
    valid = vals > threshold

    # sub-pixel refinement: 1-D quadratic fit on the response
    rc = _take(lam_min, ys, xs)
    rxp = _take(lam_min, ys, torch.clamp(xs + 1, 0, W - 1))
    rxm = _take(lam_min, ys, torch.clamp(xs - 1, 0, W - 1))
    ryp = _take(lam_min, torch.clamp(ys + 1, 0, H - 1), xs)
    rym = _take(lam_min, torch.clamp(ys - 1, 0, H - 1), xs)
    dx = torch.clamp(0.5 * (rxp - rxm) / torch.clamp(2 * rc - rxp - rxm, min=1e-12), -0.5, 0.5)
    dy = torch.clamp(0.5 * (ryp - rym) / torch.clamp(2 * rc - ryp - rym, min=1e-12), -0.5, 0.5)

    # gradient fields at two smoothing scales
    def grad_field(sigma, radius):
        bl = _conv2(img, _gauss_kernel(sigma, radius, dev))
        fx = _conv2(bl, sobel_x)
        fy = _conv2(bl, sobel_x.T.contiguous())
        return torch.sqrt(fx * fx + fy * fy + 1e-12), torch.atan2(fy, fx)

    m1, t1 = grad_field(1.0, 2)
    m2, t2 = grad_field(2.5, 4)
    ang = _dominant_orientation(m1, t1, ys, xs)
    d1 = _sift_patch_descriptor(m1, t1, ys, xs, ang, 1.0)
    d2 = _sift_patch_descriptor(m2, t2, ys, xs, ang, 2.0)
    desc = torch.cat([d1, d2], -1)
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)
    kps = torch.stack([xs.float() + dx, ys.float() + dy], -1)
    return kps, vals, desc, valid


def octave_quotas(max_kps: int, octaves: int = 3) -> list[int]:
    """Keypoints each octave may keep: half the budget at full resolution,
    the rest shared by the coarser octaves (the JAX package's split)."""
    quotas = []
    q = max_kps // 2 if octaves > 1 else max_kps
    rest = max_kps - q
    quotas.append(q)
    for o in range(1, octaves):
        this = rest // (octaves - 1) if o < octaves - 1 else rest - (rest // (octaves - 1)) * (octaves - 2)
        quotas.append(this)
    return quotas


def detect_describe(imgs, max_kps: int, nms_radius: int, threshold: float, octaves: int = 3):
    """Multi-octave oriented SIFT-class features of (B, H, W) float32
    images (COLMAP-SIFT analog for the no-weights operating point). Per
    octave: Shi-Tomasi detection + dominant-orientation two-scale SIFT
    descriptors; keypoints map back to full-resolution pixels. Returns
    (kps (B,n,2), vals (B,n), desc (B,n,256), valid (B,n)), n = max_kps."""
    out_k, out_v, out_d, out_m = [], [], [], []
    cur = imgs
    for o, quota in enumerate(octave_quotas(max_kps, octaves)):
        k, v, d, m = _octave_features(cur, quota, nms_radius, threshold)
        s = float(2**o)
        out_k.append((k + 0.5) * s - 0.5)
        # response magnitudes shrink with octave blur; rank within-octave
        # only (quotas already fix the budget per octave)
        out_v.append(v)
        out_d.append(d)
        out_m.append(m)
        if o + 1 < octaves:
            B, Hc, Wc = cur.shape
            r = cur[:, : Hc - Hc % 2, : Wc - Wc % 2].reshape(B, Hc // 2, 2, Wc // 2, 2)
            # 2×2 means summed in row-major order, as XLA reduces them (bit-equal to the JAX package)
            cur = (((r[:, :, 0, :, 0] + r[:, :, 0, :, 1]) + r[:, :, 1, :, 0]) + r[:, :, 1, :, 1]) / 4
    return torch.cat(out_k, 1), torch.cat(out_v, 1), torch.cat(out_d, 1), torch.cat(out_m, 1)


class ClassicalFeatures:
    default_conf = {
        "nms_radius": 4,
        "max_keypoints": 4096,
        "detection_threshold": 1e-6,
    }
    detection_noise = 1.5  # px — coarser localisation than SuperPoint
    # bound on the orientation histogram's elements (batch × keypoints ×
    # 17² window × 36 bins) of one call: 2^28 float32, 1 GiB
    max_hist_elements = 1 << 28

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)

    def batch_fn(self):
        """(B, H, W) float32 tensor -> padded (kps, vals, desc, valid) with
        the leading batch axis, as many images a call as the histogram
        bound allows: the unit parallel.sharded_inference shards over the
        ranks."""
        c = self.conf
        per_call = max(1, self.max_hist_elements // (c["max_keypoints"] * 17 * 17 * 36))

        def fn(x):
            outs = [detect_describe(x[s:s + per_call], c["max_keypoints"], c["nms_radius"], c["detection_threshold"])
                    for s in range(0, len(x), per_call)]
            return tuple(torch.cat(o) for o in zip(*outs))

        return fn

    @staticmethod
    def postprocess(out):
        """One image's padded (kps, vals, desc, valid) host arrays -> its
        keypoints, scores and descriptors."""
        kps, vals, desc, valid = out
        return {"keypoints": kps[valid], "scores": vals[valid], "descriptors": desc[valid]}

    def batch(self, images: list[np.ndarray]) -> list[dict]:
        """Features of same-shape gray images in [0, 1] -> one dict of host
        arrays (keypoints, scores, descriptors) an image (batch_fn)."""
        x = torch.as_tensor(np.stack(images), dtype=torch.float32, device=self.device)
        outs = [t.cpu().numpy() for t in self.batch_fn()(x)]
        return [self.postprocess(o) for o in zip(*outs)]

    def __call__(self, image_gray: np.ndarray):
        return self.batch([image_gray])[0]
