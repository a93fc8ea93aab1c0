"""Plain SuperPoint (DeTone et al., 2018; magicleap's superpoint_v1.pth
layout) in float32 torch, the benchmark's frozen reference of the detector:
the VGG-style encoder, the 65-bin detector head and the descriptor head;
softmax, the 8×8 cell unfold, the iterated max-pool NMS of SuperGlue, the
top-k above the detection threshold, bilinear descriptor sampling at kp/8.

`compare` holds the program's keypoints and descriptors of one scene, read
from its feature cache, against this reference on the same images.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CONVS = (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b"), ("conv4a", "conv4b"))


def gray_of(rgb):
    """The 8-bit gray of an RGB image as libpng's rgb_to_gray gives it (the
    weights 0.299, 0.587, 0.114 in 15-bit fixed point, truncated; gray
    pixels kept)."""
    if rgb.ndim == 2:
        return rgb
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    gray = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (g == b), r, gray).astype(np.uint8)


def net(p, x):
    """x (B, 1, H, W) in [0, 1] -> scores65 (B, H/8, W/8, 65), unit
    descriptors (B, H/8, W/8, D)."""
    y = x
    for block in CONVS:
        for name in block:
            y = F.relu(F.conv2d(y, p[name + ".weight"], p[name + ".bias"], padding=1))
        if block[0] != "conv4a":
            y = F.max_pool2d(y, 2, 2)
    s = F.conv2d(F.relu(F.conv2d(y, p["convPa.weight"], p["convPa.bias"], padding=1)), p["convPb.weight"],
                 p["convPb.bias"])
    d = F.conv2d(F.relu(F.conv2d(y, p["convDa.weight"], p["convDa.bias"], padding=1)), p["convDb.weight"],
                 p["convDb.bias"])
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-8)
    return s.permute(0, 2, 3, 1), d.permute(0, 2, 3, 1)


def nms(scores, radius):
    def pool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    keep = scores == pool(scores)
    for _ in range(2):
        supp = pool(keep.to(scores.dtype)) > 0
        supp_scores = torch.where(supp, zeros, scores)
        keep = keep | ((supp_scores == pool(supp_scores)) & ~supp)
    return torch.where(keep, scores, zeros)


def detect(p, gray, spec, device):
    """One (H, W) uint8 gray image -> keypoints (n, 2) float64 and
    descriptors (n, D) float32 host arrays."""
    H, W = gray.shape
    H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
    x = torch.as_tensor(gray.astype(np.float32) / 255.0, device=device)
    x = F.pad(x[None, None], (0, W8 - W, 0, H8 - H))
    with torch.no_grad():
        s65, dmap = net(p, x)
        _, Hc, Wc, _ = s65.shape
        heat = torch.softmax(s65, -1)[..., :64].reshape(1, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4)
        heat = nms(heat.reshape(1, Hc * 8, Wc * 8), spec.get("nms_radius", 4))
        vals, idx = torch.topk(heat.reshape(1, -1), min(spec.get("max_keypoints", 6000), H8 * W8), dim=1)
        ys, xs = torch.div(idx, W8, rounding_mode="floor").float(), (idx % W8).float()
        valid = (vals > spec.get("detection_threshold", 0.005)) & (xs < W) & (ys < H)
        gx, gy = (xs + 0.5) / 8.0 - 0.5, (ys + 0.5) / 8.0 - 0.5
        x0 = torch.clamp(torch.floor(gx).long(), 0, Wc - 1)
        y0 = torch.clamp(torch.floor(gy).long(), 0, Hc - 1)
        x1, y1 = torch.clamp(x0 + 1, 0, Wc - 1), torch.clamp(y0 + 1, 0, Hc - 1)
        fx, fy = torch.clamp(gx - x0, 0, 1)[..., None], torch.clamp(gy - y0, 0, 1)[..., None]
        m = dmap[0]
        d = (m[y0, x0] * (1 - fx) * (1 - fy) + m[y0, x1] * fx * (1 - fy) + m[y1, x0] * (1 - fx) * fy
             + m[y1, x1] * fx * fy)[0]
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)
        v = valid[0]
    kps = torch.stack([xs, ys], -1)[0][v]
    return kps.double().cpu().numpy(), d[v].cpu().numpy()


def load(path, device):
    return {k: v.to(device=device, dtype=torch.float32) for k, v in torch.load(path, map_location="cpu").items()}


def compare(ctx):
    """sp_kp_miss: the share of keypoints that one side has and the other
    lacks, over the union of the program's and the reference's (exact pixel
    positions: both come off the same pixel grid), so that a keypoint
    dropped reads as one added; sp_desc_gap: the largest gap of a
    descriptor entry over the common keypoints, both sides rounded to
    float16 as the feature cache stores them. In the control the reference
    in the lower precision takes the program's place."""
    spec = ctx.net("superpoint")
    p = load(spec["path"], ctx.device)
    miss, gap, union = 0, 0.0, 0
    for name, rgb in ctx.scene_images():
        gray = gray_of(rgb)
        kr, dr = detect(p, gray, spec, ctx.device)
        if ctx.control:
            with ctx.lower_precision():
                kp, dp = detect(p, gray, spec, ctx.device)
        else:
            kp, dp = ctx.program_features(name)
        ref = {(int(x), int(y)): i for i, (x, y) in enumerate(np.rint(kr))}
        got = {(int(x), int(y)): i for i, (x, y) in enumerate(np.rint(kp))}
        common = [(got[k], ref[k]) for k in got.keys() & ref.keys()]
        miss += len(got.keys() ^ ref.keys())
        union += len(got.keys() | ref.keys())
        if common:
            a, b = np.array(common).T
            gap = max(gap, float(np.abs(dp[a].astype(np.float16).astype(np.float32)
                                        - dr[b].astype(np.float16).astype(np.float32)).max()))
    return {"sp_kp_miss": miss / max(union, 1), "sp_desc_gap": gap}
