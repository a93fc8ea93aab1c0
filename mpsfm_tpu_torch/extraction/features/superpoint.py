"""SuperPoint (port of mpsfm_tpu/extraction/features/superpoint.py).

The magicleap network as an nn.Module under the checkpoint's own names
(conv1a … convDb), so superpoint_v1.pth loads with load_state_dict, and
its post-processing on the device: the softmax over the 65 bins, the 8×8
cell unfold, maxpool NMS, the top-k and the bilinear descriptor sampling
at kp/8 (reference configs/superpoint.yaml: nms_radius 4, 6000
keypoints). Images of one shape go through as one batch (`batch_fn`, the
unit parallel.sharded_inference shares out). Tensors are NCHW inside the
net; its outputs keep the JAX package's channels-last layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.features.classical import simple_nms
from mpsfm_tpu_torch.extraction.manifest import check_state_dict
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
         "convPa", "convPb", "convDa", "convDb")


class SuperPointNet(nn.Module):
    """VGG-style encoder + detector/descriptor heads (magicleap layout)."""

    def __init__(self, descriptor_dim=256):
        super().__init__()
        c = {"conv1a": (1, 64), "conv1b": (64, 64), "conv2a": (64, 64), "conv2b": (64, 64),
             "conv3a": (64, 128), "conv3b": (128, 128), "conv4a": (128, 128), "conv4b": (128, 128),
             "convPa": (128, 256), "convDa": (128, 256)}
        for name, (i, o) in c.items():
            setattr(self, name, nn.Conv2d(i, o, 3, padding=1))
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDb = nn.Conv2d(256, descriptor_dim, 1)

    def forward(self, x):
        """x (B, 1, H, W) in [0, 1], H and W multiples of 8 -> scores65
        (B, H/8, W/8, 65) and unit descriptors (B, H/8, W/8, D)."""
        y = x
        for block in (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b"), ("conv4a", "conv4b")):
            for name in block:
                y = F.relu(getattr(self, name)(y))
            if block[0] != "conv4a":
                y = F.max_pool2d(y, 2, 2)
        scores = self.convPb(F.relu(self.convPa(y)))
        desc = self.convDb(F.relu(self.convDa(y)))
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-8)
        return scores.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def postprocess_maps(scores65, desc_map, max_kps: int, nms_radius: int, threshold: float):
    """scores65 (B,Hc,Wc,65) -> (kps (B,K,2), scores (B,K), desc (B,K,D),
    valid (B,K)), K = min(max_kps, H·W) (the JAX package's _postprocess)."""
    B, Hc, Wc, _ = scores65.shape
    prob = torch.softmax(scores65, -1)[..., :64]
    heat = prob.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)
    heat = simple_nms(heat, nms_radius)
    H, W = Hc * 8, Wc * 8
    vals, idx = torch.topk(heat.reshape(B, -1), min(max_kps, H * W), dim=1)
    ys = torch.div(idx, W, rounding_mode="floor").float()
    xs = (idx % W).float()
    kps = torch.stack([xs, ys], -1)
    valid = vals > threshold
    # bilinear descriptor sampling at kp/8 on the coarse map
    gx = (xs + 0.5) / 8.0 - 0.5
    gy = (ys + 0.5) / 8.0 - 0.5
    x0 = torch.clamp(torch.floor(gx).long(), 0, Wc - 1)
    x1 = torch.clamp(x0 + 1, 0, Wc - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, Hc - 1)
    y1 = torch.clamp(y0 + 1, 0, Hc - 1)
    fx = torch.clamp(gx - x0, 0, 1)[..., None]
    fy = torch.clamp(gy - y0, 0, 1)[..., None]
    bidx = torch.arange(B, device=scores65.device)[:, None]
    d = (
        desc_map[bidx, y0, x0] * (1 - fx) * (1 - fy)
        + desc_map[bidx, y0, x1] * fx * (1 - fy)
        + desc_map[bidx, y1, x0] * (1 - fx) * fy
        + desc_map[bidx, y1, x1] * fx * fy
    )
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)
    return kps, vals, d, valid


class SuperPoint:
    """Host wrapper: gray images -> keypoints/scores/descriptors, on `device`."""

    default_conf = {
        "nms_radius": 4,
        "max_keypoints": 6000,
        "detection_threshold": 0.005,
        "resize_max": 1600,
        "weights_path": None,
    }
    detection_noise = 1.0  # px (reference superpoint.yaml)
    max_batch_pixels = 1 << 23  # pixels of one forward: conv1's activations then take 2 GiB

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)
        self.net = None
        wp = maybe_resolve(self.conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            check_state_dict(sd, "superpoint", where=str(wp))
            self.load_state_dict(sd)

    def load_state_dict(self, sd):
        net = SuperPointNet()
        net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()})
        self.net = net.to(self.device).eval()

    def init_random(self, seed=0):
        """Seeded weights (torch.nn.Conv2d's uniform bounds, an explicit
        generator); tests carry the JAX package's weights across instead."""
        g = torch.Generator().manual_seed(seed)
        net = SuperPointNet()
        with torch.no_grad():
            for name in CONVS:
                conv = getattr(net, name)
                bound = 1.0 / math.sqrt(conv.weight[0].numel())
                conv.weight.copy_(torch.rand(conv.weight.shape, generator=g) * 2 * bound - bound)
                conv.bias.copy_(torch.rand(conv.bias.shape, generator=g) * 2 * bound - bound)
        self.net = net.to(self.device).eval()

    def batch_fn(self):
        """(B, H, W) float32 tensor -> padded (kps, vals, desc, valid) with
        the leading batch axis: the images padded to multiples of 8, as
        many a forward as max_batch_pixels allows; keypoints outside the
        image are not valid."""
        assert self.net is not None, "load weights or call init_random() first"
        c = self.conf

        def fn(x):
            B, H, W = x.shape
            H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
            per_call = max(1, self.max_batch_pixels // (H8 * W8))
            outs = []
            for s in range(0, B, per_call):
                img = F.pad(x[s:s + per_call].float(), (0, W8 - W, 0, H8 - H))[:, None]
                with torch.no_grad():
                    scores65, desc_map = self.net(img)
                kps, vals, desc, valid = postprocess_maps(scores65, desc_map, c["max_keypoints"], c["nms_radius"],
                                                          c["detection_threshold"])
                outs.append((kps, vals, desc, valid & (kps[..., 0] < W) & (kps[..., 1] < H)))
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
        arrays (keypoints, scores, descriptors) an image."""
        x = torch.as_tensor(np.stack(images), dtype=torch.float32, device=self.device)
        outs = [t.cpu().numpy() for t in self.batch_fn()(x)]
        return [self.postprocess(o) for o in zip(*outs)]

    def __call__(self, image_gray: np.ndarray):
        """image_gray (H,W) float [0,1] -> keypoints in pixel coords, scores,
        descriptors."""
        return self.batch([image_gray])[0]
