"""Dense warp regressor, RoMa class (port of
mpsfm_tpu/extraction/nets/warp.py).

Coarse features from a shared strided conv encoder, a global correlation
volume at /8 decoded into a soft-argmax warp and a certainty, then
convolutional refiners at /8 and /4 on [features, warp, certainty]: a
dense warp A -> B in B's /4 pixel grid and a per-pixel certainty. Torch
modules on channels-last tensors under the JAX package's Flax names. The
stride-2 convolutions pad as XLA's 'SAME' does (the odd pixel on the
bottom and right).

Weights: a torch state dict in the port's module names
(convert.warp_state_dict writes one from the JAX package's params); the
JAX package's Flax msgpack files are refused naming the format. Without
weights the net is drawn from a seeded torch.Generator (vit.init_seeded).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.nets.depth_anything import _resize
from mpsfm_tpu_torch.extraction.nets.dpt import Conv
from mpsfm_tpu_torch.extraction.nets.two_view import load_torch_state, padded_pair, prep_rgb
from mpsfm_tpu_torch.extraction.nets.vit import init_seeded


class ConvEncoder(nn.Module):
    """Strided conv pyramid: features at /4 and /8."""

    def __init__(self, feat=64):
        super().__init__()
        f2 = feat // 2
        self.c1, self.c2 = Conv(3, f2, 3, stride=2), Conv(f2, f2, 3)
        self.c3, self.c4 = Conv(f2, feat, 3, stride=2), Conv(feat, feat, 3)
        self.c5, self.c6 = Conv(feat, feat, 3, stride=2), Conv(feat, feat, 3)

    def forward(self, x):
        y = F.relu(self.c2(F.relu(self.c1(x))))
        y4 = F.relu(self.c4(F.relu(self.c3(y))))
        y8 = F.relu(self.c6(F.relu(self.c5(y4))))
        return y4, y8


class WarpNet(nn.Module):
    def __init__(self, feat=64):
        super().__init__()
        self.encoder = ConvEncoder(feat)
        self.ref8_1, self.ref8_2, self.ref8_out = Conv(feat + 3, feat, 3), Conv(feat, feat, 3), Conv(feat, 3, 3)
        self.ref4_1, self.ref4_2, self.ref4_out = Conv(feat + 3, feat, 3), Conv(feat, feat, 3), Conv(feat, 3, 3)

    def forward(self, imA, imB):  # (B,H,W,3) -> warp (B,H/4,W/4,2) px in B, certainty
        B = imA.shape[0]
        a4, a8 = self.encoder(imA)
        _, b8 = self.encoder(imB)
        h8, w8 = a8.shape[1:3]
        fa, fb = a8.reshape(B, h8 * w8, -1), b8.reshape(B, h8 * w8, -1)
        fa = fa / torch.clamp(torch.linalg.vector_norm(fa, dim=-1, keepdim=True), min=1e-8)
        fb = fb / torch.clamp(torch.linalg.vector_norm(fb, dim=-1, keepdim=True), min=1e-8)
        corr = fa @ fb.transpose(1, 2)  # (B, na, nb)
        w_soft = torch.softmax(corr * 10.0, -1)
        yy, xx = torch.meshgrid(torch.arange(h8, device=imA.device), torch.arange(w8, device=imA.device),
                                indexing="ij")
        coords = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).to(imA.dtype)  # (nb, 2), soft-argmax targets
        tgt = (w_soft @ coords).reshape(B, h8, w8, 2)
        peak = corr.max(-1).values.reshape(B, h8, w8, 1)
        r = F.relu(self.ref8_1(torch.cat([a8, tgt, peak], -1)))
        d8 = self.ref8_out(F.relu(self.ref8_2(r)))  # dxy + logit
        warp8, cert8 = tgt + d8[..., :2], d8[..., 2:]
        hw4 = tuple(a4.shape[1:3])
        warp4, cert4 = _resize(warp8 * 2.0, hw4), _resize(cert8, hw4)
        r = F.relu(self.ref4_1(torch.cat([a4, warp4, cert4], -1)))
        d4 = self.ref4_out(F.relu(self.ref4_2(r)))
        return warp4 + d4[..., :2], torch.sigmoid(cert4 + d4[..., 2:])[..., 0]


class WarpMatcher:
    """Dense-matcher interface around WarpNet on `device`: a pair of images
    -> dense keypoints of A's /4 grid, their warp into B and certainties
    (the '/4 grid -> full-resolution pixel' convention of the reference's
    RoMa to-pixel step)."""

    default_conf = {
        "feat": 64,
        "certainty_threshold": 0.5,
        "max_matches": 4096,
        "weights_path": None,
    }

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)
        self.net = WarpNet(feat=self.conf["feat"])
        if self.conf["weights_path"]:
            sd = load_torch_state(self.conf["weights_path"])
            self.net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()})
        else:
            init_seeded(self.net, 0)
        self.net.to(self.device).eval()

    def __call__(self, imgA, imgB):
        A, B = prep_rgb(imgA), prep_rgb(imgB)
        xa, xb = padded_pair(A, B, 32, self.device)
        with torch.no_grad():
            warp, cert = self.net(xa, xb)
        warp, cert = warp[0].cpu().numpy(), cert[0].cpu().numpy()  # warp in B's /4 grid
        h4, w4 = warp.shape[:2]
        ys, xs = np.meshgrid(np.arange(h4), np.arange(w4), indexing="ij")
        kA = np.stack([xs * 4 + 1.5, ys * 4 + 1.5], -1).reshape(-1, 2)
        kB = warp.reshape(-1, 2) * 4.0 + 1.5
        c = cert.reshape(-1)
        keep = ((c > self.conf["certainty_threshold"])
                & (kA[:, 0] < A.shape[1]) & (kA[:, 1] < A.shape[0])
                & (kB[:, 0] >= 0) & (kB[:, 0] < B.shape[1])
                & (kB[:, 1] >= 0) & (kB[:, 1] < B.shape[0]))
        idx = np.where(keep)[0]
        if len(idx) > self.conf["max_matches"]:
            idx = idx[np.argsort(-c[idx])[: self.conf["max_matches"]]]
        return {"keypoints0": kA[idx], "keypoints1": kB[idx], "certainty": c[idx]}
