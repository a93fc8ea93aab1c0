"""DPT dense-prediction decoder (port of mpsfm_tpu/extraction/nets/dpt.py).

Per-hook reassembly to a feature pyramid, residual fusion upsampling and
task heads, as torch modules on channels-last tensors with the JAX
package's Flax module names. Convolutions pad as XLA's 'SAME' does
(depth_anything._conv); every resize is bilinear with half-pixel centres,
which is jax.image.resize's for the upsamplings these modules make (its
antialiasing acts on downscales only).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from mpsfm_tpu_torch.extraction.nets.depth_anything import _conv, _resize


class Conv(nn.Conv2d):
    """A Flax nn.Conv: channels last, XLA's 'SAME' padding, stride 1 unless given."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride)

    def forward(self, x):
        return _conv(x, self.weight, self.bias, stride=self.stride[0])


class ResidualConvUnit(nn.Module):
    def __init__(self, feat):
        super().__init__()
        self.conv1 = Conv(feat, feat, 3)
        self.conv2 = Conv(feat, feat, 3)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    def __init__(self, feat, skip=True):
        super().__init__()
        if skip:
            self.rcu1 = ResidualConvUnit(feat)
        self.rcu2 = ResidualConvUnit(feat)
        self.project = Conv(feat, feat, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            if x.shape[1:3] != skip.shape[1:3]:  # odd grids: align to the skip's resolution before adding
                x = _resize(x, tuple(skip.shape[1:3]))
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = _resize(x, (x.shape[1] * 2, x.shape[2] * 2))
        return self.project(x)


class DPTDecoder(nn.Module):
    """hooks (list of (B,h,w,D)) -> (B, h*8, w*8, feat) fused feature map.
    `scales`: each hook's resample factor (> 1 up, < -1 average-pooled down)."""

    def __init__(self, dim, feat=128, scales=(4, 2, 1, -2)):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(len(self.scales)):
            self.add_module(f"read_{i}", Conv(dim, feat, 1))
            self.add_module(f"proj_{i}", Conv(feat, feat, 3))
        self.fuse_3 = FusionBlock(feat, skip=False)
        for i in (2, 1, 0):
            self.add_module(f"fuse_{i}", FusionBlock(feat))

    def forward(self, feats):
        if len(feats) != len(self.scales):
            raise ValueError(f"DPTDecoder: {len(feats)} hooks for {len(self.scales)} scales")
        pyr = []
        for i, (f, s) in enumerate(zip(feats, self.scales)):
            y = getattr(self, f"read_{i}")(f)
            if s > 1:
                y = _resize(y, (y.shape[1] * s, y.shape[2] * s))
            elif s < -1:
                y = F.avg_pool2d(y.permute(0, 3, 1, 2), -s).permute(0, 2, 3, 1)
            pyr.append(getattr(self, f"proj_{i}")(y))
        x = self.fuse_3(pyr[3])
        x = self.fuse_2(x, pyr[2])
        x = self.fuse_1(x, pyr[1])
        return self.fuse_0(x, pyr[0])


class Head(nn.Module):
    def __init__(self, out, feat=128):
        super().__init__()
        self.conv1 = Conv(feat, feat // 2, 3)
        self.conv2 = Conv(feat // 2, 32, 3)
        self.out = Conv(32, out, 1)

    def forward(self, x):
        return self.out(F.relu(self.conv2(F.relu(self.conv1(x)))))
