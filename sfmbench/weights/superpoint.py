"""superpoint_v1.pth (magicleap's layout) with seeded weights that make
matches reach the mapper: every convolution He-normal (std sqrt(2 / fan_in))
and, but the detector's last (convPb), zero-mean over each filter, so that
no response follows its input's mean; zero biases. A uniform draw loses the
image over the eight convolutions (its descriptors agree to a cosine of
0.9999 and no matcher tells them apart)."""

from __future__ import annotations

import torch

SHAPES = {"conv1a": (64, 1, 3), "conv1b": (64, 64, 3), "conv2a": (64, 64, 3), "conv2b": (64, 64, 3),
          "conv3a": (128, 64, 3), "conv3b": (128, 128, 3), "conv4a": (128, 128, 3), "conv4b": (128, 128, 3),
          "convPa": (256, 128, 3), "convPb": (65, 256, 1), "convDa": (256, 128, 3), "convDb": (256, 256, 1)}


def state_dict(spec, device, reference=None):
    g = torch.Generator(device=device).manual_seed(spec["seed"])
    sd = {}
    for name, (o, i, k) in SHAPES.items():
        w = torch.randn((o, i, k, k), generator=g, device=device) * (2 / (i * k * k)) ** 0.5
        sd[name + ".weight"] = w if name == "convPb" else w - w.mean((1, 2, 3), keepdim=True)
        sd[name + ".bias"] = torch.zeros(o, device=device)
    return sd
