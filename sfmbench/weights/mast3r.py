"""MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth's layout with seeded
weights at the configuration's widths (the reference's inventory,
reference/mast3r.param_shapes), drawn on the device as chip_smoke.py's
seeded_state_dict draws them so that activations keep their scale through
the nets' depth: every weight of two or more dimensions normal with std
1/sqrt(fan_in) (fan_in the product of its dimensions after the first),
norms 1, biases 0. The port's own draw (0.05 for every convolution) grows
the DPT heads' activations past float32's range on the pointmap's expm1."""

from __future__ import annotations

import math

import torch


def state_dict(spec, device, reference):
    g = torch.Generator(device=device).manual_seed(spec["seed"])
    sd = {}
    for name, shape, kind, _ in reference.param_shapes(reference.conf_of(spec)):
        if kind == "w" and len(shape) > 1:
            sd[name] = torch.randn(shape, generator=g, device=device) / math.sqrt(math.prod(shape[1:]))
        else:
            sd[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return sd
