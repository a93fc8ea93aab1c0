"""metric_depth_vit_{small,large,giant2}_800k.pth (``depth_model.`` keys) with
seeded weights at the configuration's widths: the reference's parameter
inventory (reference/metric3dv2.param_shapes, the official names and
shapes), each weight normal at its scale (0.02 for tokens and embeddings,
1/sqrt(fan_in) for the ViT's dense layers, 0.05 for the decoder's
convolutions), norms and LayerScale at 1, biases 0; drawn on the device."""

from __future__ import annotations

import torch


def state_dict(spec, device, reference):
    g = torch.Generator(device=device).manual_seed(spec["seed"])
    sd = {}
    for name, shape, kind, scale in reference.param_shapes(reference.conf_of(spec)):
        if kind == "w":
            v = torch.randn(shape, generator=g, device=device) * scale
        else:
            v = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
        sd["depth_model." + name] = v
    return sd
