"""The Pitts30K VGG16-NetVLAD in its torch export's layout (backbone.N for
the 13 convolutions of VGG16's trunk, netvlad.score_proj and
netvlad.centers, whiten 4096 × K·D, preproc_mean), seeded: convolutions
normal 0.05, assignments normal 0.1, centres normal 0.1, the whitening
normal with std 1/sqrt(K·D)."""

from __future__ import annotations

import torch

CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256), (12, 256, 256), (14, 256, 256),
         (17, 256, 512), (19, 512, 512), (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512)]


def state_dict(spec, device, reference=None):
    K, D = spec.get("K", 64), spec.get("D", 512)
    g = torch.Generator(device=device).manual_seed(spec["seed"])
    sd = {}
    for idx, i, o in CONVS:
        sd[f"backbone.{idx}.weight"] = torch.randn((o, i, 3, 3), generator=g, device=device) * 0.05
        sd[f"backbone.{idx}.bias"] = torch.zeros(o, device=device)
    sd["netvlad.score_proj.weight"] = torch.randn((K, D, 1), generator=g, device=device) * 0.1
    sd["netvlad.centers"] = torch.randn((D, K), generator=g, device=device) * 0.1
    sd["whiten.weight"] = torch.randn((4096, K * D), generator=g, device=device) * (K * D) ** -0.5
    sd["whiten.bias"] = torch.zeros(4096, device=device)
    sd["preproc_mean"] = torch.tensor([123.68, 116.779, 103.939], device=device)
    return sd
