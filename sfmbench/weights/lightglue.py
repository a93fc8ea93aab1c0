"""superpoint_lightglue.pth (the post-rename layout, transformers.{l}.*)
with seeded weights that make matches reach the mapper: every dense layer
normal with std 1/sqrt(fan_in) and zero bias, Wr normal, norms at 1 and 0;
then each block's last FFN layer (ffn.3) zeroed, so that a block returns
its input, input_proj the identity, final_proj 80·I and matchability 1
(weight 0, bias 10), so that the descriptors reach the dual softmax
unchanged. A plain seeded draw puts every score near 1/N² and keeps no
match. The attention still runs, at full width, in every block."""

from __future__ import annotations

import torch


def state_dict(spec, device, reference=None):
    D, H, L = spec.get("dim", 256), spec.get("num_heads", 4), spec.get("n_layers", 9)
    g = torch.Generator(device=device).manual_seed(spec["seed"])
    sd = {}

    def dense(name, i, o):
        sd[name + ".weight"] = torch.randn((o, i), generator=g, device=device) * i**-0.5
        sd[name + ".bias"] = torch.zeros(o, device=device)

    sd["input_proj.weight"] = torch.eye(D, device=device)
    sd["input_proj.bias"] = torch.zeros(D, device=device)
    sd["posenc.Wr.weight"] = torch.randn((D // H // 2, 2), generator=g, device=device)
    for l in range(L):
        for blk, parts in (("self_attn", (("Wqkv", 3 * D), ("out_proj", D))),
                           ("cross_attn", (("to_qk", D), ("to_v", D), ("to_out", D)))):
            base = f"transformers.{l}.{blk}"
            for name, o in parts:
                dense(f"{base}.{name}", D, o)
            dense(f"{base}.ffn.0", 2 * D, 2 * D)
            sd[f"{base}.ffn.1.weight"] = torch.ones(2 * D, device=device)
            sd[f"{base}.ffn.1.bias"] = torch.zeros(2 * D, device=device)
            sd[f"{base}.ffn.3.weight"] = torch.zeros((D, 2 * D), device=device)
            sd[f"{base}.ffn.3.bias"] = torch.zeros(D, device=device)
    la = f"log_assignment.{L - 1}"
    sd[la + ".final_proj.weight"] = 80 * torch.eye(D, device=device)
    sd[la + ".final_proj.bias"] = torch.zeros(D, device=device)
    sd[la + ".matchability.weight"] = torch.zeros((1, D), device=device)
    sd[la + ".matchability.bias"] = torch.full((1,), 10.0, device=device)
    return sd
