"""Vision Transformer trunk with multi-depth feature hooks (port of
mpsfm_tpu/extraction/nets/vit.py).

The JAX package's Flax ViT as torch modules on channels-last tensors
(B, H, W, C), as there. Submodules carry the Flax names (``blocks_{i}``,
``mlp_fc1``, ...), so a Flax param tree maps onto the state dict name for
name (convert.flax_state_dict: Dense kernels transposed to (out, in), Conv
kernels HWIO to OIHW, LayerNorm scales to weights). Every LayerNorm has
Flax's epsilon, 1e-6, and the GELU is the exact one.

The attention is K4 (depth_anything.multi_head: attention with every key
real): on a CUDA tensor the hand-written float32 kernel
(csrc/attention.cu) for these nets' head width 64, on a CPU tensor its
plain version.

`vit_params_from_torch` maps timm/DINOv2-style naming (patch_embed.proj,
blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}, norm) onto the
module's names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mpsfm_tpu_torch.extraction.nets.depth_anything import _conv, _resize, multi_head

LN_EPS = 1e-6  # flax.linen.LayerNorm's


def layer_norm(dim):
    return nn.LayerNorm(dim, eps=LN_EPS)


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):  # (B, N, D)
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, D // H)
        y = multi_head(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(y.reshape(B, N, D))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class ViT(nn.Module):
    """Patch-embed ViT with multi-depth feature hooks.

    forward(x (B,H,W,3)) -> list of (B, h, w, D) feature maps at `hooks`
    depths (after the block, before the final norm; the last hook gets
    the final LayerNorm, the DPT convention). The learned position
    embedding over a pos_grid² base grid is resized bilinearly to (h, w)
    without antialiasing (timm's F.interpolate)."""

    def __init__(self, dim=384, depth=12, num_heads=6, patch=16, hooks=(2, 5, 8, 11), with_cls=True, pos_grid=24):
        super().__init__()
        self.dim, self.depth, self.patch, self.hooks, self.with_cls = dim, depth, patch, tuple(hooks), with_cls
        self.patch_embed = nn.Conv2d(3, dim, patch, patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid, pos_grid, dim))
        if with_cls:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}", Block(dim, num_heads))
        self.norm = layer_norm(dim)

    def forward(self, x):
        B, H, W, _ = x.shape
        h, w = H // self.patch, W // self.patch
        y = _conv(x, self.patch_embed.weight, self.patch_embed.bias, stride=self.patch, pad="VALID")
        y = y.reshape(B, h * w, self.dim)
        pos = self.pos_embed
        if (h, w) != tuple(pos.shape[1:3]):
            pos = _resize(pos, (h, w))
        y = y + pos.reshape(1, h * w, self.dim)
        if self.with_cls:
            y = torch.cat([self.cls_token.expand(B, 1, self.dim), y], 1)
        feats = []
        for i in range(self.depth):
            y = getattr(self, f"blocks_{i}")(y)
            if i in self.hooks:
                t = y[:, 1:] if self.with_cls else y
                if i == max(self.hooks):
                    t = self.norm(t)
                feats.append(t.reshape(B, h, w, self.dim))
        return feats


def init_seeded(module: nn.Module, seed=0):
    """Seeded weights for a module of these nets, drawn by a CPU
    torch.Generator in the order of its state dict: Linear and Conv
    weights normal with variance 1/fan_in (Flax's lecun_normal, without its
    truncation), biases 0, LayerNorm weights 1, position embeddings and
    class tokens normal(0.02) (the JAX package's initializers). The JAX
    package draws from a Flax PRNGKey, which the port cannot reproduce:
    tests carry the JAX weights across by convert.flax_state_dict."""
    g = torch.Generator().manual_seed(seed)
    norms = {name for name, m in module.named_modules() if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner, leaf = name.rpartition(".")[::2]
            if leaf == "bias":
                p.zero_()
            elif owner in norms:
                p.fill_(1.0)
            elif leaf in ("pos_embed", "cls_token"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * float(np.prod(p.shape[1:])) ** -0.5)
    return module


def vit_params_from_torch(sd, depth=12, prefix="") -> dict:
    """timm/DINOv2-style state dict -> the ViT module's state dict (float32
    CPU tensors, without `prefix`): patch_embed.proj -> patch_embed,
    blocks.N.mlp.fcK -> blocks_N.mlp_fcK, the position embedding without its
    class row reshaped to its (1, side, side, D) grid."""
    g = lambda k: torch.as_tensor(np.asarray(sd[prefix + k], np.float32))  # noqa: E731
    out = {"patch_embed.weight": g("patch_embed.proj.weight"), "patch_embed.bias": g("patch_embed.proj.bias"),
           "norm.weight": g("norm.weight"), "norm.bias": g("norm.bias")}
    pe = g("pos_embed")  # (1, 1+N or N, D)
    n = pe.shape[1]
    side = int(np.sqrt(n))
    if prefix + "cls_token" in sd:
        out["cls_token"] = g("cls_token")
        if int(np.sqrt(n - 1)) ** 2 == n - 1:
            side = int(np.sqrt(n - 1))
            pe = pe[:, 1:]
    out["pos_embed"] = pe[:, : side * side].reshape(1, side, side, -1)
    names = {"norm1": "norm1", "norm2": "norm2", "attn.qkv": "attn.qkv", "attn.proj": "attn.proj",
             "mlp.fc1": "mlp_fc1", "mlp.fc2": "mlp_fc2"}
    for i in range(depth):
        for src, dst in names.items():
            for leaf in ("weight", "bias"):
                out[f"blocks_{i}.{dst}.{leaf}"] = g(f"blocks.{i}.{src}.{leaf}")
    return out
