"""Monocular metric depth + surface-normal net, the framework's own prior
(port of mpsfm_tpu/extraction/nets/mono.py).

MonoViT: the ViT trunk (nets/vit.py) with four hooks, the DPT decoder and
three heads (nets/dpt.py), torch modules on channels-last tensors under the
JAX package's Flax names (``trunk``, ``decoder``, ``depth_head``,
``normal_head``, ``conf_head``):

  * depth: softplus metric depth in the canonical-focal convention
    (predictions scale by f / f_canonical, like Metric3Dv2's);
  * normals: L2-normalised 3-vectors and a kappa concentration channel,
    kappa -> angular variance as the reference's DSINE wrapper does;
  * confidence: a sigmoid channel -> the relative depth std.

Its attention is K4 (depth_anything.multi_head): on a CUDA tensor the
hand-written float32 kernel, heads of 64 (the default 192 / 3) or of 48
(train_mono's default 96 / 2, attention_row_kernel<48>), on a CPU tensor the plain
version; with a gradient through K4's autograd Function.

`ViTMonoBackend` is the prior-backend interface: the image resized to the
processing resolution by OpenCV's INTER_AREA (guided_filter.resize_area, its
twin in torch: the card's host has no OpenCV), padded to the patch, the
optional flipped pass, the outputs brought back by INTER_LINEAR
(guided_filter.resize_linear). Weights: a torch state dict, in the port's
module names or in the timm-style naming `mono_params_from_torch` reads
(what train_mono.save_mono_params writes, and what the JAX package's
load_mono_params reads); the JAX package also reads Flax msgpack files,
which the port refuses naming the format. Without weights the backend
raises MissingWeightsError when called.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.guided_filter import resize_area, resize_linear
from mpsfm_tpu_torch.extraction.nets.depth_anything import _resize
from mpsfm_tpu_torch.extraction.nets.dpt import DPTDecoder, Head
from mpsfm_tpu_torch.extraction.nets.vit import ViT, vit_params_from_torch
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

HEADS = ("depth_head", "normal_head", "conf_head")


def kappa_to_alpha(kappa):
    """vMF concentration -> expected angular error in radians (DSINE's
    formula, the reference's dsine.py:22-23); numpy."""
    return (2 * kappa / (kappa**2 + 1)) + np.exp(-kappa * np.pi) * np.pi / (1 + np.exp(-kappa * np.pi))


class MonoViT(nn.Module):
    def __init__(self, dim=192, depth_blocks=6, num_heads=3, patch=16, feat=64):
        super().__init__()
        self.dim, self.depth_blocks, self.num_heads, self.patch, self.feat = dim, depth_blocks, num_heads, patch, feat
        d = depth_blocks
        hooks = tuple(sorted({d // 4, d // 2, (3 * d) // 4, d - 1}))
        self.trunk = ViT(dim, depth_blocks, num_heads, patch, hooks=hooks)
        self.decoder = DPTDecoder(dim, feat)
        self.depth_head = Head(1, feat)
        self.normal_head = Head(4, feat)
        self.conf_head = Head(1, feat)

    def forward(self, x):  # (B, H, W, 3) in [0, 1], H and W multiples of the patch
        feats = self.trunk(x)
        while len(feats) < 4:  # tiny trunks: the last hook repeated
            feats = feats + [feats[-1]]
        fused = _resize(self.decoder(feats), tuple(x.shape[1:3]))
        depth = F.softplus(self.depth_head(fused))[..., 0]
        nk = self.normal_head(fused)
        n = nk[..., :3]
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)
        kappa = F.softplus(nk[..., 3]) + 0.01
        conf = torch.sigmoid(self.conf_head(fused))[..., 0]
        return {"depth": depth, "normals": n, "kappa": kappa, "conf": conf}


class ViTMonoBackend:
    """Prior-backend interface around MonoViT on `device`: rgb -> {depth,
    depth_variance, normals, normals_variance, valid} (numpy, full
    resolution; depth2 etc. with flip_consistency).

    conf: weights_path (a torch state dict), canonical_focal,
    flip_consistency, resize_long (the processing resolution's long side:
    train-time and inference-time token grids share one position-embedding
    layout; depth values are resolution-invariant and the focal of the
    canonical-scale conversion is the resized one), depth_uncertainty,
    arch keys (dim, depth_blocks, num_heads, patch, feat)."""

    needs_image = True

    def __init__(self, conf=None, device="cuda"):
        from mpsfm_tpu_torch.extraction.priors import MissingWeightsError

        conf = dict(conf or {})
        self.conf = conf
        self.canonical_focal = float(conf.get("canonical_focal", 500.0))
        self.flip_consistency = bool(conf.get("flip_consistency", False))
        self.depth_uncertainty = conf.get("depth_uncertainty", 0.05)
        self.resize_long = conf.get("resize_long")
        self.device = resolve_device(device)
        self.net = MonoViT(dim=int(conf.get("dim", 192)), depth_blocks=int(conf.get("depth_blocks", 6)),
                           num_heads=int(conf.get("num_heads", 3)), patch=int(conf.get("patch", 16)),
                           feat=int(conf.get("feat", 64)))
        self._missing = None
        wp = conf.get("weights_path")
        try:
            wp = maybe_resolve(wp)
        except FileNotFoundError as e:
            wp, self._missing = None, MissingWeightsError(f"vit_mono: {e}")
        if wp and Path(wp).exists():
            self.net.load_state_dict(load_mono_params(wp, self.net))
        elif self._missing is None:
            self._missing = MissingWeightsError(
                "vit_mono has no weights: train them with train_mono.fit_scene_prior and name the file in "
                f"conf.weights_path (got {wp!r})")
        self.net.to(self.device).eval()

    def __call__(self, image_rgb, intrinsics=None, **kw):
        if self._missing is not None:
            raise self._missing
        img = np.asarray(image_rgb, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        H, W = img.shape[:2]
        f_scale = 1.0
        Hr, Wr = H, W
        if self.resize_long and max(H, W) != int(self.resize_long):
            f_scale = float(self.resize_long) / max(H, W)
            Wr, Hr = max(1, round(W * f_scale)), max(1, round(H * f_scale))
            img = resize_area(torch.as_tensor(img), (Hr, Wr)).numpy()
        p = self.net.patch
        Hp, Wp = ((Hr + p - 1) // p) * p, ((Wr + p - 1) // p) * p
        xb = np.zeros((1, Hp, Wp, 3), np.float32)
        xb[0, :Hr, :Wr] = img
        if self.flip_consistency:
            xb = np.concatenate([xb, xb[:, :, ::-1]], 0)
        with torch.no_grad():
            out = {k: v.cpu().numpy() for k, v in self.net(torch.as_tensor(xb, device=self.device)).items()}

        def up(a):
            """Processing resolution -> native (depth values are invariant)."""
            a = np.asarray(a, np.float64)
            if (Hr, Wr) == (H, W):
                return a
            return resize_linear(torch.as_tensor(np.ascontiguousarray(a, np.float32)), (H, W)).numpy().astype(
                np.float64)

        f = 0.5 * (float(intrinsics[0]) + float(intrinsics[1])) * f_scale if intrinsics is not None else None
        depth = up(out["depth"][0][:Hr, :Wr])
        normals = up(out["normals"][0][:Hr, :Wr])
        normals = normals / np.clip(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-8, None)
        kappa = up(out["kappa"][0][:Hr, :Wr])
        conf = up(out["conf"][0][:Hr, :Wr])
        if f is not None:
            depth = depth * (f / self.canonical_focal)
        result = {
            "depth": depth,
            "valid": depth > 0,
            # the model's confidence as a variance; the scene's Depth adds the proportional depth_uncertainty·d floor
            "depth_variance": np.square(depth * np.clip(1.0 - conf, 1e-3, None)),
            "normals": normals,
            # kappa -> angular variance alpha² (the reference's metric3dv2.py:117)
            "normals_variance": kappa_to_alpha(np.maximum(kappa, 1e-3)) ** 2,
        }
        if self.flip_consistency:
            d2 = up(out["depth"][1][:, ::-1][:Hr, :Wr])  # unflipped
            if f is not None:
                d2 = d2 * (f / self.canonical_focal)
            result["depth2"] = d2
            c2 = up(out["conf"][1][:, ::-1][:Hr, :Wr])
            result["depth_variance2"] = np.square(d2 * np.clip(1.0 - c2, 1e-3, None))
            n2 = up(out["normals"][1][:, ::-1][:Hr, :Wr]).copy()
            n2[..., 0] *= -1.0  # the x component mirrored back
            result["normals2"] = n2 / np.clip(np.linalg.norm(n2, axis=-1, keepdims=True), 1e-8, None)
            result["normals2_variance"] = kappa_to_alpha(np.maximum(up(out["kappa"][1][:, ::-1][:Hr, :Wr]), 1e-3)) ** 2
        return result


def load_mono_params(path, net: MonoViT):
    """A torch checkpoint -> MonoViT's state dict: the port's own module
    names as they are, timm-style naming through mono_params_from_torch. A
    Flax .msgpack or .flax file raises, naming the format."""
    p = Path(path)
    if p.suffix in (".msgpack", ".flax"):
        raise ValueError(f"{p}: a Flax {p.suffix} file; the port loads torch state dicts (.pth), e.g. "
                         "convert.mono_state_dict of the JAX package's params or train_mono.save_mono_params'")
    sd = torch.load(p, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "trunk.patch_embed.weight" in sd:
        return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return mono_params_from_torch(sd, depth=net.depth_blocks)


def head_names():
    """The decoder's and heads' parameter names (the same in both namings)."""
    convs = [f"decoder.{kind}_{i}" for i in range(4) for kind in ("read", "proj")]
    for i in range(4):
        rcus = ("rcu1", "rcu2") if i != 3 else ("rcu2",)
        convs += [f"decoder.fuse_{i}.{r}.conv{j}" for r in rcus for j in (1, 2)] + [f"decoder.fuse_{i}.project"]
    convs += [f"{h}.{c}" for h in HEADS for c in ("conv1", "conv2", "out")]
    return [f"{c}.{leaf}" for c in convs for leaf in ("weight", "bias")]


def mono_params_from_torch(sd, depth=6):
    """timm-style naming (trunk.* a timm ViT; decoder and heads mirrored 1:1)
    -> MonoViT's state dict of float32 CPU tensors."""
    out = {"trunk." + k: v for k, v in vit_params_from_torch(sd, depth=depth, prefix="trunk.").items()}
    out.update({k: torch.as_tensor(np.asarray(sd[k], np.float32)) for k in head_names()})
    return out
