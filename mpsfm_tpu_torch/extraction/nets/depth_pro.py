"""DepthPro, Apple's metric monocular depth net (port of
mpsfm_tpu/extraction/nets/depth_pro.py).

A DINOv2 ViT-L/14 at 384 runs over a 3-level pyramid of overlapping
384² patches of the 1536² input (1 + 9 + 25 patches at ratios 0.25 / 0.5 /
1 with overlaps 0 / 0.5 / 0.25, one batched forward), a second one over the
whole image at 384² and a third, the FOV encoder, over the same image; the
merged multi-scale feature maps go through the neck's deconvolutions and a
DPT-style fusion to a canonical inverse-depth map, and the FOV head to a
field of view. Metric depth = f_px / (W · inverse depth), f_px from the
intrinsics or from the FOV head. Tensors are channels last (B, H, W, C), as
in the JAX package; every resize is depth_anything._resize's static
separable matrices and the patch split and merge are static slices.

Parameters keep the HuggingFace ``DepthProForDepthEstimation`` naming
(apple/DepthPro-hf), flat, float32 on the net's device; a checkpoint in that
naming loads as it is (``mask_token`` and ``num_batches_tracked`` dropped),
manifest-checked at the official size. `init_random` draws seeded weights
from a torch.Generator over `param_specs` (the official names and shapes
for the conf), without `transformers`, which the JAX package's draws through.

Every attention is K4 (depth_anything.multi_head: the hand-written float32
kernel csrc/attention.cu on a CUDA tensor, heads of 64; its plain version on
a CPU tensor): 24 calls a ViT, 72 a forward with the FOV head. The JAX
package keeps all 25 hidden states of the patch encoder (2.6 GB at full
width); the port keeps the intermediate hooks' states of the scale-1
patches and the final one only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.manifest import check_state_dict
from mpsfm_tpu_torch.extraction.nets.depth_anything import IMAGENET_MEAN, IMAGENET_STD, _conv, _ln, _resize, multi_head
from mpsfm_tpu_torch.extraction.nets.roma import _Clock
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

MODEL_CONFIG = {
    # the ViT shared by the patch, image and FOV encoders (Apple's ViT-L/14 at 384)
    "dim": 1024,
    "depth": 24,
    "heads": 16,
    "vit_image_size": 384,
    "vit_patch": 14,
    # the multi-scale pyramid
    "patch_size": 384,
    "scaled_images_ratios": (0.25, 0.5, 1.0),
    "scaled_images_overlap_ratios": (0.0, 0.5, 0.25),
    "scaled_images_feature_dims": (1024, 1024, 512),
    "intermediate_hook_ids": (11, 5),
    "intermediate_feature_dims": (256, 256),
    "merge_padding_value": 3,
    "fusion_hidden_size": 256,
    "use_fov_model": True,
    "num_fov_head_layers": 2,
    "image_size": 1536,  # the network's input resolution
}
ENCODERS = ("depth_pro.encoder.patch_encoder.model.", "depth_pro.encoder.image_encoder.model.",
            "fov_model.fov_encoder.model.")


def _vit_specs(prefix, c):
    D, P = c["dim"], c["vit_patch"]
    grid = c["vit_image_size"] // P
    s = [(prefix + "embeddings.cls_token", (1, 1, D)), (prefix + "embeddings.mask_token", (1, D)),
         (prefix + "embeddings.patch_embeddings.projection.bias", (D,)),
         (prefix + "embeddings.patch_embeddings.projection.weight", (D, 3, P, P)),
         (prefix + "embeddings.position_embeddings", (1, 1 + grid * grid, D))]
    for i in range(c["depth"]):
        b = f"{prefix}encoder.layer.{i}."
        for name in ("attention.attention.query", "attention.attention.key", "attention.attention.value",
                     "attention.output.dense"):
            s += [(b + name + ".weight", (D, D)), (b + name + ".bias", (D,))]
        s += [(b + "layer_scale1.lambda1", (D,)), (b + "layer_scale2.lambda1", (D,)),
              (b + "mlp.fc1.weight", (4 * D, D)), (b + "mlp.fc1.bias", (4 * D,)),
              (b + "mlp.fc2.weight", (D, 4 * D)), (b + "mlp.fc2.bias", (D,))]
        for n in ("norm1", "norm2"):
            s += [(b + n + ".weight", (D,)), (b + n + ".bias", (D,))]
    return s + [(prefix + "layernorm.weight", (D,)), (prefix + "layernorm.bias", (D,))]


def param_specs(c):
    """The official parameters of conf `c` (HF naming, mask tokens included,
    as in a checkpoint): a list of (name, shape). At MODEL_CONFIG it is the
    pinned manifest, key for key."""
    D, Fh = c["dim"], c["fusion_hidden_size"]
    sdims, idims = tuple(c["scaled_images_feature_dims"]), tuple(c["intermediate_feature_dims"])
    specs = []
    for prefix in ENCODERS if c["use_fov_model"] else ENCODERS[:2]:
        specs += _vit_specs(prefix, c)
    nk = "depth_pro.neck."
    specs += [(nk + "feature_upsample.image_block.layers.0.weight", (D, sdims[0], 2, 2)),
              (nk + "feature_upsample.image_block.layers.0.bias", (sdims[0],))]
    for i, f in enumerate(sdims):
        specs += [(f"{nk}feature_upsample.scaled_images.{i}.layers.0.weight", (f, D, 1, 1)),
                  (f"{nk}feature_upsample.scaled_images.{i}.layers.1.weight", (f, f, 2, 2))]
    for i, f in enumerate(idims):
        mid = Fh if i == 0 else f
        specs.append((f"{nk}feature_upsample.intermediate.{i}.layers.0.weight", (mid, D, 1, 1)))
        for j in range(2 + i):
            cin = mid if j == 0 else f  # ConvTranspose2d weights are (in, out, k, k)
            specs.append((f"{nk}feature_upsample.intermediate.{i}.layers.{j + 1}.weight", (cin, f, 2, 2)))
    specs += [(nk + "fuse_image_with_low_res.weight", (sdims[0], 2 * sdims[0], 1, 1)),
              (nk + "fuse_image_with_low_res.bias", (sdims[0],))]
    dims = sdims + idims
    for i, f in enumerate(dims):
        if not (i == len(dims) - 1 and f == Fh):  # the last projection is the identity when the widths agree
            specs.append((f"{nk}feature_projection.projections.{i}.weight", (Fh, f, 3, 3)))
    n_fusion = len(c["intermediate_hook_ids"]) + len(c["scaled_images_ratios"])
    for i in range(n_fusion):
        pre = "fusion_stage.final." if i == n_fusion - 1 else f"fusion_stage.intermediate.{i}."
        for r in ("residual_layer1", "residual_layer2"):
            for conv in ("convolution1", "convolution2"):
                specs += [(f"{pre}{r}.{conv}.weight", (Fh, Fh, 3, 3)), (f"{pre}{r}.{conv}.bias", (Fh,))]
        if i != n_fusion - 1:
            specs.append((pre + "deconv.weight", (Fh, Fh, 2, 2)))
        specs += [(pre + "projection.weight", (Fh, Fh, 1, 1)), (pre + "projection.bias", (Fh,))]
    specs += [("head.layers.0.weight", (Fh // 2, Fh, 3, 3)), ("head.layers.0.bias", (Fh // 2,)),
              ("head.layers.1.weight", (Fh // 2, Fh // 2, 2, 2)), ("head.layers.1.bias", (Fh // 2,)),
              ("head.layers.2.weight", (32, Fh // 2, 3, 3)), ("head.layers.2.bias", (32,)),
              ("head.layers.4.weight", (1, 32, 1, 1)), ("head.layers.4.bias", (1,))]
    if c["use_fov_model"]:
        specs += [("fov_model.fov_encoder.neck.weight", (Fh // 2, D)), ("fov_model.fov_encoder.neck.bias", (Fh // 2,)),
                  ("fov_model.conv.weight", (Fh // 2, Fh, 3, 3)), ("fov_model.conv.bias", (Fh // 2,))]
        n = c["num_fov_head_layers"]
        for i in range(n):
            cin, cout = math.ceil(Fh / 2 ** (i + 1)), math.ceil(Fh / 2 ** (i + 2))
            specs += [(f"fov_model.head.layers.{2 * i}.weight", (cout, cin, 3, 3)),
                      (f"fov_model.head.layers.{2 * i}.bias", (cout,))]
        k = int((c["vit_image_size"] // c["vit_patch"] - 1) / 2 ** n + 1)
        specs += [(f"fov_model.head.layers.{2 * n}.weight", (1, math.ceil(Fh / 2 ** (n + 1)), k, k)),
                  (f"fov_model.head.layers.{2 * n}.bias", (1,))]
    return specs


def draw(name, shape, g, device):
    """One seeded parameter: biases 0, LayerNorm weights and LayerScales 1,
    class tokens and position embeddings normal(0.02), every other weight
    normal / sqrt(its fan in, the product of its dimensions after the
    first), so that activations keep their scale through the depth."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return torch.zeros(shape, device=device)
    if leaf == "lambda1" or (leaf == "weight" and len(shape) == 1):
        return torch.ones(shape, device=device)
    if leaf in ("cls_token", "mask_token", "position_embeddings"):
        return 0.02 * torch.randn(shape, generator=g, device=device)
    return torch.randn(shape, generator=g, device=device) * float(np.prod(shape[1:])) ** -0.5


def _deconv(x, w_iohw, b=None):
    """ConvTranspose2d with kernel == stride == 2 (pure pixel expansion)."""
    B, h, w, _ = x.shape
    y = torch.einsum("bhwc,copq->bhpwqo", x, w_iohw).reshape(B, h * 2, w * 2, w_iohw.shape[1])
    return y if b is None else y + b


class DepthPro:
    """DepthPro on `device`. Params: a flat dict of HF names -> tensors.
    Conf: MODEL_CONFIG's keys (tests' tiny nets override the widths) and
    weights_path (a file or a registry name)."""

    def __init__(self, conf=None, device="cuda"):
        conf = dict(conf or {})
        self.conf = {**MODEL_CONFIG, **{k: v for k, v in conf.items() if k in MODEL_CONFIG}}
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            if "state_dict" in sd:
                sd = sd["state_dict"]
            if all(self.conf[k] == v for k, v in MODEL_CONFIG.items()):  # the manifest check at the official size
                check_state_dict(sd, "depthpro", where=str(wp))
            self.params = self.params_from_torch_state_dict(sd)

    # ------------------------------------------------------------- params
    def params_from_torch_state_dict(self, sd):
        """HF-named state dict -> float32 tensors on the device, without the
        mask tokens and BatchNorm counters."""
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device) for k, v in sd.items()
                if "mask_token" not in k and "num_batches_tracked" not in k}

    def init_random(self, seed=0):
        """Seeded params under the HF names (`draw`, a torch.Generator on the
        net's device, in param_specs' order)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.params = {name: draw(name, shape, g, self.device) for name, shape in param_specs(self.conf)
                       if "mask_token" not in name}
        return self.params

    # ------------------------------------------------------------- dinov2
    def _vit(self, p, prefix, x, keep=(), keep_rows=None):
        """HF Dinov2Model on (B, S, S, 3) at its native size: the hidden states
        after the blocks in `keep` (0 = the embeddings; their first keep_rows
        batch rows) and the final LayerNorm of the last state."""
        c = self.conf
        D, H, P = c["dim"], c["heads"], c["vit_patch"]
        B, S = x.shape[0], x.shape[1]
        h = w = S // P
        # HF's patch embedding is a VALID conv: 384 px / 14 -> 27 tokens, the trailing 6 px dropped
        tok = _conv(x[:, : h * P, : w * P], p[prefix + "embeddings.patch_embeddings.projection.weight"],
                    p[prefix + "embeddings.patch_embeddings.projection.bias"], stride=P, pad="VALID")
        tok = tok.reshape(B, h * w, D)
        pe = p[prefix + "embeddings.position_embeddings"]
        if (h, w) != (math.isqrt(pe.shape[1] - 1),) * 2:
            raise ValueError(f"DepthPro: its ViTs run at their native size, not {S}")
        tok = torch.cat([p[prefix + "embeddings.cls_token"].expand(B, 1, D), tok], 1) + pe
        states = {0: tok[:keep_rows]} if 0 in keep else {}
        hd = D // H
        for i in range(c["depth"]):
            b = f"{prefix}encoder.layer.{i}."
            y = _ln(tok, p[b + "norm1.weight"], p[b + "norm1.bias"])
            q, k, v = (
                (y @ p[f"{b}attention.attention.{n}.weight"].T + p[f"{b}attention.attention.{n}.bias"]).reshape(
                    B, -1, H, hd) for n in ("query", "key", "value"))
            y = multi_head(q, k, v).reshape(B, -1, D)
            y = y @ p[b + "attention.output.dense.weight"].T + p[b + "attention.output.dense.bias"]
            tok = tok + y * p[b + "layer_scale1.lambda1"]
            y = _ln(tok, p[b + "norm2.weight"], p[b + "norm2.bias"])
            y = F.gelu(y @ p[b + "mlp.fc1.weight"].T + p[b + "mlp.fc1.bias"])
            tok = tok + (y @ p[b + "mlp.fc2.weight"].T + p[b + "mlp.fc2.bias"]) * p[b + "layer_scale2.lambda1"]
            if i + 1 in keep:
                states[i + 1] = tok[:keep_rows]
        return states, _ln(tok, p[prefix + "layernorm.weight"], p[prefix + "layernorm.bias"])

    # ---------------------------------------------------------- patching
    @staticmethod
    def _split_to_patches(x, patch, overlap):
        """(B,H,W,C) -> (n_patches*B, patch, patch, C) in torch-unfold order
        (row-major patch grid, the patch index major over the batch)."""
        _, H, W, _ = x.shape
        if H == W == patch:
            return x
        stride = int(patch * (1 - overlap))
        return torch.cat([x[:, i: i + patch, j: j + patch] for i in range(0, H - patch + 1, stride)
                          for j in range(0, W - patch + 1, stride)], 0)

    @staticmethod
    def _merge_patches(patches, batch_size, padding):
        """The inverse of _split_to_patches on feature maps (B-major blocks),
        `padding` pixels cropped from the interior merge edges."""
        n, h, w, _ = patches.shape
        if n == batch_size:
            return patches
        s = math.isqrt(n // batch_size)
        rows = []
        for r in range(s):
            cols = []
            for col in range(s):
                i = r * s + col
                box = patches[batch_size * i: batch_size * (i + 1)]
                top, bot = (padding if r != 0 else 0), (padding if r != s - 1 else 0)
                left, right = (padding if col != 0 else 0), (padding if col != s - 1 else 0)
                cols.append(box[:, top: h - bot, left: w - right])
            rows.append(torch.cat(cols, 2))
        return torch.cat(rows, 1)

    def _reconstruct(self, tokens, batch_size, padding, out_hw):
        """(n*B, 1+S², D) tokens -> (B, out_h, out_w, D) feature map."""
        n, seq, D = tokens.shape
        size = math.isqrt(seq)
        feats = tokens[:, -(size * size):].reshape(n, size, size, D)
        return _resize(self._merge_patches(feats, batch_size, padding), out_hw)

    # ------------------------------------------------------------ forward
    def forward(self, x, p=None, times=None):
        """x (B, image_size, image_size, 3) ImageNet-normalized ->
        (inverse depth (B, S, S), field of view in degrees (B,) or None).
        `times`, a dict, gets each stage's host seconds after a synchronize:
        the patch encoder, the image encoder, the decoder (neck, fusion,
        head), the FOV head (its encoder included)."""
        p = self.params if p is None else p
        c = self.conf
        clock = _Clock(x.device, times)
        B, S = x.shape[0], x.shape[1]
        ratios = c["scaled_images_ratios"]
        out_size = c["vit_image_size"] // c["vit_patch"]
        n_scaled = len(ratios)

        # the patch encoder over the pyramid, one batched ViT forward, the full-resolution patches first
        scaled = [self._split_to_patches(_resize(x, (int(S * r), int(S * r))), c["patch_size"],
                                         c["scaled_images_overlap_ratios"][i]) for i, r in enumerate(ratios)]
        n_per = [t.shape[0] for t in scaled]
        hook_ids = c["intermediate_hook_ids"]
        states, final = self._vit(p, ENCODERS[0], torch.cat(scaled[::-1], 0), keep={h + 1 for h in hook_ids},
                                  keep_rows=n_per[-1])  # the hooks read the scale-1 patches only
        del scaled
        per_scale_last = torch.split(final, n_per[::-1], 0)[::-1]  # low resolution first
        exponent = int(math.log2(S / out_size))
        base = S // 2 ** exponent
        mpv = c["merge_padding_value"]
        feats = [self._reconstruct(per_scale_last[i], B, int(mpv / ratios[i]), (base * 2 ** i,) * 2)
                 for i in range(n_scaled)]
        side = base * 2 ** (n_scaled - 1)
        inter = [self._reconstruct(states[h + 1], B, int(mpv / ratios[-1]), (side, side)) for h in hook_ids]
        del states, final, per_scale_last
        clock("patch encoder")

        # the image encoder: the whole image at the ViT's size
        img = _resize(x, (c["vit_image_size"],) * 2)
        _, img_final = self._vit(p, ENCODERS[1], img)
        features = [self._reconstruct(img_final, B, 0, (base, base)), *feats, *inter]
        clock("image encoder")

        # the neck: upsample, fuse the image with the lowest scale, project
        nk = "depth_pro.neck.feature_upsample."
        features[0] = _deconv(features[0], p[nk + "image_block.layers.0.weight"], p[nk + "image_block.layers.0.bias"])
        for i in range(n_scaled):
            blk = f"{nk}scaled_images.{i}.layers."
            features[i + 1] = _deconv(features[i + 1] @ p[blk + "0.weight"][:, :, 0, 0].T, p[blk + "1.weight"])
        for i in range(len(hook_ids)):
            blk = f"{nk}intermediate.{i}.layers."
            y = features[n_scaled + i + 1] @ p[blk + "0.weight"][:, :, 0, 0].T
            for j in range(1, 2 + i + 1):
                y = _deconv(y, p[blk + f"{j}.weight"])
            features[n_scaled + i + 1] = y
        glob = _conv(torch.cat([features[1], features[0]], -1), p["depth_pro.neck.fuse_image_with_low_res.weight"],
                     p["depth_pro.neck.fuse_image_with_low_res.bias"])
        features = [glob, *features[2:]]
        projected = []
        for i, f in enumerate(features):
            key = f"depth_pro.neck.feature_projection.projections.{i}.weight"
            projected.append(_conv(f, p[key]) if key in p else f)

        # the DPT fusion, coarse to fine, a deconvolution a stage
        def rcu(prefix, t):
            y = _conv(F.relu(t), p[prefix + ".convolution1.weight"], p[prefix + ".convolution1.bias"])
            return t + _conv(F.relu(y), p[prefix + ".convolution2.weight"], p[prefix + ".convolution2.bias"])

        fused = None
        for i, f in enumerate(projected):
            last = i == len(projected) - 1
            pref = "fusion_stage.final" if last else f"fusion_stage.intermediate.{i}"
            y = f if fused is None else fused + rcu(pref + ".residual_layer1", f)
            y = rcu(pref + ".residual_layer2", y)
            if not last:
                y = _deconv(y, p[pref + ".deconv.weight"])
            fused = _conv(y, p[pref + ".projection.weight"], p[pref + ".projection.bias"])

        # the depth head
        y = _conv(fused, p["head.layers.0.weight"], p["head.layers.0.bias"])
        y = _deconv(y, p["head.layers.1.weight"], p["head.layers.1.bias"])
        y = F.relu(_conv(y, p["head.layers.2.weight"], p["head.layers.2.bias"]))
        inv_depth = F.relu(_conv(y, p["head.layers.4.weight"], p["head.layers.4.bias"]))[..., 0]
        clock("decoder")

        # the FOV head
        fov = None
        if c["use_fov_model"] and "fov_model.conv.weight" in p:
            _, fov_final = self._vit(p, ENCODERS[2], img)
            fov_tokens = fov_final @ p["fov_model.fov_encoder.neck.weight"].T + p["fov_model.fov_encoder.neck.bias"]
            y = self._reconstruct(fov_tokens, B, 0, (base, base))
            y = y + F.relu(_conv(projected[0], p["fov_model.conv.weight"], p["fov_model.conv.bias"], stride=2))
            y = _resize(y, (out_size, out_size))
            n = c["num_fov_head_layers"]
            for i in range(n):
                layer = f"fov_model.head.layers.{2 * i}."
                y = F.relu(_conv(y, p[layer + "weight"], p[layer + "bias"], stride=2))
            y = _conv(y, p[f"fov_model.head.layers.{2 * n}.weight"], p[f"fov_model.head.layers.{2 * n}.bias"],
                      pad="VALID")
            fov = y.reshape(B)
            clock("fov")
        return inv_depth, fov

    # ------------------------------------------------------------ host API
    def infer_image(self, image_rgb, f_px=None, times=None):
        """uint8/float HxWx3 -> dict(depth [m], fov_deg, f_px): the paper's
        canonical inverse depth made metric, depth = f_px / (W · inverse
        depth), f_px from the intrinsics or from the FOV head. `times` as
        forward's."""
        if self.params is None:
            raise ValueError("DepthPro: load weights or call init_random() first")
        img = np.asarray(image_rgb, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        H0, W0 = img.shape[:2]
        S = self.conf["image_size"]
        with torch.no_grad():
            x = _resize(torch.as_tensor((img - IMAGENET_MEAN) / IMAGENET_STD, device=self.device)[None], (S, S))
            inv_c, fov = self.forward(x, times=times)
            inv_c = _resize(inv_c[..., None], (H0, W0))[0, ..., 0].cpu().numpy()
        fov_deg = float(fov[0]) if fov is not None else None
        if f_px is None:
            f_px = 0.5 * W0 if fov_deg is None else 0.5 * W0 / math.tan(0.5 * math.radians(fov_deg))
        inv = inv_c * (W0 / f_px)
        return {"depth": 1.0 / np.clip(inv, 1e-4, 1e4), "fov_deg": fov_deg, "f_px": f_px}
