"""DepthAnythingV2: DINOv2 + DPT head (port of
mpsfm_tpu/extraction/nets/depth_anything.py), and the resize and layer
helpers that Metric3Dv2, DSINE, RoMa, MASt3R and the ViT-DPT nets import
(its :50-131). Tensors are channels last (B, H, W, C), as in the JAX
package.

Every resize is a static separable interpolation matrix (one contraction
a side) replicating torch.nn.functional.interpolate's coordinates,
including DINOv2's position-embedding scale override.

`DepthAnythingV2` keeps its parameters under the OFFICIAL checkpoint names
(``pretrained.*`` for the DINOv2 backbone, ``depth_head.*`` for the DPT
decoder), so ``depth_anything_v2_{metric_*_,}vit{s,b,l}.pth`` state dicts
load directly; HuggingFace ``DepthAnythingForDepthEstimation`` naming is
renamed onto them (`_rename_hf`). As in the official repo: bicubic
position-embedding interpolation with DINOv2's 0.1 offset, LayerScale,
get_intermediate_layers(norm=True) (the final LayerNorm on every hooked
block), DPT fusion with per-stage target sizes and align-corners
upsampling, relative (ReLU) or metric (sigmoid · max_depth) heads. Its
attention is K4 (extraction/matchers/attention.attention with every key
real): on a CUDA tensor the hand-written float32 kernel (csrc/attention.cu,
heads 64 wide), on a CPU tensor its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.manifest import convert_checked
from mpsfm_tpu_torch.extraction.matchers.attention import attention
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

MODEL_CONFIGS = {
    "vits": dict(dim=384, depth=12, heads=6, hooks=(2, 5, 8, 11),
                 features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(dim=768, depth=12, heads=12, hooks=(2, 5, 8, 11),
                 features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(dim=1024, depth=24, heads=16, hooks=(4, 11, 17, 23),
                 features=256, out_channels=(256, 512, 1024, 1024)),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _cubic_kernel(x, a=-0.75):
    """torch bicubic kernel (a=-0.75)."""
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
    )


def _interp_matrix(n_src, n_dst, mode="bilinear", align_corners=False, scale=None):
    """(n_dst, n_src) separable interpolation matrix replicating
    torch.nn.functional.interpolate's coordinate conventions. `scale`
    overrides the implied scale factor (DINOv2's +0.1 offset trick)."""
    W = np.zeros((n_dst, n_src), np.float64)
    if n_dst == 1 or n_src == 1:
        W[:] = 1.0 / n_src if not align_corners else 0.0
        if align_corners:
            W[:, 0] = 1.0
        return W
    if align_corners:
        src = np.arange(n_dst) * (n_src - 1) / (n_dst - 1)
    else:
        s = scale if scale is not None else n_dst / n_src
        src = (np.arange(n_dst) + 0.5) / s - 0.5
    if mode == "bilinear":
        lo = np.floor(src).astype(int)
        frac = src - lo
        for j in range(n_dst):
            i0 = min(max(lo[j], 0), n_src - 1)
            i1 = min(max(lo[j] + 1, 0), n_src - 1)
            W[j, i0] += 1 - frac[j]
            W[j, i1] += frac[j]
    else:  # bicubic
        base = np.floor(src).astype(int)
        for j in range(n_dst):
            for k in range(-1, 3):
                idx = base[j] + k
                W[j, min(max(idx, 0), n_src - 1)] += _cubic_kernel(src[j] - idx)
    return W


def _resize(x, hw, mode="bilinear", align_corners=False, scales=None):
    """(B,H,W,C) -> (B,h,w,C) with static separable matrices."""
    _, H, W0, _ = x.shape
    h, w = hw
    if (H, W0) == (h, w):
        return x
    Wh = torch.as_tensor(_interp_matrix(H, h, mode, align_corners, scales[0] if scales else None), dtype=x.dtype,
                         device=x.device)
    Ww = torch.as_tensor(_interp_matrix(W0, w, mode, align_corners, scales[1] if scales else None), dtype=x.dtype,
                         device=x.device)
    return torch.einsum("hH,bHWc,wW->bhwc", Wh, x, Ww)


def _ln(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _same_pad(n, k, s):
    """XLA's 'SAME' padding (low, high) of one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w_oihw, b=None, stride=1, pad="SAME", groups=1):
    """NHWC conv with a torch-layout (O,I/groups,kh,kw) kernel, XLA's 'SAME'
    or 'VALID' padding. 'SAME' puts the odd pixel of a padding on the bottom
    and right (a stride-2 3×3 conv of an even side pads (0, 1)), where
    torch's padding=1 would pad both sides and shift the map."""
    y = x.permute(0, 3, 1, 2)
    kh, kw = w_oihw.shape[2:]
    if pad == "SAME":
        (t, bo), (lft, r) = _same_pad(y.shape[2], kh, stride), _same_pad(y.shape[3], kw, stride)
        if t == bo and lft == r:
            y = F.conv2d(y, w_oihw, b, stride, padding=(t, lft), groups=groups)
        else:
            y = F.conv2d(F.pad(y, (lft, r, t, bo)), w_oihw, b, stride, groups=groups)
    else:
        y = F.conv2d(y, w_oihw, b, stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def multi_head(q, k, v):
    """softmax(q kᵀ / sqrt(hd)) v on (B, N, H, hd) heads with every key real:
    K4 (extraction/matchers/attention.attention) with an all-true key mask."""
    return attention(q, k, v, torch.ones(k.shape[:2], dtype=torch.bool, device=q.device), q.shape[-1] ** -0.5)


def draw_params(specs, seed, device):
    """Seeded params from (name, shape, kind, scale) specs in the JAX
    package's draw order: kind "w" a numpy normal draw of that scale, "0"
    zeros, "1" ones; float32 tensors on `device`."""
    rng = np.random.default_rng(seed)
    p = {}
    for name, shape, kind, scale in specs:
        if kind == "w":
            p[name] = rng.normal(scale=scale, size=shape).astype(np.float32)
        else:
            p[name] = np.full(shape, float(kind), np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in p.items()}


def _deconv_block(x, w_iohw, b, f):
    """ConvTranspose2d with kernel == stride == f (pure pixel expansion)."""
    B, h, w, _ = x.shape
    y = torch.einsum("bhwc,copq->bhpwqo", x, w_iohw)  # (B,h,f,w,f,O)
    return y.reshape(B, h * f, w * f, w_iohw.shape[1]) + b


def param_specs(c):
    """The official parameters of config `c` in the JAX package's draw order:
    (name, shape, kind, scale), kind "w" a normal draw of that scale, "0"
    zeros, "1" ones."""
    D, depth = c["dim"], c["depth"]
    specs = []

    def w(name, *shape, scale=0.02):
        specs.append((name, shape, "w", scale))

    def zeros(name, *shape):
        specs.append((name, shape, "0", None))

    def ones(name, *shape):
        specs.append((name, shape, "1", None))

    def conv(name, o, i, k, bias=True):
        w(name + ".weight", o, i, k, k, scale=0.05)
        if bias:
            zeros(name + ".bias", o)

    w("pretrained.cls_token", 1, 1, D)
    grid = c["input_size"] // 14
    w("pretrained.pos_embed", 1, 1 + grid * grid, D)
    w("pretrained.patch_embed.proj.weight", D, 3, 14, 14)
    zeros("pretrained.patch_embed.proj.bias", D)
    for i in range(depth):
        b = f"pretrained.blocks.{i}."
        ones(b + "norm1.weight", D)
        zeros(b + "norm1.bias", D)
        ones(b + "norm2.weight", D)
        zeros(b + "norm2.bias", D)
        for name, o, i_ in (("attn.qkv", 3 * D, D), ("attn.proj", D, D), ("mlp.fc1", 4 * D, D), ("mlp.fc2", D, 4 * D)):
            w(b + name + ".weight", o, i_, scale=D ** -0.5)
            zeros(b + name + ".bias", o)
        ones(b + "ls1.gamma", D)
        ones(b + "ls2.gamma", D)
    ones("pretrained.norm.weight", D)
    zeros("pretrained.norm.bias", D)
    oc, F_ = c["out_channels"], c["features"]
    for i in range(4):
        w(f"depth_head.projects.{i}.weight", oc[i], D, 1, 1, scale=D ** -0.5)
        zeros(f"depth_head.projects.{i}.bias", oc[i])
        conv(f"depth_head.scratch.layer{i + 1}_rn", F_, oc[i], 3, bias=False)
    conv("depth_head.resize_layers.0", oc[0], oc[0], 4)  # ConvTranspose2d (in, out, 4, 4)
    conv("depth_head.resize_layers.1", oc[1], oc[1], 2)  # ConvTranspose2d (in, out, 2, 2)
    conv("depth_head.resize_layers.3", oc[3], oc[3], 3)
    for i in range(1, 5):
        rb = f"depth_head.scratch.refinenet{i}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            conv(rb + unit + ".conv1", F_, F_, 3)
            conv(rb + unit + ".conv2", F_, F_, 3)
        conv(rb + "out_conv", F_, F_, 1)
    conv("depth_head.scratch.output_conv1", F_ // 2, F_, 3)
    conv("depth_head.scratch.output_conv2.0", 32, F_ // 2, 3)
    conv("depth_head.scratch.output_conv2.2", 1, 32, 1)
    return specs


class DepthAnythingV2:
    """DepthAnythingV2 on `device`. Params: a flat dict of official names ->
    tensors. Conf: encoder (vits | vitb | vitl), depth_estimation_type
    (relative | metric), max_depth, input_size, and any width of
    MODEL_CONFIGS[encoder] overridden (tests' tiny nets)."""

    def __init__(self, conf=None, device="cuda"):
        conf = dict(conf or {})
        enc = conf.get("encoder", "vitl")
        self.conf = {**MODEL_CONFIGS[enc], "encoder": enc,
                     "depth_estimation_type": conf.get("depth_estimation_type", "relative"),
                     "max_depth": conf.get("max_depth", 1.0),
                     "input_size": conf.get("input_size", 518),
                     **{k: v for k, v in conf.items() if k in MODEL_CONFIGS[enc]}}
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            for key in ("state_dict", "model"):
                if key in sd:
                    sd = sd[key]
            official = all(self.conf.get(k) == v for k, v in MODEL_CONFIGS[enc].items())
            if enc == "vitl" and official:  # the manifest check only at the official architecture size
                self.params = convert_checked(self.params_from_torch_state_dict, sd, "depthanythingv2-vitl",
                                              where=str(wp))
            else:
                self.params = self.params_from_torch_state_dict(sd)

    # ------------------------------------------------------------- params
    def init_random(self, seed=0):
        """Seeded params under the official naming: the JAX package's numpy
        draws in its order."""
        self.params = draw_params(param_specs(self.conf), seed, self.device)
        return self.params

    def params_from_torch_state_dict(self, sd):
        """Official DA2 naming passes through; HF DepthAnything naming is
        renamed onto it (query/key/value fused back into qkv). Float32
        tensors on the device, without the mask token."""
        sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
        if any(k.startswith("backbone.") for k in sd):
            sd = self._rename_hf(sd)
        return {k: torch.as_tensor(v).to(self.device) for k, v in sd.items()
                if k.startswith(("pretrained.", "depth_head.")) and "mask_token" not in k}

    @staticmethod
    def _rename_hf(sd):
        out = {}
        for k, v in sd.items():
            if k.startswith("backbone.embeddings.cls_token"):
                out["pretrained.cls_token"] = v
            elif k.startswith("backbone.embeddings.position_embeddings"):
                out["pretrained.pos_embed"] = v
            elif k.startswith("backbone.embeddings.patch_embeddings.projection"):
                out["pretrained.patch_embed.proj." + k.split(".")[-1]] = v
            elif k.startswith("backbone.layernorm."):
                out["pretrained.norm." + k.split(".")[-1]] = v
            elif k.startswith("backbone.encoder.layer."):
                parts = k.split(".")
                i, rest = parts[3], ".".join(parts[4:])
                b = f"pretrained.blocks.{i}."
                m = {
                    "norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
                    "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
                    "attention.output.dense.weight": "attn.proj.weight",
                    "attention.output.dense.bias": "attn.proj.bias",
                    "layer_scale1.lambda1": "ls1.gamma",
                    "layer_scale2.lambda1": "ls2.gamma",
                    "mlp.fc1.weight": "mlp.fc1.weight", "mlp.fc1.bias": "mlp.fc1.bias",
                    "mlp.fc2.weight": "mlp.fc2.weight", "mlp.fc2.bias": "mlp.fc2.bias",
                }
                if rest in m:
                    out[b + m[rest]] = v
                else:
                    out.setdefault("_qkv", {}).setdefault(i, {})[rest] = v
            elif k.startswith("neck.reassemble_stage.layers."):
                parts = k.split(".")
                i, tail = parts[3], parts[-1]
                if parts[4] == "projection":
                    out[f"depth_head.projects.{i}.{tail}"] = v
                else:  # resize
                    out[f"depth_head.resize_layers.{i}.{tail}"] = v
            elif k.startswith("neck.convs."):
                i = int(k.split(".")[2])
                out[f"depth_head.scratch.layer{i + 1}_rn.weight"] = v
            elif k.startswith("neck.fusion_stage.layers."):
                parts = k.split(".")
                # HF fuses reversed: layers.0 handles the COARSEST hook -> official refinenet4
                i = 4 - int(parts[3])
                sub, tail = parts[4], parts[-1]
                m = {"residual_layer1": "resConfUnit1", "residual_layer2": "resConfUnit2",
                     "projection": "out_conv"}
                if sub == "projection":
                    out[f"depth_head.scratch.refinenet{i}.out_conv.{tail}"] = v
                else:
                    conv = "conv1" if parts[5] == "convolution1" else "conv2"
                    out[f"depth_head.scratch.refinenet{i}.{m[sub]}.{conv}.{tail}"] = v
            elif k.startswith("head.conv1."):
                out["depth_head.scratch.output_conv1." + k.split(".")[-1]] = v
            elif k.startswith("head.conv2."):
                out["depth_head.scratch.output_conv2.0." + k.split(".")[-1]] = v
            elif k.startswith("head.conv3."):
                out["depth_head.scratch.output_conv2.2." + k.split(".")[-1]] = v
        for i, qkv in out.pop("_qkv", {}).items():
            for tail in ("weight", "bias"):
                out[f"pretrained.blocks.{i}.attn.qkv.{tail}"] = np.concatenate(
                    [qkv[f"attention.attention.{part}.{tail}"] for part in ("query", "key", "value")], axis=0)
        return out

    # ------------------------------------------------------------- forward
    def _backbone(self, p, x, patch_hw):
        c = self.conf
        D, H, depth = c["dim"], c["heads"], c["depth"]
        h, w = patch_hw
        B = x.shape[0]
        tok = _conv(x, p["pretrained.patch_embed.proj.weight"], p["pretrained.patch_embed.proj.bias"], stride=14,
                    pad="VALID").reshape(B, h * w, D)
        pe = p["pretrained.pos_embed"]  # (1, 1+M*M, D)
        M = int(math.isqrt(pe.shape[1] - 1))
        cls_pe, patch_pe = pe[:, :1], pe[:, 1:].reshape(1, M, M, D)
        if (h, w) != (M, M):  # DINOv2's interpolate_offset = 0.1 bicubic convention
            patch_pe = _resize(patch_pe, (h, w), mode="bicubic", scales=((h + 0.1) / M, (w + 0.1) / M))
        tok = tok + patch_pe.reshape(1, h * w, D)
        tok = torch.cat([(p["pretrained.cls_token"] + cls_pe).expand(B, 1, D), tok], 1)
        hooks = set(c["hooks"])
        feats = []
        hd = D // H
        for i in range(depth):
            b = f"pretrained.blocks.{i}."
            y = _ln(tok, p[b + "norm1.weight"], p[b + "norm1.bias"])
            qkv = (y @ p[b + "attn.qkv.weight"].T + p[b + "attn.qkv.bias"]).reshape(B, -1, 3, H, hd)
            y = multi_head(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(B, -1, D)
            tok = tok + (y @ p[b + "attn.proj.weight"].T + p[b + "attn.proj.bias"]) * p[b + "ls1.gamma"]
            y = _ln(tok, p[b + "norm2.weight"], p[b + "norm2.bias"])
            y = F.gelu(y @ p[b + "mlp.fc1.weight"].T + p[b + "mlp.fc1.bias"])
            tok = tok + (y @ p[b + "mlp.fc2.weight"].T + p[b + "mlp.fc2.bias"]) * p[b + "ls2.gamma"]
            if i in hooks:
                feats.append(tok)
        return [_ln(f, p["pretrained.norm.weight"], p["pretrained.norm.bias"]) for f in feats]

    def forward(self, x, patch_hw, p=None):
        """x (B, 14h, 14w, 3) ImageNet-normalized -> depth (B, 14h, 14w)."""
        p = self.params if p is None else p
        c = self.conf
        h, w = patch_hw
        B = x.shape[0]
        pyr = []
        for i, f in enumerate(self._backbone(p, x, patch_hw)):
            y = f[:, 1:].reshape(B, h, w, c["dim"])
            y = y @ p[f"depth_head.projects.{i}.weight"][:, :, 0, 0].T + p[f"depth_head.projects.{i}.bias"]
            if i in (0, 1):
                y = _deconv_block(y, p[f"depth_head.resize_layers.{i}.weight"], p[f"depth_head.resize_layers.{i}.bias"],
                                  4 // (i + 1))
            elif i == 3:
                y = _conv(y, p["depth_head.resize_layers.3.weight"], p["depth_head.resize_layers.3.bias"], stride=2)
            pyr.append(_conv(y, p[f"depth_head.scratch.layer{i + 1}_rn.weight"]))

        def rcu(prefix, x):
            y = _conv(F.relu(x), p[prefix + ".conv1.weight"], p[prefix + ".conv1.bias"])
            return x + _conv(F.relu(y), p[prefix + ".conv2.weight"], p[prefix + ".conv2.bias"])

        def fuse(i, x, res, size):
            rb = f"depth_head.scratch.refinenet{i}"
            if res is not None:
                x = x + rcu(rb + ".resConfUnit1", res)
            x = rcu(rb + ".resConfUnit2", x)
            x = _resize(x, size or (x.shape[1] * 2, x.shape[2] * 2), align_corners=True)
            return _conv(x, p[rb + ".out_conv.weight"], p[rb + ".out_conv.bias"])

        path = fuse(4, pyr[3], None, tuple(pyr[2].shape[1:3]))
        path = fuse(3, path, pyr[2], tuple(pyr[1].shape[1:3]))
        path = fuse(2, path, pyr[1], tuple(pyr[0].shape[1:3]))
        path = fuse(1, path, pyr[0], None)
        y = _conv(path, p["depth_head.scratch.output_conv1.weight"], p["depth_head.scratch.output_conv1.bias"])
        y = _resize(y, (h * 14, w * 14), align_corners=True)
        y = F.relu(_conv(y, p["depth_head.scratch.output_conv2.0.weight"], p["depth_head.scratch.output_conv2.0.bias"]))
        y = _conv(y, p["depth_head.scratch.output_conv2.2.weight"], p["depth_head.scratch.output_conv2.2.bias"])[..., 0]
        if c["depth_estimation_type"] == "metric":
            return torch.sigmoid(y) * c["max_depth"]
        return F.relu(y)

    # ------------------------------------------------------------- host API
    def infer_image(self, image_rgb):
        """uint8/float HxWx3 -> depth at the input resolution (the official
        preprocessing: the short side resized to input_size, both sides
        snapped to multiples of 14, ImageNet-normalized; the forward; the
        depth resized back)."""
        if self.params is None:
            raise ValueError("DepthAnythingV2: load weights or call init_random() first")
        img = np.asarray(image_rgb, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        H0, W0 = img.shape[:2]
        s = self.conf["input_size"] / min(H0, W0)
        h = max(int(round(H0 * s / 14)), 1) * 14
        w = max(int(round(W0 * s / 14)), 1) * 14
        with torch.no_grad():
            x = _resize(torch.as_tensor((img - IMAGENET_MEAN) / IMAGENET_STD, device=self.device)[None], (h, w))
            d = self.forward(x, (h // 14, w // 14))
            d = _resize(d[..., None], (H0, W0))[0, ..., 0]
        return d.cpu().numpy()
