"""DSINE v02_kappa: TF-EfficientNet-B5 encoder + rotation-refinement decoder
(port of mpsfm_tpu/extraction/nets/dsine.py).

The JAX package's architecture-exact DSINE in torch, on the device, with
tensors channels last as there:

* the encoder is geffnet's ``tf_efficientnet_b5_ap`` under the official
  ``encoder.original_model.*`` names: MBConv blocks (expansion 1×1,
  depthwise k×k, squeeze-excitation, projection 1×1), inference BatchNorm
  with eps 1e-3, SiLU, and TF 'SAME' padding, which pads a stride-2
  depthwise convolution of an even side on the bottom and right only
  (depth_anything._conv);
* the decoder (``decoder.*``): a UNet ladder from the 2048-channel head to
  1/8, per-pixel unit camera rays, an initial normal + kappa, a ConvGRU
  whose every step rotates the normal by a per-pixel axis-angle (Rodrigues),
  and a learned convex ×8 upsampling.

Parameters are a flat dict of tensors under the official names of
``dsine.pth``. `init_random(seed)` draws the JAX package's numpy draws in its
order, so both packages get the same weights from one seed.

`infer_image` is the reference wrapper's inference (normals/dsine.py:26-141):
pad to a multiple of 32, ImageNet normalization, rays at 1/8 of the padded
image, the optional horizontally flipped pass (image and rays, the rays' x
negated, the output flipped back and its x negated), omni -> BNI coordinates
(x negated) and kappa -> angular variance by `kappa_to_alpha`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.manifest import convert_checked
from mpsfm_tpu_torch.extraction.nets.depth_anything import IMAGENET_MEAN, IMAGENET_STD, _conv, _resize
from mpsfm_tpu_torch.extraction.nets.metric3d import kappa_to_alpha
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

E = "encoder.original_model."
D = "decoder."


def _round_ch(ch, mult):
    """EfficientNet channel rounding: scale by the width multiplier, round to /8."""
    ch = ch * mult
    new = max(8, int(ch + 4) // 8 * 8)
    if new < 0.9 * ch:
        new += 8
    return int(new)


def _round_rep(rep, mult):
    return int(np.ceil(rep * mult))


# the B0 stage spec: (expand, channels, repeats, stride, kernel)
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def efficientnet_stages(width_mult=1.6, depth_mult=2.2):
    """B5 by default: width 1.6, depth 2.2 (stem 48, head 2048)."""
    return [(e, _round_ch(c, width_mult), _round_rep(r, depth_mult), s, k) for (e, c, r, s, k) in _B0_STAGES]


class DSINE(torch.nn.Module):
    """DSINE v02_kappa on `device`. Params: a flat dict of official names -> tensors."""

    def __init__(self, conf=None, device="cuda"):
        super().__init__()
        conf = dict(conf or {})
        stages = conf.get("stages")
        if stages is None:
            stages = efficientnet_stages(conf.get("width_mult", 1.6), conf.get("depth_mult", 2.2))
        self.conf = {
            "stages": tuple(tuple(s) for s in stages),
            "stem": conf.get("stem", _round_ch(32, conf.get("width_mult", 1.6))),
            "head": conf.get("head", 2048),
            "feature_dim": conf.get("feature_dim", 64),
            "hidden_dim": conf.get("hidden_dim", 64),
            "decoder_nf": conf.get("decoder_nf", 2048),
            "iters": conf.get("iters", 5),
            "se_ratio": conf.get("se_ratio", 0.25),
        }
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            for key in ("model_state_dict", "state_dict", "model"):
                if isinstance(sd, dict) and key in sd:
                    sd = sd[key]
            # the manifest check only at the official architecture size (tests load tiny checkpoints this way)
            official = (self.conf["stages"] == tuple(tuple(s) for s in efficientnet_stages(1.6, 2.2))
                        and self.conf["head"] == 2048)
            if official:
                self.params = convert_checked(self.params_from_torch_state_dict, sd, "dsine", where=str(wp))
            else:
                self.params = self.params_from_torch_state_dict(sd)

    # ------------------------------------------------------------- params
    def params_from_torch_state_dict(self, sd, strict=True):
        """The official checkpoint layout: strips ``module.``, keeps
        ``encoder.*`` / ``decoder.*`` (without BatchNorm's
        num_batches_tracked) as float32 tensors on the device; any other key
        raises with strict."""
        out = {}
        unmatched = []
        for k, v in sd.items():
            if k.startswith("module."):
                k = k[len("module."):]
            if k.startswith(("encoder.", "decoder.")):
                if "num_batches_tracked" in k:
                    continue
                out[k] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            else:
                unmatched.append(k)
        if strict and unmatched:
            raise ValueError(f"unrecognized checkpoint keys: {unmatched[:8]}")
        return out

    def init_random(self, seed=0):
        """Seeded params under the official naming: the JAX package's numpy
        draws in its order."""
        rng = np.random.default_rng(seed)
        c = self.conf
        p = {}

        def w(name, *shape, scale=0.05):
            p[name] = rng.normal(scale=scale, size=shape).astype(np.float32)

        def zeros(name, *shape):
            p[name] = np.zeros(shape, np.float32)

        def ones(name, *shape):
            p[name] = np.ones(shape, np.float32)

        def bn(name, ch):
            ones(name + ".weight", ch)
            zeros(name + ".bias", ch)
            zeros(name + ".running_mean", ch)
            p[name + ".running_var"] = np.abs(rng.normal(loc=1.0, scale=0.1, size=ch)).astype(np.float32)

        def se(b, cin, mid):
            n = max(1, int(cin * c["se_ratio"]))
            w(b + "se.conv_reduce.weight", n, mid, 1, 1)
            zeros(b + "se.conv_reduce.bias", n)
            w(b + "se.conv_expand.weight", mid, n, 1, 1)
            zeros(b + "se.conv_expand.bias", mid)

        stem = c["stem"]
        w(E + "conv_stem.weight", stem, 3, 3, 3)
        bn(E + "bn1", stem)
        cin = stem
        for si, (exp, ch, rep, _, k) in enumerate(c["stages"]):
            for bi in range(rep):
                b = E + f"blocks.{si}.{bi}."
                mid = cin * exp
                if exp == 1:  # DepthwiseSeparableConv: conv_dw -> bn1 -> se -> conv_pw -> bn2
                    w(b + "conv_dw.weight", cin, 1, k, k)
                    bn(b + "bn1", cin)
                    se(b, cin, cin)
                    w(b + "conv_pw.weight", ch, cin, 1, 1)
                    bn(b + "bn2", ch)
                else:  # InvertedResidual: conv_pw -> bn1 -> conv_dw -> bn2 -> se -> conv_pwl -> bn3
                    w(b + "conv_pw.weight", mid, cin, 1, 1)
                    bn(b + "bn1", mid)
                    w(b + "conv_dw.weight", mid, 1, k, k)
                    bn(b + "bn2", mid)
                    se(b, cin, mid)
                    w(b + "conv_pwl.weight", ch, mid, 1, 1)
                    bn(b + "bn3", ch)
                cin = ch
        w(E + "conv_head.weight", c["head"], cin, 1, 1)
        bn(E + "bn2", c["head"])

        nf = c["decoder_nf"]
        skips = self._skip_channels()
        w(D + "conv2.weight", nf, c["head"], 1, 1)
        zeros(D + "conv2.bias", nf)
        cin_d = nf
        for i, cout in enumerate((nf // 2, nf // 4)):  # the UNet ladder 1/32 -> 1/16 -> 1/8
            u = D + f"up{i + 1}."
            w(u + "convA.weight", cout, cin_d + skips[i], 3, 3)
            zeros(u + "convA.bias", cout)
            w(u + "convB.weight", cout, cout, 3, 3)
            zeros(u + "convB.bias", cout)
            cin_d = cout
        fd, hd = c["feature_dim"], c["hidden_dim"]
        w(D + "feature_head.conv1.weight", fd, cin_d + 3, 3, 3)  # + 3 ray channels
        zeros(D + "feature_head.conv1.bias", fd)
        w(D + "feature_head.conv2.weight", fd, fd, 1, 1)
        zeros(D + "feature_head.conv2.bias", fd)
        w(D + "init_head.weight", 4, fd, 3, 3)
        zeros(D + "init_head.bias", 4)
        for gate in ("convz", "convr", "convq"):
            w(D + f"gru.{gate}.weight", hd, hd + fd + 4 + 3, 3, 3)
            zeros(D + f"gru.{gate}.bias", hd)
        w(D + "hidden_init.weight", hd, fd, 3, 3)
        zeros(D + "hidden_init.bias", hd)
        w(D + "rot_head.conv1.weight", hd, hd, 3, 3)
        zeros(D + "rot_head.conv1.bias", hd)
        w(D + "rot_head.conv2.weight", 4, hd, 3, 3)  # 3 axis-angle + dkappa
        zeros(D + "rot_head.conv2.bias", 4)
        w(D + "mask_head.conv1.weight", 2 * hd, hd, 3, 3)
        zeros(D + "mask_head.conv1.bias", 2 * hd)
        w(D + "mask_head.conv2.weight", 9 * 64, 2 * hd, 1, 1)
        zeros(D + "mask_head.conv2.bias", 9 * 64)
        self.params = {k: torch.as_tensor(v, device=self.device) for k, v in p.items()}
        return self.params

    def _skip_channels(self):
        """Channels of the 1/16 and 1/8 encoder features."""
        scale, per_scale, cin = 2, {}, self.conf["stem"]
        for (_, ch, _, stride, _) in self.conf["stages"]:
            scale *= stride
            per_scale[scale] = ch
            cin = ch
        return per_scale.get(16, cin), per_scale.get(8, cin)

    # ------------------------------------------------------------ encoder
    @staticmethod
    def _bn(p, name, x):
        return ((x - p[name + ".running_mean"]) / torch.sqrt(p[name + ".running_var"] + 1e-3) * p[name + ".weight"]
                + p[name + ".bias"])

    @staticmethod
    def _conv(p, name, x, stride=1, groups=1, bias=False):
        return _conv(x, p[name + ".weight"], p[name + ".bias"] if bias else None, stride, groups=groups)

    def _se(self, p, prefix, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = F.silu(self._conv(p, prefix + "conv_reduce", s, bias=True))
        return x * torch.sigmoid(self._conv(p, prefix + "conv_expand", s, bias=True))

    def _encoder(self, p, x):
        """The features at 1/8 and 1/16 and the 2048-channel head at 1/32."""
        y = F.silu(self._bn(p, E + "bn1", self._conv(p, E + "conv_stem", x, stride=2)))
        feats = {}
        scale = 2
        for si, (exp, _, rep, stride, _) in enumerate(self.conf["stages"]):
            for bi in range(rep):
                b = E + f"blocks.{si}.{bi}."
                st = stride if bi == 0 else 1
                inp = y
                if exp == 1:
                    y = self._conv(p, b + "conv_dw", y, stride=st, groups=y.shape[-1])
                    y = self._se(p, b + "se.", F.silu(self._bn(p, b + "bn1", y)))
                    y = self._bn(p, b + "bn2", self._conv(p, b + "conv_pw", y))
                else:
                    y = F.silu(self._bn(p, b + "bn1", self._conv(p, b + "conv_pw", y)))
                    y = self._conv(p, b + "conv_dw", y, stride=st, groups=y.shape[-1])
                    y = self._se(p, b + "se.", F.silu(self._bn(p, b + "bn2", y)))
                    y = self._bn(p, b + "bn3", self._conv(p, b + "conv_pwl", y))
                if st == 1 and inp.shape == y.shape:
                    y = y + inp  # the residual (drop_path is the identity at inference)
            scale *= stride
            feats[scale] = y
        head = F.silu(self._bn(p, E + "bn2", self._conv(p, E + "conv_head", y)))
        return feats.get(8), feats.get(16), head

    # ------------------------------------------------------------ decoder
    @staticmethod
    def _unit(n):
        return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-6)

    @staticmethod
    def _rotate(n, aa):
        """n (B,H,W,3) rotated by the per-pixel axis-angle aa (B,H,W,3) (Rodrigues)."""
        theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
        axis = aa / torch.clamp(theta, min=1e-8)
        cos, sin = torch.cos(theta), torch.sin(theta)
        return (n * cos + torch.linalg.cross(axis, n, dim=-1) * sin
                + axis * (axis * n).sum(-1, keepdim=True) * (1 - cos))

    @staticmethod
    def _convex_upsample(x, mask, factor=8):
        """Convex upsampling: x (B,h,w,C), mask (B,h,w,9·f·f) -> (B,f·h,f·w,C)."""
        B, h, w, C = x.shape
        mask = torch.softmax(mask.reshape(B, h, w, 9, factor * factor), 3)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        neigh = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)
        up = torch.einsum("bhwkf,bhwkc->bhwfc", mask, neigh).reshape(B, h, w, factor, factor, C)
        return up.permute(0, 1, 3, 2, 4, 5).reshape(B, h * factor, w * factor, C)

    def forward(self, x, rays, p=None):
        """x (B,H,W,3) normalized, rays (B,H/8,W/8,3) unit camera rays ->
        normals (B,H,W,3) of unit length and kappa (B,H,W)."""
        p = self.params if p is None else p
        f8, f16, head = self._encoder(p, x)
        y = self._conv(p, D + "conv2", head, bias=True)
        for i, skip in enumerate((f16, f8)):
            u = D + f"up{i + 1}."
            y = torch.cat([_resize(y, tuple(skip.shape[1:3])), skip], -1)
            y = F.leaky_relu(self._conv(p, u + "convA", y, bias=True), 0.2)
            y = F.leaky_relu(self._conv(p, u + "convB", y, bias=True), 0.2)
        y = torch.cat([y, rays], -1)
        f = F.relu(self._conv(p, D + "feature_head.conv1", y, bias=True))
        f = self._conv(p, D + "feature_head.conv2", f, bias=True)
        pred = self._conv(p, D + "init_head", f, bias=True)
        n = self._unit(pred[..., :3])
        kap = pred[..., 3:4]
        h = torch.tanh(self._conv(p, D + "hidden_init", f, bias=True))
        for _ in range(self.conf["iters"]):
            inp = torch.cat([f, n, kap, rays], -1)
            hx = torch.cat([h, inp], -1)
            z = torch.sigmoid(self._conv(p, D + "gru.convz", hx, bias=True))
            r = torch.sigmoid(self._conv(p, D + "gru.convr", hx, bias=True))
            q = torch.tanh(self._conv(p, D + "gru.convq", torch.cat([r * h, inp], -1), bias=True))
            h = (1 - z) * h + z * q
            d = F.relu(self._conv(p, D + "rot_head.conv1", h, bias=True))
            d = self._conv(p, D + "rot_head.conv2", d, bias=True)
            n = self._unit(self._rotate(n, d[..., :3]))
            kap = kap + d[..., 3:4]
        mask = F.relu(self._conv(p, D + "mask_head.conv1", h, bias=True))
        mask = self._conv(p, D + "mask_head.conv2", mask, bias=True)
        full = self._convex_upsample(torch.cat([n, kap], -1), mask, factor=8)
        return self._unit(full[..., :3]), F.elu(full[..., 3]) + 1.0

    # ------------------------------------------------------------- host API
    def infer_image(self, image_rgb, intrinsics, flip=False):
        """uint8/float HxWx3 + (fx, fy, cx, cy) -> normals (BNI coordinates)
        and normals_variance at the input resolution, host float64 arrays
        (the reference's dsine.py:80-99)."""
        assert self.params is not None, "load weights or call init_random() first"
        img = np.asarray(image_rgb, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        if img.max() > 2.0:
            img = img / 255.0
        H0, W0 = img.shape[:2]
        H, W = (H0 + 31) // 32 * 32, (W0 + 31) // 32 * 32  # the reference's get_padding
        lr, tb = (W - W0) // 2, (H - H0) // 2
        x = np.pad((img - IMAGENET_MEAN) / IMAGENET_STD, ((tb, H - H0 - tb), (lr, W - W0 - lr), (0, 0)))
        fx, fy, cx, cy = (float(v) for v in intrinsics)
        cx, cy = cx + lr, cy + tb
        U, V = np.meshgrid((np.arange(W // 8) + 0.5) * 8 - 0.5, (np.arange(H // 8) + 0.5) * 8 - 0.5)
        rays = np.stack([(U - cx) / fx, (V - cy) / fy, np.ones_like(U)], -1)
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        with torch.no_grad():
            xt = torch.as_tensor(x, device=self.device)[None]
            rt = torch.as_tensor(rays.astype(np.float32), device=self.device)[None]
            if flip:
                xt = torch.flip(xt, [2])
                rt = torch.flip(rt, [2]) * torch.tensor([-1.0, 1.0, 1.0], device=self.device)
            normal, kappa = self.forward(xt, rt)
            normal, kappa = normal[0], kappa[0]
            if flip:
                normal, kappa = torch.flip(normal, [1]), torch.flip(kappa, [1])
            normal = normal[tb:tb + H0, lr:lr + W0].cpu().numpy()
            kappa = kappa[tb:tb + H0, lr:lr + W0].cpu().numpy()
        normal = normal * np.array([-1.0, 1.0, 1.0])  # omni -> BNI (the reference's dsine.py:151-153)
        if flip:
            normal[..., 0] *= -1.0
        return {"normals": np.asarray(normal, np.float64), "normals_variance": kappa_to_alpha(kappa) ** 2}
