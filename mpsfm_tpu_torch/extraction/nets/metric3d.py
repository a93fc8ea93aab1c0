"""Metric3Dv2: DINOv2-reg ViT + RAFT-DPT head (port of
mpsfm_tpu/extraction/nets/metric3d.py).

The JAX package's architecture-exact Metric3Dv2 in torch, on the device:
the DINOv2 ViT with 4 register tokens (SwiGLU MLP for giant2) and the +0.1
bicubic position-embedding interpolation, its attention plain torch
matmuls and softmax (the JAX package's einsums, outside any Pallas
kernel); the RAFT-DPT decoder (token-to-feature pyramid, DPT fusion, a
3-level ConvGRU at 1/4-1/8-1/16 with convex upsampling, joint
depth + normal + kappa heads). Tensors are channels last, as in the JAX
package.

Parameters are a flat dict of tensors under the official names of
``metric_depth_vit_{small,large,giant2}_800k.pth`` after its
``depth_model.`` / ``module.`` prefixes: ``encoder.*`` (facebookresearch/
dinov2's vit_{small,large,giant2} with num_register_tokens=4) and
``decoder.*``. `init_random(seed)` draws the JAX package's numpy draws in
its order, so both packages get the same weights from one seed.

`infer_image` is the reference wrapper's inference (metric3dv2.py:29-120):
the scale-canonical transform (resize into the (616, 1064) crop, pad with
the ImageNet mean, label_scale_factor = canonical_focal / focal · scale),
depth = prediction · depth_range_max / label_scale_factor, error =
depth · (1 − confidence), valid = prediction < 200, normals in BNI
coordinates (omni_to_bni: y and z negated) with kappa_to_alpha(kappa)²
variance, and the optional horizontally flipped pass.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.manifest import convert_checked
from mpsfm_tpu_torch.extraction.nets.depth_anything import _conv, _deconv_block, _ln, _resize
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

# official arch presets (dinov2 reg variants; decoder ladders of vit.raft5.{small,large,giant2})
MODEL_CONFIGS = {
    "vit_small_reg": dict(
        dim=384, depth=12, heads=6, mlp="mlp", hooks=(2, 5, 8, 11),
        feature_channels=(96, 192, 384, 768),
        decoder_channels=(48, 96, 192, 384, 384), hidden=48,
    ),
    "vit_large_reg": dict(
        dim=1024, depth=24, heads=16, mlp="mlp", hooks=(4, 11, 17, 23),
        feature_channels=(256, 512, 1024, 1024),
        decoder_channels=(128, 256, 512, 1024, 1024), hidden=128,
    ),
    "vit_giant2_reg": dict(
        dim=1536, depth=40, heads=24, mlp="swiglu", hooks=(9, 19, 29, 39),
        feature_channels=(384, 768, 1536, 1536),
        decoder_channels=(192, 384, 768, 1536, 1536), hidden=192,
    ),
}
TAGS = {"vit_small_reg": "small", "vit_large_reg": "large", "vit_giant2_reg": "giant2"}

# mmcv-style normalization (0-255 space) of the Metric3D transforms
MEAN_255 = np.array([123.675, 116.28, 103.53], np.float32)
STD_255 = np.array([58.395, 57.12, 57.375], np.float32)

CANONICAL_FOCAL = 1000.0
CROP_SIZE = (616, 1064)  # vit.raft5.* data_basic.crop_size
DEPTH_RANGE_MAX = 200.0  # data_basic.depth_range[1] -> normalize_scale


def kappa_to_alpha(kappa):
    """vMF concentration -> expected angular error (reference dsine.py:22)."""
    kappa = np.asarray(kappa, np.float64)
    return (2 * kappa / (kappa**2 + 1)) + np.exp(-kappa * np.pi) * np.pi / (1 + np.exp(-kappa * np.pi))


def _swiglu_hidden(dim):
    """DINOv2 SwiGLUFFNFused hidden width: 2/3 * 4d rounded up to 8."""
    return (int(dim * 4 * 2 / 3) + 7) // 8 * 8


def param_shapes(c):
    """(name, shape, kind, scale) of every parameter under the official
    naming, in the JAX package's init_random order; kind is "w" (normal at
    scale), "zeros" or "ones"."""
    D, depth, R, ps = c["dim"], c["depth"], c["num_register_tokens"], c["patch"]
    out = []

    def w(name, *shape, scale=0.02):
        out.append((name, shape, "w", scale))

    def zeros(name, *shape):
        out.append((name, shape, "zeros", 0.0))

    def ones(name, *shape):
        out.append((name, shape, "ones", 0.0))

    # ---- encoder (DINOv2-reg)
    w("encoder.cls_token", 1, 1, D)
    M = c["pos_grid"]
    w("encoder.pos_embed", 1, 1 + M * M, D)
    w("encoder.register_tokens", 1, R, D)
    w("encoder.patch_embed.proj.weight", D, 3, ps, ps)
    zeros("encoder.patch_embed.proj.bias", D)
    for i in range(depth):
        b = f"encoder.blocks.{i}."
        ones(b + "norm1.weight", D); zeros(b + "norm1.bias", D)  # noqa: E702
        ones(b + "norm2.weight", D); zeros(b + "norm2.bias", D)  # noqa: E702
        w(b + "attn.qkv.weight", 3 * D, D, scale=D**-0.5)
        zeros(b + "attn.qkv.bias", 3 * D)
        w(b + "attn.proj.weight", D, D, scale=D**-0.5)
        zeros(b + "attn.proj.bias", D)
        if c["mlp"] == "swiglu":
            h = _swiglu_hidden(D)
            w(b + "mlp.w12.weight", 2 * h, D, scale=D**-0.5)
            zeros(b + "mlp.w12.bias", 2 * h)
            w(b + "mlp.w3.weight", D, h, scale=h**-0.5)
            zeros(b + "mlp.w3.bias", D)
        else:
            w(b + "mlp.fc1.weight", 4 * D, D, scale=D**-0.5)
            zeros(b + "mlp.fc1.bias", 4 * D)
            w(b + "mlp.fc2.weight", D, 4 * D, scale=D**-0.5)
            zeros(b + "mlp.fc2.bias", D)
        ones(b + "ls1.gamma", D)
        ones(b + "ls2.gamma", D)
    ones("encoder.norm.weight", D); zeros("encoder.norm.bias", D)  # noqa: E702

    # ---- decoder (RAFT-DPT)
    fc, dec, hid = c["feature_channels"], c["decoder_channels"], c["hidden"]
    for i in range(4):
        w(f"decoder.projects.{i}.weight", fc[i], D, 1, 1, scale=D**-0.5)
        zeros(f"decoder.projects.{i}.bias", fc[i])
    w("decoder.resize_layers.0.weight", fc[0], fc[0], 4, 4, scale=0.05)
    zeros("decoder.resize_layers.0.bias", fc[0])
    w("decoder.resize_layers.1.weight", fc[1], fc[1], 2, 2, scale=0.05)
    zeros("decoder.resize_layers.1.bias", fc[1])
    for i in range(1, 5):
        w(f"decoder.scratch.layer{i}_rn.weight", dec[i], fc[i - 1], 3, 3, scale=0.05)
    widths = {4: (dec[4], dec[3]), 3: (dec[3], dec[2]), 2: (dec[2], dec[1]), 1: (dec[1], dec[0])}
    for i, (cin, cout) in widths.items():
        rb = f"decoder.scratch.refinenet{i}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            w(rb + unit + ".conv1.weight", cin, cin, 3, 3, scale=0.05)
            zeros(rb + unit + ".conv1.bias", cin)
            w(rb + unit + ".conv2.weight", cin, cin, 3, 3, scale=0.05)
            zeros(rb + unit + ".conv2.bias", cin)
        w(rb + "out_conv.weight", cout, cin, 1, 1, scale=0.05)
        zeros(rb + "out_conv.bias", cout)
    for i, cs in enumerate((dec[0], dec[1], dec[2])):
        w(f"decoder.context_convs.{i}.weight", 2 * hid, cs, 3, 3, scale=0.05)
        zeros(f"decoder.context_convs.{i}.bias", 2 * hid)
    w("decoder.init_head.weight", 4, dec[0], 3, 3, scale=0.05)
    zeros("decoder.init_head.bias", 4)
    ub = "decoder.update_block."
    w(ub + "encoder.conv1.weight", hid, 4, 7, 7, scale=0.05)
    zeros(ub + "encoder.conv1.bias", hid)
    w(ub + "encoder.conv2.weight", hid - 4, hid, 3, 3, scale=0.05)
    zeros(ub + "encoder.conv2.bias", hid - 4)
    for g, inp in {"gru16": hid, "gru08": 2 * hid, "gru04": 2 * hid}.items():
        for gate in ("convz", "convr", "convq"):
            w(ub + f"{g}.{gate}.weight", hid, hid + inp, 3, 3, scale=0.05)
            zeros(ub + f"{g}.{gate}.bias", hid)
    w(ub + "head.conv1.weight", hid, hid, 3, 3, scale=0.05)
    zeros(ub + "head.conv1.bias", hid)
    w(ub + "head.conv2.weight", 4, hid, 3, 3, scale=0.05)
    zeros(ub + "head.conv2.bias", 4)
    w("decoder.mask_head.conv1.weight", 2 * hid, hid, 3, 3, scale=0.05)
    zeros("decoder.mask_head.conv1.bias", 2 * hid)
    w("decoder.mask_head.conv2.weight", 9 * 16, 2 * hid, 1, 1, scale=0.05)
    zeros("decoder.mask_head.conv2.bias", 9 * 16)
    w("decoder.confidence_head.conv1.weight", hid, hid, 3, 3, scale=0.05)
    zeros("decoder.confidence_head.conv1.bias", hid)
    w("decoder.confidence_head.conv2.weight", 2, hid, 3, 3, scale=0.05)
    zeros("decoder.confidence_head.conv2.bias", 2)
    return out


class Metric3Dv2:
    """Functional Metric3Dv2 on `device`. Params: flat dict of official names -> tensors."""

    def __init__(self, conf=None, device="cuda"):
        conf = dict(conf or {})
        enc = conf.get("encoder", "vit_large_reg")
        base = dict(MODEL_CONFIGS[enc])
        base.update({k: v for k, v in conf.items() if k in base})
        self.conf = {
            **base,
            "encoder": enc,
            "patch": conf.get("patch", 14),
            "num_register_tokens": conf.get("num_register_tokens", 4),
            "iters": conf.get("iters", 4),
            "crop_size": tuple(conf.get("crop_size", CROP_SIZE)),
            "canonical_focal": conf.get("canonical_focal", CANONICAL_FOCAL),
            "depth_range_max": conf.get("depth_range_max", DEPTH_RANGE_MAX),
            "pos_grid": conf.get("pos_grid", 37),  # 518/14 pretraining grid
        }
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            for key in ("model_state_dict", "state_dict", "model"):
                if isinstance(sd, dict) and key in sd:
                    sd = sd[key]
            # manifest check only at the official architecture size (tests load tiny checkpoints this way)
            official = all(self.conf.get(k) == v for k, v in MODEL_CONFIGS[enc].items())
            if official:
                self.params = convert_checked(self.params_from_torch_state_dict, sd, f"metric3dv2-{TAGS[enc]}",
                                              where=str(wp))
            else:
                self.params = self.params_from_torch_state_dict(sd)

    # ------------------------------------------------------------- params
    def params_from_torch_state_dict(self, sd, strict=True):
        """The official checkpoint layout: strips ``module.`` /
        ``depth_model.`` prefixes, keeps ``encoder.*`` / ``decoder.*``
        (without the unused mask_token) as float32 tensors on the device."""
        out = {}
        unmatched = []
        for k, v in sd.items():
            for pre in ("module.", "depth_model."):
                if k.startswith(pre):
                    k = k[len(pre):]
                if k.startswith(pre):  # module.depth_model.*
                    k = k[len(pre):]
            if k.startswith(("encoder.", "decoder.")):
                if "mask_token" in k:
                    continue
                out[k] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            else:
                unmatched.append(k)
        if strict and unmatched:
            raise ValueError(f"unrecognized checkpoint keys (not encoder./decoder.): {unmatched[:8]}")
        return out

    def init_random(self, seed=0, on_device=False):
        """Seeded params under the official naming. By default the JAX
        package's numpy draws in its order (both packages get the same
        weights); on_device draws them on the device from a seeded
        torch.Generator instead (other numbers, the same shapes and
        scales: the giant2 encoder's 1.1 B values in seconds)."""
        shapes = param_shapes(self.conf)
        p = {}
        if on_device:
            g = torch.Generator(device=self.device).manual_seed(seed)
            for name, shape, kind, scale in shapes:
                if kind == "w":
                    p[name] = torch.randn(shape, generator=g, device=self.device) * scale
                else:
                    p[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=self.device)
        else:
            rng = np.random.default_rng(seed)
            for name, shape, kind, scale in shapes:
                if kind == "w":
                    a = rng.normal(scale=scale, size=shape).astype(np.float32)
                else:
                    a = (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
                p[name] = torch.as_tensor(a, device=self.device)
        self.params = p
        return p

    # ------------------------------------------------------------ encoder
    def _backbone(self, p, x, patch_hw):
        c = self.conf
        D, H, depth, R = c["dim"], c["heads"], c["depth"], c["num_register_tokens"]
        h, w = patch_hw
        B = x.shape[0]
        tok = _conv(x, p["encoder.patch_embed.proj.weight"], p["encoder.patch_embed.proj.bias"], stride=c["patch"],
                    pad="VALID").reshape(B, h * w, D)
        pe = p["encoder.pos_embed"]
        M = int(math.isqrt(pe.shape[1] - 1))
        cls_pe, patch_pe = pe[:, :1], pe[:, 1:].reshape(1, M, M, D)
        if (h, w) != (M, M):
            # DINOv2 interpolate_offset=0.1 bicubic convention
            patch_pe = _resize(patch_pe, (h, w), mode="bicubic", scales=((h + 0.1) / M, (w + 0.1) / M))
        tok = tok + patch_pe.reshape(1, h * w, D)
        cls = (p["encoder.cls_token"] + cls_pe).expand(B, 1, D)
        reg = p["encoder.register_tokens"].expand(B, R, D)
        tok = torch.cat([cls, reg, tok], 1)

        hooks = set(c["hooks"])
        feats = []
        hd = D // H
        for i in range(depth):
            b = f"encoder.blocks.{i}."
            y = _ln(tok, p[b + "norm1.weight"], p[b + "norm1.bias"])
            qkv = (y @ p[b + "attn.qkv.weight"].T + p[b + "attn.qkv.bias"]).reshape(B, -1, 3, H, hd)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # (B,H,n,hd)
            a = torch.softmax((q @ k.transpose(-1, -2)) * (hd**-0.5), -1)
            y = (a @ v).transpose(1, 2).reshape(B, -1, D)
            y = y @ p[b + "attn.proj.weight"].T + p[b + "attn.proj.bias"]
            tok = tok + y * p[b + "ls1.gamma"]
            y = _ln(tok, p[b + "norm2.weight"], p[b + "norm2.bias"])
            if c["mlp"] == "swiglu":
                y = y @ p[b + "mlp.w12.weight"].T + p[b + "mlp.w12.bias"]
                y1, y2 = y.chunk(2, -1)
                y = (F.silu(y1) * y2) @ p[b + "mlp.w3.weight"].T + p[b + "mlp.w3.bias"]
            else:
                y = F.gelu(y @ p[b + "mlp.fc1.weight"].T + p[b + "mlp.fc1.bias"])
                y = y @ p[b + "mlp.fc2.weight"].T + p[b + "mlp.fc2.bias"]
            tok = tok + y * p[b + "ls2.gamma"]
            if i in hooks:
                feats.append(tok)
        # the final norm on each hooked output, then the cls + register tokens dropped
        return [_ln(f, p["encoder.norm.weight"], p["encoder.norm.bias"])[:, 1 + R:] for f in feats]

    # ------------------------------------------------------------ decoder
    @staticmethod
    def _gru(p, prefix, h, x):
        hx = torch.cat([h, x], -1)
        z = torch.sigmoid(_conv(hx, p[prefix + ".convz.weight"], p[prefix + ".convz.bias"]))
        r = torch.sigmoid(_conv(hx, p[prefix + ".convr.weight"], p[prefix + ".convr.bias"]))
        q = torch.tanh(_conv(torch.cat([r * h, x], -1), p[prefix + ".convq.weight"], p[prefix + ".convq.bias"]))
        return (1 - z) * h + z * q

    @staticmethod
    def _convex_upsample(x, mask, factor=4):
        """RAFT convex upsampling: x (B,h,w,C), mask (B,h,w,9*f*f)."""
        B, h, w, C = x.shape
        mask = torch.softmax(mask.reshape(B, h, w, 9, factor * factor), 3)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # 3x3 neighborhoods, zero edges (torch unfold pad=1)
        neigh = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)  # (B,h,w,9,C)
        up = torch.einsum("bhwkf,bhwkc->bhwfc", mask, neigh).reshape(B, h, w, factor, factor, C)
        return up.permute(0, 1, 3, 2, 4, 5).reshape(B, h * factor, w * factor, C)

    def forward(self, p, x, patch_hw):
        """x (B, 14h, 14w, 3) normalized -> dict of canonical-space maps:
        prediction (normalized depth), confidence, normal (3), kappa."""
        c = self.conf
        h, w = patch_hw
        B = x.shape[0]
        Hc, Wc = h * c["patch"], w * c["patch"]
        hid = c["hidden"]

        feats = self._backbone(p, x, patch_hw)
        pyr = []
        for i, f in enumerate(feats):
            y = f.reshape(B, h, w, c["dim"])
            y = y @ p[f"decoder.projects.{i}.weight"][:, :, 0, 0].T + p[f"decoder.projects.{i}.bias"]
            if i < 2:
                y = _deconv_block(y, p[f"decoder.resize_layers.{i}.weight"], p[f"decoder.resize_layers.{i}.bias"],
                                  4 if i == 0 else 2)
            pyr.append(_conv(y, p[f"decoder.scratch.layer{i + 1}_rn.weight"]))
        # scales: pyr[0] 4/14, pyr[1] 2/14, pyr[2] 1/14, pyr[3] 1/14

        def rcu(prefix, x):
            y = _conv(F.relu(x), p[prefix + ".conv1.weight"], p[prefix + ".conv1.bias"])
            y = _conv(F.relu(y), p[prefix + ".conv2.weight"], p[prefix + ".conv2.bias"])
            return x + y

        def fuse(i, x, res, size):
            rb = f"decoder.scratch.refinenet{i}"
            if res is not None:
                x = x + rcu(rb + ".resConfUnit1", res)
            x = rcu(rb + ".resConfUnit2", x)
            if size is not None:
                x = _resize(x, size, align_corners=True)
            return _conv(x, p[rb + ".out_conv.weight"], p[rb + ".out_conv.bias"])

        f4 = fuse(4, pyr[3], None, None)
        f3 = fuse(3, f4, pyr[2], tuple(pyr[1].shape[1:3]))
        f2 = fuse(2, f3, pyr[1], tuple(pyr[0].shape[1:3]))
        f1 = fuse(1, f2, pyr[0], None)

        # RAFT pyramid at 1/4, 1/8, 1/16 of the canonical crop
        s04, s08, s16 = (Hc // 4, Wc // 4), (Hc // 8, Wc // 8), (Hc // 16, Wc // 16)
        hiddens, contexts = [], []
        for i, (src, size) in enumerate(((f1, s04), (f2, s08), (f3, s16))):
            y = _conv(_resize(src, size), p[f"decoder.context_convs.{i}.weight"], p[f"decoder.context_convs.{i}.bias"])
            hiddens.append(torch.tanh(y[..., :hid]))
            contexts.append(F.relu(y[..., hid:]))
        h04, h08, h16 = hiddens
        c04, c08, c16 = contexts

        pred = _conv(_resize(f1, s04), p["decoder.init_head.weight"], p["decoder.init_head.bias"])  # (B,h/4,w/4,4)
        ub = "decoder.update_block."
        for _ in range(c["iters"]):
            m = F.relu(_conv(pred, p[ub + "encoder.conv1.weight"], p[ub + "encoder.conv1.bias"]))
            m = F.relu(_conv(m, p[ub + "encoder.conv2.weight"], p[ub + "encoder.conv2.bias"]))
            m = torch.cat([m, pred], -1)
            # coarse-to-fine GRU cascade (RAFT-Stereo slow-fast pattern)
            h16 = self._gru(p, ub + "gru16", h16, c16 + _resize(h08, s16))
            h08 = self._gru(p, ub + "gru08", h08, torch.cat([c08 + _resize(h04, s08), _resize(h16, s08)], -1))
            h04 = self._gru(p, ub + "gru04", h04, torch.cat([c04 + m, _resize(h08, s04)], -1))
            d = F.relu(_conv(h04, p[ub + "head.conv1.weight"], p[ub + "head.conv1.bias"]))
            pred = pred + _conv(d, p[ub + "head.conv2.weight"], p[ub + "head.conv2.bias"])

        conf = F.relu(_conv(h04, p["decoder.confidence_head.conv1.weight"], p["decoder.confidence_head.conv1.bias"]))
        conf = _conv(conf, p["decoder.confidence_head.conv2.weight"], p["decoder.confidence_head.conv2.bias"])
        mask = F.relu(_conv(h04, p["decoder.mask_head.conv1.weight"], p["decoder.mask_head.conv1.bias"]))
        mask = _conv(mask, p["decoder.mask_head.conv2.weight"], p["decoder.mask_head.conv2.bias"])

        full = self._convex_upsample(torch.cat([pred, conf], -1), mask, factor=4)  # (B,Hc,Wc,6)
        normal = full[..., 1:4]
        normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-6)
        return {
            "prediction": full[..., 0],
            "confidence": torch.clamp(torch.sigmoid(full[..., 4]), 0.0, 1.0),
            "normal": normal,
            "kappa": F.elu(full[..., 5]) + 1.0,
        }

    # ------------------------------------------------------------- host API
    def infer_image(self, image_rgb, intrinsics, flip=False):
        """uint8/float HxWx3 + (fx, fy, cx, cy) -> depth (m),
        depth_variance, normals (BNI coords), normals_variance, valid at the
        input resolution, as host float64 arrays (valid bool), through the
        reference's scale-canonical transform."""
        assert self.params is not None, "load weights or call init_random() first"
        c = self.conf
        dev = self.device
        img = np.asarray(image_rgb, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        if img.max() <= 2.0:
            img = img * 255.0
        H0, W0 = img.shape[:2]
        fx, fy = float(intrinsics[0]), float(intrinsics[1])
        ori_focal = 0.5 * (fx + fy)
        crop_h, crop_w = c["crop_size"]
        scale = min(crop_h / H0, crop_w / W0)
        rh, rw = int(H0 * scale), int(W0 * scale)
        label_scale_factor = (c["canonical_focal"] / ori_focal) * scale

        with torch.no_grad():
            x = _resize(torch.as_tensor((img - MEAN_255) / STD_255, device=dev)[None], (rh, rw))
            pad_h, pad_w = crop_h - rh, crop_w - rw
            pt, pl = pad_h // 2, pad_w // 2
            x = F.pad(x, (0, 0, pl, pad_w - pl, pt, pad_h - pt))
            if flip:
                x = torch.flip(x, [2])
            out = self.forward(self.params, x, (crop_h // c["patch"], crop_w // c["patch"]))
            out = {k: v[0] for k, v in out.items()}
            if flip:
                out = {k: torch.flip(v, [1]) for k, v in out.items()}

            def unpad_resize(m):
                m = m[pt:pt + rh, pl:pl + rw]
                if m.ndim == 2:
                    return _resize(m[None, ..., None], (H0, W0))[0, ..., 0].cpu().numpy()
                return _resize(m[None], (H0, W0))[0].cpu().numpy()

            pred = unpad_resize(out["prediction"])
            conf = np.clip(unpad_resize(out["confidence"]), 0.0, 1.0)
            normals = unpad_resize(out["normal"])
            kappa = unpad_resize(out["kappa"])
        valid = pred < 200.0  # metric3dv2.py:129 valid_canon
        depth = pred * c["depth_range_max"] / label_scale_factor
        error = depth * (1.0 - conf)
        # omni -> BNI coords (metric3dv2.py:151-153): y,z negated
        normals = normals * np.array([1.0, -1.0, -1.0])
        if flip:
            normals[..., 0] *= -1.0
        return {
            "depth": np.asarray(depth, np.float64),
            "depth_variance": np.asarray(error, np.float64) ** 2,
            "normals": np.asarray(normals, np.float64),
            "normals_variance": kappa_to_alpha(kappa) ** 2,
            "valid": valid & (depth > 0),
        }
