"""Plain Metric3Dv2 (DINOv2-reg ViT + RAFT-DPT head) in float32 torch: the
benchmark's frozen reference of the depth and normal prior.

It follows the published architecture (Hu et al., "Metric3D v2", 2024;
github.com/YvanYin/Metric3D, vit.raft5.{small,large,giant2}): the DINOv2
ViT with 4 register tokens (SwiGLU for giant2) and the +0.1 bicubic
position-embedding interpolation; the RAFT-DPT decoder (token-to-feature
pyramid, DPT fusion, a 3-level ConvGRU at 1/4-1/8-1/16, convex
upsampling, joint depth + normal + kappa heads); the inference wrapper of
MP-SfM (resize into the 616×1064 crop, pad with the ImageNet mean, depth =
prediction · 200 / label_scale_factor, normals with y and z negated).
Channels last. Parameters: a flat dict under the official names of
metric_depth_vit_*_800k.pth after its ``depth_model.`` prefix.

`param_shapes` also serves the weight maker (weights/metric3dv2.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MODEL_CONFIGS = {
    "vit_small_reg": dict(dim=384, depth=12, heads=6, mlp="mlp", hooks=(2, 5, 8, 11),
                          feature_channels=(96, 192, 384, 768), decoder_channels=(48, 96, 192, 384, 384), hidden=48),
    "vit_large_reg": dict(dim=1024, depth=24, heads=16, mlp="mlp", hooks=(4, 11, 17, 23),
                          feature_channels=(256, 512, 1024, 1024), decoder_channels=(128, 256, 512, 1024, 1024),
                          hidden=128),
    "vit_giant2_reg": dict(dim=1536, depth=40, heads=24, mlp="swiglu", hooks=(9, 19, 29, 39),
                           feature_channels=(384, 768, 1536, 1536), decoder_channels=(192, 384, 768, 1536, 1536),
                           hidden=192),
}
MEAN_255 = np.array([123.675, 116.28, 103.53], np.float32)
STD_255 = np.array([58.395, 57.12, 57.375], np.float32)


def conf_of(spec):
    """The net's full conf from a configuration file's entry: the encoder's
    preset, overridden by any width the entry gives (tests only)."""
    c = dict(MODEL_CONFIGS[spec.get("encoder", "vit_giant2_reg")])
    c.update({k: spec[k] for k in c if k in spec})
    c.update(patch=spec.get("patch", 14), num_register_tokens=spec.get("num_register_tokens", 4),
             iters=spec.get("iters", 4), crop_size=tuple(spec.get("crop_size", (616, 1064))),
             canonical_focal=spec.get("canonical_focal", 1000.0), depth_range_max=200.0,
             pos_grid=spec.get("pos_grid", 37))
    return c


def swiglu_hidden(dim):
    return (int(dim * 4 * 2 / 3) + 7) // 8 * 8


def param_shapes(c):
    """(name, shape, kind, scale): kind "w" a normal draw of that scale,
    "zeros" or "ones"."""
    D, depth, R, ps = c["dim"], c["depth"], c["num_register_tokens"], c["patch"]
    out = []

    def w(name, *shape, scale=0.02):
        out.append((name, shape, "w", scale))

    def zeros(name, *shape):
        out.append((name, shape, "zeros", 0.0))

    def ones(name, *shape):
        out.append((name, shape, "ones", 0.0))

    w("encoder.cls_token", 1, 1, D)
    M = c["pos_grid"]
    w("encoder.pos_embed", 1, 1 + M * M, D)
    w("encoder.register_tokens", 1, R, D)
    w("encoder.patch_embed.proj.weight", D, 3, ps, ps)
    zeros("encoder.patch_embed.proj.bias", D)
    for i in range(depth):
        b = f"encoder.blocks.{i}."
        ones(b + "norm1.weight", D)
        zeros(b + "norm1.bias", D)
        ones(b + "norm2.weight", D)
        zeros(b + "norm2.bias", D)
        w(b + "attn.qkv.weight", 3 * D, D, scale=D**-0.5)
        zeros(b + "attn.qkv.bias", 3 * D)
        w(b + "attn.proj.weight", D, D, scale=D**-0.5)
        zeros(b + "attn.proj.bias", D)
        if c["mlp"] == "swiglu":
            h = swiglu_hidden(D)
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
    ones("encoder.norm.weight", D)
    zeros("encoder.norm.bias", D)
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


# ------------------------------------------------------------------ ops
def _cubic(x, a=-0.75):
    x = np.abs(x)
    return np.where(x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
                    np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))


def interp_matrix(n_src, n_dst, mode="bilinear", align_corners=False, scale=None):
    """(n_dst, n_src) matrix of torch's interpolate conventions, with
    `scale` overriding the implied factor (DINOv2's +0.1 offset)."""
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
    rows = np.arange(n_dst)
    if mode == "bilinear":
        lo = np.floor(src).astype(int)
        frac = src - lo
        np.add.at(W, (rows, np.clip(lo, 0, n_src - 1)), 1 - frac)
        np.add.at(W, (rows, np.clip(lo + 1, 0, n_src - 1)), frac)
    else:
        base = np.floor(src).astype(int)
        for k in range(-1, 3):
            np.add.at(W, (rows, np.clip(base + k, 0, n_src - 1)), _cubic(src - (base + k)))
    return W


def resize(x, hw, mode="bilinear", align_corners=False, scales=None):
    """(B,H,W,C) -> (B,h,w,C) by separable matrices."""
    _, H, W0, _ = x.shape
    h, w = hw
    if (H, W0) == (h, w):
        return x
    Wh = torch.as_tensor(interp_matrix(H, h, mode, align_corners, scales[0] if scales else None), dtype=x.dtype,
                         device=x.device)
    Ww = torch.as_tensor(interp_matrix(W0, w, mode, align_corners, scales[1] if scales else None), dtype=x.dtype,
                         device=x.device)
    return torch.einsum("hH,bHWc,wW->bhwc", Wh, x, Ww)


def layer_norm(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _same_pad(n, k, s):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, b=None, stride=1, pad="SAME"):
    """NHWC convolution with an (O, I, kh, kw) kernel and 'SAME' (odd pixel
    bottom and right) or 'VALID' padding."""
    y = x.permute(0, 3, 1, 2)
    kh, kw = w.shape[2:]
    if pad == "SAME":
        (t, bo), (lft, r) = _same_pad(y.shape[2], kh, stride), _same_pad(y.shape[3], kw, stride)
        y = F.conv2d(F.pad(y, (lft, r, t, bo)), w, b, stride)
    else:
        y = F.conv2d(y, w, b, stride)
    return y.permute(0, 2, 3, 1)


def deconv(x, w, b, f):
    """ConvTranspose2d with kernel == stride == f."""
    B, h, wd, _ = x.shape
    y = torch.einsum("bhwc,copq->bhpwqo", x, w)
    return y.reshape(B, h * f, wd * f, w.shape[1]) + b


# ------------------------------------------------------------------ net
def backbone(c, p, x, patch_hw):
    D, H, depth, R = c["dim"], c["heads"], c["depth"], c["num_register_tokens"]
    h, w = patch_hw
    B = x.shape[0]
    tok = conv(x, p["encoder.patch_embed.proj.weight"], p["encoder.patch_embed.proj.bias"], stride=c["patch"],
               pad="VALID").reshape(B, h * w, D)
    pe = p["encoder.pos_embed"]
    M = int(math.isqrt(pe.shape[1] - 1))
    patch_pe = pe[:, 1:].reshape(1, M, M, D)
    if (h, w) != (M, M):
        patch_pe = resize(patch_pe, (h, w), mode="bicubic", scales=((h + 0.1) / M, (w + 0.1) / M))
    tok = tok + patch_pe.reshape(1, h * w, D)
    cls = (p["encoder.cls_token"] + pe[:, :1]).expand(B, 1, D)
    tok = torch.cat([cls, p["encoder.register_tokens"].expand(B, R, D), tok], 1)
    feats, hd = [], D // H
    for i in range(depth):
        b = f"encoder.blocks.{i}."
        y = layer_norm(tok, p[b + "norm1.weight"], p[b + "norm1.bias"])
        qkv = (y @ p[b + "attn.qkv.weight"].T + p[b + "attn.qkv.bias"]).reshape(B, -1, 3, H, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = torch.softmax((q @ k.transpose(-1, -2)) * (hd**-0.5), -1)
        y = (a @ v).transpose(1, 2).reshape(B, -1, D) @ p[b + "attn.proj.weight"].T + p[b + "attn.proj.bias"]
        tok = tok + y * p[b + "ls1.gamma"]
        y = layer_norm(tok, p[b + "norm2.weight"], p[b + "norm2.bias"])
        if c["mlp"] == "swiglu":
            y1, y2 = (y @ p[b + "mlp.w12.weight"].T + p[b + "mlp.w12.bias"]).chunk(2, -1)
            y = (F.silu(y1) * y2) @ p[b + "mlp.w3.weight"].T + p[b + "mlp.w3.bias"]
        else:
            y = F.gelu(y @ p[b + "mlp.fc1.weight"].T + p[b + "mlp.fc1.bias"])
            y = y @ p[b + "mlp.fc2.weight"].T + p[b + "mlp.fc2.bias"]
        tok = tok + y * p[b + "ls2.gamma"]
        if i in c["hooks"]:
            feats.append(tok)
    return [layer_norm(f, p["encoder.norm.weight"], p["encoder.norm.bias"])[:, 1 + R:] for f in feats]


def _gru(p, prefix, h, x):
    hx = torch.cat([h, x], -1)
    z = torch.sigmoid(conv(hx, p[prefix + ".convz.weight"], p[prefix + ".convz.bias"]))
    r = torch.sigmoid(conv(hx, p[prefix + ".convr.weight"], p[prefix + ".convr.bias"]))
    q = torch.tanh(conv(torch.cat([r * h, x], -1), p[prefix + ".convq.weight"], p[prefix + ".convq.bias"]))
    return (1 - z) * h + z * q


def _convex_upsample(x, mask, factor=4):
    B, h, w, C = x.shape
    mask = torch.softmax(mask.reshape(B, h, w, 9, factor * factor), 3)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)
    up = torch.einsum("bhwkf,bhwkc->bhwfc", mask, neigh).reshape(B, h, w, factor, factor, C)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, h * factor, w * factor, C)


def forward(c, p, x, patch_hw):
    """x (B, 14h, 14w, 3) normalized -> canonical maps: prediction,
    confidence, normal (3), kappa."""
    h, w = patch_hw
    B = x.shape[0]
    Hc, Wc, hid = h * c["patch"], w * c["patch"], c["hidden"]
    pyr = []
    for i, f in enumerate(backbone(c, p, x, patch_hw)):
        y = f.reshape(B, h, w, c["dim"]) @ p[f"decoder.projects.{i}.weight"][:, :, 0, 0].T \
            + p[f"decoder.projects.{i}.bias"]
        if i < 2:
            y = deconv(y, p[f"decoder.resize_layers.{i}.weight"], p[f"decoder.resize_layers.{i}.bias"],
                       4 if i == 0 else 2)
        pyr.append(conv(y, p[f"decoder.scratch.layer{i + 1}_rn.weight"]))

    def rcu(prefix, x):
        y = conv(F.relu(x), p[prefix + ".conv1.weight"], p[prefix + ".conv1.bias"])
        return x + conv(F.relu(y), p[prefix + ".conv2.weight"], p[prefix + ".conv2.bias"])

    def fuse(i, x, res, size):
        rb = f"decoder.scratch.refinenet{i}"
        if res is not None:
            x = x + rcu(rb + ".resConfUnit1", res)
        x = rcu(rb + ".resConfUnit2", x)
        if size is not None:
            x = resize(x, size, align_corners=True)
        return conv(x, p[rb + ".out_conv.weight"], p[rb + ".out_conv.bias"])

    f4 = fuse(4, pyr[3], None, None)
    f3 = fuse(3, f4, pyr[2], tuple(pyr[1].shape[1:3]))
    f2 = fuse(2, f3, pyr[1], tuple(pyr[0].shape[1:3]))
    f1 = fuse(1, f2, pyr[0], None)
    s04, s08, s16 = (Hc // 4, Wc // 4), (Hc // 8, Wc // 8), (Hc // 16, Wc // 16)
    hiddens, contexts = [], []
    for i, (src, size) in enumerate(((f1, s04), (f2, s08), (f3, s16))):
        y = conv(resize(src, size), p[f"decoder.context_convs.{i}.weight"], p[f"decoder.context_convs.{i}.bias"])
        hiddens.append(torch.tanh(y[..., :hid]))
        contexts.append(F.relu(y[..., hid:]))
    h04, h08, h16 = hiddens
    c04, c08, c16 = contexts
    pred = conv(resize(f1, s04), p["decoder.init_head.weight"], p["decoder.init_head.bias"])
    ub = "decoder.update_block."
    for _ in range(c["iters"]):
        m = F.relu(conv(pred, p[ub + "encoder.conv1.weight"], p[ub + "encoder.conv1.bias"]))
        m = torch.cat([F.relu(conv(m, p[ub + "encoder.conv2.weight"], p[ub + "encoder.conv2.bias"])), pred], -1)
        h16 = _gru(p, ub + "gru16", h16, c16 + resize(h08, s16))
        h08 = _gru(p, ub + "gru08", h08, torch.cat([c08 + resize(h04, s08), resize(h16, s08)], -1))
        h04 = _gru(p, ub + "gru04", h04, torch.cat([c04 + m, resize(h08, s04)], -1))
        d = F.relu(conv(h04, p[ub + "head.conv1.weight"], p[ub + "head.conv1.bias"]))
        pred = pred + conv(d, p[ub + "head.conv2.weight"], p[ub + "head.conv2.bias"])
    cf = F.relu(conv(h04, p["decoder.confidence_head.conv1.weight"], p["decoder.confidence_head.conv1.bias"]))
    cf = conv(cf, p["decoder.confidence_head.conv2.weight"], p["decoder.confidence_head.conv2.bias"])
    mask = F.relu(conv(h04, p["decoder.mask_head.conv1.weight"], p["decoder.mask_head.conv1.bias"]))
    mask = conv(mask, p["decoder.mask_head.conv2.weight"], p["decoder.mask_head.conv2.bias"])
    full = _convex_upsample(torch.cat([pred, cf], -1), mask)
    normal = full[..., 1:4]
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-6)
    return {"prediction": full[..., 0], "confidence": torch.clamp(torch.sigmoid(full[..., 4]), 0.0, 1.0),
            "normal": normal, "kappa": F.elu(full[..., 5]) + 1.0}


def canonical_input(c, rgb):
    """The wrapper's scale-canonical input of an (H, W, 3) uint8 image:
    (x (1, crop_h, crop_w, 3) on the host, (top, left, rh, rw), scale)."""
    img = np.asarray(rgb, np.float32)
    H0, W0 = img.shape[:2]
    crop_h, crop_w = c["crop_size"]
    scale = min(crop_h / H0, crop_w / W0)
    rh, rw = int(H0 * scale), int(W0 * scale)
    return img, (crop_h, crop_w, rh, rw), scale


def infer(c, p, rgb, intrinsics, device):
    """depth (m) and normals (BNI coordinates) of one uint8 RGB image at its
    own resolution, float64 host arrays."""
    img, (crop_h, crop_w, rh, rw), scale = canonical_input(c, rgb)
    H0, W0 = img.shape[:2]
    fx, fy = float(intrinsics[0]), float(intrinsics[1])
    label_scale_factor = (c["canonical_focal"] / (0.5 * (fx + fy))) * scale
    with torch.no_grad():
        x = resize(torch.as_tensor((img - MEAN_255) / STD_255, device=device)[None], (rh, rw))
        pad_h, pad_w = crop_h - rh, crop_w - rw
        pt, pl = pad_h // 2, pad_w // 2
        x = F.pad(x, (0, 0, pl, pad_w - pl, pt, pad_h - pt))
        out = {k: v[0] for k, v in forward(c, p, x, (crop_h // c["patch"], crop_w // c["patch"])).items()}

        def back(m):
            m = m[pt:pt + rh, pl:pl + rw]
            if m.ndim == 2:
                return resize(m[None, ..., None], (H0, W0))[0, ..., 0].cpu().numpy()
            return resize(m[None], (H0, W0))[0].cpu().numpy()

        pred, normals = back(out["prediction"]), back(out["normal"])
    depth = pred.astype(np.float64) * c["depth_range_max"] / label_scale_factor
    return {"depth": depth, "normals": normals.astype(np.float64) * np.array([1.0, -1.0, -1.0])}


def rel_gap(got, ref, scale=None):
    """The largest |got − ref| over `scale` (by default the largest |ref|);
    infinite where either side is not finite, so that an overflow or a NaN
    fails and never reads as 0."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not (np.isfinite(got).all() and np.isfinite(ref).all()):
        return float("inf")
    scale = np.abs(ref).max() if scale is None else scale
    return float(np.abs(got - ref).max() / max(scale, 1e-30))


def load(path, device):
    """The checkpoint's float32 parameters on `device` (``depth_model.``
    prefix stripped)."""
    sd = torch.load(path, map_location="cpu")
    return {k[len("depth_model."):] if k.startswith("depth_model.") else k: v.to(device=device, dtype=torch.float32)
            for k, v in sd.items()}


def compare(ctx):
    """m3d_depth_gap, m3d_normal_gap: over the scene's images, the largest
    gap of the program's prior depth to the reference's over the largest
    reference depth (where the prior keeps its depth), and the largest gap
    of a normal's component, from the program's prior cache. In the control the reference with TF32 on (the
    precision below the configuration's float32 with TF32 off) takes the
    program's place."""
    spec = ctx.net("metric3dv2")
    c = conf_of(spec)
    p = load(spec["path"], ctx.device)
    dgap, ngap = 0.0, 0.0
    for name, rgb in ctx.scene_images():
        ref = infer(c, p, rgb, ctx.intrinsics(name), ctx.device)
        if ctx.control:
            with ctx.lower_precision():
                got = infer(c, p, rgb, ctx.intrinsics(name), ctx.device)
        else:
            got = ctx.program_mono(name)
        if "depth" in ctx.program_mono(name):  # a normals-only prior (metric3dv2-normals) keeps no depth
            dgap = max(dgap, rel_gap(got["depth"], ref["depth"]))
        else:
            dgap = None
        ngap = max(ngap, rel_gap(got["normals"], ref["normals"], scale=1.0))
    return {"m3d_normal_gap": ngap} if dgap is None else {"m3d_depth_gap": dgap, "m3d_normal_gap": ngap}
