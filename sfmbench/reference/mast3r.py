"""Plain MASt3R (Leroy et al., "Grounding Image Matching in 3D with MASt3R",
2024; MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth) in float32
torch, the benchmark's frozen reference of the two-view net: the CroCo
ViT-L encoder with 2-D RoPE over both views, the asymmetric dual decoder
(self-attention, cross-attention to the other view, MLP; 12 blocks a
view), the DPT pointmap heads (pts3d = unit(xyz)·expm1(|xyz|), conf =
1 + exp) and the catMLP local-feature heads. Images in [0, 1], normalized
by 0.5 / 0.5, zero-padded to multiples of 16, never resized. Channels last.

`param_shapes` also serves the weight maker (weights/mast3r.py). `compare`
holds the program's two-view depth of each pair (its pair-depth cache: the
pointmap's z of each view in view 1's frame) against this reference.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

CONFIG = dict(enc_dim=1024, enc_depth=24, enc_heads=16, dec_dim=768, dec_depth=12, dec_heads=12, patch=16,
              desc_dim=24, rope_freq=100.0, dpt_layer_dims=(96, 192, 384, 768), dpt_feature_dim=256,
              mlp_hidden_factor=4.0)


def _ops():
    """The plain convolution, resize and norm ops of reference/metric3dv2.py."""
    spec = importlib.util.spec_from_file_location("sfmbench_reference_mast3r_ops",
                                                  Path(__file__).resolve().parent / "metric3dv2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OPS = _ops()


def conf_of(spec):
    return {**CONFIG, **{k: spec[k] for k in CONFIG if k in spec}}


def param_shapes(c):
    """(name, shape, kind, scale) of the official parameters."""
    De, Dd, ps, dd = c["enc_dim"], c["dec_dim"], c["patch"], c["desc_dim"]
    out = []

    def w(name, *shape, scale=0.02):
        out.append((name, shape, "w", scale))

    def zeros(name, *shape):
        out.append((name, shape, "zeros", 0.0))

    def norm(name, D):
        out.append((name + ".weight", (D,), "ones", 0.0))
        zeros(name + ".bias", D)

    def lin(name, o, i):
        w(name + ".weight", o, i, scale=i ** -0.5)
        zeros(name + ".bias", o)

    def block(b, D, cross):
        norm(b + "norm1", D)
        lin(b + "attn.qkv", 3 * D, D)
        lin(b + "attn.proj", D, D)
        norm(b + "norm2", D)
        if cross:
            norm(b + "norm_y", D)
            for nm in ("projq", "projk", "projv", "proj"):
                lin(b + f"cross_attn.{nm}", D, D)
            norm(b + "norm3", D)
        lin(b + "mlp.fc1", 4 * D, D)
        w(b + "mlp.fc2.weight", D, 4 * D, scale=D ** -0.5)
        zeros(b + "mlp.fc2.bias", D)

    def conv(name, o, i, k, bias=True):
        w(name + ".weight", o, i, k, k, scale=0.05)
        if bias:
            zeros(name + ".bias", o)

    w("patch_embed.proj.weight", De, 3, ps, ps)
    zeros("patch_embed.proj.bias", De)
    for i in range(c["enc_depth"]):
        block(f"enc_blocks.{i}.", De, cross=False)
    norm("enc_norm", De)
    lin("decoder_embed", Dd, De)
    for stack in ("dec_blocks", "dec_blocks2"):
        for i in range(c["dec_depth"]):
            block(f"{stack}.{i}.", Dd, cross=True)
    norm("dec_norm", Dd)
    ld, Fd = c["dpt_layer_dims"], c["dpt_feature_dim"]
    for hname in ("downstream_head1", "downstream_head2"):
        hp = hname + ".dpt."
        for k, din in enumerate((De, Dd, Dd, Dd)):
            conv(hp + f"act_postprocess.{k}.0", ld[k], din, 1)
        conv(hp + "act_postprocess.0.1", ld[0], ld[0], 4)
        conv(hp + "act_postprocess.1.1", ld[1], ld[1], 2)
        conv(hp + "act_postprocess.3.1", ld[3], ld[3], 3)
        for k in range(1, 5):
            conv(hp + f"scratch.layer{k}_rn", Fd, ld[k - 1], 3, bias=False)
        for k in range(1, 5):
            rb = hp + f"scratch.refinenet{k}."
            for unit in ("resConfUnit1", "resConfUnit2"):
                conv(rb + unit + ".conv1", Fd, Fd, 3)
                conv(rb + unit + ".conv2", Fd, Fd, 3)
            conv(rb + "out_conv", Fd, Fd, 1)
        conv(hp + "head.0", Fd // 2, Fd, 3)
        conv(hp + "head.2", 32, Fd // 2, 3)
        conv(hp + "head.4", 4, 32, 1)
        idim = De + Dd
        hid = int(c["mlp_hidden_factor"] * idim)
        lin(hname + ".head_local_features.fc1", hid, idim)
        lin(hname + ".head_local_features.fc2", (dd + 1) * ps * ps, hid)
    return out


def rope_tables(h, w, hd, freq, device):
    """cos/sin (2, h·w, hd/2) of CroCo's RoPE2D: the head split in (y, x)
    halves, each rotated half against half."""
    D = hd // 2
    inv = 1.0 / (freq ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")

    def tab(p1d):
        f = np.einsum("n,k->nk", p1d.reshape(-1).astype(np.float64), inv)
        f = np.concatenate([f, f], -1)
        return np.cos(f), np.sin(f)

    (cy, sy), (cx, sx) = tab(ys), tab(xs)
    return (torch.as_tensor(np.stack([cy, cx]), dtype=torch.float32, device=device),
            torch.as_tensor(np.stack([sy, sx]), dtype=torch.float32, device=device))


def rope(t, cos, sin):
    D = t.shape[-1] // 2

    def rot(u, c, s):
        u1, u2 = u[..., : D // 2], u[..., D // 2:]
        return u * c[None, :, None, :] + torch.cat([-u2, u1], -1) * s[None, :, None, :]

    return torch.cat([rot(t[..., :D], cos[0], sin[0]), rot(t[..., D:], cos[1], sin[1])], -1)


def _lin(x, p, name):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def heads_attention(q, k, v):
    """softmax(q kᵀ / sqrt(hd)) v on (B, N, H, hd), every key real."""
    a = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * q.shape[-1] ** -0.5, -1)
    return torch.einsum("bhnm,bmhd->bnhd", a, v)


def block(p, b, x, cos, sin, heads, ctx=None):
    B, _, D = x.shape
    hd = D // heads
    ln = OPS.layer_norm
    qkv = _lin(ln(x, p[b + "norm1.weight"], p[b + "norm1.bias"]), p, b + "attn.qkv").reshape(B, -1, 3, heads, hd)
    q, k, v = rope(qkv[:, :, 0], cos, sin), rope(qkv[:, :, 1], cos, sin), qkv[:, :, 2]
    x = x + _lin(heads_attention(q, k, v).reshape(B, -1, D), p, b + "attn.proj")
    mn = "norm2"
    if ctx is not None:
        ym = ln(ctx, p[b + "norm_y.weight"], p[b + "norm_y.bias"])
        xq = ln(x, p[b + "norm2.weight"], p[b + "norm2.bias"])
        q = rope(_lin(xq, p, b + "cross_attn.projq").reshape(B, -1, heads, hd), cos, sin)
        kk = rope(_lin(ym, p, b + "cross_attn.projk").reshape(B, -1, heads, hd), cos, sin)
        vv = _lin(ym, p, b + "cross_attn.projv").reshape(B, -1, heads, hd)
        x = x + _lin(heads_attention(q, kk, vv).reshape(B, -1, D), p, b + "cross_attn.proj")
        mn = "norm3"
    y = ln(x, p[b + f"{mn}.weight"], p[b + f"{mn}.bias"])
    return x + _lin(F.gelu(_lin(y, p, b + "mlp.fc1")), p, b + "mlp.fc2")


def dpt_head(c, p, hname, hooks, patch_hw):
    conv, resize = OPS.conv, OPS.resize
    h, w = patch_hw
    hp = hname + ".dpt."
    B = hooks[0].shape[0]
    pyr = []
    for k, tok in enumerate(hooks):
        y = tok.reshape(B, h, w, tok.shape[-1])
        y = y @ p[hp + f"act_postprocess.{k}.0.weight"][:, :, 0, 0].T + p[hp + f"act_postprocess.{k}.0.bias"]
        if k in (0, 1):
            y = OPS.deconv(y, p[hp + f"act_postprocess.{k}.1.weight"], p[hp + f"act_postprocess.{k}.1.bias"],
                           4 // (k + 1))
        elif k == 3:
            y = conv(y, p[hp + "act_postprocess.3.1.weight"], p[hp + "act_postprocess.3.1.bias"], stride=2)
        pyr.append(conv(y, p[hp + f"scratch.layer{k + 1}_rn.weight"]))

    def rcu(prefix, x):
        y = conv(F.relu(x), p[prefix + ".conv1.weight"], p[prefix + ".conv1.bias"])
        return x + conv(F.relu(y), p[prefix + ".conv2.weight"], p[prefix + ".conv2.bias"])

    def fuse(i, x, res, size):
        rb = hp + f"scratch.refinenet{i}"
        if res is not None:
            x = x + rcu(rb + ".resConfUnit1", res)
        x = resize(rcu(rb + ".resConfUnit2", x), size, align_corners=True)
        return conv(x, p[rb + ".out_conv.weight"], p[rb + ".out_conv.bias"])

    path = fuse(4, pyr[3], None, tuple(pyr[2].shape[1:3]))
    path = fuse(3, path, pyr[2], tuple(pyr[1].shape[1:3]))
    path = fuse(2, path, pyr[1], tuple(pyr[0].shape[1:3]))
    path = fuse(1, path, pyr[0], (pyr[0].shape[1] * 2, pyr[0].shape[2] * 2))
    y = conv(path, p[hp + "head.0.weight"], p[hp + "head.0.bias"])
    y = resize(y, (h * c["patch"], w * c["patch"]))
    y = F.relu(conv(y, p[hp + "head.2.weight"], p[hp + "head.2.bias"]))
    y = conv(y, p[hp + "head.4.weight"], p[hp + "head.4.bias"])
    xyz = y[..., :3]
    n = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    return xyz / torch.clamp(n, min=1e-8) * torch.expm1(n), 1.0 + torch.exp(y[..., 3])


def forward(c, p, xa, xb, patch_hw):
    """Pointmaps of both views in view 1's frame and their confidences."""
    h, w = patch_hw
    dev = xa.device
    cos_e, sin_e = rope_tables(h, w, c["enc_dim"] // c["enc_heads"], c["rope_freq"], dev)
    cos_d, sin_d = rope_tables(h, w, c["dec_dim"] // c["dec_heads"], c["rope_freq"], dev)
    x = torch.cat([xa, xb], 0)
    tok = OPS.conv(x, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], stride=c["patch"], pad="VALID")
    tok = tok.reshape(x.shape[0], h * w, c["enc_dim"])
    for i in range(c["enc_depth"]):
        tok = block(p, f"enc_blocks.{i}.", tok, cos_e, sin_e, c["enc_heads"])
    tok = OPS.layer_norm(tok, p["enc_norm.weight"], p["enc_norm.bias"])
    B = xa.shape[0]
    f1e, f2e = tok[:B], tok[B:]
    f1, f2 = _lin(f1e, p, "decoder_embed"), _lin(f2e, p, "decoder_embed")
    outs1, outs2 = [f1e], [f2e]
    for i in range(c["dec_depth"]):
        f1, f2 = (block(p, f"dec_blocks.{i}.", f1, cos_d, sin_d, c["dec_heads"], ctx=f2),
                  block(p, f"dec_blocks2.{i}.", f2, cos_d, sin_d, c["dec_heads"], ctx=f1))
        outs1.append(f1)
        outs2.append(f2)
    outs1[-1] = OPS.layer_norm(outs1[-1], p["dec_norm.weight"], p["dec_norm.bias"])
    outs2[-1] = OPS.layer_norm(outs2[-1], p["dec_norm.weight"], p["dec_norm.bias"])
    d = c["dec_depth"]
    hooks = (0, d * 2 // 4, d * 3 // 4, d)
    pts1, conf1 = dpt_head(c, p, "downstream_head1", [outs1[i] for i in hooks], patch_hw)
    pts2, conf2 = dpt_head(c, p, "downstream_head2", [outs2[i] for i in hooks], patch_hw)
    return {"pts0": pts1, "conf0": conf1, "pts1": pts2, "conf1": conf2}


def pair_depth(c, p, rgb_a, rgb_b, device):
    """Each view's depth (the pointmap's z within the image), float64."""
    imgs = [(np.asarray(x, np.float32) / 255.0 - 0.5) / 0.5 for x in (rgb_a, rgb_b)]
    H = max(i.shape[0] for i in imgs)
    W = max(i.shape[1] for i in imgs)
    m = c["patch"]
    Hb, Wb = -(-H // m) * m, -(-W // m) * m
    xs = []
    for img in imgs:
        x = np.zeros((1, Hb, Wb, 3), np.float32)
        x[0, :img.shape[0], :img.shape[1]] = img
        xs.append(torch.as_tensor(x, device=device))
    with torch.no_grad():
        out = forward(c, p, xs[0], xs[1], (Hb // m, Wb // m))
    return [out[f"pts{k}"][0, :img.shape[0], :img.shape[1], 2].double().cpu().numpy()
            for k, img in zip("01", imgs)]


def load(path, device):
    return {k: v.to(device=device, dtype=torch.float32) for k, v in torch.load(path, map_location="cpu").items()}


def compare(ctx):
    """mast3r_depth_gap: over the scene's pairs and both views, the largest
    gap of the program's two-view depth to the reference's over the largest
    reference depth. The control: the reference with TF32 on in the
    program's place."""
    spec = ctx.net("mast3r")
    c = conf_of(spec)
    p = load(spec["path"], ctx.device)
    images = dict(ctx.scene_images())
    gap = 0.0
    for a, b in ctx.scene_pairs():
        ref = pair_depth(c, p, images[a], images[b], ctx.device)
        if ctx.control:
            with ctx.lower_precision():
                got = pair_depth(c, p, images[a], images[b], ctx.device)
        else:
            got = ctx.program_pair_depth(a, b)
        for g, r in zip(got, ref):
            gap = max(gap, OPS.rel_gap(g, r))
    return {"mast3r_depth_gap": gap}
