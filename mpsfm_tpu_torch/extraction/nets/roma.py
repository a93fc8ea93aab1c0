"""RoMa: DINOv2 ViT-L/14 + VGG19-BN pyramid, GP match encoder, transformer
match decoder, ConvRefiner cascade (port of
mpsfm_tpu/extraction/nets/roma.py).

The JAX package's architecture-exact RoMa in torch, on the device, with
tensors channels last as there. Parameters are a flat dict of tensors under
the official names of the two files the reference downloads:
``roma_outdoor.pth`` (``encoder.cnn.layers.*``: torchvision's vgg19_bn
features[:40]; ``decoder.*``: the projections, the GP's position embedding,
the 5-block match decoder with its (64² + 1)-way classifier and the
refiners) and ``dinov2_vitl14_pretrain.pth`` (kept under ``dinov2.*``).
`init_random(seed)` draws the JAX package's numpy draws in its order, so
both packages get the same weights from one seed.

The GP's posterior mean solves K_bb · sol = f with K_bb = exp((cos − 1)/T) +
σ·I, a Schur-product exponential of a PSD kernel plus a ridge: symmetric
positive definite with every eigenvalue ≥ σ. Where the JAX package calls
XLA's LU (`jnp.linalg.solve`), the port solves it by Cholesky through
ba/cholesky.cholesky_solve, one call a batch item: on a CUDA tensor the
hand-written K1 many kernel (csrc/cholesky_many.cu, K = 48² = 2304 at the
official 672² on its grid route), on a CPU tensor its plain version. The
DINOv2's attention (16 heads of 64, no mask) is K4 (depth_anything.multi_head:
csrc/attention.cu on the card, attention_plain on the CPU); the match
decoder's (heads of 128, a width K4 has no kernel for), the convolutions
and the correlation volumes are plain torch ops, as they are XLA ops in the
JAX package.

`RomaMatcher` is the dense-matcher interface (the reference's roma.py:
98-117): certainty NMS by a (2r+1)² max-pool, the sample threshold, the
max_matches most certain, pixel coordinates of the original images.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba.cholesky import cholesky_solve
from mpsfm_tpu_torch.extraction.manifest import convert_checked
from mpsfm_tpu_torch.extraction.nets.depth_anything import (IMAGENET_MEAN, IMAGENET_STD, _conv, _ln, _resize,
                                                           multi_head)
from mpsfm_tpu_torch.extraction.priors import MissingWeightsError
from mpsfm_tpu_torch.extraction.weights import maybe_resolve


# vgg19_bn features[:40]: ("C", ch) = conv3x3 + BN + ReLU, "M" = maxpool 2
VGG19_SPEC = (
    ("C", 64), ("C", 64), "M",
    ("C", 128), ("C", 128), "M",
    ("C", 256), ("C", 256), ("C", 256), ("C", 256), "M",
    ("C", 512), ("C", 512), ("C", 512), ("C", 512), "M",
)

MODEL_CONFIG = dict(
    vit_dim=1024, vit_depth=24, vit_heads=16, vit_patch=14, pos_grid=37,
    gp_dim=512, feat_dim=512, dec_blocks=5, dec_heads=8,
    cls_res=64, kernel_T=0.2, sigma_noise=0.1,
    vgg_spec=VGG19_SPEC,
    # per scale: (name, proj_in, proj_out, disp_emb_dim, local_corr_radius, hidden_blocks, depthwise)
    scales=(
        ("16", 1024, 512, 128, 7, 8, True),
        ("8", 512, 512, 64, 3, 8, True),
        ("4", 256, 256, 32, 2, 8, True),
        ("2", 128, 64, 16, 0, 8, True),
        ("1", 64, 9, 6, 0, 5, False),
    ),
    resolution=672,  # 14·8·6 (the reference's roma.py:74)
)
FILES = "roma_outdoor.pth (dense_matcher_conf.weights_path) and dinov2_vitl14_pretrain.pth (dinov2_weights_path)"


def _linear(x, w, b):
    return x @ w.T + b


def _vit_block(p, b, tok, heads, on_k4):
    """A DINOv2 block (LayerScale, exact GELU) on tokens (B, n, D). on_k4:
    the attention through K4 (multi_head; DINOv2's 16 heads of 64), else
    softmax(q kᵀ) v as torch ops (the match decoder's heads of 128, a width
    K4 has no kernel for)."""
    B, n, Dm = tok.shape
    hd = Dm // heads
    y = _ln(tok, p[b + "norm1.weight"], p[b + "norm1.bias"])
    qkv = _linear(y, p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"]).reshape(B, n, 3, heads, hd)
    if on_k4:
        y = multi_head(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(B, n, Dm)
    else:
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # (B, heads, n, hd)
        a = torch.softmax((q @ k.transpose(-1, -2)) * hd**-0.5, -1)
        y = (a @ v).transpose(1, 2).reshape(B, n, Dm)
    tok = tok + _linear(y, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"]) * p[b + "ls1.gamma"]
    y = _ln(tok, p[b + "norm2.weight"], p[b + "norm2.bias"])
    y = F.gelu(_linear(y, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"]))
    return tok + _linear(y, p[b + "mlp.fc2.weight"], p[b + "mlp.fc2.bias"]) * p[b + "ls2.gamma"]


def _center_grid(h, w, device):
    """(1, h, w, 2) pixel centres in [-1, 1], x then y (float64 linspace cast to float32)."""
    gy, gx = np.meshgrid(np.linspace(-1 + 1 / h, 1 - 1 / h, h), np.linspace(-1 + 1 / w, 1 - 1 / w, w), indexing="ij")
    return torch.as_tensor(np.stack([gx, gy], -1), dtype=torch.float32, device=device)[None]


class RomaNet:
    """RoMa on `device`. Params: a flat dict of official names -> tensors."""

    def __init__(self, conf=None, device="cuda"):
        conf = dict(conf or {})
        self.conf = {**MODEL_CONFIG, **{k: v for k, v in conf.items() if k in MODEL_CONFIG}}
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            for key in ("model", "state_dict"):
                if isinstance(sd, dict) and key in sd:
                    sd = sd[key]
            dv = maybe_resolve(conf.get("dinov2_weights_path"))
            dsd = {}
            if dv:
                dsd = torch.load(dv, map_location="cpu")
                if isinstance(dsd, dict) and "model" in dsd:
                    dsd = dsd["model"]
            if self.conf == MODEL_CONFIG:  # each file against its own manifest, only at the official size
                self.params = convert_checked(self.params_from_torch_state_dict, sd, "roma-outdoor", where=str(wp))
                if dv:
                    dino = convert_checked(self._dinov2_params, dsd, "roma-dinov2", where=str(dv))
                    self.params.update({"dinov2." + k: v for k, v in dino.items()})
            else:
                self.params = self.params_from_torch_state_dict(sd, dsd)

    # ------------------------------------------------------------- params
    def _dinov2_params(self, dsd):
        """The DINOv2 file's tensors (without the unused mask_token) on the device, under its own names."""
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device) for k, v in dsd.items()
                if "mask_token" not in k}

    def params_from_torch_state_dict(self, sd, dinov2_sd=None, strict=True):
        """roma_outdoor.pth's ``encoder.*`` / ``decoder.*`` (strips
        ``module.``; skips num_batches_tracked and any DINOv2 copy in it)
        and the DINOv2 file's tensors under ``dinov2.*``, float32 on the
        device; any other key of roma_outdoor.pth raises with strict."""
        out = {}
        unmatched = []
        for k, v in sd.items():
            if k.startswith("module."):
                k = k[len("module."):]
            if k.startswith(("encoder.", "decoder.")):
                if "num_batches_tracked" in k or "dinov2" in k:
                    continue
                out[k] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            else:
                unmatched.append(k)
        out.update({"dinov2." + k: v for k, v in self._dinov2_params(dinov2_sd or {}).items()})
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

        def block(b, dim):
            ones(b + "norm1.weight", dim)
            zeros(b + "norm1.bias", dim)
            ones(b + "norm2.weight", dim)
            zeros(b + "norm2.bias", dim)
            w(b + "attn.qkv.weight", 3 * dim, dim, scale=dim**-0.5)
            zeros(b + "attn.qkv.bias", 3 * dim)
            w(b + "attn.proj.weight", dim, dim, scale=dim**-0.5)
            zeros(b + "attn.proj.bias", dim)
            w(b + "mlp.fc1.weight", 4 * dim, dim, scale=dim**-0.5)
            zeros(b + "mlp.fc1.bias", 4 * dim)
            w(b + "mlp.fc2.weight", dim, 4 * dim, scale=dim**-0.5)
            zeros(b + "mlp.fc2.bias", dim)
            ones(b + "ls1.gamma", dim)
            ones(b + "ls2.gamma", dim)

        Dv, M = c["vit_dim"], c["pos_grid"]
        w("dinov2.cls_token", 1, 1, Dv, scale=0.02)
        w("dinov2.pos_embed", 1, 1 + M * M, Dv, scale=0.02)
        w("dinov2.patch_embed.proj.weight", Dv, 3, c["vit_patch"], c["vit_patch"], scale=0.02)
        zeros("dinov2.patch_embed.proj.bias", Dv)
        for i in range(c["vit_depth"]):
            block(f"dinov2.blocks.{i}.", Dv)
        ones("dinov2.norm.weight", Dv)
        zeros("dinov2.norm.bias", Dv)

        i, cin = 0, 3  # torchvision's vgg19_bn indexing: conv, bn, relu, [pool]
        for entry in c["vgg_spec"]:
            if entry == "M":
                i += 1
                continue
            ch = entry[1]
            w(f"encoder.cnn.layers.{i}.weight", ch, cin, 3, 3)
            zeros(f"encoder.cnn.layers.{i}.bias", ch)
            bn(f"encoder.cnn.layers.{i + 1}", ch)
            i += 3
            cin = ch

        Dd = c["gp_dim"] + c["feat_dim"]
        for i in range(c["dec_blocks"]):
            block(f"decoder.embedding_decoder.blocks.{i}.", Dd)
        w("decoder.embedding_decoder.to_out.weight", c["cls_res"] ** 2 + 1, Dd, scale=Dd**-0.5)
        zeros("decoder.embedding_decoder.to_out.bias", c["cls_res"] ** 2 + 1)
        w("decoder.gps.16.pos_conv.weight", c["gp_dim"], 2, 1, 1)
        zeros("decoder.gps.16.pos_conv.bias", c["gp_dim"])

        def refblock(prefix, ci, co, dw):
            w(prefix + ".0.weight", co, ci // (ci if dw else 1), 5, 5)
            zeros(prefix + ".0.bias", co)
            bn(prefix + ".1", co)
            w(prefix + ".3.weight", co, co, 1, 1)
            zeros(prefix + ".3.bias", co)

        for (s, cin_s, cout_s, demb, rad, hb, dw) in c["scales"]:
            w(f"decoder.proj.{s}.0.weight", cout_s, cin_s, 1, 1)
            zeros(f"decoder.proj.{s}.0.bias", cout_s)
            bn(f"decoder.proj.{s}.1", cout_s)
            in_dim = 2 * cout_s + demb + ((2 * rad + 1) ** 2 if rad else 0)
            hid = in_dim if dw else max(in_dim, 24)
            rb = f"decoder.conv_refiner.{s}."
            w(rb + "disp_emb.weight", demb, 2, 1, 1)
            zeros(rb + "disp_emb.bias", demb)
            refblock(rb + "block1", in_dim, hid, dw)
            for k in range(hb):
                refblock(rb + f"hidden_blocks.{k}", hid, hid, dw)
            w(rb + "out_conv.weight", 3, hid, 1, 1)
            zeros(rb + "out_conv.bias", 3)
        self.params = {k: torch.as_tensor(v, device=self.device) for k, v in p.items()}
        return self.params

    # ------------------------------------------------------------ encoder
    @staticmethod
    def _bn(p, name, x):
        return ((x - p[name + ".running_mean"]) / torch.sqrt(p[name + ".running_var"] + 1e-5) * p[name + ".weight"]
                + p[name + ".bias"])

    @staticmethod
    def _pointwise(p, name, x):
        """A 1×1 convolution as a matmul over channels."""
        return x @ p[name + ".weight"][:, :, 0, 0].T + p[name + ".bias"]

    def _vgg(self, p, x):
        """The features before each max-pool (romatch's VGG19): scales 1, 2, 4, 8."""
        feats, scale, i = {}, 1, 0
        for entry in self.conf["vgg_spec"]:
            if entry == "M":
                feats[scale] = x
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
                scale *= 2
                i += 1
                continue
            x = _conv(x, p[f"encoder.cnn.layers.{i}.weight"], p[f"encoder.cnn.layers.{i}.bias"])
            x = F.relu(self._bn(p, f"encoder.cnn.layers.{i + 1}", x))
            i += 3
        return feats

    def _dinov2(self, p, x, patch_hw):
        """The final layer's normalized patch tokens (B, h, w, D)."""
        c = self.conf
        Dv = c["vit_dim"]
        h, w = patch_hw
        B = x.shape[0]
        tok = _conv(x, p["dinov2.patch_embed.proj.weight"], p["dinov2.patch_embed.proj.bias"], stride=c["vit_patch"],
                    pad="VALID").reshape(B, h * w, Dv)
        pe = p["dinov2.pos_embed"]
        M = int(math.isqrt(pe.shape[1] - 1))
        cls_pe, patch_pe = pe[:, :1], pe[:, 1:].reshape(1, M, M, Dv)
        if (h, w) != (M, M):  # DINOv2's interpolate_offset = 0.1 bicubic convention
            patch_pe = _resize(patch_pe, (h, w), mode="bicubic", scales=((h + 0.1) / M, (w + 0.1) / M))
        tok = tok + patch_pe.reshape(1, h * w, Dv)
        tok = torch.cat([(p["dinov2.cls_token"] + cls_pe).expand(B, 1, Dv), tok], 1)
        for i in range(c["vit_depth"]):
            tok = _vit_block(p, f"dinov2.blocks.{i}.", tok, c["vit_heads"], on_k4=True)
        tok = _ln(tok, p["dinov2.norm.weight"], p["dinov2.norm.bias"])
        return tok[:, 1:].reshape(B, h, w, Dv)

    # ------------------------------------------------------------ decoder
    def _gp(self, p, xa, xb):
        """The cosine-kernel GP's posterior mean of xb's Fourier position
        embedding at xa's features (romatch GP/CosKernel); K_bb's solve on
        K1 many (cholesky_solve), one call a batch item."""
        c = self.conf
        B, h, w, C = xa.shape
        N = h * w
        f = self._pointwise(p, "decoder.gps.16.pos_conv", _center_grid(h, w, xa.device).expand(B, h, w, 2))

        def cos_k(u, v):
            un = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-6)
            vn = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-6)
            return torch.exp((un @ vn.transpose(-1, -2) - 1.0) / c["kernel_T"])

        a, bt, fv = xa.reshape(B, N, C), xb.reshape(B, N, C), f.reshape(B, N, -1)
        K_bb = cos_k(bt, bt) + c["sigma_noise"] * torch.eye(N, device=xa.device)
        sol = torch.stack([cholesky_solve(K_bb[i], fv[i].contiguous()) for i in range(B)])
        return (cos_k(a, bt) @ sol).reshape(B, h, w, -1)

    def _match_decoder(self, p, x):
        """5 transformer blocks + the anchor-grid classifier -> (logits, certainty)."""
        c = self.conf
        B, h, w, Dd = x.shape
        tok = x.reshape(B, h * w, Dd)
        for i in range(c["dec_blocks"]):
            tok = _vit_block(p, f"decoder.embedding_decoder.blocks.{i}.", tok, c["dec_heads"], on_k4=False)
        out = _linear(tok, p["decoder.embedding_decoder.to_out.weight"], p["decoder.embedding_decoder.to_out.bias"])
        out = out.reshape(B, h, w, -1)
        return out[..., :-1], out[..., -1:]

    def _cls_to_flow(self, logits):
        """romatch's cls_to_flow_refine: the argmax anchor cell and a softmax
        over its 3×3 neighbours -> flow in [-1, 1]² of image B."""
        R = self.conf["cls_res"]
        cell = torch.argmax(logits, -1)
        cy, cx = cell // R, cell % R
        probs, coords = [], []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ny, nx = torch.clamp(cy + dy, 0, R - 1), torch.clamp(cx + dx, 0, R - 1)
                probs.append(torch.gather(logits, -1, (ny * R + nx)[..., None])[..., 0])
                coords.append(torch.stack([(nx + 0.5) / R * 2 - 1, (ny + 0.5) / R * 2 - 1], -1))
        pr = torch.softmax(torch.stack(probs, -1), -1)
        return (pr[..., None] * torch.stack(coords, -2)).sum(-2)

    @staticmethod
    def _grid_sample(img, flow):
        """Bilinear samples of img (B,H,W,C) at flow (B,h,w,2) in [-1, 1]
        (align_corners=False, zero padding: an out-of-image corner adds 0)."""
        B, H, W, C = img.shape
        x = (flow[..., 0] + 1) * W / 2 - 0.5
        y = (flow[..., 1] + 1) * H / 2 - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        wx, wy = x - x0, y - y0
        flat = img.reshape(B, H * W, C)

        def gather(yy, xx):
            valid = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W))[..., None]
            idx = (torch.clamp(yy, 0, H - 1).long() * W + torch.clamp(xx, 0, W - 1).long()).reshape(B, -1, 1)
            return torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(*yy.shape, C) * valid

        return (gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
                + gather(y0, x0 + 1) * (wx * (1 - wy))[..., None]
                + gather(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
                + gather(y0 + 1, x0 + 1) * (wx * wy)[..., None])

    def _local_corr(self, xa, xb, flow, radius):
        """(2r+1)² correlation channels between xa and xb sampled around the warp (romatch local_correlation)."""
        _, h, w, C = xa.shape
        chans = []
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                off = torch.tensor([2 * dx / w, 2 * dy / h], dtype=torch.float32, device=xa.device)
                chans.append((xa * self._grid_sample(xb, flow + off)).mean(-1) / math.sqrt(C))
        return torch.stack(chans, -1)

    def _refiner(self, p, s, dw, hb, rad, xa, xb, flow):
        rb = f"decoder.conv_refiner.{s}."
        _, h, w, _ = xa.shape
        disp = flow - _center_grid(h, w, xa.device)
        parts = [xa, self._grid_sample(xb, flow), self._pointwise(p, rb + "disp_emb", disp * (40.0 / 32.0))]
        if rad:
            parts.append(self._local_corr(xa, xb, flow, rad))
        d = torch.cat(parts, -1)

        def refblock(prefix, x):
            y = _conv(x, p[prefix + ".0.weight"], p[prefix + ".0.bias"], groups=x.shape[-1] if dw else 1)
            return self._pointwise(p, prefix + ".3", F.relu(self._bn(p, prefix + ".1", y)))

        d = refblock(rb + "block1", d)
        for k in range(hb):
            d = refblock(rb + f"hidden_blocks.{k}", d)
        d = self._pointwise(p, rb + "out_conv", d)
        return d[..., :2], d[..., 2:3]

    # ------------------------------------------------------------ forward
    def forward(self, xa, xb, p=None, times=None):
        """xa, xb (B,H,W,3) ImageNet-normalized, H and W multiples of the
        patch and of 8 -> (warp (B,H,W,2) in [-1, 1] coordinates of B,
        certainty logits (B,H,W)). `times`, a dict, gets each stage's host
        seconds after a device synchronize (the encoders, the GP, the match
        decoder, the refiners)."""
        p = self.params if p is None else p
        c = self.conf
        H, W = xa.shape[1:3]
        B = xa.shape[0]
        clock = _Clock(xa.device, times)
        both = torch.cat([xa, xb], 0)
        vgg = self._vgg(p, both)
        clock("vgg")
        coarse = self._dinov2(p, both, (H // c["vit_patch"], W // c["vit_patch"]))
        clock("dinov2")

        def proj(s, x):
            return self._bn(p, f"decoder.proj.{s}.1", self._pointwise(p, f"decoder.proj.{s}.0", x))

        feats = {"16": proj("16", coarse)}
        for s in ("8", "4", "2", "1"):
            feats[s] = proj(s, vgg[int(s)])
        flow = cert = None
        for (s, _, _, _, rad, hb, dw) in c["scales"]:
            fa, fb = feats[s][:B], feats[s][B:]
            h, w = fa.shape[1:3]
            if s == "16":
                clock("projections")
                gp = self._gp(p, fa, fb)
                clock("gp")
                logits, cert = self._match_decoder(p, torch.cat([gp, fa], -1))
                flow = self._cls_to_flow(logits)
                clock("decoder")
            else:
                flow, cert = _resize(flow, (h, w)), _resize(cert, (h, w))
            disp, dcert = self._refiner(p, s, dw, hb, rad, fa, fb, flow)
            # the displacement is in units of this scale's pixels: to the normalized warp (romatch ConvRefiner)
            flow = flow + disp * torch.tensor([2.0 / w, 2.0 / h], dtype=torch.float32, device=flow.device)
            cert = cert + dcert
        clock("refiners")
        return flow, cert[..., 0]


class _Clock:
    """Adds the host seconds since the last call to times[name], after a
    synchronize of a CUDA device; does nothing without `times`."""

    def __init__(self, device, times):
        self.device, self.times = device, times
        self.t = time.perf_counter() if times is not None else None

    def __call__(self, name):
        if self.times is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + t - self.t
        self.t = t


class RomaMatcher:
    """The dense-matcher interface around RomaNet: a pair of images ->
    keypoint pairs and certainties by max-pool NMS on the certainty map
    (the reference's roma.py:98-106 simple_nms and sample_thresh) at the
    matcher's working resolution, mapped to the original images' pixels
    (to_pixel_coordinates). The sparse mode (the warp at detected
    keypoints, roma.py:107-117) is Extraction's dense_anchor path over this
    output. Without weights at the official width it raises
    MissingWeightsError naming both files, unless allow_random (seeded
    weights, for smokes); below it (tests' tiny configs) it draws seeded
    weights."""

    default_conf = {
        "sample_thresh": 0.1,
        "nms_radius": 8,
        "max_matches": 4096,
        "resolution": 672,
        "weights_path": None,
        "dinov2_weights_path": None,
    }

    def __init__(self, conf=None, device="cuda"):
        conf = {**self.default_conf, **(conf or {})}
        self.conf = conf
        self.net = RomaNet(conf, device=device)
        self.device = self.net.device
        ps = self.net.conf["vit_patch"]
        # the working resolution: a multiple of 14 and of 16 (the ViT's patches, the refiners' pyramid)
        self.resolution = (int(conf["resolution"]) // (ps * 16)) * ps * 16 or ps * 16
        if self.net.params is None:
            if self.net.conf["vit_dim"] >= 512 and not conf.get("allow_random"):
                raise MissingWeightsError(f"RoMa matcher has no weights in this environment: set {FILES}; "
                                          "allow_random: true runs seeded weights (smokes only).")
            self.net.init_random(0)
        elif "dinov2.cls_token" not in self.net.params:
            raise MissingWeightsError(f"RoMa matcher: roma_outdoor.pth is loaded but not its encoder; set {FILES}.")

    def _prep(self, img, res):
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        x = torch.as_tensor((img - IMAGENET_MEAN) / IMAGENET_STD, device=self.device)[None]
        return _resize(x, (res, res)), img.shape[:2]

    def __call__(self, imgA, imgB, times=None):
        """Keypoints of both images and certainties; `times` as RomaNet.forward's."""
        res = self.resolution
        with torch.no_grad():
            A, shA = self._prep(imgA, res)
            Bm, shB = self._prep(imgB, res)
            warp, cert = self.net.forward(A, Bm, times=times)
            cert = torch.sigmoid(cert[0])
            r = int(self.conf["nms_radius"])  # the reference's simple_nms (models/utils/warp.py:6-24)
            pooled = F.max_pool2d(cert[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
            keep = ((cert == pooled) & (cert > self.conf["sample_thresh"])).cpu().numpy()
            warp, cert = warp[0].cpu().numpy(), cert.cpu().numpy()
        ys, xs = np.where(keep)
        if len(ys) == 0:
            return {"keypoints0": np.zeros((0, 2)), "keypoints1": np.zeros((0, 2)), "certainty": np.zeros(0)}
        score = cert[ys, xs]
        if len(ys) > self.conf["max_matches"]:
            sel = np.argsort(-score)[: self.conf["max_matches"]]
            ys, xs, score = ys[sel], xs[sel], score[sel]
        # to_pixel_coordinates (the reference's roma.py:101): A's pixels from the grid, B's from the warp
        kA = np.stack([xs * shA[1] / res, ys * shA[0] / res], -1)
        wb = warp[ys, xs]
        kB = np.stack([(wb[:, 0] + 1) / 2 * shB[1], (wb[:, 1] + 1) / 2 * shB[0]], -1)
        ok = (kB[:, 0] >= 0) & (kB[:, 0] < shB[1]) & (kB[:, 1] >= 0) & (kB[:, 1] < shB[0])
        return {"keypoints0": kA[ok], "keypoints1": kB[ok], "certainty": score[ok]}
