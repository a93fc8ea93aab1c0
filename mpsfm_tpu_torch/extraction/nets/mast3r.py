"""MASt3R: CroCo ViT-L encoder with 2-D RoPE, the asymmetric dual decoder,
DPT pointmap heads and the catMLP local-feature heads (port of
mpsfm_tpu/extraction/nets/mast3r.py).

The JAX package's architecture-exact MASt3R in torch, on the device, with
tensors channels last as there. Both images encode in one batch, both
decode directions run through the dec_blocks / dec_blocks2 stacks, and
every attention is K4 (depth_anything.multi_head: attention with every key
real, after RoPE on q and k): on a CUDA tensor the hand-written
float32 kernel (csrc/attention.cu; all heads here are 64 wide), on a CPU
tensor its plain version. A forward launches it 72 times at the official
depth: 24 encoder blocks over both views (B = 2) and 12 self- and 12
cross-attentions in each decoder stack (B = 1).

Parameters are a flat dict of tensors under the OFFICIAL names of
``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth``:

  patch_embed.proj.*                    16x16 conv, 3 -> 1024
  enc_blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}
                                        24 CroCo blocks, dim 1024, 16 heads
  enc_norm.*, decoder_embed.*           1024 -> 768
  dec_blocks.{i}.* / dec_blocks2.{i}.*  12 decoder blocks each (view 1 /
      view 2), dim 768, 12 heads: norm1 + self-attn, norm_y on the other
      view's tokens, norm2 + cross_attn.{projq,projk,projv,proj}, norm3 + mlp
  dec_norm.*
  downstream_head{1,2}.dpt.*            the DPT adapter (act_postprocess,
      scratch.layer{1-4}_rn, scratch.refinenet{1-4}, head.{0,2,4})
  downstream_head{1,2}.head_local_features.{fc1,fc2}

`init_random(seed)` draws the JAX package's numpy draws in its order, so
both packages get the same weights from one seed. Output semantics follow
the published postprocess: pts3d = unit(xyz)·expm1(|xyz|), conf =
1 + exp(x), desc L2-normalized, desc_conf = 1 + exp(x); head 2's pointmap
lives in view 1's frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.manifest import convert_checked
from mpsfm_tpu_torch.extraction.nets.depth_anything import _conv, _deconv_block, _ln, _resize, draw_params, multi_head
from mpsfm_tpu_torch.extraction.nets.roma import _Clock
from mpsfm_tpu_torch.extraction.nets.two_view import depth_pair, nn_matches, padded_pair, prep_rgb, \
    sample_descriptors
from mpsfm_tpu_torch.extraction.priors import MissingWeightsError
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

DUST3R_MEAN = 0.5  # dust3r ImgNorm: Normalize((0.5,)*3, (0.5,)*3)
DUST3R_STD = 0.5
FILE = "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth"

MODEL_CONFIG = dict(
    enc_dim=1024, enc_depth=24, enc_heads=16,
    dec_dim=768, dec_depth=12, dec_heads=12,
    patch=16, desc_dim=24, rope_freq=100.0,
    dpt_layer_dims=(96, 192, 384, 768), dpt_feature_dim=256,
    mlp_hidden_factor=4.0,
)


# ------------------------------------------------------------------ RoPE
def rope_tables(h, w, hd, freq=100.0, device="cpu"):
    """cos/sin tables (2, h·w, hd/2) for CroCo RoPE2D: the head split in
    (y, x) halves, each rotated GPT-NeoX style (rotate-half over its
    hd/2). Computed in float64, kept in float32."""
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


def apply_rope(t, cos, sin):
    """t (B,N,H,hd); cos/sin (2,N,hd/2) for the (y, x) halves."""
    D = t.shape[-1] // 2

    def rot(u, c, s):
        u1, u2 = u[..., : D // 2], u[..., D // 2:]
        return u * c[None, :, None, :] + torch.cat([-u2, u1], -1) * s[None, :, None, :]

    return torch.cat([rot(t[..., :D], cos[0], sin[0]), rot(t[..., D:], cos[1], sin[1])], -1)


def _linear(x, p, name):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def param_specs(c):
    """The official parameters of config `c` in the JAX package's draw order:
    (name, shape, kind, scale), kind "w" a normal draw of that scale, "0"
    zeros, "1" ones."""
    De, Dd, ps, dd = c["enc_dim"], c["dec_dim"], c["patch"], c["desc_dim"]
    specs = []

    def w(name, *shape, scale=0.02):
        specs.append((name, shape, "w", scale))

    def zeros(name, *shape):
        specs.append((name, shape, "0", None))

    def ones(name, *shape):
        specs.append((name, shape, "1", None))

    def norm(name, D):
        ones(name + ".weight", D)
        zeros(name + ".bias", D)

    def lin(name, o, i):
        w(name + ".weight", o, i, scale=i ** -0.5)
        zeros(name + ".bias", o)

    def block(b, D, cross):
        norm(b + "norm1", D)
        w(b + "attn.qkv.weight", 3 * D, D, scale=D ** -0.5)
        zeros(b + "attn.qkv.bias", 3 * D)
        w(b + "attn.proj.weight", D, D, scale=D ** -0.5)
        zeros(b + "attn.proj.bias", D)
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
    w("decoder_embed.weight", Dd, De, scale=De ** -0.5)
    zeros("decoder_embed.bias", Dd)
    for stack in ("dec_blocks", "dec_blocks2"):
        for i in range(c["dec_depth"]):
            block(f"{stack}.{i}.", Dd, cross=True)
    norm("dec_norm", Dd)
    ld, F_ = c["dpt_layer_dims"], c["dpt_feature_dim"]
    for hname in ("downstream_head1", "downstream_head2"):
        hp = hname + ".dpt."
        for k, din in enumerate((De, Dd, Dd, Dd)):
            conv(hp + f"act_postprocess.{k}.0", ld[k], din, 1)
        conv(hp + "act_postprocess.0.1", ld[0], ld[0], 4)  # ConvTranspose2d (in, out, 4, 4)
        conv(hp + "act_postprocess.1.1", ld[1], ld[1], 2)  # ConvTranspose2d (in, out, 2, 2)
        conv(hp + "act_postprocess.3.1", ld[3], ld[3], 3)
        for k in range(1, 5):
            conv(hp + f"scratch.layer{k}_rn", F_, ld[k - 1], 3, bias=False)
        for k in range(1, 5):
            rb = hp + f"scratch.refinenet{k}."
            for unit in ("resConfUnit1", "resConfUnit2"):
                conv(rb + unit + ".conv1", F_, F_, 3)
                conv(rb + unit + ".conv2", F_, F_, 3)
            conv(rb + "out_conv", F_, F_, 1)
        conv(hp + "head.0", F_ // 2, F_, 3)
        conv(hp + "head.2", 32, F_ // 2, 3)
        conv(hp + "head.4", 4, 32, 1)
        idim = De + Dd
        hid = int(c["mlp_hidden_factor"] * idim)
        lin(hname + ".head_local_features.fc1", hid, idim)
        lin(hname + ".head_local_features.fc2", (dd + 1) * ps * ps, hid)
    return specs


class Mast3rNet:
    """MASt3R on `device`. Params: a flat dict of official names -> tensors."""

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
            if self.conf == MODEL_CONFIG:  # the manifest check only at the official size
                self.params = convert_checked(self.params_from_torch_state_dict, sd, "mast3r", where=str(wp))
            else:
                self.params = self.params_from_torch_state_dict(sd)

    # ------------------------------------------------------------- params
    def params_from_torch_state_dict(self, sd, strict=True):
        """The official keys (``module.`` stripped) as float32 tensors on the
        device; the mask token and DUSt3R's prediction head and mask
        generator are skipped; any other key raises with strict."""
        out, unmatched = {}, []
        prefixes = ("patch_embed.", "enc_blocks.", "enc_norm.", "decoder_embed.", "dec_blocks.", "dec_blocks2.",
                    "dec_norm.", "downstream_head1.", "downstream_head2.")
        for k, v in sd.items():
            if k.startswith("module."):
                k = k[len("module."):]
            if k.startswith(prefixes):
                out[k] = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            elif "mask_token" in k or k.startswith(("prediction_head", "mask_generator")):
                continue
            else:
                unmatched.append(k)
        if strict and unmatched:
            raise ValueError(f"unrecognized checkpoint keys: {unmatched[:8]}")
        return out

    def init_random(self, seed=0):
        """Seeded params under the official naming: the JAX package's numpy
        draws in its order."""
        self.params = draw_params(param_specs(self.conf), seed, self.device)
        return self.params

    # ------------------------------------------------------------ encoder
    def _block(self, p, b, x, cos, sin, heads, ctx=None):
        B, _, D = x.shape
        hd = D // heads
        qkv = _linear(_ln(x, p[b + "norm1.weight"], p[b + "norm1.bias"]), p, b + "attn.qkv").reshape(B, -1, 3, heads,
                                                                                                     hd)
        q, k, v = apply_rope(qkv[:, :, 0], cos, sin), apply_rope(qkv[:, :, 1], cos, sin), qkv[:, :, 2]
        x = x + _linear(multi_head(q, k, v).reshape(B, -1, D), p, b + "attn.proj")
        mn = "norm2"
        if ctx is not None:
            ym = _ln(ctx, p[b + "norm_y.weight"], p[b + "norm_y.bias"])
            xq = _ln(x, p[b + "norm2.weight"], p[b + "norm2.bias"])
            q = apply_rope(_linear(xq, p, b + "cross_attn.projq").reshape(B, -1, heads, hd), cos, sin)
            kk = apply_rope(_linear(ym, p, b + "cross_attn.projk").reshape(B, -1, heads, hd), cos, sin)
            vv = _linear(ym, p, b + "cross_attn.projv").reshape(B, -1, heads, hd)
            x = x + _linear(multi_head(q, kk, vv).reshape(B, -1, D), p, b + "cross_attn.proj")
            mn = "norm3"
        y = _ln(x, p[b + f"{mn}.weight"], p[b + f"{mn}.bias"])
        return x + _linear(F.gelu(_linear(y, p, b + "mlp.fc1")), p, b + "mlp.fc2")

    def _encode(self, p, x, patch_hw, cos, sin):
        c = self.conf
        h, w = patch_hw
        tok = _conv(x, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], stride=c["patch"], pad="VALID")
        tok = tok.reshape(x.shape[0], h * w, c["enc_dim"])
        for i in range(c["enc_depth"]):
            tok = self._block(p, f"enc_blocks.{i}.", tok, cos, sin, c["enc_heads"])
        return _ln(tok, p["enc_norm.weight"], p["enc_norm.bias"])

    # --------------------------------------------------------------- head
    def _dpt_head(self, p, hname, hooks, patch_hw):
        c = self.conf
        h, w = patch_hw
        hp = hname + ".dpt."
        B = hooks[0].shape[0]
        pyr = []
        for k, tok in enumerate(hooks):
            y = tok.reshape(B, h, w, tok.shape[-1])
            y = y @ p[hp + f"act_postprocess.{k}.0.weight"][:, :, 0, 0].T + p[hp + f"act_postprocess.{k}.0.bias"]
            if k in (0, 1):
                y = _deconv_block(y, p[hp + f"act_postprocess.{k}.1.weight"], p[hp + f"act_postprocess.{k}.1.bias"],
                                  4 // (k + 1))
            elif k == 3:
                y = _conv(y, p[hp + "act_postprocess.3.1.weight"], p[hp + "act_postprocess.3.1.bias"], stride=2)
            pyr.append(_conv(y, p[hp + f"scratch.layer{k + 1}_rn.weight"]))

        def rcu(prefix, x):
            y = _conv(F.relu(x), p[prefix + ".conv1.weight"], p[prefix + ".conv1.bias"])
            return x + _conv(F.relu(y), p[prefix + ".conv2.weight"], p[prefix + ".conv2.bias"])

        def fuse(i, x, res, size):
            rb = hp + f"scratch.refinenet{i}"
            if res is not None:
                x = x + rcu(rb + ".resConfUnit1", res)
            x = _resize(rcu(rb + ".resConfUnit2", x), size, align_corners=True)
            return _conv(x, p[rb + ".out_conv.weight"], p[rb + ".out_conv.bias"])

        path = fuse(4, pyr[3], None, tuple(pyr[2].shape[1:3]))
        path = fuse(3, path, pyr[2], tuple(pyr[1].shape[1:3]))
        path = fuse(2, path, pyr[1], tuple(pyr[0].shape[1:3]))
        path = fuse(1, path, pyr[0], (pyr[0].shape[1] * 2, pyr[0].shape[2] * 2))
        y = _conv(path, p[hp + "head.0.weight"], p[hp + "head.0.bias"])
        y = _resize(y, (h * c["patch"], w * c["patch"]))
        y = F.relu(_conv(y, p[hp + "head.2.weight"], p[hp + "head.2.bias"]))
        y = _conv(y, p[hp + "head.4.weight"], p[hp + "head.4.bias"])  # (B,H,W,4)
        xyz = y[..., :3]  # dust3r's postprocess: directional exp + conf
        n = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        return xyz / torch.clamp(n, min=1e-8) * torch.expm1(n), 1.0 + torch.exp(y[..., 3])

    def _local_features(self, p, hname, enc_tok, dec_tok, patch_hw):
        c = self.conf
        h, w = patch_hw
        ps, dd = c["patch"], c["desc_dim"]
        B = enc_tok.shape[0]
        y = F.gelu(_linear(torch.cat([enc_tok, dec_tok], -1), p, hname + ".head_local_features.fc1"))
        y = _linear(y, p, hname + ".head_local_features.fc2")  # (B, N, (dd+1)·ps²)
        y = y.reshape(B, h, w, dd + 1, ps, ps).permute(0, 1, 4, 2, 5, 3).reshape(B, h * ps, w * ps, dd + 1)
        desc = y[..., :dd]
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
        return desc, 1.0 + torch.exp(y[..., dd])

    # ------------------------------------------------------------ forward
    def forward(self, xa, xb, patch_hw, p=None, times=None):
        """xa/xb (B, 16h, 16w, 3) dust3r-normalized -> per view pts3d (both in
        view 1's frame), conf, desc, desc_conf. `times`, a dict, gets each
        stage's host seconds after a device synchronize (the encoder, the
        decoders, the DPT heads, the local-feature heads)."""
        p = self.params if p is None else p
        c = self.conf
        h, w = patch_hw
        clock = _Clock(xa.device, times)
        cos_e, sin_e = rope_tables(h, w, c["enc_dim"] // c["enc_heads"], c["rope_freq"], xa.device)
        cos_d, sin_d = rope_tables(h, w, c["dec_dim"] // c["dec_heads"], c["rope_freq"], xa.device)
        tok = self._encode(p, torch.cat([xa, xb], 0), patch_hw, cos_e, sin_e)
        B = xa.shape[0]
        f1e, f2e = tok[:B], tok[B:]
        clock("encoder")
        f1, f2 = _linear(f1e, p, "decoder_embed"), _linear(f2e, p, "decoder_embed")
        outs1, outs2 = [f1e], [f2e]
        for i in range(c["dec_depth"]):
            f1, f2 = (self._block(p, f"dec_blocks.{i}.", f1, cos_d, sin_d, c["dec_heads"], ctx=f2),
                      self._block(p, f"dec_blocks2.{i}.", f2, cos_d, sin_d, c["dec_heads"], ctx=f1))
            outs1.append(f1)
            outs2.append(f2)
        outs1[-1] = _ln(outs1[-1], p["dec_norm.weight"], p["dec_norm.bias"])
        outs2[-1] = _ln(outs2[-1], p["dec_norm.weight"], p["dec_norm.bias"])
        clock("decoders")
        d = c["dec_depth"]
        hooks = (0, d * 2 // 4, d * 3 // 4, d)  # dust3r create_dpt_head
        pts1, conf1 = self._dpt_head(p, "downstream_head1", [outs1[i] for i in hooks], patch_hw)
        pts2, conf2 = self._dpt_head(p, "downstream_head2", [outs2[i] for i in hooks], patch_hw)
        clock("dpt_heads")
        desc1, dconf1 = self._local_features(p, "downstream_head1", f1e, outs1[-1], patch_hw)
        desc2, dconf2 = self._local_features(p, "downstream_head2", f2e, outs2[-1], patch_hw)
        clock("local_features")
        return {"pts0": pts1, "conf0": conf1, "desc0": desc1, "desc_conf0": dconf1,
                "pts1": pts2, "conf1": conf2, "desc1": desc2, "desc_conf1": dconf2}


class Mast3rMatcher:
    """The dense-matcher interface around Mast3rNet on `device`: a pair of
    images -> keypoints0/1 + certainty by reciprocal NN on the descriptor
    maps (two_view._reciprocal_nn); pair_depth, the pointmap's z in view
    1's frame with variance (1/conf)² (the reference's mast3r.py:303-315);
    descriptors_at, descriptor samples at detected keypoints. The images are
    padded to multiples of 16, never resized. Without weights at the
    official width it raises MissingWeightsError naming the file, unless
    allow_random (seeded weights, for smokes); below it (tests' tiny
    configs) it draws seeded weights."""

    default_conf = {
        "stride": 4,
        "max_matches": 4096,
        "certainty_threshold": 0.0,
        "weights_path": None,
    }

    def __init__(self, conf=None, device="cuda"):
        conf = {**self.default_conf, **(conf or {})}
        self.conf = conf
        self.net = Mast3rNet(conf, device=device)
        self.device = self.net.device
        if self.net.params is None:
            if self.net.conf["enc_dim"] >= 512 and not conf.get("allow_random"):
                raise MissingWeightsError(f"MASt3R matcher has no weights in this environment: set "
                                          f"dense_matcher_conf.weights_path to {FILE}; allow_random: true runs "
                                          "seeded weights (smokes only).")
            self.net.init_random(0)

    def _prep(self, img):
        return (prep_rgb(img) - DUST3R_MEAN) / DUST3R_STD

    def _forward(self, imgA, imgB, times=None):
        A, B = self._prep(imgA), self._prep(imgB)
        ps = self.net.conf["patch"]
        xa, xb = padded_pair(A, B, ps, self.device)
        with torch.no_grad():
            out = self.net.forward(xa, xb, (xa.shape[1] // ps, xa.shape[2] // ps), times=times)
        return out, (A.shape[:2], B.shape[:2])

    def __call__(self, imgA, imgB, times=None):
        """Matches of a pair; `times` as Mast3rNet.forward's, plus the reciprocal NN's."""
        out, (shA, shB) = self._forward(imgA, imgB, times)
        clock = _Clock(self.device, times)
        res = nn_matches(out, shA, shB, self.conf)
        clock("reciprocal_nn")
        return res

    def pair_depth(self, imgA, imgB):
        out, (shA, shB) = self._forward(imgA, imgB)
        return depth_pair(out, shA, shB)

    def descriptors_at(self, img_pair_out, kps, view: int):
        return sample_descriptors(img_pair_out, kps, view)
