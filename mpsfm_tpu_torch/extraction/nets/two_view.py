"""Two-view cross-attention matcher, MASt3R/DUSt3R class (port of
mpsfm_tpu/extraction/nets/two_view.py).

A shared ViT encoder runs once over both views in one batch, a decoder of
interleaved self- and cross-attention blocks exchanges information
between them symmetrically (both directions in one batch), and DPT heads
regress per pixel a pointmap (3: its z is the 'depth' matching mode's
depth, (1/conf)² its variance), a confidence and a descriptor map
(reciprocal nearest neighbours for dense matches, samples at detected
keypoints for the sparse mode). Torch modules on channels-last tensors
under the JAX package's Flax names; every attention is K4
(depth_anything.multi_head).

Weights: a torch state dict, in the port's module names (as
convert.two_view_state_dict writes from the JAX package's params) or in
CroCo/DUSt3R naming (`two_view_params_from_torch`). The JAX package also
reads Flax msgpack files; the port has no Flax and refuses them naming the
format. Without weights the net is drawn from a seeded torch.Generator
(vit.init_seeded), not the JAX package's PRNGKey(0).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.nets.depth_anything import _resize, multi_head
from mpsfm_tpu_torch.extraction.nets.dpt import DPTDecoder, Head
from mpsfm_tpu_torch.extraction.nets.vit import Attention, ViT, init_seeded, layer_norm, vit_params_from_torch
from mpsfm_tpu_torch.utils.interp import sample_bilinear


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v, self.proj = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x, ctx):  # (B,N,D), (B,M,D)
        B, N, D = x.shape
        H = self.num_heads
        y = multi_head(self.q(x).reshape(B, N, H, D // H), self.k(ctx).reshape(B, -1, H, D // H),
                       self.v(ctx).reshape(B, -1, H, D // H))
        return self.proj(y.reshape(B, N, D))


class DecoderBlock(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.norm1, self.norm2, self.norm_ctx, self.norm3 = (layer_norm(dim) for _ in range(4))
        self.self_attn = Attention(dim, num_heads)
        self.cross_attn = CrossAttention(dim, num_heads)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x, ctx):
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), self.norm_ctx(ctx))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm3(x))))


class TwoViewNet(nn.Module):
    def __init__(self, dim=192, enc_depth=6, dec_depth=4, num_heads=3, patch=16, feat=64, desc_dim=24):
        super().__init__()
        self.dim, self.enc_depth, self.dec_depth, self.patch = dim, enc_depth, dec_depth, patch
        self.encoder = ViT(dim, enc_depth, num_heads, patch, hooks=(enc_depth - 1,), with_cls=False)
        for i in range(dec_depth):
            self.add_module(f"dec_{i}", DecoderBlock(dim, num_heads))
        self.decoder = DPTDecoder(dim, feat)
        self.point_head = Head(3, feat)
        self.conf_head = Head(1, feat)
        self.desc_head = Head(desc_dim, feat)

    def forward(self, imA, imB):  # (B,H,W,3) x2 -> per-view outputs
        B, H, W, _ = imA.shape
        h, w = H // self.patch, W // self.patch
        tok = self.encoder(torch.cat([imA, imB], 0))[0].reshape(2 * B, h * w, self.dim)
        tA, tB = tok[:B], tok[B:]
        x, ctx = torch.cat([tA, tB], 0), torch.cat([tB, tA], 0)  # both directions in one batch
        feats = []
        hook_every = max(self.dec_depth // 4, 1)
        for i in range(self.dec_depth):
            x = getattr(self, f"dec_{i}")(x, ctx)
            if (i + 1) % hook_every == 0 or i == self.dec_depth - 1:
                feats.append(x.reshape(2 * B, h, w, self.dim))
        feats = feats[-4:] if len(feats) >= 4 else feats + [feats[-1]] * (4 - len(feats))
        fused = _resize(self.decoder(feats), (H, W))
        pts = self.point_head(fused)
        pts = torch.cat([pts[..., :2], torch.exp(torch.clamp(pts[..., 2:], -8, 8))], -1)  # positive z
        conf = 1.0 + F.softplus(self.conf_head(fused))[..., 0]
        desc = self.desc_head(fused)
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
        return {"pts0": pts[:B], "pts1": pts[B:], "conf0": conf[:B], "conf1": conf[B:],
                "desc0": desc[:B], "desc1": desc[B:]}


def _reciprocal_nn(descA, descB, confA, confB, stride=4):
    """Grid-subsampled reciprocal NN matching on descriptor maps (H,W,D):
    (ptsA (N,2) xy, ptsB (N,2), score (N,), mutual (N,)) over the strided
    grid of A, on the maps' device. The first maximum wins a tie in either
    direction, as jnp.argmax's does."""
    Wa, Wb = descA.shape[1], descB.shape[1]
    D = descA.shape[-1]
    ga = descA[::stride, ::stride].reshape(-1, D)
    gb = descB[::stride, ::stride].reshape(-1, D)
    sim = ga @ gb.T
    j = torch.argmax(sim, 1)
    i_back = torch.argmax(sim, 0)
    ar = torch.arange(ga.shape[0], device=ga.device)
    mutual = i_back[j] == ar
    wa, wb = -(-Wa // stride), -(-Wb // stride)
    ya, xa, yb, xb = ar // wa, ar % wa, j // wb, j % wb
    ca = confA[::stride, ::stride].reshape(-1)
    cb = confB[::stride, ::stride].reshape(-1)[j]
    score = torch.minimum(ca, cb) * torch.gather(sim, 1, j[:, None])[:, 0]
    ptsA = torch.stack([xa * stride, ya * stride], -1).float()
    ptsB = torch.stack([xb * stride, yb * stride], -1).float()
    return ptsA, ptsB, score, mutual


def prep_rgb(img):
    """A uint8 or [0, 1] image, gray or RGB -> float32 RGB in [0, 1]."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img


def padded_pair(A, B, mult, device):
    """Both images zero-padded to one (H, W), each side rounded up to a
    multiple of `mult`, as (1, H, W, 3) tensors on `device`."""
    H, W = max(A.shape[0], B.shape[0]), max(A.shape[1], B.shape[1])
    Hb, Wb = -(-H // mult) * mult, -(-W // mult) * mult
    out = []
    for img in (A, B):
        x = np.zeros((1, Hb, Wb, 3), np.float32)
        x[0, : img.shape[0], : img.shape[1]] = img
        out.append(torch.as_tensor(x, device=device))
    return out


def nn_matches(out, shA, shB, conf):
    """Reciprocal NN matches of a forward's first batch element within both
    images, above the certainty threshold, the max_matches best by score
    (numpy's argsort of the negated scores, as the JAX package's)."""
    ptsA, ptsB, score, mutual = (t.cpu().numpy() for t in _reciprocal_nn(
        out["desc0"][0], out["desc1"][0], out["conf0"][0], out["conf1"][0], stride=conf["stride"]))
    keep = mutual & (score > conf["certainty_threshold"])
    keep &= (ptsA[:, 0] < shA[1]) & (ptsA[:, 1] < shA[0])
    keep &= (ptsB[:, 0] < shB[1]) & (ptsB[:, 1] < shB[0])
    idx = np.where(keep)[0]
    if len(idx) > conf["max_matches"]:
        idx = idx[np.argsort(-score[idx])[: conf["max_matches"]]]
    return {"keypoints0": ptsA[idx], "keypoints1": ptsB[idx], "certainty": score[idx]}


def depth_pair(out, shA, shB):
    """'depth' mode from a forward: per view the pointmap's z within the
    image (float64), valid where positive, variance (1/conf)² (the
    reference's mast3r.py:303-315)."""
    res = {}
    for key, sh in (("0", shA), ("1", shB)):
        z = out[f"pts{key}"][0, : sh[0], : sh[1], 2].double().cpu().numpy()
        c = out[f"conf{key}"][0, : sh[0], : sh[1]].double().cpu().numpy()
        res[key] = {"depth": z, "valid": z > 0, "variance": np.square(1.0 / np.maximum(c, 1e-3))}
    return res


def sample_descriptors(img_pair_out, kps, view):
    """'sparse' mode: descriptors of one view's map bilinearly sampled at keypoints."""
    return sample_bilinear(img_pair_out[f"desc{view}"][0].cpu().numpy(), np.asarray(kps))


def load_torch_state(path):
    """A torch checkpoint's state dict (unwrapping 'model' and 'state_dict');
    a Flax msgpack file raises, naming the format."""
    p = Path(path)
    if p.suffix in (".msgpack", ".flax"):
        raise ValueError(f"{p}: a Flax {p.suffix} file; the port loads torch state dicts (.pth), e.g. "
                         "convert.two_view_state_dict or convert.warp_state_dict of the JAX package's params")
    sd = torch.load(p, map_location="cpu")
    for key in ("model", "state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return sd


class TwoViewMatcher:
    """Dense-matcher interface around TwoViewNet on `device`: a pair of
    images -> keypoints0/1 + certainty; pair_depth for the 'depth' mode and
    descriptors_at for the 'sparse' mode."""

    default_conf = {
        "stride": 4,
        "max_matches": 4096,
        "certainty_threshold": 0.0,
        "dim": 192, "enc_depth": 6, "dec_depth": 4, "num_heads": 3,
        "feat": 64, "desc_dim": 24,
        "weights_path": None,
    }

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        c = self.conf
        self.device = resolve_device(device)
        self.net = TwoViewNet(dim=c["dim"], enc_depth=c["enc_depth"], dec_depth=c["dec_depth"],
                              num_heads=c["num_heads"], feat=c["feat"], desc_dim=c["desc_dim"])
        if c["weights_path"]:
            self.net.load_state_dict(load_two_view_params(c["weights_path"], self.net))
        else:
            init_seeded(self.net, 0)
        self.net.to(self.device).eval()

    def _forward(self, imgA, imgB):
        A, B = prep_rgb(imgA), prep_rgb(imgB)
        xa, xb = padded_pair(A, B, self.net.patch, self.device)
        with torch.no_grad():
            out = self.net(xa, xb)
        return out, (A.shape[:2], B.shape[:2])

    def __call__(self, imgA, imgB):
        out, (shA, shB) = self._forward(imgA, imgB)
        return nn_matches(out, shA, shB, self.conf)

    def pair_depth(self, imgA, imgB):
        out, (shA, shB) = self._forward(imgA, imgB)
        return depth_pair(out, shA, shB)

    def descriptors_at(self, img_pair_out, kps, view: int):
        return sample_descriptors(img_pair_out, kps, view)


def load_two_view_params(path, net: TwoViewNet):
    """A checkpoint -> the net's state dict: the port's own module names as
    they are, CroCo/DUSt3R naming through two_view_params_from_torch."""
    sd = load_torch_state(path)
    if "encoder.patch_embed.weight" in sd:
        return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    return two_view_params_from_torch(sd, enc_depth=net.enc_depth, dec_depth=net.dec_depth)


def two_view_params_from_torch(sd, enc_depth=6, dec_depth=4):
    """CroCo/DUSt3R-style torch naming -> TwoViewNet's state dict:
      encoder.*                                   timm ViT (vit_params_from_torch)
      dec_blocks.N.norm1 / attn.qkv / attn.proj   -> dec_N.norm1 / self_attn.*
      dec_blocks.N.norm2 / norm_y / cross_attn.projq/projk/projv/proj
                                                  -> norm2 / norm_ctx / cross_attn.q/k/v/proj
      dec_blocks.N.norm3 / mlp.fc1 / mlp.fc2      -> norm3 / mlp_fc1 / mlp_fc2
      decoder.* / point_head.* / conf_head.* / desc_head.*   the same names
    """
    t = lambda k: torch.as_tensor(np.asarray(sd[k], np.float32))  # noqa: E731
    out = {"encoder." + k: v for k, v in vit_params_from_torch(sd, depth=enc_depth, prefix="encoder.").items()}
    names = {"norm1": "norm1", "attn.qkv": "self_attn.qkv", "attn.proj": "self_attn.proj", "norm2": "norm2",
             "norm_y": "norm_ctx", "cross_attn.projq": "cross_attn.q", "cross_attn.projk": "cross_attn.k",
             "cross_attn.projv": "cross_attn.v", "cross_attn.proj": "cross_attn.proj", "norm3": "norm3",
             "mlp.fc1": "mlp_fc1", "mlp.fc2": "mlp_fc2"}
    for i in range(dec_depth):
        for src, dst in names.items():
            for leaf in ("weight", "bias"):
                out[f"dec_{i}.{dst}.{leaf}"] = t(f"dec_blocks.{i}.{src}.{leaf}")
    for k in sd:
        if k.startswith(("decoder.", "point_head.", "conf_head.", "desc_head.")):
            out[k] = t(k)
    return out
