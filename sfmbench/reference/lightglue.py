"""Plain LightGlue (Lindenberger et al., ICCV 2023; superpoint_lightglue.pth
in its post-rename layout, ``transformers.{l}.*``) in torch, the benchmark's
frozen reference of the matcher: rotary positional encoding, n_layers of
self- and cross-attention with their FFNs, the matchability-weighted dual
softmax, mutual argmax above the filter threshold. Fixed depth, no
pruning. Each pair runs unpadded.

`compare` runs it on the program's own keypoints and descriptors (read
from its feature cache; the detector is held apart, reference/superpoint.py)
and holds the program's matches against it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def load(path, device):
    return {k: v.to(device=device, dtype=torch.float32) for k, v in torch.load(path, map_location="cpu").items()}


def _dense(p, name, x):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _rotary(x, cos, sin):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, 0::2], sin[:, None, 0::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], -1).reshape(x.shape)


def attend(q, k, v, scale, rnd):
    """softmax(q kᵀ · scale) v over (N, H, hd) heads, operands through `rnd`."""
    q, k, v = rnd(q), rnd(k), rnd(v)
    a = torch.softmax(torch.einsum("nhd,mhd->hnm", q, k) * scale, -1)
    return torch.einsum("hnm,mhd->nhd", rnd(a), v)


def _ffn(p, blk, x, msg):
    y = torch.cat([x, msg], -1)
    ff = _ln(_dense(p, blk + ".ffn.0", y), p[blk + ".ffn.1.weight"], p[blk + ".ffn.1.bias"])
    return x + _dense(p, blk + ".ffn.3", F.gelu(ff))


def scores(p, spec, k0, k1, d0, d1, rnd=lambda t: t):
    """Log assignment (N0, N1) of normalized keypoints k (n, 2) and
    descriptors d (n, D); `rnd` rounds parameters, inputs and attention
    operands (identity: float32)."""
    D, H, L = spec.get("dim", 256), spec.get("num_heads", 4), spec.get("n_layers", 9)
    p = {k: rnd(v) for k, v in p.items()}
    k0, k1, d0, d1 = (rnd(t) for t in (k0, k1, d0, d1))
    x0, x1 = _dense(p, "input_proj", d0), _dense(p, "input_proj", d1)
    enc = []
    for k in (k0, k1):
        proj = k @ p["posenc.Wr.weight"].T
        enc.append((torch.repeat_interleave(torch.cos(proj), 2, -1), torch.repeat_interleave(torch.sin(proj), 2, -1)))
    hd = D // H
    scale = 1.0 / math.sqrt(hd)
    for l in range(L):
        blk = f"transformers.{l}.self_attn"
        xs = []
        for x, (cos, sin) in zip((x0, x1), enc):
            qkv = _dense(p, blk + ".Wqkv", x).reshape(-1, H, hd, 3)
            q, k, v = _rotary(qkv[..., 0], cos, sin), _rotary(qkv[..., 1], cos, sin), qkv[..., 2]
            xs.append(_ffn(p, blk, x, _dense(p, blk + ".out_proj", attend(q, k, v, scale, rnd).reshape(-1, D))))
        x0, x1 = xs
        blk = f"transformers.{l}.cross_attn"
        qk0, qk1 = (_dense(p, blk + ".to_qk", x).reshape(-1, H, hd) for x in (x0, x1))
        v0, v1 = (_dense(p, blk + ".to_v", x).reshape(-1, H, hd) for x in (x0, x1))
        m0 = attend(qk0, qk1, v1, scale, rnd).reshape(-1, D)
        m1 = attend(qk1, qk0, v0, scale, rnd).reshape(-1, D)
        x0, x1 = _ffn(p, blk, x0, _dense(p, blk + ".to_out", m0)), _ffn(p, blk, x1, _dense(p, blk + ".to_out", m1))
    la = f"log_assignment.{L - 1}"
    sim = _dense(p, la + ".final_proj", x0) @ _dense(p, la + ".final_proj", x1).T / D**0.5
    z0 = F.logsigmoid(_dense(p, la + ".matchability", x0))[:, 0]
    z1 = F.logsigmoid(_dense(p, la + ".matchability", x1))[:, 0]
    return torch.log_softmax(sim, 1) + torch.log_softmax(sim, 0) + z0[:, None] + z1[None, :]


def matches(s, threshold):
    """matches0 (N0,) int64: the mutual argmax above the threshold, else -1."""
    best1, best0 = s.argmax(1), s.argmax(0)
    mutual = best0[best1] == torch.arange(s.shape[0], device=s.device)
    ok = mutual & (torch.exp(s.max(1).values) > threshold)
    return torch.where(ok, best1, -1).cpu().numpy()


def normalize(kps, wh):
    size = np.asarray(wh, np.float32)
    return (np.asarray(kps, np.float32) - size / 2.0) / (size.max() / 2.0)


def fp8(t):
    return t.to(torch.float8_e4m3fn).to(torch.float32)


def compare(ctx):
    """lg_match_miss: over the scene's pairs, the share of matches that one
    side makes and the other does not, over the union of the program's and
    the float32 reference's, so that a match dropped reads as one moved.
    The pairs are every pair of the scene where retrieval keeps them all
    (n_retrieval at least the images less one), else the program's; a pair
    the program left without matches counts all of the reference's as
    missing. In the control the reference with its parameters, inputs and
    attention operands in float8 (e4m3), the precision below the
    configuration's bfloat16, takes the program's place."""
    spec = ctx.net("lightglue")
    p = load(spec["path"], ctx.device)
    thr = spec.get("filter_threshold", 0.1)
    miss, union = 0, 0
    for a, b in ctx.expected_pairs():
        (ka, da), (kb, db) = ctx.program_features(a), ctx.program_features(b)
        args = [torch.as_tensor(t, device=ctx.device) for t in
                (normalize(ka, ctx.image_wh(a)), normalize(kb, ctx.image_wh(b)), da.astype(np.float32),
                 db.astype(np.float32))]
        with torch.no_grad():
            ref = matches(scores(p, spec, *args), thr)
            got = matches(scores(p, spec, *args, rnd=fp8), thr) if ctx.control else ctx.program_matches(a, b)
        r, g = ref >= 0, got >= 0
        miss += int((r & g & (got != ref)).sum()) * 2 + int((r ^ g).sum())
        union += int((r | g).sum()) + int((r & g & (got != ref)).sum())
    return {"lg_match_miss": miss / max(union, 1)}
