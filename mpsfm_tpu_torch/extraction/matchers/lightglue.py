"""LightGlue (port of mpsfm_tpu/extraction/matchers/lightglue.py).

9 transformer layers of self- (with rotary positional encoding) and
cross-attention over the two keypoint sets, then the matchability-weighted
dual-softmax assignment, at fixed depth (no early exit or pruning, as in
the JAX package). Keypoint sets are padded to power-of-two buckets from
512 up, with masks; pairs of one bucket go through as one batch. Every
attention call goes through `attention.attention`: K4's hand-written
kernel of the operands' dtype on a CUDA tensor, its plain version on a CPU
one. The JAX package's
`qchunk`, `stream` and `pallas` attention branches are TPU tiling and
transport paths and have no counterpart here.

Parameters live in a plain dict of tensors on the device, in the JAX
package's tree (`input_proj`, `Wr`, `self_{l}`, `cross_{l}`, `final_proj`,
`matchability`), built from the official checkpoint
(superpoint_lightglue.pth) by `params_from_torch_state_dict`. The conf's
`dtype` is `bfloat16` (the default, as in the JAX package) or `float32`
(the parity setting). Under bfloat16 the parameters, keypoints and
descriptors are rounded to bfloat16, as the JAX package's raw_fwd does,
and every attention call takes bfloat16 q, k, v (K4's tensor-core
kernel: float32 logits, softmax statistics and accumulator, P rounded to
bfloat16 for P·V, a bfloat16 result); the dense layers,
norms and the assignment compute in float32 on those rounded values, as
XLA does with the JAX package's bfloat16 graph on the CPU (its excess
precision keeps fused intermediates in float32). The scores are float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.manifest import check_state_dict
from mpsfm_tpu_torch.extraction.matchers.attention import attention
from mpsfm_tpu_torch.extraction.weights import maybe_resolve


def normalize_keypoints(kps, wh):
    """Center + scale keypoints to ~[-1,1] (lightglue convention); host numpy."""
    size = np.asarray(wh, np.float32)
    c = size / 2.0
    f = size.max() / 2.0
    return (np.asarray(kps, np.float32) - c) / f


def apply_rotary(x, enc):
    """x (B,N,H,D) interleaved rotation by enc=(cos,sin) (B,N,D)."""
    cos, sin = enc
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    cos = cos[:, :, None, 0::2]
    sin = sin[:, :, None, 0::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).reshape(x.shape)


def _fourier_enc(kpts_norm, Wr):
    """Rotary positional encoding: project 2D positions with learned Wr
    (D/H/2, 2) -> angles, return (cos, sin) each repeated twice along the
    last axis."""
    proj = torch.einsum("bnc,dc->bnd", kpts_norm, Wr)
    return torch.repeat_interleave(torch.cos(proj), 2, -1), torch.repeat_interleave(torch.sin(proj), 2, -1)


def _dense(p, x):
    return x @ p["w"].T + p["b"]


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def device_extract(scores, m0, m1, threshold):
    """Mutual-argmax match extraction over a padded masked batch: returns
    (matches0 (B,N0) int32, matching_scores0 (B,N0) float32)."""
    s = torch.where(m0[:, :, None] & m1[:, None, :], scores, torch.full((), -1e9, device=scores.device))
    best1 = s.argmax(2)
    best0 = s.argmax(1)
    mutual = torch.gather(best0, 1, best1) == torch.arange(s.shape[1], device=s.device)[None]
    prob = torch.exp(s.max(2).values)
    valid = mutual & (prob > threshold) & m0
    return (torch.where(valid, best1, -1).to(torch.int32),
            torch.where(valid, prob, torch.zeros((), device=s.device)).float())


class LightGlue:
    """Functional LightGlue with an explicit parameter dict, on `device`."""

    default_conf = {
        "dim": 256,
        "input_dim": None,  # descriptor dim fed to input_proj (default: dim)
        "num_heads": 4,
        "n_layers": 9,
        "filter_threshold": 0.1,
        "weights_path": None,
        "dtype": "bfloat16",  # bfloat16 | float32 (the parity setting); see the module docstring
        "table_dtype": "float16",  # match_pairs_from_table's descriptor table, as in the JAX package
    }
    # bound on B·N0·N1 of one forward: its (B, N0, N1) float32 score tensors then take 1 GiB each
    max_score_elements = 1 << 28

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(self.conf.get("weights_path"))
        if wp:
            sd = torch.load(wp, map_location="cpu")
            if "state_dict" in sd:
                sd = sd["state_dict"]
            sd = self.normalize_torch_state_dict(sd, n_layers=self.conf["n_layers"], dim=self.conf["dim"])
            # manifest check only at the official architecture size
            if (self.conf["dim"], self.conf["num_heads"], self.conf["n_layers"]) == (256, 4, 9):
                check_state_dict(sd, "lightglue", where=str(wp))
            self.params = self.params_from_torch_state_dict(sd, n_layers=self.conf["n_layers"])

    @property
    def compute_dtype(self):
        """The type the parameters, inputs and attention operands are rounded to."""
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.conf["dtype"]]

    def _attend(self, q, k, v, mask, scale):
        dt = self.compute_dtype
        return attention(q.to(dt), k.to(dt), v.to(dt), mask, scale).float()

    # ---------- parameter handling ----------
    def _to_device(self, tree):
        return {k: self._to_device(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v, np.float32),
                                                                                   device=self.device)
                for k, v in tree.items()}

    def init_random(self, seed=0):
        """The JAX package's init_random: the same numpy draws in the same
        order, so init_random(s) gives both packages the same weights."""
        rng = np.random.default_rng(seed)
        D, H, L = self.conf["dim"], self.conf["num_heads"], self.conf["n_layers"]

        def dense(i, o):
            return {"w": rng.normal(scale=1 / np.sqrt(i), size=(o, i)).astype(np.float32),
                    "b": np.zeros(o, np.float32)}

        in_dim = self.conf.get("input_dim") or D
        p = {"input_proj": dense(in_dim, D), "Wr": rng.normal(scale=1.0, size=(D // H // 2, 2)).astype(np.float32)}
        for l in range(L):
            p[f"self_{l}"] = {"Wqkv": dense(D, 3 * D), "out": dense(D, D), "ffn0": dense(2 * D, 2 * D),
                              "ffn_ln_g": np.ones(2 * D, np.float32), "ffn_ln_b": np.zeros(2 * D, np.float32),
                              "ffn1": dense(2 * D, D)}
            p[f"cross_{l}"] = {"to_qk": dense(D, D), "to_v": dense(D, D), "out": dense(D, D),
                               "ffn0": dense(2 * D, 2 * D), "ffn_ln_g": np.ones(2 * D, np.float32),
                               "ffn_ln_b": np.zeros(2 * D, np.float32), "ffn1": dense(2 * D, D)}
        p["final_proj"] = dense(D, D)
        p["matchability"] = dense(D, 1)
        self.params = self._to_device(p)

    @staticmethod
    def normalize_torch_state_dict(sd, n_layers=9, dim=256):
        """Bring the released superpoint_lightglue.pth naming onto the
        post-rename layout this port (and the pinned manifest) uses: the
        old ``self_attn.{i}.*`` / ``cross_attn.{i}.*`` become
        ``transformers.{i}.self_attn.*`` / ``.cross_attn.*``, and a missing
        ``input_proj`` (nn.Identity when input_dim == descriptor_dim) is
        synthesized as the identity."""
        out = dict(sd)
        for i in range(n_layers):
            for old, new in ((f"self_attn.{i}.", f"transformers.{i}.self_attn."),
                             (f"cross_attn.{i}.", f"transformers.{i}.cross_attn.")):
                for k in list(out):
                    if k.startswith(old):
                        out[new + k[len(old):]] = out.pop(k)
        if "input_proj.weight" not in out:
            qkv = out.get("transformers.0.self_attn.Wqkv.weight")
            if qkv is not None:
                dim = int(np.shape(qkv)[-1])
            out["input_proj.weight"] = torch.eye(dim)
            out["input_proj.bias"] = torch.zeros(dim)
        return out

    def params_from_torch_state_dict(self, sd, n_layers=9):
        """The official checkpoint (released or normalized naming) -> the
        parameter dict on the device."""
        sd = self.normalize_torch_state_dict(sd, n_layers=n_layers)

        def dense(prefix):
            return {"w": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

        p = {"input_proj": dense("input_proj"), "Wr": sd["posenc.Wr.weight"],
             "final_proj": dense(f"log_assignment.{n_layers - 1}.final_proj"),
             "matchability": dense(f"log_assignment.{n_layers - 1}.matchability")}
        for l in range(n_layers):
            base = f"transformers.{l}"
            p[f"self_{l}"] = {"Wqkv": dense(f"{base}.self_attn.Wqkv"), "out": dense(f"{base}.self_attn.out_proj"),
                              "ffn0": dense(f"{base}.self_attn.ffn.0"),
                              "ffn_ln_g": sd[f"{base}.self_attn.ffn.1.weight"],
                              "ffn_ln_b": sd[f"{base}.self_attn.ffn.1.bias"], "ffn1": dense(f"{base}.self_attn.ffn.3")}
            p[f"cross_{l}"] = {"to_qk": dense(f"{base}.cross_attn.to_qk"), "to_v": dense(f"{base}.cross_attn.to_v"),
                               "out": dense(f"{base}.cross_attn.to_out"), "ffn0": dense(f"{base}.cross_attn.ffn.0"),
                               "ffn_ln_g": sd[f"{base}.cross_attn.ffn.1.weight"],
                               "ffn_ln_b": sd[f"{base}.cross_attn.ffn.1.bias"],
                               "ffn1": dense(f"{base}.cross_attn.ffn.3")}
        return self._to_device(p)

    # ---------- math ----------
    def _self_block(self, p, x, enc, mask):
        D, H = self.conf["dim"], self.conf["num_heads"]
        B, N, _ = x.shape
        # checkpoint layout: the 3D Wqkv output unflattens to (H, D/H, 3), not (H, 3, D/H)
        qkv = _dense(p["Wqkv"], x).reshape(B, N, H, D // H, 3)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        q = apply_rotary(q, enc)
        k = apply_rotary(k, enc)
        ctx = self._attend(q, k, v, mask, 1.0 / math.sqrt(D // H)).reshape(B, N, D)
        y = torch.cat([x, _dense(p["out"], ctx)], -1)
        ff = _ln(_dense(p["ffn0"], y), p["ffn_ln_g"], p["ffn_ln_b"])
        return x + _dense(p["ffn1"], F.gelu(ff))  # exact GELU, as torch's nn.GELU

    def _cross_block(self, p, x0, x1, mask0, mask1):
        D, H = self.conf["dim"], self.conf["num_heads"]
        B = x0.shape[0]

        def heads(t):
            return t.reshape(B, -1, H, D // H)

        qk0 = heads(_dense(p["to_qk"], x0))
        qk1 = heads(_dense(p["to_qk"], x1))
        v0 = heads(_dense(p["to_v"], x0))
        v1 = heads(_dense(p["to_v"], x1))
        scale = 1.0 / math.sqrt(D // H)  # hd^-0.25 applied to each side == this
        m0 = self._attend(qk0, qk1, v1, mask1, scale).reshape(B, -1, D)
        m1 = self._attend(qk1, qk0, v0, mask0, scale).reshape(B, -1, D)

        def ffn(x, msg):
            y = torch.cat([x, _dense(p["out"], msg)], -1)
            ff = _ln(_dense(p["ffn0"], y), p["ffn_ln_g"], p["ffn_ln_b"])
            return x + _dense(p["ffn1"], F.gelu(ff))

        return ffn(x0, m0), ffn(x1, m1)

    def _forward(self, p, kps0n, kps1n, desc0, desc1, mask0, mask1):
        """Log assignment scores (B, N0, N1) of padded keypoint sets."""
        x0 = _dense(p["input_proj"], desc0)
        x1 = _dense(p["input_proj"], desc1)
        enc0 = _fourier_enc(kps0n, p["Wr"])
        enc1 = _fourier_enc(kps1n, p["Wr"])
        for l in range(self.conf["n_layers"]):
            x0 = self._self_block(p[f"self_{l}"], x0, enc0, mask0)
            x1 = self._self_block(p[f"self_{l}"], x1, enc1, mask1)
            x0, x1 = self._cross_block(p[f"cross_{l}"], x0, x1, mask0, mask1)
        mf0 = _dense(p["final_proj"], x0)
        mf1 = _dense(p["final_proj"], x1)
        D = self.conf["dim"]
        # the official MatchAssignment divides each side by d^0.25 => sim / d^0.5
        sim = torch.einsum("bnd,bmd->bnm", mf0, mf1) / D**0.5
        z0 = F.logsigmoid(_dense(p["matchability"], x0))[..., 0]
        z1 = F.logsigmoid(_dense(p["matchability"], x1))[..., 0]
        sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim, torch.full((), -1e9, dtype=sim.dtype,
                                                                                   device=sim.device))
        return torch.log_softmax(sim, 2) + torch.log_softmax(sim, 1) + z0[:, :, None] + z1[:, None, :]

    def forward(self, k0, k1, d0, d1, m0, m1):
        """Scores (B, N0, N1) float32 (the JAX package's raw_fwd): under
        bfloat16 the parameters, keypoints and descriptors are rounded to it
        first."""
        dt = self.compute_dtype
        p, args = self.params, (k0, k1, d0, d1)
        if dt != torch.float32:
            p = _rounded(p, dt)
            args = tuple(t.to(dt).float() for t in args)
        with torch.no_grad():
            return self._forward(p, *args, m0, m1)

    def forward_extract(self, k0, k1, d0, d1, m0, m1):
        """Forward + on-device match extraction: (matches0, matching_scores0)."""
        scores = self.forward(k0, k1, d0, d1, m0, m1)
        return device_extract(scores, m0, m1, self.conf["filter_threshold"])

    # ---------- host API ----------
    @staticmethod
    def _bucket(n):
        b = 512
        while b < n:
            b *= 2
        return b

    def _chunk(self, n0, n1, cap=64):
        """Pairs of one forward at buckets (n0, n1): at most `cap`, and few
        enough that one (B, n0, n1) score tensor stays under
        max_score_elements (changes no result: pairs are independent)."""
        return max(1, min(cap, self.max_score_elements // (n0 * n1)))

    def match_pairs(self, pairs):
        """Batched-pairs matching: ``pairs`` is a list of
        (kps0, desc0, wh0, kps1, desc1, wh1). Pairs are bucketed by padded
        keypoint counts and each bucket runs as batched forwards. Returns a
        list of {matches0, matching_scores0}."""
        assert self.params is not None, "load weights or call init_random() first"
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (k0, _, _, k1, _, _) in enumerate(pairs):
            buckets.setdefault((self._bucket(len(k0)), self._bucket(len(k1))), []).append(i)
        results: list[dict] = [None] * len(pairs)
        for (b0, b1), all_idxs in buckets.items():
            step = self._chunk(b0, b1)
            for c0 in range(0, len(all_idxs), step):
                idxs = all_idxs[c0:c0 + step]
                B = len(idxs)
                K0 = np.zeros((B, b0, 2), np.float32)
                K1 = np.zeros((B, b1, 2), np.float32)
                D0 = np.zeros((B, b0, pairs[idxs[0]][1].shape[1]), np.float32)
                D1 = np.zeros((B, b1, pairs[idxs[0]][4].shape[1]), np.float32)
                m0 = np.zeros((B, b0), bool)
                m1 = np.zeros((B, b1), bool)
                for j, i in enumerate(idxs):
                    k0, d0, wh0, k1, d1, wh1 = pairs[i]
                    n0, n1 = len(k0), len(k1)
                    K0[j, :n0] = normalize_keypoints(k0, wh0)
                    K1[j, :n1] = normalize_keypoints(k1, wh1)
                    D0[j, :n0] = d0
                    D1[j, :n1] = d1
                    m0[j, :n0] = True
                    m1[j, :n1] = True
                dev = self.device
                mm, ss = self.forward_extract(*(torch.as_tensor(a, device=dev) for a in (K0, K1, D0, D1, m0, m1)))
                mm, ss = mm.cpu().numpy(), ss.cpu().numpy()
                for j, i in enumerate(idxs):
                    n0 = len(pairs[i][0])
                    results[i] = {"matches0": mm[j, :n0].astype(np.int64),
                                  "matching_scores0": ss[j, :n0].astype(np.float64)}
        return results

    def match_pairs_from_table(self, feats, whs, pair_idx, chunk=64):
        """Image-major batched matching: each image's keypoints and
        descriptors go into one device table once (descriptors in
        table_dtype, float16 by default, as in the JAX package), and each
        chunk of pairs gathers its operands from it by index.

        feats: list of (kps (n,2), desc (n,D)) per image; whs: list of
        (w, h); pair_idx: (P, 2) int array of image indices. Returns a
        list of {matches0, matching_scores0} per pair."""
        assert self.params is not None, "load weights or call init_random() first"
        n_img = len(feats)
        Nmax = self._bucket(max((len(k) for k, _ in feats), default=1))
        D = feats[0][1].shape[1] if feats else self.conf["dim"]
        tdtype = np.dtype(self.conf.get("table_dtype", "float16"))
        K = np.zeros((n_img, Nmax, 2), np.float32)
        Dt = np.zeros((n_img, Nmax, D), tdtype)
        M = np.zeros((n_img, Nmax), bool)
        for i, ((kps, desc), wh) in enumerate(zip(feats, whs)):
            n = len(kps)
            K[i, :n] = normalize_keypoints(kps, wh)
            Dt[i, :n] = desc.astype(tdtype)
            M[i, :n] = True
        dev = self.device
        K_t, D_t, M_t = (torch.as_tensor(a, device=dev) for a in (K, Dt, M))
        pair_idx = np.asarray(pair_idx, np.int64).reshape(-1, 2)
        step = self._chunk(Nmax, Nmax, chunk)
        results = []
        for c0 in range(0, len(pair_idx), step):
            idx = torch.as_tensor(pair_idx[c0:c0 + step], device=dev)
            i0, i1 = idx[:, 0], idx[:, 1]
            mm, ss = self.forward_extract(K_t[i0], K_t[i1], D_t[i0].float(), D_t[i1].float(), M_t[i0], M_t[i1])
            mm, ss = mm.cpu().numpy(), ss.cpu().numpy()
            for j in range(len(idx)):
                n0 = len(feats[pair_idx[c0 + j, 0]][0])
                results.append({"matches0": mm[j, :n0].astype(np.int64),
                                "matching_scores0": ss[j, :n0].astype(np.float64)})
        return results

    def __call__(self, kps0, desc0, wh0, kps1, desc1, wh1):
        """One pair's matches: the mutual argmax above filter_threshold."""
        return self.match_pairs([(kps0, desc0, wh0, kps1, desc1, wh1)])[0]


def _rounded(tree, dt):
    """The parameter tree rounded to dt, kept in float32."""
    return {k: _rounded(v, dt) if isinstance(v, dict) else v.to(dt).float() for k, v in tree.items()}
