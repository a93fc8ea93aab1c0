"""On-scene training of the framework's own MonoViT prior (port of
mpsfm_tpu/extraction/nets/train_mono.py).

Where no pretrained checkpoint can be downloaded, the framework fits its
prior net (nets/mono.py) to posed RGB-D views of the scene, e.g. an initial
mapping pass with sensor depth, and then uses its predictions (depth,
normals and their calibrated variances) as monocular priors when it
registers new, low-overlap captures.

Losses (masked by validity), as the JAX package's:
  * depth: log-L1, plus the confidence head regressed against the detached
    residual (sigma_rel = |r|, clipped to [0.01, 1]), the parameterization
    the backend exports as depth_variance = (d · (1 - conf))²;
  * normals: the heteroscedastic angular NLL with alpha = kappa_to_alpha(
    kappa), theta² ~ 2 (1 - <n, n_gt>), plus 1 - <n, n_gt>.

Batches are assembled on the host with numpy's generator (the same seed
gives the JAX package's batches): a random view, a patch-aligned crop,
optionally a horizontal flip with the normals' x mirrored. The optimizer is
AdamW (weight decay 1e-4) under optax's warmup_cosine_decay_schedule(0, lr,
warmup, steps, 0.05 lr), evaluated, as optax does, at the count before each
step: the first update has lr = 0. The attention's gradient is K4's autograd
Function (extraction/matchers/attention: the kernel forward, torch ops
backward) on the card.

Depth is trained in the canonical-focal convention (d_canonical = d_metric
· f_canonical / f), matching the backend's inverse rescale at inference.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.nets.mono import HEADS, MonoViT
from mpsfm_tpu_torch.extraction.nets.vit import init_seeded

DEFAULT_NET = {"dim": 96, "depth_blocks": 4, "num_heads": 2, "patch": 16, "feat": 48}
WEIGHT_DECAY = 1e-4
END_LR = 0.05  # the schedule's end value, a share of lr


def _pad_to_patch(img, patch):
    H, W = img.shape[:2]
    Hp, Wp = ((H + patch - 1) // patch) * patch, ((W + patch - 1) // patch) * patch
    if (Hp, Wp) == (H, W):
        return img
    out = np.zeros((Hp, Wp) + img.shape[2:], img.dtype)
    out[:H, :W] = img
    return out


def kappa_to_alpha(kappa):
    """Differentiable vMF kappa -> expected angular error (radians)."""
    e = torch.exp(-kappa * math.pi)
    return (2 * kappa / (kappa**2 + 1)) + e * math.pi / (1 + e)


def _loss_fn(net, batch):
    """(loss, aux) of `net` on a batch of tensors (rgb, depth, normals,
    valid); aux: loss, log_d_mae, ang_err, detached."""
    out = net(batch["rgb"])
    m = batch["valid"]
    msum = torch.clamp(m.sum(), min=1.0)
    d = torch.clamp(out["depth"], min=1e-4)
    r = torch.log(d) - torch.log(torch.clamp(batch["depth"], min=1e-4))
    loss_d = (r.abs() * m).sum() / msum
    sig_tgt = torch.clamp(r.abs(), 0.01, 1.0).detach()
    loss_d = loss_d + (torch.square((1.0 - out["conf"]) - sig_tgt) * m).sum() / msum
    dot = torch.clamp((out["normals"] * batch["normals"]).sum(-1), -1.0, 1.0)
    theta2 = 2.0 * (1.0 - dot)
    alpha = torch.clamp(kappa_to_alpha(out["kappa"]), 1e-3, math.pi)
    nll_n = 0.5 * theta2 / torch.square(alpha) + torch.log(alpha)
    loss = loss_d + (nll_n * m).sum() / msum + ((1.0 - dot) * m).sum() / msum
    aux = {"loss": loss.detach(), "log_d_mae": ((r.abs() * m).sum() / msum).detach(),
           "ang_err": ((torch.sqrt(theta2 + 1e-12) * m).sum() / msum).detach()}
    return loss, aux


def _make_crop_batch(rng, images, depths, normals, valids, crop_hw, batch, patch, flip_aug):
    """Host-side batch assembly: a random view, a patch-aligned crop, an
    optional horizontal flip (the normals' x mirrored); static shapes. The
    JAX package's draws, in its order."""
    ch, cw = crop_hw
    N, H, W = depths.shape
    rgb = np.empty((batch, ch, cw, 3), np.float32)
    dep = np.empty((batch, ch, cw), np.float32)
    nrm = np.empty((batch, ch, cw, 3), np.float32)
    val = np.empty((batch, ch, cw), np.float32)
    for b in range(batch):
        i = rng.integers(N)
        y = patch * rng.integers((H - ch) // patch + 1)
        x = patch * rng.integers((W - cw) // patch + 1)
        r_, d_, n_, v_ = (images[i, y: y + ch, x: x + cw], depths[i, y: y + ch, x: x + cw],
                          normals[i, y: y + ch, x: x + cw], valids[i, y: y + ch, x: x + cw])
        if flip_aug and rng.integers(2):
            r_, d_, v_ = r_[:, ::-1], d_[:, ::-1], v_[:, ::-1]
            n_ = n_[:, ::-1].copy()
            n_[..., 0] *= -1.0
        rgb[b], dep[b], nrm[b], val[b] = r_, d_, n_, v_
    return {"rgb": rgb, "depth": dep, "normals": nrm, "valid": val}


def lr_at(count, lr, warmup, steps):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, END_LR · lr)
    at `count`: linear from 0 over the warmup, then a cosine to END_LR · lr
    over the remaining steps."""
    if count < warmup:
        return lr * count / warmup
    c = min(count - warmup, steps - warmup)
    return lr * ((1 - END_LR) * 0.5 * (1 + math.cos(math.pi * c / (steps - warmup))) + END_LR)


def train_mono(images, depths, normals, valids=None, *, net=None, net_conf=None, params=None, steps=300, batch=8,
               crop=None, lr=1e-3, seed=0, focals=None, canonical_focal=500.0, flip_aug=False, log_every=0,
               device="cuda"):
    """Fit MonoViT to posed RGB-D supervision on `device`.

    images: (N,H,W,3) float in [0,1] (or uint8); depths: (N,H,W) metric;
    normals: (N,H,W,3) camera-frame unit normals; valids: (N,H,W) bool.
    focals: per-image focal lengths (depth converted to the canonical-focal
    convention). crop=None trains full frames. params: the initial state
    dict (e.g. the JAX package's Flax init by convert.mono_state_dict), else
    a seeded draw (vit.init_seeded). Returns (net, its state dict, the last
    step's metrics)."""
    if steps < 2:
        raise ValueError(f"train_mono: {steps} steps; the cosine schedule needs at least 2")
    dev = resolve_device(device)
    images = np.asarray(images, np.float32)
    if images.max() > 1.5:
        images = images / 255.0
    depths = np.asarray(depths, np.float32)
    normals = np.asarray(normals, np.float32)
    if valids is None:
        valids = depths > 0
    valids = np.asarray(valids, np.float32)
    if focals is not None:
        depths = depths * (canonical_focal / np.asarray(focals, np.float32).reshape(-1, 1, 1))
    if net is None:
        c = {**DEFAULT_NET, **(net_conf or {})}
        net = MonoViT(**{k: int(c[k]) for k in DEFAULT_NET})
    patch = net.patch
    images, depths, normals, valids = (np.stack([_pad_to_patch(a, patch) for a in arr])
                                       for arr in (images, depths, normals, valids))
    H, W = depths.shape[1:3]
    ch, cw = (H, W) if crop is None else (min(crop[0], H) // patch * patch, min(crop[1], W) // patch * patch)
    if params is not None:
        net.load_state_dict(params)
    else:
        init_seeded(net, seed)
    net.to(dev).train()
    rng = np.random.default_rng(seed)
    warmup = max(1, min(steps // 10, 50, steps - 1))
    opt = torch.optim.AdamW(net.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
    aux = {}
    for it in range(steps):
        b = _make_crop_batch(rng, images, depths, normals, valids, (ch, cw), batch, patch, flip_aug)
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        for group in opt.param_groups:
            group["lr"] = lr_at(it, lr, warmup, steps)
        opt.zero_grad(set_to_none=True)
        loss, aux = _loss_fn(net, b)
        loss.backward()
        opt.step()
        if log_every and (it % log_every == 0 or it == steps - 1):
            a = {k: float(v) for k, v in aux.items()}
            print(f"[train_mono] step {it}: loss {a['loss']:.4f} log_d_mae {a['log_d_mae']:.4f} "
                  f"ang_err {a['ang_err']:.4f}")
    net.eval()
    return net, net.state_dict(), {k: float(v) for k, v in aux.items()}


def save_mono_params(params, path):
    """MonoViT's state dict -> a torch file in the timm-style naming that
    mono.mono_params_from_torch (and the JAX package's load_mono_params)
    reads: trunk.patch_embed.proj, trunk.blocks.N.mlp.fcK, the position
    embedding flattened to (1, side², D); the decoder and heads as they
    are. A Flax file suffix raises (the port writes torch files only)."""
    path = Path(path)
    if path.suffix in (".msgpack", ".flax"):
        raise ValueError(f"{path}: the port writes torch state dicts, not Flax {path.suffix} files")
    sd = {}
    for k, v in params.items():
        v = v.detach().float().cpu().contiguous()
        if not k.startswith("trunk."):
            sd[k] = v
            continue
        name = k[len("trunk."):]
        if name.startswith("patch_embed."):
            name = "patch_embed.proj." + name.split(".", 1)[1]
        elif name.startswith("blocks_"):
            i, rest = name[len("blocks_"):].split(".", 1)
            name = f"blocks.{i}." + rest.replace("mlp_fc", "mlp.fc")
        elif name == "pos_embed":
            v = v.reshape(1, -1, v.shape[-1])
        sd["trunk." + name] = v
    if not all(any(k.startswith(h) for k in sd) for h in HEADS):
        raise ValueError("save_mono_params: not a MonoViT state dict")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)
    return path


def load_scene(data_dir, resize_long=160):
    """An RGB-D scene directory (datasets/simple.py's layout: images/*.png,
    depth/*.npy, intrinsics.yaml) as fit_scene_prior trains on it:
    (images (N,H,W,3) in [0,1], depths, normals, valids, focals), the frames
    resized to the resize_long processing resolution by INTER_AREA
    (guided_filter.resize_area; depth values are resolution-invariant, the
    focal scales with the resize) and the normals derived from the depth
    (priors.normals_from_depth, the measured backend's geometry)."""
    from mpsfm_tpu_torch.datasets.simple import SimpleParser
    from mpsfm_tpu_torch.extraction.guided_filter import resize_area
    from mpsfm_tpu_torch.extraction.priors import normals_from_depth
    from mpsfm_tpu_torch.utils import io

    parser = SimpleParser(data_dir)
    images, depths, normals, valids, focals = [], [], [], [], []
    for name in parser.image_names():
        rgb = io.read_image(parser.image_path(name)).astype(np.float32) / 255.0
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, -1)
        kw = parser.prior_inputs(name)
        d = np.asarray(kw["depth_measured"], np.float32)
        fx, fy, cx, cy = [float(v) for v in kw["intrinsics"][:4]]
        H, W = d.shape
        if resize_long and max(H, W) != resize_long:
            s = float(resize_long) / max(H, W)
            Wr, Hr = max(1, round(W * s)), max(1, round(H * s))
            rgb = resize_area(torch.as_tensor(rgb), (Hr, Wr)).numpy()
            d = resize_area(torch.as_tensor(d), (Hr, Wr)).numpy()
            fx, fy, cx, cy = fx * s, fy * s, cx * s, cy * s
        images.append(rgb)
        depths.append(d)
        normals.append(normals_from_depth(d, fx, fy, cx, cy).astype(np.float32))
        valids.append(d > 0)
        focals.append(0.5 * (fx + fy))
    return np.stack(images), np.stack(depths), np.stack(normals), np.stack(valids), np.asarray(focals)


def fit_scene_prior(data_dir, out_path, *, net_conf=None, steps=300, batch=8, lr=1e-3, seed=0, canonical_focal=500.0,
                    resize_long=160, log_every=0, device="cuda"):
    """Train on an RGB-D scene directory (load_scene) on `device` and save
    the weights (save_mono_params). Training runs full frames at the
    resize_long processing resolution; the returned backend conf carries
    the same resize_long. Returns (weights_path, backend_conf, history)."""
    images, depths, normals, valids, focals = load_scene(data_dir, resize_long)
    net, params, history = train_mono(images, depths, normals, valids, net_conf=net_conf, steps=steps, batch=batch,
                                      crop=None, lr=lr, seed=seed, focals=focals, canonical_focal=canonical_focal,
                                      log_every=log_every, device=device)
    save_mono_params(params, out_path)
    backend_conf = {"dim": net.dim, "depth_blocks": net.depth_blocks, "num_heads": net.num_heads, "patch": net.patch,
                    "feat": net.feat, "canonical_focal": canonical_focal, "resize_long": resize_long,
                    "weights_path": str(out_path)}
    return out_path, backend_conf, history
