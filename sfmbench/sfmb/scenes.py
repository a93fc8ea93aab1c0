"""The benchmark's scenes: a textured corner of two planes seen by cameras
stepping along x, rendered on the device from (seed, scene index) and
written as the directory a user hands to reconstruct (images/imNN.png,
intrinsics.yaml).

The geometry and sizes are the same for every scene and seed; the seed
draws the textures. The planes n·p = n_z·d0 and the camera
path are those of the port's test scenes (tests/synthetic.PlaneScene's
wedge): camera i looks down +z from (−baseline·i, 0.03·i, 0.02·i) rotated
by the rotation vector (0.01, 0.015, 0.005)·i. Each plane carries three
multi-octave noise textures, one a colour channel.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PLANES = [((0.25, -0.15, -1.0), 5.0), ((-0.45, 0.1, -1.0), 3.6)]
OCTAVES = (1.0, 0.7, 0.5, 0.35, 0.25)
PLANE_EXTENT = 8.0


def rotvec_matrix(v):
    """Rodrigues: the rotation matrix of rotation vector v."""
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def poses(n, baseline):
    """World-to-camera (R, t) of the n cameras: p_cam = R p + t."""
    return [(rotvec_matrix(np.array([0.01, 0.015, 0.005]) * i), np.array([-baseline * i, 0.03 * i, 0.02 * i]))
            for i in range(n)]


def noise_texture(rng, res, device):
    """(res, res) noise in [0, 1]: uniform layers of res/16 .. res texels a
    side (at least 8), bilinearly upsampled with corners aligned, weighted,
    summed, then a [1, 2, 1]/4 blur a side (reflected edges)."""
    tex = torch.zeros((res, res), dtype=torch.float64, device=device)
    for octv, wgt in enumerate(OCTAVES):
        m = max(8, res >> (len(OCTAVES) - 1 - octv))
        layer = torch.as_tensor(rng.uniform(-1, 1, (m, m)), device=device)
        tex += wgt * F.interpolate(layer[None, None], size=(res, res), mode="bilinear", align_corners=True)[0, 0]
    k = torch.tensor([0.25, 0.5, 0.25], dtype=torch.float64, device=device)
    t = F.pad(tex[None, None], (1, 1, 1, 1), mode="reflect")
    t = F.conv2d(F.conv2d(t, k.view(1, 1, 1, 3)), k.view(1, 1, 3, 1))[0, 0]
    return (t - t.min()) / (t.max() - t.min())


def _lookup(tex, su, tv):
    n = tex.shape[-1]
    su, tv = su.clamp(0, n - 1.001), tv.clamp(0, n - 1.001)
    x0, y0 = su.long(), tv.long()
    fx, fy = su - x0, tv - y0
    return ((tex[:, y0, x0] * (1 - fx) + tex[:, y0, x0 + 1] * fx) * (1 - fy)
            + (tex[:, y0 + 1, x0] * (1 - fx) + tex[:, y0 + 1, x0 + 1] * fx) * fy)


def render(R, t, wh, focal, textures, planes):
    """(H, W, 3) uint8 view from (R, t): each pixel takes the colour of the
    nearest plane along its ray, at the hit point's coordinates in that
    plane's frame."""
    W, H = wh
    dev = textures[0].device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    rays = torch.stack([(xx - W / 2) / focal, (yy - H / 2) / focal, torch.ones_like(xx)], -1)
    Rt = torch.as_tensor(R.T, device=dev)
    r = rays @ Rt.T
    c = torch.as_tensor(-R.T @ t, device=dev)
    img = torch.zeros((3, H, W), dtype=torch.float64, device=dev)
    best = torch.full((H, W), float("inf"), dtype=torch.float64, device=dev)
    for (n, d0), tex in zip(planes, textures):
        n = np.asarray(n, np.float64) / np.linalg.norm(n)
        nt = torch.as_tensor(n, device=dev)
        denom = r @ nt
        s = (n[2] * d0 - float(n @ (-R.T @ t))) / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        s = torch.where(s > 0.05, s, torch.full_like(s, float("inf")))
        e1 = np.cross(n, [0, 0, 1.0])
        e1 = e1 / np.linalg.norm(e1) if np.linalg.norm(e1) > 1e-6 else np.array([1.0, 0, 0])
        e2 = np.cross(n, e1)
        rel = c + torch.where(torch.isfinite(s), s, torch.zeros_like(s))[..., None] * r \
            - torch.tensor([0, 0, d0], dtype=torch.float64, device=dev)
        res = tex.shape[-1]
        su = (rel @ torch.as_tensor(e1, device=dev) / PLANE_EXTENT + 0.5) * (res - 1)
        tv = (rel @ torch.as_tensor(e2, device=dev) / PLANE_EXTENT + 0.5) * (res - 1)
        near = s < best
        img = torch.where(near, _lookup(tex, su, tv), img)
        best = torch.minimum(best, s)
    return (img.permute(1, 2, 0) * 255).to(torch.uint8).cpu().numpy()


def png_rgb(img):
    """PNG bytes of an (H, W, 3) uint8 image: 8-bit RGB, no row filter, one
    zlib stream at level 1."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], 1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def make_scene(out_dir, seed, index, traffic, n_images, device):
    """Render scene `index` of `seed` into out_dir. Returns {"dir", "names",
    "images" (uint8 RGB arrays), "intrinsics", "truth" ({name: world-to-camera
    (R, t)})}."""
    rng = np.random.default_rng([seed % 2**63, index + 1])
    wh = (traffic["width"], traffic["height"])
    focal = float(traffic["focal"])
    planes = PLANES[:1 + bool(traffic.get("wedge", True))]
    textures = [torch.stack([noise_texture(rng, traffic["texture_res"], device) for _ in range(3)])
                for _ in planes]
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    names, images, truth = [], [], {}
    for i, (R, t) in enumerate(poses(n_images, traffic["baseline"])):
        img = render(R, t, wh, focal, textures, planes)
        name = f"im{i:02d}.png"
        (out / "images" / name).write_bytes(png_rgb(img))
        names.append(name)
        images.append(img)
        truth[name] = (R, t)
    intr = [focal, focal, wh[0] / 2, wh[1] / 2]
    (out / "intrinsics.yaml").write_text(json.dumps({"1": {"params": intr, "images": "all"}}))
    return {"dir": out, "names": names, "images": images, "intrinsics": intr, "truth": truth}
