"""Coarse-to-fine NCC dense matcher (port of
mpsfm_tpu/extraction/matchers/dense_ncc.py) — the no-weights stand-in for
the reference's dense matchers (RoMa warp / MASt3R reciprocal matching,
mpsfm/extraction/pairwise/match_dense_2view.py + models/roma.py).

Estimates a stride-s flow field A->B by normalized cross-correlation:
global search on a coarse pyramid level, windowed refinement per finer
level, forward-backward consistency for certainty. Outputs grid
keypoints + matches + certainties in the shape the dense caches hold.

The flow runs as torch ops on the images' device. Where the JAX package
gathers a 7×7 patch for every candidate pixel and normalises it, the port
normalises each level's patches once (`_patch_table`: every pixel's patch
of the replicate-padded image, mean removed, divided by its norm) and
gathers rows of that table by the flat index of each clipped candidate
centre: the same values, since clipping a patch's pixels to the image is
replicate padding. The search runs over chunks of the grid, so that one
(chunk, candidates, 49) block of gathered patches stays under BLOCK_BYTES.
Flows are int32 and `argmax` takes the first maximum, as jnp.argmax does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device

BLOCK_BYTES = 256 * 2**20  # the largest block of gathered patches one chunk of the search holds


def _pyr_down(img):
    """5×5 binomial blur with zero padding (XLA's SAME), then every second
    pixel."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float32, device=img.device) / 16.0
    out = F.conv2d(img[None, None], (k[:, None] * k[None, :])[None, None], padding=2)[0, 0]
    return out[::2, ::2]


def _patch_table(img, P):
    """(H·W, P·P) normalised patches of every pixel of img: the replicate-
    padded P×P window, its mean removed, divided by max(‖p‖, 1e-6)."""
    r = P // 2
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    p = F.unfold(padded, P)[0].T
    p = p - p.mean(-1, keepdim=True)
    return p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-6)


def _rows_at(table, W, ys, xs):
    """Rows of a level's patch table (row width W) at in-image centres
    (ys, xs); callers clip the centres, as the JAX package's _patches_at
    clips each patch pixel."""
    return table[ys.long() * W + xs.long()]


def _refine_level(tabA, tabB, shape, ys, xs, flow, R: int):
    """At one level: for A grid points (ys, xs) with current flow, search a
    (2R+1)² window in B for the best NCC match. Returns (flow, score); the
    flow int32."""
    H, W = shape
    dev = ys.device
    offs = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    K = dy.numel()
    chunk = max(1, BLOCK_BYTES // (K * tabB.shape[1] * tabB.element_size()))
    flows, scores = [], []
    for s in range(0, ys.numel(), chunk):
        y, x, f = ys[s:s + chunk], xs[s:s + chunk], flow[s:s + chunk]
        pa = _rows_at(tabA, W, y, x)  # the grid points lie inside the level
        cand_y = (y[:, None] + f[:, 1, None] + dy[None]).clamp(0, H - 1)
        cand_x = (x[:, None] + f[:, 0, None] + dx[None]).clamp(0, W - 1)
        pb = _rows_at(tabB, W, cand_y, cand_x)
        ncc = torch.bmm(pb, pa[:, :, None])[..., 0]
        best = torch.argmax(ncc, dim=1, keepdim=True)
        scores.append(ncc.gather(1, best)[:, 0])
        flows.append(torch.stack([cand_x.gather(1, best)[:, 0] - x, cand_y.gather(1, best)[:, 0] - y], -1))
    return torch.cat(flows), torch.cat(scores)


def ncc_flow(imgA, imgB, stride: int = 8, patch: int = 7, levels: int = 3, coarse_radius: int = 16,
             fine_radius: int = 3):
    """(H, W) float32 images on one device -> (grid_xy (N,2) in A, flow
    (N,2) A->B, certainty (N,)), float32 on that device."""
    H, W = imgA.shape
    dev = imgA.device
    pyrA, pyrB = [imgA], [imgB]
    for _ in range(levels - 1):
        pyrA.append(_pyr_down(pyrA[-1]))
        pyrB.append(_pyr_down(pyrB[-1]))
    tabA = [_patch_table(im, patch) for im in pyrA]
    tabB = [_patch_table(im, patch) for im in pyrB]

    ys0, xs0 = torch.meshgrid(
        torch.arange(patch, H - patch, stride, dtype=torch.int32, device=dev),
        torch.arange(patch, W - patch, stride, dtype=torch.int32, device=dev),
        indexing="ij",
    )
    ys0, xs0 = ys0.reshape(-1), xs0.reshape(-1)

    # coarse level: global-ish search
    f = 2 ** (levels - 1)
    flow = torch.zeros((ys0.numel(), 2), dtype=torch.int32, device=dev)
    flow, score = _refine_level(tabA[-1], tabB[-1], pyrB[-1].shape, ys0 // f, xs0 // f, flow, coarse_radius)
    # finer levels
    for lvl in range(levels - 2, -1, -1):
        f = 2**lvl
        flow, score = _refine_level(tabA[lvl], tabB[lvl], pyrB[lvl].shape, ys0 // f, xs0 // f, flow * 2,
                                    fine_radius)

    # forward-backward check at full res
    bx = (xs0 + flow[:, 0]).clamp(0, W - 1)
    by = (ys0 + flow[:, 1]).clamp(0, H - 1)
    back, _ = _refine_level(tabB[0], tabA[0], imgA.shape, by, bx, -flow, fine_radius)
    fb_err = torch.linalg.vector_norm((back + flow).float(), dim=-1)
    certainty = score * torch.exp(-0.5 * (fb_err / 2.0) ** 2)
    grid_xy = torch.stack([xs0, ys0], -1).float()
    return grid_xy, flow.float(), certainty


def assign_flow_to_keypoints(grid_xy, flow, certainty, kpsA, kpsB, max_dist=2.0, cert_thresh=0.5):
    """RoMa-sparse-style anchoring (reference models/utils/warp.py:34-73):
    interpolate the dense flow at detected keypoints of A, warp them into
    B, and assign each to the nearest detected keypoint of B within
    max_dist px (greedy dedup by certainty). Returns matches0 (NA,) into
    kpsB (or -1) + scores. Host numpy and scipy, as in the JAX package."""
    import scipy.spatial

    NA = len(kpsA)
    matches0 = np.full(NA, -1, np.int64)
    scores0 = np.zeros(NA, np.float32)
    if NA == 0 or len(kpsB) == 0 or len(grid_xy) == 0:
        return {"matches0": matches0, "matching_scores0": scores0}
    # interpolate flow + certainty at kpsA from the (scattered) grid
    tree_g = scipy.spatial.cKDTree(grid_xy)
    dist, idx = tree_g.query(kpsA, k=1)
    ux = np.unique(grid_xy[:, 0])
    stride = float(np.median(np.diff(ux))) if len(ux) > 1 else 8.0
    ok = (dist < 1.5 * max(stride, 8.0)) & (certainty[idx] > cert_thresh)
    warped = kpsA + flow[idx]
    tree_b = scipy.spatial.cKDTree(kpsB)
    db, jb = tree_b.query(warped, k=1)
    ok &= db < max_dist
    # greedy dedup: highest certainty keeps the target
    order = np.argsort(-certainty[idx])
    taken = set()
    for i in order:
        if not ok[i]:
            continue
        j = int(jb[i])
        if j in taken:
            continue
        taken.add(j)
        matches0[i] = j
        scores0[i] = certainty[idx[i]]
    return {"matches0": matches0, "matching_scores0": scores0}


class DenseNCCMatcher:
    """Dense matcher interface: pair of grayscale images -> dense
    keypoints in both + matches + certainties (reference 'dense' mode).
    The flow runs on `device`, the selection on the host."""

    default_conf = {
        "stride": 8,
        "patch": 7,
        "levels": 3,
        "certainty_threshold": 0.55,
        "max_matches": 4096,
    }

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)

    def __call__(self, grayA: np.ndarray, grayB: np.ndarray):
        c = self.conf
        # both zero-padded to a multiple of 32 (the JAX package's compile bucket): the grid, the
        # pyramid's borders and the patches near them depend on it
        H = max(grayA.shape[0], grayB.shape[0])
        W = max(grayA.shape[1], grayB.shape[1])
        Hb = ((H + 31) // 32) * 32
        Wb = ((W + 31) // 32) * 32
        A = np.zeros((Hb, Wb), np.float32)
        B = np.zeros((Hb, Wb), np.float32)
        A[: grayA.shape[0], : grayA.shape[1]] = grayA
        B[: grayB.shape[0], : grayB.shape[1]] = grayB
        out = ncc_flow(torch.as_tensor(A, device=self.device), torch.as_tensor(B, device=self.device),
                       c["stride"], c["patch"], c["levels"])
        grid, flow, cert = (t.cpu().numpy() for t in out)
        tgt = grid + flow
        ok = (
            (cert > c["certainty_threshold"])
            & (grid[:, 0] < grayA.shape[1])
            & (grid[:, 1] < grayA.shape[0])
            & (tgt[:, 0] >= 0)
            & (tgt[:, 0] < grayB.shape[1])
            & (tgt[:, 1] >= 0)
            & (tgt[:, 1] < grayB.shape[0])
        )
        idx = np.where(ok)[0]
        if len(idx) > c["max_matches"]:
            idx = idx[np.argsort(cert[idx])[::-1][: c["max_matches"]]]
        return {
            "keypoints0": grid[idx],
            "keypoints1": tgt[idx],
            "certainty": cert[idx],
        }
