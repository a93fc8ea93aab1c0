"""Mutual nearest-neighbor descriptor matching (port of
mpsfm_tpu/extraction/matchers/nn.py).

Replaces the reference's NearestNeighbor matcher
(mpsfm/extraction/pairwise/models/nearest_neighbor.py): cosine similarity,
mutual check, optional ratio and distance thresholds. One similarity
product a pair on the caller's device, float32 with TF32 off (the JAX
package's HIGHEST precision). The JAX package pads each side to a power
of two for its compiled shapes; the padding is masked out there, so the
port matches the unpadded arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device


def match(d0, d1, ratio_thresh: float, dist_thresh: float):
    """(N0, D), (N1, D) unit descriptors -> (matches0 (N0,) index into d1
    or -1, scores0 (N0,))."""
    n0 = d0.shape[0]
    sim = d0 @ d1.T
    best1 = torch.argmax(sim, dim=1)
    s_best = sim.gather(1, best1[:, None])[:, 0]
    # second best for ratio test (on distance^2 = 2-2sim for unit vectors)
    rows = torch.arange(n0, device=sim.device)
    sim2 = sim.clone()
    sim2[rows, best1] = -2.0
    # one column: the JAX package's padded columns (-2) are the second best
    s_second = sim2.max(dim=1).values if d1.shape[0] > 1 else torch.full_like(s_best, -2.0)
    best0 = torch.argmax(sim, dim=0)
    mutual = best0[best1] == rows
    d_best = torch.sqrt(torch.clamp(2 - 2 * s_best, min=0))
    d_second = torch.sqrt(torch.clamp(2 - 2 * s_second, min=0))
    ok = mutual
    if ratio_thresh > 0:
        ok = ok & (d_best <= ratio_thresh * d_second)
    if dist_thresh > 0:
        ok = ok & (d_best <= dist_thresh)
    matches0 = torch.where(ok, best1, -1)
    scores0 = torch.where(ok, (s_best + 1) / 2, 0.0)
    return matches0, scores0


class MutualNNMatcher:
    default_conf = {"ratio_threshold": 0.95, "distance_threshold": 0.0}

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)

    def __call__(self, desc0: np.ndarray, desc1: np.ndarray):
        n0, n1 = len(desc0), len(desc1)
        if n0 == 0 or n1 == 0:
            return {"matches0": np.full(n0, -1, np.int64), "matching_scores0": np.zeros(n0, np.float32)}
        d0 = torch.as_tensor(np.asarray(desc0, np.float32), device=self.device)
        d1 = torch.as_tensor(np.asarray(desc1, np.float32), device=self.device)
        m0, s0 = match(d0, d1, float(self.conf["ratio_threshold"]), float(self.conf["distance_threshold"]))
        return {"matches0": m0.cpu().numpy(), "matching_scores0": s0.cpu().numpy()}
