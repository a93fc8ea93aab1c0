"""Image-pair generation: exhaustive, sequential, retrieval top-k (port of
mpsfm_tpu/extraction/pairs.py).

Ports the reference's pair generators (mpsfm/extraction/pairs/*):
exhaustive all-pairs, sequential +/-overlap with quadratic loop-closure
skips, and retrieval top-k by global-descriptor dot product — the
similarity matrix and its top-k are one device call each.
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device


def pairs_exhaustive(names: list[str]) -> list[tuple[str, str]]:
    return [(names[i], names[j]) for i in range(len(names)) for j in range(i + 1, len(names))]


def pairs_sequential(names: list[str], overlap: int = 10, quadratic: bool = True):
    """reference pairs/base.py:7-37: +/-overlap neighbors plus quadratic
    2^k skips for loop closure."""
    pairs = set()
    n = len(names)
    for i in range(n):
        for d in range(1, overlap + 1):
            if i + d < n:
                pairs.add((i, i + d))
        if quadratic:
            d = 2
            while i + overlap * d < n:
                pairs.add((i, i + overlap * d))
                d *= 2
    return [(names[i], names[j]) for i, j in sorted(pairs)]


def pairs_from_retrieval(names: list[str], global_descs: np.ndarray, num_matched: int = 20, device="cuda"):
    """Top-k by normalized descriptor similarity, self and duplicate pairs
    removed (reference pairs_from_retrieval.py:47-114; nquery=20 default,
    extraction/base.py:45). The similarity and its top-k run on `device`;
    the top-k is a stable descending sort, so ties keep the lower index
    first on every device."""
    d = np.asarray(global_descs, np.float32)
    d = d / np.clip(np.linalg.norm(d, axis=1, keepdims=True), 1e-12, None)
    dt = torch.as_tensor(d, device=resolve_device(device))
    sim = dt @ dt.T
    sim.fill_diagonal_(-float("inf"))
    k = min(num_matched, len(names) - 1)
    top = torch.sort(sim, dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
    pairs = set()
    for i in range(len(names)):
        for j in top[i]:
            a, b = (i, int(j)) if i < j else (int(j), i)
            pairs.add((a, b))
    return [(names[a], names[b]) for a, b in sorted(pairs)]
