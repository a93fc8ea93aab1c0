"""Batched inference sharded over the ranks of a process group (port of
mpsfm_tpu/parallel/sharded_inference.py).

Images are bucketed by shape and stacked into one padded batch a bucket,
as in the JAX package; where the JAX package lays the batch axis over a
device mesh, here each rank runs its contiguous share of the padded
batch and all_gather puts every output on every rank (the
DataParallel of the reference's per-image forwards). With one rank it is
plain batching.
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.parallel import multihost


def _gather(x, group):
    """(ranks · len(x), ...): every rank's x in rank order (bool as uint8 on the wire)."""
    y = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = multihost.Collectives(group).gather(y).flatten(0, 1)
    return out.bool() if x.dtype == torch.bool else out


def run_sharded_batches(fn, items, prep, group=None, device="cuda"):
    """Run `fn(batch) -> tensor or tuple of tensors with a leading batch
    axis` over `items`.

    prep(item) -> np.ndarray (the per-item input; items with the same
    shape are grouped into one padded batch, zero rows up to a multiple
    of the group's ranks). Each rank runs fn on its share of a bucket, as
    a tensor on `device` (the card unless the caller asks for the CPU);
    the outputs are all-gathered. Returns a list of
    per-item outputs (numpy, or tuples of numpy) in the original order."""
    dev = resolve_device(device)
    n = multihost.world_size(group)
    me = multihost.rank(group)
    arrays = [np.asarray(prep(it)) for it in items]
    buckets: dict[tuple, list[int]] = {}
    for i, a in enumerate(arrays):
        buckets.setdefault(a.shape, []).append(i)

    results: list = [None] * len(items)
    for shape, idxs in buckets.items():
        B = len(idxs)
        Bp = ((B + n - 1) // n) * n
        batch = np.zeros((Bp, *shape), arrays[idxs[0]].dtype)
        for k, i in enumerate(idxs):
            batch[k] = arrays[i]
        share = Bp // n
        out = fn(torch.as_tensor(batch[me * share:(me + 1) * share], device=dev))
        single = torch.is_tensor(out)
        outs = [_gather(o, group).cpu().numpy() for o in ((out,) if single else out)]
        for k, i in enumerate(idxs):
            results[i] = outs[0][k] if single else tuple(o[k] for o in outs)
    return results
