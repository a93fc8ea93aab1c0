"""State of the JAX package, given as numpy arrays, turned into the port's.

The refinement step has no learned weights; what carries over is the
state the JAX package hands between its device programs. Each converter
takes host arrays, e.g. `{k: np.asarray(v) for k, v in nt._asdict().items()}`
of a JAX NamedTuple, and returns tensors on `device` (the card unless the
caller asks for the CPU; no GPU raises, see `resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba.dense import DenseBAData
from mpsfm_tpu_torch.ba.solver import BAData
from mpsfm_tpu_torch.integration.bini import BiniInputs, BiniParams


def _f32(a, dev):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def dense_ba_data(arrays: dict, device="cuda") -> DenseBAData:
    """mpsfm_tpu.ba.dense.DenseBAData fields -> DenseBAData of float32 tensors."""
    dev = resolve_device(device)
    return DenseBAData(**{f: _f32(arrays[f], dev) for f in DenseBAData._fields})


def ba_data(arrays: dict, device="cuda") -> BAData:
    """mpsfm_tpu.ba.solver.BAData fields -> BAData: float fields float32,
    index fields (integer arrays) int64, absent optional tables None. The
    block-sparse Schur tables (`bs`) are not ported: a problem that carries
    them is refused."""
    if arrays.get("bs") is not None:
        raise ValueError("ba_data: the block-sparse Schur tables (bs) are not ported")
    dev = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int64), device=dev)
        return _f32(a, dev)

    return BAData(**{f: conv(arrays.get(f)) for f in BAData._fields})


def bini_inputs(arrays: dict, device="cuda") -> BiniInputs:
    """mpsfm_tpu.integration.bini.BiniInputs fields, (H,W) or (B,H,W) each
    -> BiniInputs of float32 tensors of the same shapes."""
    dev = resolve_device(device)
    return BiniInputs(**{f: _f32(arrays[f], dev) for f in BiniInputs._fields})


def bini_params(fields: dict) -> BiniParams:
    """mpsfm_tpu.integration.bini.BiniParams fields -> BiniParams (host scalars)."""
    return BiniParams(**{f: fields[f] for f in BiniParams._fields if f in fields})


def anchor_state(anch, prev, cov, pairs, device="cuda"):
    """Arguments of bini_gate_solve_batch_anchors: anchor rows anch (B,6,Ka),
    gate state prev (B,2), point covariances cov (Pc,3,3) and the cached
    (z0 (H,W), stat8 (8,H,W)) pair of each lane -> (anch, prev, cov, pairs)
    as float32 tensors."""
    dev = resolve_device(device)
    return (
        _f32(anch, dev),
        _f32(prev, dev),
        _f32(cov, dev),
        [(_f32(z0, dev), _f32(stat8, dev)) for z0, stat8 in pairs],
    )
