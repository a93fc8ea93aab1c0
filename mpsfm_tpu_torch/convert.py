"""State of the JAX package, given as numpy arrays, turned into the port's.

The port runs no learned weights; what carries over is the state the JAX
package hands between its device programs, its cameras and poses, and the
depth-consistency check's grids and per-pair rows. Each converter
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
from mpsfm_tpu_torch.geometry.projection import Camera
from mpsfm_tpu_torch.geometry.rotations import Rigid3d
from mpsfm_tpu_torch.integration.bini import BiniInputs, BiniParams
from mpsfm_tpu_torch.mapper.depth_consistency import pair_rows


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


def camera(fields: dict, device="cuda") -> Camera:
    """mpsfm_tpu.geometry.projection.Camera fields (fx, fy, cx, cy as arrays,
    width and height as ints) -> Camera of float32 tensors."""
    dev = resolve_device(device)
    return Camera(*(_f32(fields[f], dev) for f in ("fx", "fy", "cx", "cy")),
                  int(fields.get("width", 0)), int(fields.get("height", 0)))


def rigid(quat, t, device="cuda") -> Rigid3d:
    """A pose (quat (..., 4) wxyz, t (..., 3)) -> Rigid3d of float32 tensors."""
    dev = resolve_device(device)
    return Rigid3d(_f32(quat, dev), _f32(t, dev))


def dc_inputs(query, refs, device="cuda"):
    """The arguments of depth_consistency._bundle_counts (all but c and the
    threshold) for a query image against refs of one grid shape, as the JAX
    checker's check_bundle_depth_consistency builds them: each image is
    (depth (H, W), variance (H, W) already divided by prior_std_multiplier²,
    K (3, 3) at grid scale, quat, t) with a cam_from_world pose, and every
    factor is 1. Returns (d_q, var_q, K_q, fac_q (2,), d_r (B, H, W), var_r,
    K_r (B, 3, 3), rows (B, 32)) on `device`."""
    dev = resolve_device(device)
    rows = pair_rows(query[3:], [r[3:] for r in refs])
    return (*(_f32(a, dev) for a in query[:3]), _f32(np.ones(2), dev),
            *(_f32(np.stack([r[i] for r in refs]), dev) for i in range(3)), _f32(rows, dev))
