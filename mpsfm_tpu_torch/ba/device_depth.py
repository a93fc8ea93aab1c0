"""Depth-observation rows of the BA built on the device from refined
log-depth maps (port of mpsfm_tpu/ba/device_depth.py).

  sample_logd:       bilinear depth sample at keypoints (linear-space
                     interpolation, border clamp, pixel centres at +0.5);
  build_depth_grids: scale filter, magnitudes d²/σ², robust scales m·σ/d,
                     the optional MAD truncation multiplier, and the
                     scatter into the dense (C,P) grids of DenseBAData.
"""

from __future__ import annotations

import torch

from mpsfm_tpu_torch.ba.solver import _rotmat_cols
from mpsfm_tpu_torch.geometry.rotations import quat_normalize


def sample_logd(zlog, shift, gx, gy):
    """log of the bilinear sample of exp(zlog + shift) (zlog (H,W)) at grid
    coordinates (gx, gy) of any matching shape."""
    d = torch.exp(zlog + shift)
    H, W = d.shape
    x = gx - 0.5
    y = gy - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(d.dtype)
    fy = (y - y0).to(d.dtype)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x0c = x0i.clamp(0, W - 1)
    x1c = (x0i + 1).clamp(0, W - 1)
    y0c = y0i.clamp(0, H - 1)
    y1c = (y0i + 1).clamp(0, H - 1)
    v = (
        d[y0c, x0c] * (1 - fx) * (1 - fy)
        + d[y0c, x1c] * fx * (1 - fy)
        + d[y1c, x0c] * (1 - fx) * fy
        + d[y1c, x1c] * fx * fy
    )
    return torch.log(v.clamp_min(1e-8))


def _nanmedian(x):
    """Median over the non-NaN entries, the two middle values averaged for
    an even count (jnp.nanmedian); torch.nanmedian would return the lower."""
    return torch.nanquantile(x.reshape(-1), 0.5, interpolation="midpoint")


def build_depth_grids(
    logd,      # (Cr,Sd) sampled log depths (stacked sample_logd rows)
    sigma2,    # (Cr,Sd) per-keypoint depth variances
    ptidx,     # (Cr,Sd) integer local point index; >= P marks padding (dropped)
    cam_rows,  # (Cr,) integer camera (local) index of each row block
    quat, t, xyz,  # initial BA state (for the projected z)
    m_base,    # scalar: param_multiplier * rob_std [* trunc when not computed here]
    sff,       # scale_filter_factor
    min_trunc,  # floor for the computed truncation multiplier (-inf: none)
    C: int,
    P: int,
    scale_filter: bool,
    compute_trunc: bool,
):
    """Returns (d_logt, d_w, d_scale) dense (C,P) grids + the truncation
    multiplier applied (1.0 when compute_trunc is False).

    mask = padding & scale filter, d_w = d²/σ², d_scale = m·σ/d; the
    truncation multiplier is the MAD fit over the unfiltered whitened log
    residuals. Two rows that land on one (camera, point) cell leave one of
    them, unspecified which (as in the JAX package)."""
    ptidx = ptidx.to(torch.int64)
    cam_rows = cam_rows.to(torch.int64)
    R = _rotmat_cols(quat_normalize(quat))
    Xg = xyz[ptidx.clamp(0, xyz.shape[0] - 1)]  # (Cr,Sd,3); padding masked below
    z = (
        R[6][cam_rows][:, None] * Xg[..., 0]
        + R[7][cam_rows][:, None] * Xg[..., 1]
        + R[8][cam_rows][:, None] * Xg[..., 2]
        + t[cam_rows, 2][:, None]
    )
    depths = torch.exp(logd)
    mask0 = ptidx < P
    mask = mask0
    if scale_filter:
        div = depths / z.clamp_min(1e-6)
        mask = mask & (div < sff) & (div > 1.0 / sff)
    trunc = torch.ones((), dtype=logd.dtype, device=logd.device)
    if compute_trunc:
        log_stds = (torch.sqrt(sigma2) / depths).clamp_min(1e-6)
        whit = (logd - torch.log(z.clamp_min(1e-8))) / log_stds
        wv = torch.where(mask0, whit, torch.full_like(whit, float("nan")))
        mu = _nanmedian(wv)
        trunc = 1.4826 * _nanmedian((wv - mu).abs())
        floor = torch.as_tensor(min_trunc, dtype=trunc.dtype, device=trunc.device)
        trunc = torch.where(torch.isnan(trunc), torch.ones_like(trunc), torch.maximum(trunc, floor))
    m = m_base * trunc
    w = torch.where(mask, depths * depths / sigma2.clamp_min(1e-6), torch.zeros_like(depths))
    sc = torch.where(mask, m * torch.sqrt(sigma2) / depths, torch.ones_like(depths))
    # masked rows go to a spare cell past the grid, dropped with it
    flat = torch.where(mask, cam_rows[:, None] * P + ptidx, torch.full_like(ptidx, C * P)).reshape(-1)

    def grid(fill, vals):
        g = torch.full((C * P + 1,), fill, dtype=logd.dtype, device=logd.device)
        g[flat] = vals.reshape(-1)
        return g[: C * P].reshape(C, P)

    return grid(0.0, logd), grid(0.0, w), grid(1.0, sc), trunc
