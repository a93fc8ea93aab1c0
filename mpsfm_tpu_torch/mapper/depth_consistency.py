"""Two-view depth consistency (DC): the device core of the check (port of
mpsfm_tpu/mapper/depth_consistency.py:25-177 and the bundle score of :454).

Each image's depth map is splatted into the other view with a min-depth
z-buffer, the difference to the other view's depth is whitened by the
lifted and rotated variances, each in-canvas pixel is classified
surface / occluded / invalid, and the bundle score is the largest
invalid / valid ratio over both directions. The JAX package's vmap over a
bundle's references is the leading dimension B here: one call computes
the four counts of every (query, ref) pair of one grid shape.

The z-buffer is a `scatter_reduce_(..., "amin")` on an inf-filled grid,
gathered back at each source pixel. The JAX package sorts instead
(`_min_at_src`, a TPU workaround); min is exact and order-free, so the
buffer value at a winning pixel and the `won` mask are the same.

Every grid is float32 and every step is one elementwise op, so the card
and the CPU give the same bits. XLA contracts a·b + c into one FMA on the
CPU; this port does not, so a pixel whose target lies within an ulp of a
pixel boundary, or whose |t| lies within an ulp of the threshold, can be
counted differently from the JAX package (tests/test_torch_depth_consistency.py).

The checker class with its relaxation ladder waits for the port of the
scene state. `pair_rows` builds the per-pair rows on the host, as the JAX
checker's `check_bundle_depth_consistency` does (:419-431).
"""

from __future__ import annotations

import numpy as np
import torch

SIGMA_Q = 1.0  # px, keypoint noise of the lifted covariance (reference default)


def _pixel_grid(H, W, like):
    """Pixel coordinates (xx, yy), each (H, W), of like's dtype and device."""
    x = torch.arange(W, dtype=like.dtype, device=like.device)
    y = torch.arange(H, dtype=like.dtype, device=like.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return xx, yy


def _k(K, i, j):
    """Entry (i, j) of K (..., 3, 3), shaped to broadcast over (..., H, W)."""
    return K[..., i, j, None, None]


def reproject_depth(depth1, K1, K2, M12, out_hw):
    """Project depth map 1 (..., H, W) into view 2 (port of
    reproject_depth_jax and _reproject_core). M12 (..., 3, 4) =
    cam2_from_world @ world_from_cam1. Returns (p2D12 (..., H, W, 2),
    depth12, in-canvas mask)."""
    H, W = depth1.shape[-2:]
    xx, yy = _pixel_grid(H, W, depth1)
    d = torch.where(depth1 <= 0, 0.1, depth1)
    xn = (xx - _k(K1, 0, 2)) / _k(K1, 0, 0)
    yn = (yy - _k(K1, 1, 2)) / _k(K1, 1, 1)
    pc1 = (xn * d, yn * d, d)

    def row(i):
        m = M12[..., i, :, None, None]
        return m[..., 0, :, :] * pc1[0] + m[..., 1, :, :] * pc1[1] + m[..., 2, :, :] * pc1[2] + m[..., 3, :, :]

    x2, y2, z2 = row(0), row(1), row(2)
    zs = torch.where(z2.abs() < 1e-9, 1e-9, z2)
    u2 = x2 / zs * _k(K2, 0, 0) + _k(K2, 0, 2)
    v2 = y2 / zs * _k(K2, 1, 1) + _k(K2, 1, 2)
    H2, W2 = out_hw
    mask = (u2 >= 0) & ((u2 + 0.5) < W2) & (v2 >= 0) & ((v2 + 0.5) < H2) & (z2 > 0)
    return torch.stack([u2, v2], -1), z2, mask


def _target_index(p2D, mask, out_hw):
    """Flat index (..., H·W) of the target pixel of each source pixel:
    truncation toward zero, clipped to the canvas. A pixel outside the
    mask (far outside the canvas, or NaN) takes pixel 0 before the float ->
    int conversion, whose result is undefined there; the mask keeps it out
    of every count, as in the JAX package, where it is clipped instead."""
    H2, W2 = out_hw
    u = torch.where(mask, p2D[..., 0], 0.0).to(torch.int64).clamp_(0, W2 - 1)
    v = torch.where(mask, p2D[..., 1], 0.0).to(torch.int64).clamp_(0, H2 - 1)
    return (v * W2 + u).flatten(-2)


def _zbuffer(flat, depth_proj, mask, out_hw):
    """(buffer (..., H2·W2), buffer value at each source pixel's target,
    won mask (..., H, W)) of the min-depth z-buffer."""
    H2, W2 = out_hw
    d = torch.where(mask, depth_proj, torch.inf).flatten(-2)
    buf = torch.full((*d.shape[:-1], H2 * W2), torch.inf, dtype=d.dtype, device=d.device)
    buf.scatter_reduce_(-1, flat, d, "amin", include_self=True)
    at = buf.gather(-1, flat)
    won = (d == at).view_as(mask) & mask
    return buf, at.view_as(mask), won


def min_buffer(p2D, depth_proj, mask, out_hw):
    """Scatter-min z-buffer (port of min_buffer_jax): (min depth buffer
    (..., H2, W2), per-source 'won the buffer' mask)."""
    buf, _, won = _zbuffer(_target_index(p2D, mask, out_hw), depth_proj, mask, out_hw)
    return buf.view(*buf.shape[:-1], *out_hw), won


def _dir_maps(d_s, var_s, K_s, d_d, var_d, K_d, M_sd, r2, c, thresh):
    """One direction of the whitened test, per pixel, for B pairs at once:
    every argument has a leading dimension B (source grids (B, H, W),
    destination grids (B, H2, W2), K (B, 3, 3), M_sd (B, 3, 4), r2 (B, 3)).
    Returns (p2D, t, in-canvas, valid, occluded), the last four (B, H, W)."""
    B, H, W = d_s.shape
    out_hw = tuple(d_d.shape[-2:])
    p, z, m = reproject_depth(d_s, K_s, K_d, M_sd, out_hw)
    flat = _target_index(p, m, out_hw)
    _, segmin, won = _zbuffer(flat, z, m, out_hw)
    xx, yy = _pixel_grid(H, W, d_s)
    fx, fy, cx, cy = _k(K_s, 0, 0), _k(K_s, 1, 1), _k(K_s, 0, 2), _k(K_s, 1, 2)
    r0, r1, r2z = (r2[:, i, None, None] for i in range(3))
    dpdd = r0 * (xx - cx) / fx + r1 * (yy - cy) / fy + r2z
    zbar_var = var_s * dpdd**2 + SIGMA_Q**2 * ((r0 * d_s / fx) ** 2 + (r1 * d_s / fy) ** 2)
    dd_at = d_d.flatten(-2).gather(-1, flat).view(B, H, W)
    var_d_at = var_d.flatten(-2).gather(-1, flat).view(B, H, W)
    t = (segmin - dd_at) / torch.sqrt(c * c * (zbar_var + var_d_at) + 1e-12)
    t = torch.where(won, t, 0.0)  # a pixel that lost the buffer counts as surface (reference)
    surface = (t.abs() < thresh) & m
    occl = (t > thresh) & m
    return p, t, m, surface | occl, occl


def _dir_counts(d_s, var_s, K_s, d_d, var_d, K_d, M_sd, r2, c, thresh):
    """(#not-valid, #not-occluded) over the in-canvas source pixels of each
    of B pairs: two (B,) integer tensors."""
    _, _, m, valid, occl = _dir_maps(d_s, var_s, K_s, d_d, var_d, K_d, M_sd, r2, c, thresh)
    return (m & ~valid).sum((-2, -1)), (m & ~occl).sum((-2, -1))


def _pair_args(d_q, var_q, Kq, fac_q, d_r, var_r, Kr, rows):
    """The query's and the refs' grids rescaled by their factors, the query's
    expanded to the B refs, and the per-pair matrices unpacked from rows (B, 32)
    = [fac_r (2), M_qr (12), M_rq (12), r2_qr (3), r2_rq (3)]."""
    B = rows.shape[0]
    q = tuple(a.expand(B, *a.shape) for a in (d_q * fac_q[0], var_q * fac_q[1], Kq))
    r = (d_r * rows[:, 0, None, None], var_r * rows[:, 1, None, None], Kr)
    return q, r, rows[:, 2:14].reshape(B, 3, 4), rows[:, 14:26].reshape(B, 3, 4), rows[:, 26:29], rows[:, 29:32]


def _pair_counts(d_q, var_q, Kq, fac_q, d_r, var_r, Kr, rows, c, thresh):
    """(qry_nv, qry_v, ref_nv, ref_v) of B (query, ref) pairs: (B, 4).

    The query's grids d_q, var_q (H, W), Kq (3, 3) and factors fac_q (2,)
    are shared; the refs' grids d_r, var_r (B, H2, W2), Kr (B, 3, 3) and
    rows (B, 32) have one entry per pair. The depth and variance grids come
    in as bases times scalar factors (fac_q, rows[:, 0:2]), the variances
    already divided by prior_std_multiplier²."""
    q, r, M_qr, M_rq, r2_qr, r2_rq = _pair_args(d_q, var_q, Kq, fac_q, d_r, var_r, Kr, rows)
    nv_q, v_q = _dir_counts(*q, *r, M_qr, r2_qr, c, thresh)
    nv_r, v_r = _dir_counts(*r, *q, M_rq, r2_rq, c, thresh)
    return torch.stack([nv_q, v_q, nv_r, v_r], -1)


# the JAX package's _bundle_counts is the vmap of _pair_counts over the refs;
# here the refs are _pair_counts' leading dimension already
_bundle_counts = _pair_counts


def bundle_score(counts):
    """Bundle score of a query from the (B, 4) counts of its pairs: the
    larger of the refs' and the query's invalid / valid ratio
    (mpsfm_tpu/mapper/depth_consistency.py:454). Reads the counts to the
    host."""
    qry_nv, qry_v, ref_nv, ref_v = counts.sum(0).tolist()
    return max(ref_nv / max(ref_v, 0.1), qry_nv / max(qry_v, 0.1))


# ---- host side: the per-pair rows (numpy, float64 as the JAX checker's poses) ----

def _quat_rotate_np(q, v):
    w, qv = q[0], q[1:]
    uv = np.cross(qv, v)
    return v + 2.0 * (w * uv + np.cross(qv, uv))


def _quat_to_matrix_np(q):
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def _pose_mats(q, t):
    """cam_from_world (q wxyz, t) -> its [R|t] (3, 4) and the 4×4 of its inverse."""
    q, t = np.asarray(q, np.float64), np.asarray(t, np.float64)
    qi = q * np.array([1.0, -1.0, -1.0, -1.0])
    inv = np.concatenate([_quat_to_matrix_np(qi), -_quat_rotate_np(qi, t)[:, None]], 1)
    return np.concatenate([_quat_to_matrix_np(q), t[:, None]], 1), np.vstack([inv, [0, 0, 0, 1]])


def pair_rows(pose_q, poses_r):
    """The (B, 32) float32 rows of a query against B refs, as the JAX
    checker builds them: [d_fac, var_fac, M_qr, M_rq, r2_qr, r2_rq], with
    the refs' factors 1. Poses are cam_from_world (quat wxyz (4,), t (3,))."""
    P_q, Pinv_q = _pose_mats(*pose_q)
    rows = []
    for pose_r in poses_r:
        P_r, Pinv_r = _pose_mats(*pose_r)
        R_rq = P_r[:, :3] @ P_q[:, :3].T  # R_ref R_queryᵀ
        rows.append(np.concatenate([(1.0, 1.0), (P_r @ Pinv_q).reshape(-1), (P_q @ Pinv_r).reshape(-1),
                                    R_rq[2], R_rq[:, 2]]))
    return np.asarray(rows, np.float32).reshape(len(rows), 32)
