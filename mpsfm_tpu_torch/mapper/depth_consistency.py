"""Two-view depth consistency (DC): the device core of the check and the
checker with its relaxation ladder (port of
mpsfm_tpu/mapper/depth_consistency.py).

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

`pair_rows` builds the per-pair rows on the host, as the JAX checker's
`check_bundle_depth_consistency` does (:419-431). `DepthConsistencyChecker`
keeps the depth, variance and K grids of each image on its device, keyed
as the JAX checker keys them, and runs one `_bundle_counts` call per grid
shape of a bundle's refs; the counts of all groups make one score.
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.scene.reconstruction import Reconstruction

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
    """Bundle score of a query from the counts of its pairs: the larger of
    the refs' and the query's invalid / valid ratio, over the counts of all
    its pairs (mpsfm_tpu/mapper/depth_consistency.py:441-454). counts is
    one (B, 4) tensor or a sequence of them, one per grid-shape group,
    joined on the device before the one read to the host."""
    if isinstance(counts, (list, tuple)):
        counts = torch.cat(list(counts))
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


def exp_shift_dev(zlog, shift):
    """Linear depth grid from a device log-depth handle (the DC cache):
    exp(zlog + shift), shift rounded to float32 as the JAX package passes it."""
    return torch.exp(zlog + float(np.float32(shift)))


class DepthConsistencyChecker(BaseClass):
    """The reference's DepthConsistencyChecker (mpsfm/sfm/mapper/
    depthconsistency.py) with its ladder: thresholds relaxed ×1.3 a step,
    reset on a registration, pre_fail and the AP-inlier blacklist. The
    grids live on `device` (the card unless the caller asks for the CPU)."""

    default_conf = {
        "depth_cons_valid_thresh": 0.6,
        "depth_cons_thresh": 0.15,
        "init_depth_cons_thresh": 0.09,
        "init_valid_thresh": 0.8,
        "depth_consistency_resample": False,
        "c": 15.0,
        "verbose": 0,
    }

    def _init(self, rec: Reconstruction, device="cuda"):
        self.rec = rec
        self.device = resolve_device(device)
        self.depth_cons_thresh = self.conf.depth_cons_thresh
        self.reg_batch_dc_times_failed = 0
        self.cons_thresh_times_increased = 0
        self.skip_dc_check = False
        # per-image device caches of (depth, variance, K) grids; pure
        # multiplicative rescales only change the scalar factors
        self._dev_cache: dict = {}

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # --- ladder state (reference :27-49) ---
    def at_registration_success(self):
        self.cons_thresh_times_increased = 0
        self.depth_cons_thresh = self.conf.depth_cons_thresh
        self.reg_batch_dc_times_failed = 0
        for im in self.rec.images.values():
            im.ignore_matches_AP = {}
            im.failed_dc_check = False
        self.skip_dc_check = False

    def relax_thresholds(self):
        self.depth_cons_thresh *= 1.3
        self.cons_thresh_times_increased += 1
        self.reg_batch_dc_times_failed = 0
        for im in self.rec.images.values():
            im.ignore_matches_AP = {}
            im.failed_dc_check = False

    # --- core check ---
    def _image_depth(self, imid):
        d = self.rec.images[imid].depth
        return d.data if (d.activated and d.data is not None) else d.data_prior

    def _K_grid(self, imid):
        cam = self.rec.camera(imid)
        K = cam.calibration_matrix().copy()
        K[0] *= cam.sx
        K[1] *= cam.sy
        return K

    def check_depth_consistency(self, imid1, imid2, score_thresh=None):
        """Per-pixel classification of one pair in both directions
        (reference :62-159): the reprojection and z-buffer on the device,
        the whitening and classification on the host in float64."""
        rec = self.rec
        if score_thresh is None:
            score_thresh = self.conf.depth_cons_valid_thresh
        c = self.conf.c

        d1 = np.asarray(self._image_depth(imid1), np.float32)
        d2 = np.asarray(self._image_depth(imid2), np.float32)
        K1, K2 = self._dev(self._K_grid(imid1)), self._dev(self._K_grid(imid2))
        pose1 = rec.images[imid1].pose
        pose2 = rec.images[imid2].pose
        M12 = pose2.matrix() @ np.vstack([pose1.inverse().matrix(), [0, 0, 0, 1]])
        M21 = pose1.matrix() @ np.vstack([pose2.inverse().matrix(), [0, 0, 0, 1]])

        p12, z12, m12 = reproject_depth(self._dev(d1), K1, K2, self._dev(M12), d2.shape)
        p21, z21, m21 = reproject_depth(self._dev(d2), K2, K1, self._dev(M21), d1.shape)
        buf12, won12 = min_buffer(p12, z12, m12, d2.shape)
        buf21, won21 = min_buffer(p21, z21, m21, d1.shape)
        p12, p21, m12, m21, buf12, buf21, won12, won21 = (
            a.cpu().numpy() for a in (p12, p21, m12, m21, buf12, buf21, won12, won21)
        )

        # whitened test statistic t = (buffer - target depth)/sqrt(c²(σ̄²+σ²))
        def whiten(src_id, dst_id, won_src, d_src, p_src, buf_src, d_dst):
            var_s = np.asarray(rec.images[src_id].depth.uncertainty, np.float64).copy()
            var_s /= rec.images[src_id].depth.conf.prior_std_multiplier**2
            var_d = np.asarray(rec.images[dst_id].depth.uncertainty, np.float64).copy()
            var_d /= rec.images[dst_id].depth.conf.prior_std_multiplier**2
            ys, xs = np.where(won_src)
            # exact z-variance of the lifted source pixel in the dst frame
            # (reference points3D_utils.py:31-60): r₂ᵀ Σ r₂ with r₂ the third
            # row of R_dst R_srcᵀ, closed form below
            R12 = (
                rec.images[dst_id].pose.rotation_matrix()
                @ rec.images[src_id].pose.rotation_matrix().T
            )
            r2 = R12[2]
            cam = rec.camera(src_id)
            fx = cam.fx * cam.sx
            fy = cam.fy * cam.sy
            cx = cam.cx * cam.sx
            cy = cam.cy * cam.sy
            dd = d_src[ys, xs]
            dpdd = r2[0] * (xs - cx) / fx + r2[1] * (ys - cy) / fy + r2[2]
            zbar_var = var_s[ys, xs] * dpdd**2 + SIGMA_Q**2 * (
                (r2[0] * dd / fx) ** 2 + (r2[1] * dd / fy) ** 2
            )
            u = np.clip(p_src[ys, xs, 0].astype(int), 0, d_dst.shape[1] - 1)
            v = np.clip(p_src[ys, xs, 1].astype(int), 0, d_dst.shape[0] - 1)
            t = buf_src[v, u] - d_dst[v, u]
            t = t / np.sqrt((np.sqrt(zbar_var) * c) ** 2 + (np.sqrt(var_d[v, u]) * c) ** 2 + 1e-12)
            full_t = np.zeros(won_src.shape)
            full_t[ys, xs] = t
            return full_t

        t1 = whiten(imid1, imid2, won12, d1, p12, buf12, d2)
        t2 = whiten(imid2, imid1, won21, d2, p21, buf21, d1)

        def classify(t, canv):
            surface = (np.abs(t) < score_thresh) & canv
            occl = (t > score_thresh) & canv
            invalid = (t < -score_thresh) & canv
            return surface, occl, invalid

        s1, o1, i1 = classify(t1, m12)
        s2, o2, i2 = classify(t2, m21)
        return {
            "valid1": s1 | o1,
            "valid2": s2 | o2,
            "occl1": o1,
            "occl2": o2,
            "invalid1": i1,
            "invalid2": i2,
            "valid1_mask": m12,
            "valid2_mask": m21,
        }

    def _dc_dev(self, imid, z_overrides=None):
        """((d_dev, d_fac), (var_dev, var_fac), K_dev): device-cached grids
        and the scalar factors accumulated since their upload (pure rescales
        are multiplicative in both depth and variance). z_overrides {imid:
        (log-depth tensor, shift)} supplies a not yet finalized integration
        output (the fused post-registration chain checks consistency before
        the z reaches the host)."""
        d = self.rec.images[imid].depth
        c = self._dev_cache.setdefault(imid, {})
        s = float(d.scale)
        if z_overrides and imid in z_overrides:
            zdev2, zsh = z_overrides[imid]
            vent = self._dc_var_ent(c, d, s)
            return (exp_shift_dev(zdev2, zsh), 1.0), (vent[2], (s / vent[1]) ** 2), self._dc_K(imid, c)
        if d.activated and (d._data is not None or d.data_log_dev() is not None):
            dkey = ("d", d.data_epoch)
            ent = c.get("d")
            if ent is None or ent[0] != dkey:
                handle = d.data_log_dev()
                if handle is not None:
                    # device-resident working map: exp on the device, no
                    # host copy or upload
                    zdev, shift = handle
                    ent = (dkey, float(d.data_log_shift), exp_shift_dev(zdev, shift))
                else:
                    ent = (dkey, float(d.data_log_shift), self._dev(d.data))
                c["d"] = ent
            d_fac = float(np.exp(d.data_log_shift - ent[1]))
        else:
            dkey = ("p", d.version)
            ent = c.get("d")
            if ent is None or ent[0] != dkey:
                ent = (dkey, s, self._dev(d.data_prior))
                c["d"] = ent
            d_fac = s / ent[1]
        vent = self._dc_var_ent(c, d, s)
        return (ent[2], d_fac), (vent[2], (s / vent[1]) ** 2), self._dc_K(imid, c)

    def _dc_var_ent(self, c, d, s):
        vkey = ("v", d.version)
        vent = c.get("v")
        if vent is None or vent[0] != vkey:
            var = np.asarray(d.uncertainty, np.float32) / np.float32(d.conf.prior_std_multiplier**2)
            vent = (vkey, s, self._dev(var))
            c["v"] = vent
        return vent

    def _dc_K(self, imid, c):
        K = c.get("K")
        if K is None:
            K = self._dev(self._K_grid(imid))
            c["K"] = K
        return K

    def check_bundle_depth_consistency(self, imid, bundle, score_thresh=None, z_overrides=None):
        """Bundle score = max over {query, refs} of the invalid / valid pixel
        ratio (reference :213-246): the (query, ref) pairs of one grid shape
        in one `_bundle_counts` call, the counts of every group joined on
        the device and read once."""
        optim_ids = [i for i in bundle["optim_ids"] if i != imid]
        if score_thresh is None:
            score_thresh = self.conf.depth_cons_valid_thresh
        rec = self.rec
        (d_q, dq_fac), (var_q, vq_fac), K_q = self._dc_dev(imid, z_overrides)
        pose_q = rec.images[imid].pose
        Rq = pose_q.rotation_matrix()
        Mq44 = np.vstack([pose_q.inverse().matrix(), [0, 0, 0, 1]])

        groups: dict[tuple, list] = {}
        for ref in optim_ids:
            (d_r, dr_fac), (var_r, vr_fac), K_r = self._dc_dev(ref, z_overrides)
            pose_r = rec.images[ref].pose
            M_qr = pose_r.matrix() @ Mq44
            M_rq = pose_q.matrix() @ np.vstack([pose_r.inverse().matrix(), [0, 0, 0, 1]])
            R_rq = pose_r.rotation_matrix() @ Rq.T  # R_ref R_queryᵀ
            row = np.concatenate(
                [[dr_fac, vr_fac], M_qr.reshape(-1), M_rq.reshape(-1), R_rq[2], R_rq[:, 2]]
            ).astype(np.float32)
            groups.setdefault(tuple(d_r.shape), []).append((d_r, var_r, K_r, row))
        if not groups:
            return 0.0
        fac_q = self._dev(np.array([dq_fac, vq_fac], np.float32))
        counts = [
            _bundle_counts(
                d_q, var_q, K_q, fac_q,
                torch.stack([it[0] for it in items]), torch.stack([it[1] for it in items]),
                torch.stack([it[2] for it in items]), self._dev(np.stack([it[3] for it in items])),
                float(np.float32(self.conf.c)), float(np.float32(score_thresh)),
            )
            for items in groups.values()
        ]
        return bundle_score(counts)

    def check_image(self, imid, bundle, z_overrides=None):
        score = self.check_bundle_depth_consistency(imid, bundle, z_overrides=z_overrides)
        self.rec.images[imid].last_dc_score = score
        if score > self.depth_cons_thresh:
            self.log(f"Depth consistency failed for {imid}: {score:.3f}")
            self.at_failure(imid)
            return False
        self.log(f"Depth consistency passed for {imid}: {score:.3f}", level=2)
        return True

    def check_init_pair(self, init_pair):
        ref = list(init_pair)[0]
        score = self.check_bundle_depth_consistency(
            ref, {"optim_ids": set(init_pair)}, score_thresh=self.conf.init_valid_thresh
        )
        return score <= self.conf.init_depth_cons_thresh

    def pre_fail(self, imid):
        """Fail a candidate before registration from its previous DC score
        (the documented skip logic of reference depthconsistency.py:169-192,
        whose upstream body is unfinished)."""
        im = self.rec.images[imid]
        if im.last_dc_score is None:
            return False
        if self.conf.depth_consistency_resample and im.dc_times_inliers_resampled == 0:
            return False  # resampling not yet tried: give it a chance
        if self.skip_dc_check:
            return False
        if im.last_dc_score > self.depth_cons_thresh:
            self.log(f"Depth consistency pre-failed for {imid}: {im.last_dc_score:.3f}", level=1)
            self.reg_batch_dc_times_failed += 1
            return True
        return False

    def at_failure(self, imid):
        im = self.rec.images[imid]
        im.failed_dc_check = True
        if self.conf.depth_consistency_resample:
            im.dc_times_inliers_resampled += 1
            for ref_id, inlier_mask in self.rec.last_ap_inlier_masks.items():
                if len(inlier_mask) > 0:
                    if ref_id in im.ignore_matches_AP:
                        used = ~im.ignore_matches_AP[ref_id]
                        im.ignore_matches_AP[ref_id][used] |= inlier_mask
                    else:
                        im.ignore_matches_AP[ref_id] = inlier_mask.copy()
        self.reg_batch_dc_times_failed += 1
