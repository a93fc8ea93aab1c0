#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpsfm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the hand-written kernels from mpsfm_tpu_torch/csrc/*.cu with
   nvcc for sm_90a (one nvcc per source, all started together) into
   mpsfm_tpu_torch/_build/, and prints the build time and what ptxas
   reports of each kernel (registers, spills).
2. Holds each kernel against its plain torch version on the card:
   K1 (cholesky.cu) on random SPD matrices at K = 6, 390, 384 and 1024,
   strongly and less diagonally dominant, and on two with a zeroed row
   and column (a clamped pivot), timed beside its plain version and the
   library call at 384 and 1024; K1 with many right-hand sides
   (cholesky_many.cu) at K = 384, N = 24 576 (the covariances' solve),
   K = 390, N = 1000 (ragged blocks and column tile), K = 3072, N = 1000
   (the JAX package's largest dense covariance) and K = 33, N = 24 577
   (ragged, 4-byte staging), timed beside its plain version and the library
   call, with its three kernels (factorization, tile packing, substitution)
   timed apart; K2 (bini.cu) as the PCG core of
   the main path's first IRLS round (iteration counts within 1,
   bit-identical from run to run, and at B = 16 as two lane groups; a
   cooperative launch larger than the card refused) and as the
   fixed-budget solve, at B = 8 images of 290×387, timed per solve, per
   CG iteration and against the design's floor (its two lane barriers
   per iteration with almost no arithmetic), its checks shown to fail
   the plain version turned into a kernel with a stale or dropped halo
   at one CTA's seams; K3 (bini_diag.cu), the deflated PCG of diag(H⁻¹) on
   thread-block clusters, at 8 images of 145×193 with 2048 queries each
   and 16 iterations and at 2 images of 193×193, of 290×387 and of 400×600
   with 64 queries each (grids above one block's shared memory; 400×600
   keeps its bands in global memory), one launch each, bit-identical from
   run to run, the cluster shape (C CTAs, R right-hand sides) printed, the
   global mode equal bit for bit to the shared-memory mode at the main grid,
   timed beside its plain version at the main shapes and at 400×600, and
   its check shown to fail a kernel without the deflation's projection and
   one that drops p's halo row at a band edge.
3. Drives the main path at full size, once to warm up and once measured
   with every launch count set to 0 just before: the mapper's refinement
   step in the order of the JAX package's Mapper (calculate_point_covs,
   then Optimizer.ba_fused with the int_covs chain) — point covariances of
   the bench bundle (64 cameras × 8192 points), BiNI energy gate +
   IRLS/PCG solve of 8 depth maps (290×387, the main path's BiNI
   parameters; anchors priced by those covariances), the fresh depth
   downscaled to 145×193 and diag(H⁻¹) there at 2048 keypoints per image
   (16 deflated PCG iterations), the keypoints' depth variances updated
   from it, the depth-consistency check of each refined map (the query)
   against its 5 nearest lanes (the mapper's local bundle; depth exp(z),
   the prior variance grid ÷ 3.33², the bundle's poses), depth rows with
   those variances sampled from the refined maps, then 20 LM iterations
   of the dense LM-Schur BA. It checks finite, symmetric covariances with
   a positive diagonal whose depth variance grows with depth, finite
   positive variances that moved on the changed lanes, depth-consistency
   counts of every pair with valid pixels and equal to the CPU's on the
   same depth (or differing only at pixels within 1e-5 of a boundary, the
   scores within 0.02), a lower cost, ≥ 3 accepted steps, depth rows with
   weight, depth maps closer to the ground truth than their priors, and
   that every kernel entry point was launched.
4. Runs the same chain at a small size on the card and on the CPU (plain
   versions) and compares the results, with the depth std floored as on
   the main path and unfloored (where K3's variances reach the depth rows
   and must change sigma²); and compares the point covariances' scatter
   path (no per-(point, camera) tables) card vs CPU.
5. The depth-consistency check on a consistent scene at 290×387: one
   world plane rendered into 6 of the bundle's cameras scores below the
   mapper's threshold 0.15, and above it once one reference's depth is
   shifted by 1.5.
6. The estimators, with the mapper's budget of 512 hypotheses: two-view
   verification of the 66 pairs of 12 of the bundle's cameras (2048
   matches each) and PnP at 4096 matches on points in general position and
   on one plane (1 px noise, 30% outliers), timed after a warm-up, held
   against the truth and against the CPU with the same samples; the
   library solvers behind two-view verification (batched QR and eigh)
   timed apart.
7. The scene's host state (slice 5a): a Reconstruction of the bundle at
   the main path's refined poses and points (64 images of one 640×480
   camera, 8192 keypoints each, 8192 points each seen by every image:
   524 288 observations in the native track store, built with g++), its
   passes timed on the host clock (adding the points, the observation
   table, triangulation angles, filter_points3D at 4 px and 1.5 deg, the
   local bundle of one image, deregistering one image, deleting and
   re-adding 10% of the points, normalize) with the pool's invariants
   checked after each; the native store against the plain one
   (PyTrackStore) under one op sequence on 12 images; geometric
   verification of the 66 pairs of 12 images (2048 matches each, 30%
   outliers) through Correspondences.populate on the card, timed after a
   warm-up, held against the truth (every pair CALIBRATED, the median
   pair within 1 deg and 90% of the true inliers) and against populate on
   the CPU with the same samples, its correspondence graph to the inlier
   matches; and the point covariances' store (LazyCovDict) with the main
   path's covariances on the card.
8. The refinement step driven from the scene (slices 5b and the front of
   6a): a Reconstruction of the bundle (64 images, 8192 points each seen
   by every image) with ImagePriors on 8 images at 290×387 (a depth prior
   fitted to each image's points with a scale error and noise, the plane's
   normals; the main path's conf), run through the port's entry points in
   the order of the JAX package's Mapper.adjust_bundle with int_covs:
   Optimizer.calculate_point_covs (K1 many), a global step
   (integrate_bundle_deferred over the 8 lanes (K2), finalize_integration,
   int_covs_bundle_batched on the changed lanes (K3, 8192 keypoints each),
   Optimizer.ba_fused with update_trunc (K1)), a local step of one image
   (integrate_bundle_deferred, int_covs_bundle_deferred, ba_fused with the
   chained variances), then optimize_prior_shiftscale, Depth.rescale and
   refine_3d_points; once to warm up, then on a fresh scene with the launch
   counts set to 0, each entry point's wall time printed (build_ba_data's
   host passes apart) and K3 timed at int_covs_bundle_batched's shapes.
   Held: finite, symmetric covariances with a positive diagonal, parked
   with a slot for every point (the anchors' codes then ≥ 0); each BA's
   cost below its start with an accepted step; poses and points written
   back; changed lanes device-resident until read and closer to the
   points' true depths than their priors; uncertainty_update finite,
   positive and moved on the changed lanes; a finite truncation
   multiplier; each of K1, K1 many, K2 and K3 launched. The same phase at
   the small size on the card and on the CPU agrees (z, covariances,
   uncertainty_update, costs; poses, points and the truncation multiplier
   with LM iterations that end before the rel_tol latch).

`python3 chip_smoke.py --profile` adds one main-path run under
torch.profiler and prints its device time by kernel.

Prints the card's name and power limit, each kernel's times and launch
count, the wall time per phase (the depth-consistency check's with its 8
scores), the consistent scene's two scores, the estimators' times and
checks, the scene phase's checks and one line per wall time, the scene
refinement's checks and wall times and its launches (a line of their
own), a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero before that
line. Without a CUDA card it exits 1 and prints no result. Inputs are
synthetic, made from a seed with numpy.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

SEED = 0
FULL = dict(n_cams=64, n_pts=8192, B=8, H=290, W=387)  # bench bundle; 640×480 images on the ≤387 px grid
SMALL = dict(n_cams=8, n_pts=256, B=2, H=48, W=64)
# integration conf of the main path (mpsfm_tpu/scene/image_priors.py defaults)
MAIN_BINI = dict(lambda1=1.0, lambda2=1.0, k=1.0, max_iter=10, cg_max_iter=1000, cg_tol=1e-3, tol=5e-2)
# int_covs of the main path (same defaults): the diag(H⁻¹) grid is downscaled by
# 2, its deflated PCG runs 16 iterations, and the depth std is floored at 1% of
# the prior depth
DOWNSCALE, COV_CG_ITERS, INT_COV_FLOOR = 2, 16, 0.01
# depth rows of the BA (mpsfm_tpu/mapper/optimizer.py defaults: rob_std 2, scale_filter_factor 1.5)
ROWS = dict(m_base=2.0, sff=1.5, min_trunc=-1e30, scale_filter=True, compute_trunc=True)
LM_ITERS = 20
# LM iterations of the small scene refinement card vs CPU that end before the rel_tol latch (a step that
# moves the cost by < 1e-6 relative) can fire in any of its BAs: up to there every step moves the cost by
# more than float32 order can
LATCH_FREE_ITERS = 8
IMG_W, IMG_H, FOCAL = 640.0, 480.0, 500.0
# the depth-consistency check of the main path (mapper/depth_consistency.py defaults): c and the
# whitened test's threshold, the score's threshold depth_cons_thresh, the local bundle of a query
# (mapper/mapper.py:52, local_bundle_size) and prior_std_multiplier (scene/priors.py:46), by which
# the variance grids are divided
DC = dict(c=15.0, valid_thresh=0.6, score_thresh=0.15, refs=5, psm=3.33)
DC_SCORE_TOL = 0.02  # |Δscore| allowed where counts differ at boundary pixels (tests/test_mapper_units.py)
# RANSAC of the two-view verification and of registration: the mapper's hypothesis budget
# (scene/correspondences.py:24, mapper/registration.py:347) and threshold (max_error 4 px)
NUM_HYP, MAX_ERROR_PX = 512, 4.0
# the estimators' scene: 66 pairs of 12 of the bundle's cameras (the pair count of
# scripts/bench_mapping.py's 12 images), 2048 matches each; PnP at 4096 2D-3D matches; 1 px of
# Gaussian noise on every keypoint and 30% outliers (random keypoints in the image)
TWO_VIEW_CAMS, TWO_VIEW_MATCHES, PNP_MATCHES, NOISE_PX, OUTLIERS = 12, 2048, 4096, 1.0, 0.3
# the scene phase: a Reconstruction of the bench bundle after the main path's BA (64 images, 8192
# points, each seen by every image), filtered at 4 px and COLMAP's 1.5 deg triangulation angle;
# SCENE_REDO of the points deleted and re-added; the native store held against the plain one on
# the first TWO_VIEW_CAMS images
SCENE_FILTER, SCENE_REDO = (4.0, 1.5), 0.1

# published peaks of one H100 SXM: float32 outside the tensor cores, HBM
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

K1_TOL = 1e-4  # max |Δx| of K1 vs its plain version
# S = A·Aᵀ + shift·K·I: for each shift, the bound on max |Δx| / max |x| of K1
# vs its plain version and on the residual ‖S·x − b‖ / ‖b‖ of the kernel's x
# (float64). Two float32 orders differ by about a tenth of it; a trailing
# update that misses one 32×64 tile of one panel is off by a hundred times it
# or more, where the absolute bound alone may not see it (|x| ~ 1e-3 at shift 1).
K1_REL = {1.0: 1e-5, 0.01: 1e-4}
# max |Δz| in log-depth of K2 vs its plain version. Sound runs differ only in
# the order of the dot products' sums (1.6e-6 at the PCG's tolerance, 1.7e-5
# after the fixed budget's 5000 iterations, on an H100); k2_phase shows that a
# kernel whose CTA reads a stale or dropped halo at its seams fails it
# (fixed budget 1.7e-2 and 4.9e-3).
K2_TOL = 1e-4
# max |Δv| / v of K3's variances vs its plain version. Sound runs differ only in
# the order of the dot products' sums (4.7e-6 on an H100); k3_phase shows that a
# kernel that skips the deflation's projection (keeping the coarse start), or
# that drops p's halo row at a band edge, fails it (1.7e-2 and 3.6e-1).
K3_REL = 1e-3
# the covariances and variances of the small chain, card vs CPU: max |Δcov| /
# max |cov| and max |Δv| / v. The reduced camera system is ill-conditioned
# (κ ≈ 7e7 at the small bundle): one float32 ulp of S moves the covariances by
# 1.5e-4 of their max, and the card's sums differ from the CPU's by 7.2e-4 of
# it (tests/test_torch_covariance.py)
COV_REL, VAR_REL = 2e-3, 1e-3


# ---- synthetic inputs (numpy, from a seed) ----

def _rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def synthetic_bundle(n_cams=8, n_pts=256, seed=SEED, with_depth=True):
    """The JAX package's bench bundle (__graft_entry__._synthetic_ba_data):
    every camera observes every point, depth observations on the first
    quarter of the points; sparse camera-major arrays in numpy."""
    rng = np.random.default_rng(seed)
    f, cx, cy = FOCAL, IMG_W / 2, IMG_H / 2
    pts = np.stack(
        [rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 9, n_pts)], -1
    ).astype(np.float32)
    quats, ts, uvs, zs = [], [], [], []
    for i in range(n_cams):
        q = np.array([1.0, 0, 0.02 * min(i, 15), 0])
        q /= np.linalg.norm(q)
        t = np.array([-0.3 * min(i, 15) - 0.02 * i, 0.02 * min(i, 15), 0.05 * min(i, 15)])
        quats.append(q)
        ts.append(t)
        p = pts @ _rotmat(q).T + t
        uv = p[:, :2] / p[:, 2:] * f + np.array([cx, cy])
        uvs.append(uv + rng.normal(scale=0.5, size=uv.shape))
        zs.append(p[:, 2])
    No = n_cams * n_pts
    cam_dof = np.ones((n_cams, 6), np.float32)
    cam_dof[0] = 0.0
    cam_dof[1, 3] = 0.0
    Sd = max(n_pts // 4, 1)
    d_n = n_cams * Sd
    d_log = np.log(np.concatenate([z[:Sd] for z in zs])) + rng.normal(scale=0.02, size=d_n)
    f32 = np.float32
    return SimpleNamespace(
        quat=np.stack(quats).astype(f32), t=np.stack(ts).astype(f32), cam_dof=cam_dof,
        fx=np.full(n_cams, f, f32), fy=np.full(n_cams, f, f32),
        cx=np.full(n_cams, cx, f32), cy=np.full(n_cams, cy, f32),
        xyz=(pts + rng.normal(scale=0.05, size=pts.shape).astype(f32)).astype(f32),
        point_var=np.ones(n_pts, f32),
        r_cam=np.repeat(np.arange(n_cams), n_pts).astype(np.int32),
        r_pt=np.tile(np.arange(n_pts), n_cams).astype(np.int32),
        r_uv=np.concatenate(uvs).astype(f32), r_valid=np.ones(No, f32),
        r_mag=np.ones(No, f32), r_scale=np.full(No, 1.5, f32),
        d_cam=np.repeat(np.arange(n_cams), Sd).astype(np.int32),
        d_pt=np.tile(np.arange(Sd), n_cams).astype(np.int32),
        d_logtarget=d_log.astype(f32), d_valid=np.full(d_n, 1.0 if with_depth else 0.0, f32),
        d_mag=np.full(d_n, 100.0, f32), d_scale=np.full(d_n, 2.0, f32),
    )


def ba_arrays(bundle):
    """The bundle as the fields of the JAX package's BAData (numpy): its
    arrays plus the point slot tables and the per-(point, camera) tables,
    built as __graft_entry__._synthetic_ba_data builds them."""
    from mpsfm_tpu_torch.ba.solver import make_pc_tables, make_slot_tables

    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    No, Nd = bundle.r_cam.shape[0], bundle.d_cam.shape[0]
    arrays = dict(vars(bundle))
    arrays["r_pt_slots"], arrays["r_pt_slot_mask"] = make_slot_tables(bundle.r_pt, P)
    arrays["d_pt_slots"], arrays["d_pt_slot_mask"] = make_slot_tables(bundle.d_pt, P)
    arrays["pc_r_slot"], arrays["pc_r_mask"] = make_pc_tables(bundle.r_pt, bundle.r_valid, P, C, No // C)
    arrays["pc_d_slot"], arrays["pc_d_mask"] = make_pc_tables(bundle.d_pt, bundle.d_valid, P, C, Nd // C)
    return arrays


def synthetic_priors(bundle, B, H, W, seed=SEED, Ka=512, n_anchors=300):
    """Depth/normal priors of B images of the bundle on an H×W integration
    grid, with everything the refinement step takes: anchor rows
    (B,6,Ka) of every slot code (code >= 0 is the anchor's point, whose
    covariance the main path computes), gate state prev (B,2) (no lane
    integrated yet), the cached (z0, stat8) pair of each lane, the keypoint
    rows (grid coords, previous depth variances, point index, camera) for
    the BA's depth residuals, and the int_covs problem on the grid
    downscaled by DOWNSCALE: static and prior rows there, anchors at
    downscaled pixels, one query per keypoint row (padded with pixel (0, 0)
    to a multiple of 128) and the prior depth at each keypoint. The scene
    depth of image b is a slanted plane at the median depth of its points;
    the prior is that plane with 3% log-normal noise; the normals are the
    plane's. For the depth-consistency check: each lane's prior variance
    grid divided by prior_std_multiplier², the intrinsics at grid scale,
    each lane's neighbours and its rows against them (the JAX checker's)."""
    import torch

    from mpsfm_tpu_torch.integration.bini import build_prior2, build_static6, resize_log_dev
    from mpsfm_tpu_torch.mapper.depth_consistency import pair_rows

    rng = np.random.default_rng(seed + 1)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    sx, sy = W / IMG_W, H / IMG_H
    fx, fy, cx, cy = FOCAL * sx, FOCAL * sy, IMG_W / 2 * sx, IMG_H / 2 * sy
    H2, W2 = H // DOWNSCALE, W // DOWNSCALE
    Sd = max(P // 4, 1)
    Kp = -(-Sd // 128) * 128
    cam_rows = np.linspace(0, C - 1, B).round().astype(np.int32)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))

    def normal_covs(h, w):  # ~2° of normal noise
        return np.broadcast_to(np.eye(3) * (np.pi / 180 * 2) ** 2, (h, w, 3, 3))

    anch = np.zeros((B, 6, Ka), np.float32)
    anch[:, 0] = H  # padding: out of range, dropped
    anch[:, 4] = -1.0
    anch_ds = anch.copy()
    anch_ds[:, 0] = H2
    pairs, stat8_ds, z_gt = [], [], []
    gx = np.zeros((B, Sd), np.float32)
    gy = np.zeros((B, Sd), np.float32)
    sigma2 = np.ones((B, Kp), np.float32)
    dprior = np.ones((B, Kp), np.float32)
    rowcol = np.zeros((B, 2, Kp), np.int32)
    ptidx = np.full((B, Sd), P, np.int32)  # >= P: padding
    dc_var = np.zeros((B, H, W), np.float32)
    for b, c in enumerate(cam_rows):
        R = _rotmat(bundle.quat[c])
        pc = bundle.xyz @ R.T + bundle.t[c]
        u = (fx * pc[:, 0] / pc[:, 2] + cx).astype(np.float32)
        v = (fy * pc[:, 1] / pc[:, 2] + cy).astype(np.float32)
        seen = np.nonzero((pc[:, 2] > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H))[0]
        n = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15), -1.0])
        n /= np.linalg.norm(n)
        d0 = float(np.median(pc[seen, 2]))
        depth = n[2] * d0 / (n[0] * (xx - cx) / fx + n[1] * (yy - cy) / fy + n[2])
        prior = depth * np.exp(rng.normal(scale=0.03, size=depth.shape))
        static6 = build_static6(np.ones((H, W), bool), np.broadcast_to(n, (H, W, 3)), normal_covs(H, W),
                               fx, fy, cx, cy)
        prior2 = build_prior2(prior, (prior * 0.05) ** 2)
        dc_var[b] = ((prior * 0.05) ** 2).astype(np.float32) / np.float32(DC["psm"] ** 2)
        pairs.append((np.log(prior).astype(np.float32), np.concatenate([prior2, static6]).astype(np.float32)))
        z_gt.append(np.log(depth).astype(np.float32))
        # the int_covs grid: the prior resized, the static rows at the downscaled intrinsics
        prior_ds = np.exp(resize_log_dev(torch.as_tensor(np.log(prior), dtype=torch.float32), 0.0, (H2, W2)).numpy())
        static6_ds = build_static6(np.ones((H2, W2), bool), np.broadcast_to(n, (H2, W2, 3)), normal_covs(H2, W2),
                                   fx / DOWNSCALE, fy / DOWNSCALE, cx / DOWNSCALE, cy / DOWNSCALE)
        stat8_ds.append(np.concatenate([build_prior2(prior_ds, (prior_ds * 0.05) ** 2), static6_ds]).astype(np.float32))
        # keypoint rows: a random subset of the seen points, the rest padding
        kp = rng.permutation(seen)[:Sd]
        m = len(kp)
        ptidx[b, :m] = kp
        gx[b, :m], gy[b, :m] = u[kp], v[kp]
        iy, ix = np.clip(v[kp].astype(int), 0, H - 1), np.clip(u[kp].astype(int), 0, W - 1)
        sigma2[b, :m] = (0.05 * depth[iy, ix]) ** 2
        dprior[b, :m] = prior[iy, ix]
        rowcol[b, 0, :m] = np.clip(np.round(v[kp] / DOWNSCALE), 0, H2 - 1)
        rowcol[b, 1, :m] = np.clip(np.round(u[kp] / DOWNSCALE), 0, W2 - 1)
        # anchors: SfM depths at de-duplicated keypoint pixels, slot codes >=0 / -1 / -2
        pix = v[kp].astype(np.int64) * W + u[kp].astype(np.int64)
        _, first = np.unique(pix, return_index=True)
        sel = kp[np.sort(first)][:min(n_anchors, Ka)]
        L = len(sel)
        code = np.where(np.arange(L) % 3 == 0, sel, np.where(np.arange(L) % 3 == 1, -1, -2))
        ay, ax = v[sel].astype(np.int64), u[sel].astype(np.int64)
        d3 = depth[ay, ax] * np.exp(rng.normal(scale=0.01, size=L))  # SfM depth on the scene plane
        val = np.where(code == -2, d3 ** 2 / 1e-2, d3)  # -2: the value is the precision
        rows = np.stack([ay, ax, val, np.log(d3), code])
        anch[b, :5, :L] = rows
        # the int_covs grid's anchors: pixels rounded from the halved coordinates, the first on each pixel
        rows[0] = np.clip(np.round(v[sel] / DOWNSCALE), 0, H2 - 1)
        rows[1] = np.clip(np.round(u[sel] / DOWNSCALE), 0, W2 - 1)
        _, first = np.unique(rows[0] * W2 + rows[1], return_index=True)
        anch_ds[b, :5, :len(first)] = rows[:, np.sort(first)]
        anch[b, 5, 2:5] = anch_ds[b, 5, 2:5] = R[2]
    # the depth-consistency check: each lane the query against its up to DC["refs"] nearest lanes
    dc_refs = [sorted((r for r in range(B) if r != b), key=lambda r: (abs(r - b), r))[:DC["refs"]]
               for b in range(B)]
    poses = [(bundle.quat[c], bundle.t[c]) for c in cam_rows]
    dc_rows = np.stack([pair_rows(poses[b], [poses[r] for r in dc_refs[b]]) for b in range(B)])
    return SimpleNamespace(
        anch=anch, prev=np.zeros((B, 2), np.float32), pairs=pairs,
        z_gt=np.stack(z_gt), gx=gx, gy=gy, sigma2=sigma2, ptidx=ptidx, cam_rows=cam_rows,
        anch_ds=anch_ds, stat8_ds=stat8_ds, rowcol=rowcol, dprior=dprior, Sd=Sd,
        dc_var=dc_var, dc_refs=dc_refs, dc_rows=dc_rows, K_grid=grid_K(H, W),
    )


def grid_K(H, W):
    """Intrinsics of the 640×480 camera at the scale of an H×W grid."""
    sx, sy = W / IMG_W, H / IMG_H
    return np.array([[FOCAL * sx, 0, IMG_W / 2 * sx], [0, FOCAL * sy, IMG_H / 2 * sy], [0, 0, 1]], np.float32)


def lane_state(priors, dev):
    """The gate's inputs as tensors on dev: anchor rows, gate state and the
    (z0, stat8) pair of each lane."""
    import torch

    def t(a):
        return torch.as_tensor(a, device=dev)

    return t(priors.anch), t(priors.prev), [(t(z0), t(s8)) for z0, s8 in priors.pairs]


def make_inputs(n_cams, n_pts, B, H, W, seed=SEED):
    bundle = synthetic_bundle(n_cams, n_pts, seed)
    return SimpleNamespace(bundle=bundle, ba=ba_arrays(bundle), priors=synthetic_priors(bundle, B, H, W, seed),
                           C=n_cams, P=n_pts)


# ---- the main path ----

def run_slice(inputs, device, lm_iters=LM_ITERS, phases=None, floor=INT_COV_FLOOR):
    """The refinement step on `device`, through the port's entry points,
    in the JAX package's order (Mapper: calculate_point_covs, then
    Optimizer.ba_fused with the int_covs chain of _integrate_deferred, the
    depth-consistency check of each refined lane against its neighbours,
    then the BA), with the depth std floored at `floor` of the prior depth
    (0: the reference's unfloored mode). Returns a dict of tensors and
    numbers; `phases` (a dict) collects wall seconds per phase."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.covariance import point_covariances
    from mpsfm_tpu_torch.ba.dense import densify, solve_ba_dense
    from mpsfm_tpu_torch.ba.device_depth import build_depth_grids, sample_logd
    from mpsfm_tpu_torch.integration.bini import (
        BiniParams,
        bini_gate_solve_batch_anchors,
        diag_inverse_gated_batch_anchors,
        resize_log_dev,
        take_z,
    )
    from mpsfm_tpu_torch.mapper.depth_consistency import bundle_score
    from mpsfm_tpu_torch.scene.image_priors import _changed_flag_dev, _updated_unc_dev

    phases = {} if phases is None else phases
    dev = torch.device(device)
    pr = inputs.priors

    def mark(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    dense = densify(inputs.bundle, inputs.C, inputs.P, device=dev)
    ba = convert.ba_data(inputs.ba, device=dev)
    anch, prev, pairs = lane_state(pr, dev)
    rows = [torch.as_tensor(a, device=dev)
            for a in (pr.gx, pr.gy, pr.sigma2, pr.ptidx, pr.cam_rows, pr.anch_ds, pr.rowcol, pr.dprior)]
    stat8_ds = [torch.as_tensor(a, device=dev) for a in pr.stat8_ds]
    dc_var, dc_K, dc_rows = (torch.as_tensor(a, device=dev) for a in (pr.dc_var, pr.K_grid, pr.dc_rows))
    t0 = mark("upload", t0)
    cov = point_covariances(ba)
    t0 = mark("point_covs", t0)
    p = BiniParams(**MAIN_BINI)
    z, info4 = bini_gate_solve_batch_anchors(anch, prev, p, cov, *pairs)
    t0 = mark("bini_gate_solve", t0)
    gx, gy, sigma2_old, ptidx, cam_rows, anch_ds, rowcol, dprior = rows
    Bn, H2, W2 = z.shape[0], *stat8_ds[0].shape[-2:]
    pairs_ds = [(resize_log_dev(take_z(z, b), 0.0, (H2, W2)), stat8_ds[b]) for b in range(Bn)]
    flags = torch.stack([_changed_flag_dev(info4, b) for b in range(Bn)])
    varlog = diag_inverse_gated_batch_anchors(
        anch_ds, rowcol, p._replace(cg_max_iter=COV_CG_ITERS), 128, cov, flags, *pairs_ds)
    sigma2 = torch.stack([_updated_unc_dev(varlog, b, sigma2_old[b], dprior[b], info4, b, floor)
                          for b in range(Bn)])
    t0 = mark("int_covs", t0)
    dc_depth = torch.stack([torch.exp(take_z(z, b)) for b in range(Bn)])
    dc_counts = lane_dc_counts(dc_depth, dc_var, dc_K, dc_rows, pr.dc_refs)
    dc_scores = [bundle_score(c) for c in dc_counts]
    t0 = mark("dc", t0)
    logd = torch.stack([sample_logd(z[b], 0.0, gx[b], gy[b]) for b in range(Bn)])
    d_logt, d_w, d_scale, trunc = build_depth_grids(
        logd, sigma2[:, :pr.Sd], ptidx, cam_rows, dense.quat, dense.t, dense.xyz,
        ROWS["m_base"], ROWS["sff"], ROWS["min_trunc"], C=inputs.C, P=inputs.P,
        scale_filter=ROWS["scale_filter"], compute_trunc=ROWS["compute_trunc"],
    )
    dense = dense._replace(d_logt=d_logt, d_w=d_w, d_scale=d_scale)
    t0 = mark("depth_rows", t0)
    quat, t, xyz, info = solve_ba_dense(dense, max_iters=lm_iters)
    mark("dense_ba", t0)
    return dict(cov=cov, z=z, info4=info4, varlog=varlog, sigma2=sigma2, d_w=d_w, trunc=trunc,
                dc_depth=dc_depth, dc_var=dc_var, dc_K=dc_K, dc_rows=dc_rows, dc_counts=dc_counts,
                dc_scores=dc_scores, quat=quat, t=t, xyz=xyz,
                cost0=float(info["cost0"]), cost=float(info["cost"]), accepted=int(info["accepted"]))


def lane_dc_counts(depth, var, K, rows, refs):
    """The depth-consistency counts of each lane b as the query against its
    neighbours refs[b] (one _bundle_counts call per query and grid shape,
    as the JAX checker makes): depth and var (B, H, W), K (3, 3), rows
    (B, R, 32). Returns (B, R, 4): qry_nv, qry_v, ref_nv, ref_v."""
    import torch

    from mpsfm_tpu_torch.mapper.depth_consistency import _bundle_counts

    ones = torch.ones(2, device=depth.device)
    return torch.stack([
        _bundle_counts(depth[b], var[b], K, ones, depth[r], var[r], K.expand(len(r), 3, 3), rows[b],
                       DC["c"], DC["valid_thresh"])
        for b, r in enumerate(refs)
    ])


def dc_pixel_classes(depth, var, K, rows, b, j, r):
    """Per pixel, both directions of the pair (lane b, its j-th neighbour r):
    [(p2D, t, in-canvas, valid, occluded)] ×2."""
    import torch

    from mpsfm_tpu_torch.mapper.depth_consistency import _dir_maps, _pair_args

    q, rr, M_qr, M_rq, r2_qr, r2_rq = _pair_args(depth[b], var[b], K, torch.ones(2, device=depth.device),
                                                depth[[r]], var[[r]], K[None], rows[b, j:j + 1])
    args = (DC["c"], DC["valid_thresh"])
    return _dir_maps(*q, *rr, M_qr, r2_qr, *args), _dir_maps(*rr, *q, M_rq, r2_rq, *args)


def near_boundary(p, t, out_hw, tol=1e-5):
    """Pixels whose target lies within tol px of a pixel or canvas boundary,
    or whose |t| lies within tol relative of the test's threshold."""
    H2, W2 = out_hw
    u, v = p[..., 0], p[..., 1]

    def edge(x, n):
        return ((x - x.round()).abs() <= tol) | ((x + 0.5 - n).abs() <= tol)

    return edge(u, W2) | edge(v, H2) | ((t.abs() - DC["valid_thresh"]).abs() <= tol * DC["valid_thresh"])


def dc_card_vs_cpu(out, inputs):
    """The main path's depth-consistency counts of the card against the
    CPU's on the same depth: equal, or every pixel classified differently
    within 1e-5 of a boundary (near_boundary, on either device's values)
    and every lane's score within DC_SCORE_TOL. Returns a line."""
    import torch

    from mpsfm_tpu_torch.mapper.depth_consistency import bundle_score

    pr = inputs.priors
    host = [torch.as_tensor(a) for a in (pr.dc_var, pr.K_grid, pr.dc_rows)]
    cpu = lane_dc_counts(out["dc_depth"].cpu(), *host, pr.dc_refs)
    card = out["dc_counts"].cpu()
    if torch.equal(card, cpu):
        return f"depth-consistency counts card vs CPU: equal ({card.numel()} counts)"
    dev = [out["dc_depth"], out["dc_var"], out["dc_K"], out["dc_rows"]]
    unexplained, n_diff = 0, 0
    for b, j in {(int(b), int(j)) for b, j, _ in torch.nonzero(card != cpu).tolist()}:
        r = pr.dc_refs[b][j]
        for mc, mg in zip(dc_pixel_classes(out["dc_depth"].cpu(), *host, b, j, r),
                          dc_pixel_classes(*dev, b, j, r)):
            diff = torch.zeros_like(mc[2])
            for a, g in zip(mc[2:], mg[2:]):
                diff |= a != g.cpu()
            hw = pr.dc_var.shape[-2:]
            near = near_boundary(mc[0], mc[1], hw) | near_boundary(mg[0].cpu(), mg[1].cpu(), hw)
            n_diff += int(diff.sum())
            unexplained += int((diff & ~near).sum())
    gap = max(abs(bundle_score(a) - bundle_score(c)) for a, c in zip(card, cpu))
    line = (f"depth-consistency counts card vs CPU: {int((card != cpu).sum())} of {card.numel()} differ, "
            f"{n_diff} pixels classified differently, {unexplained} of them not at a boundary; "
            f"max |Δscore| {gap:.3g} (tolerance {DC_SCORE_TOL})")
    if unexplained or not n_diff or gap > DC_SCORE_TOL:
        raise AssertionError(line)
    return line


def check_slice(out, inputs):
    """The main path's own checks; raises on the first that fails."""
    import torch

    for k in ("cov", "z", "info4", "varlog", "sigma2", "d_w", "quat", "t", "xyz"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")
    pr = inputs.priors
    B, H, W = pr.z_gt.shape
    if tuple(out["z"].shape) != (B, H, W) or tuple(out["xyz"].shape) != (inputs.P, 3):
        raise AssertionError("unexpected output shapes")
    if tuple(out["cov"].shape) != (inputs.P, 3, 3) or tuple(out["varlog"].shape) != pr.rowcol[:, 0].shape:
        raise AssertionError("unexpected covariance or variance shapes")
    cov = out["cov"].double().cpu().numpy()
    asym = np.abs(cov - cov.transpose(0, 2, 1)).max() / np.abs(cov).max()
    if not (asym < 1e-5 and (np.einsum("pii->pi", cov) > 0).all()):
        raise AssertionError(f"covariances not symmetric ({asym}) or with a non-positive diagonal")
    corr = np.corrcoef(inputs.bundle.xyz[:, 2], cov[:, 2, 2])[0, 1]
    if not corr > 0.2:  # deeper points are less certain (tests/test_ba.py:test_point_covariance_sanity)
        raise AssertionError(f"depth variance does not grow with depth: correlation {corr}")
    if not bool((out["varlog"] > 0).all()):
        raise AssertionError("a diag(H^-1) variance is not positive")
    info4 = out["info4"].cpu().numpy()
    if not (info4[:, 2] == 1).all() or (info4[:, 3] == 1).any():
        raise AssertionError(f"every lane should refine and none abort: {info4}")
    real = torch.as_tensor(pr.ptidx < inputs.P)
    moved = (out["sigma2"][:, :pr.Sd].cpu() != torch.as_tensor(pr.sigma2[:, :pr.Sd]))[real]
    if not bool(moved.all()):  # every lane changed here
        raise AssertionError(f"{int((~moved).sum())} keypoint variances of changed lanes did not move")
    if not out["cost"] < out["cost0"]:
        raise AssertionError(f"cost {out['cost']} not below cost0 {out['cost0']}")
    if out["accepted"] < 3:
        raise AssertionError(f"only {out['accepted']} accepted LM steps")
    if int((out["d_w"] > 0).sum()) == 0:
        raise AssertionError("no depth row has weight")
    z = out["z"].cpu().numpy()
    z0 = np.stack([q[0] for q in pr.pairs])
    err, err0 = np.abs(z - pr.z_gt).mean((1, 2)), np.abs(z0 - pr.z_gt).mean((1, 2))
    if not (err < 0.5 * err0).all():
        raise AssertionError(f"refined depth not closer to the truth: {err} vs prior {err0}")
    counts = out["dc_counts"].cpu()
    R = min(DC["refs"], B - 1)
    if tuple(counts.shape) != (B, R, 4) or not bool(((counts >= 0) & (counts <= H * W)).all()):
        raise AssertionError(f"depth-consistency counts of shape {tuple(counts.shape)}, not ({B}, {R}, 4) in [0, {H * W}]")
    valid = counts[..., [1, 3]].sum(1)
    if not bool((valid > 0).all()) or not all(np.isfinite(out["dc_scores"])):
        raise AssertionError(f"a lane's depth-consistency check saw no valid pixel: {valid.tolist()}, {out['dc_scores']}")
    dc_line = dc_card_vs_cpu(out, inputs) if out["dc_depth"].is_cuda else None
    return dict(dc_line=dc_line, depth_err=float(err.mean()), prior_err=float(err0.mean()), cov_depth_corr=float(corr),
                var_ratio=float((out["sigma2"][:, :pr.Sd].cpu()[real] / torch.as_tensor(pr.sigma2[:, :pr.Sd])[real])
                                .median()))


# ---- kernel phases ----

def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over reps calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def k1_check(S, b, rel, what):
    """K1 vs its plain version on (S, b): finite, max |Δx| ≤ K1_TOL, max |Δx| /
    max |x| ≤ rel and ‖S·x − b‖ / ‖b‖ ≤ rel. Returns (x, max |Δx|, a line)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    x = cholesky.cholesky_solve(S, b)
    ref = cholesky.cholesky_solve_plain(S, b)
    err = float((x - ref).abs().max())
    rel_err = err / float(ref.abs().max())
    b64 = b.double()
    res = float(torch.linalg.vector_norm(S.double() @ x.double() - b64) / torch.linalg.vector_norm(b64))
    line = (f"{what}: max|kernel - plain| {err:.3e} (tolerance {K1_TOL}), relative {rel_err:.2e}, "
            f"residual {res:.2e} (tolerance {rel}), max|x| {float(ref.abs().max()):.3g}")
    if not (bool(torch.isfinite(x).all()) and err <= K1_TOL and rel_err <= rel and res <= rel):
        raise AssertionError(f"K1 disagrees with its plain version: {line}")
    return x, err, line


def k1_phase(dev, rng):
    """K1 vs its plain version at K = 6 (one ragged panel), 390 (a ragged
    last panel), 384 (the bench bundle's 6C) and 1024, on S = A·Aᵀ +
    shift·K·I for each shift of K1_REL, and with a zeroed row and column
    (its pivot clamped to 1e-20); times of the kernel, the plain version and
    the library call at 384 and 1024 (shift 1). Returns the K = 384 figures
    (the main path's shape)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    def spd(K, shift):
        A = rng.normal(size=(K, K)).astype(np.float32)
        S = A @ A.T + shift * K * np.eye(K, dtype=np.float32)
        return S, rng.normal(size=K).astype(np.float32)

    out = {}
    for K in (6, 390, 384, 1024):
        parts, errs = [], []
        for shift, rel in K1_REL.items():
            S, b = (torch.as_tensor(a, device=dev) for a in spd(K, shift))
            _, err, line = k1_check(S, b, rel, f"shift {shift}")
            parts.append(line)
            errs.append(err)
            if shift == 1.0:
                S1, b1 = S, b
        line = f"K1 cholesky_solve K={K}: " + "; ".join(parts)
        if K in (384, 1024):
            ms = cuda_ms(lambda: cholesky.cholesky_solve(S1, b1), 20)
            plain_ms = cuda_ms(lambda: cholesky.cholesky_solve_plain(S1, b1), 2)

            def library():
                return torch.cholesky_solve(b1[:, None], torch.linalg.cholesky(S1))

            lib_ms = cuda_ms(library, 20)
            flops = K ** 3 / 3 + 2 * K * K
            nbytes = 4 * (K * K + 2 * K)
            bound_ms = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms, "
                     f"bound {bound_ms:.5f} ms")
            if K == 384:
                out = dict(err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)
        print(line)
    for K, z in ((42, 35), (390, 100)):  # z in the ragged last panel, and in a full one
        S, b = spd(K, 1.0)
        S[z, :] = 0.0
        S[:, z] = 0.0
        b[z] = 0.0
        x, _, line = k1_check(torch.as_tensor(S, device=dev), torch.as_tensor(b, device=dev), K1_REL[1.0],
                              f"K1 cholesky_solve K={K}, row and column {z} zeroed")
        if float(x[z]) != 0.0:
            raise AssertionError(f"K1 at a clamped pivot: x[{z}] = {float(x[z])}, not 0")
        print(line + f", x[{z}] = 0")
    return out


def kernel_ms_by_name(fn, reps):
    """Device ms per call of fn() by kernel name (torch.profiler over reps
    calls, after one warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return ms


def k1_many_phase(dev, rng):
    """K1 with many right-hand sides vs its plain version at K = 384, N =
    24 576 (the covariances' solve at the bench bundle: 6C × 3P), K = 390,
    N = 1000 (a ragged last block and column tile), K = 3072, N = 1000 (512
    cameras, the JAX package's largest dense covariance) and K = 33, N =
    24 577 (ragged, N no multiple of 4), on S = A·Aᵀ + shift·K·I for each
    shift of K1_REL: max |ΔX| ≤ K1_TOL, max |ΔX| / max |X| and ‖S·X − B‖_F /
    ‖B‖_F within the shift's bound. Times of the kernel, the plain version
    and the library call at the main shape, and of the kernel's three
    launches apart (the substitution beside its bound and the library's
    substitution with a given factor)."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    out = {}
    for K, N in ((384, 24576), (390, 1000), (3072, 1000), (33, 24577)):
        parts, errs = [], []
        for shift, rel in K1_REL.items():
            A = rng.normal(size=(K, K)).astype(np.float32)
            S = torch.as_tensor(A @ A.T + shift * K * np.eye(K, dtype=np.float32), device=dev)
            Bm = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32), device=dev)
            n0 = cholesky.KERNEL_MANY.launches
            X = cholesky.cholesky_solve(S, Bm)
            if cholesky.KERNEL_MANY.launches != n0 + 1:
                raise AssertionError("K1 with many right-hand sides was not launched")
            ref = cholesky.cholesky_solve_plain(S, Bm)
            err = float((X - ref).abs().max())
            rel_err = err / float(ref.abs().max())
            res = float(torch.linalg.norm(S.double() @ X.double() - Bm.double()) / torch.linalg.norm(Bm.double()))
            line = f"shift {shift}: max|kernel - plain| {err:.3e}, relative {rel_err:.2e}, residual {res:.2e} (tolerance {rel})"
            if not (bool(torch.isfinite(X).all()) and err <= K1_TOL and rel_err <= rel and res <= rel):
                raise AssertionError(f"K1 many disagrees with its plain version at K={K}, N={N}: {line}")
            parts.append(line)
            errs.append(err)
            if shift == 1.0:
                S1, B1 = S, Bm
        line = f"K1 cholesky_solve K={K}, N={N}: " + "; ".join(parts)
        if N == 24576:
            ms = cuda_ms(lambda: cholesky.cholesky_solve(S1, B1), 10)
            plain_ms = cuda_ms(lambda: cholesky.cholesky_solve_plain(S1, B1), 2)
            lib_ms = cuda_ms(lambda: torch.cholesky_solve(B1, torch.linalg.cholesky(S1)), 10)
            flops = K ** 3 / 3 + 2.0 * K * K * N
            nbytes = 4.0 * (K * K + 2 * K * N)
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms, "
                     f"bound {max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3:.5f} ms")
            out = dict(err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)
            by_name = kernel_ms_by_name(lambda: cholesky.cholesky_solve(S1, B1), 10)
            L1 = torch.linalg.cholesky(S1)
            lib_subst = cuda_ms(lambda: torch.cholesky_solve(B1, L1), 10)
            subst_bound = 2.0 * K * K * N / PEAK_F32 * 1e3
            parts = {"factorization": "chol_solve_kernel", "packing": "chol_pack_kernel",
                     "substitution": "chol_subst_kernel"}
            got = {what: sum(t for n, t in by_name.items() if key in n) for what, key in parts.items()}
            if not all(got.values()):
                raise AssertionError(f"K1 many's kernels not all seen by the profiler: {sorted(by_name)}")
            print(f"K1 many K={K}, N={N} by kernel (torch.profiler, 10 calls): "
                  + ", ".join(f"{what} {t:.4f} ms" for what, t in got.items())
                  + f"; substitution bound {subst_bound:.5f} ms (2 K^2 N FLOP), library's substitution "
                  f"(torch.cholesky_solve, factor given) {lib_subst:.4f} ms")
        print(line)
    return out


def k3_inputs(pr, cov, dev, queries=None):
    """K3's inputs for the priors `pr`: each lane's int_covs problem (the
    downscaled grid, its anchors priced by the covariances `cov`) with the
    resized prior as z, its operator, the deflation set-up and the first
    `queries` keypoint queries (all by default); and the iteration count."""
    import torch

    from mpsfm_tpu_torch.integration import bini, bini_diag, bini_fused

    pairs = [(torch.as_tensor(s8[1], device=dev), torch.as_tensor(s8, device=dev)) for s8 in pr.stat8_ds]
    packed = bini._assemble_batch_anchors(torch.as_tensor(pr.anch_ds, device=dev), cov, pairs)
    inp = bini._unpack(packed)
    p = bini.BiniParams(**MAIN_BINI)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, _, dg = bini._operator(inp, p, wx, wy)
    rowcol = torch.as_tensor(pr.rowcol[:, :, :queries], device=dev)
    return st, bini_diag.deflation(st, dg), rowcol[:, 0], rowcol[:, 1], COV_CG_ITERS


@contextlib.contextmanager
def k3_no_projection():
    """The plain deflated PCG turned into a kernel that skips the
    deflation's projection of the preconditioned residual (the coarse
    start stays)."""
    from mpsfm_tpu_torch.integration import bini_diag

    project = bini_diag.project
    bini_diag.project = lambda dfl, Z, V: V
    try:
        yield
    finally:
        bini_diag.project = project


@contextlib.contextmanager
def k3_seam_fault(row, iters):
    """The plain deflated PCG turned into a kernel whose band starting at
    `row` reads p's halo row (row − 1, the band above's last row) as 0:
    every H·p of the iterations is that of the sound kernel except on that
    band's first row, where the upper edge sees p(row − 1) = 0. The coarse
    start's H·x0 is analytic in the kernel and stays sound."""
    from mpsfm_tpu_torch.integration import bini_diag

    matvec = bini_diag.matvec
    calls = [0]

    def faulty(st, v):
        out = matvec(st, v)
        calls[0] += 1
        if calls[0] % (iters + 1) != 1:  # per chunk of queries: H·x0 first, then H·p of each iteration
            dropped = v.clone()
            dropped[..., row - 1, :] = 0.0
            out[..., row, :] = matvec(st, dropped)[..., row, :]
        return out

    bini_diag.matvec = faulty
    try:
        yield
    finally:
        bini_diag.matvec = matvec


def k3_check(what, args):
    """K3 vs its plain version: one launch, positive variances within
    K3_REL, bit-identical from run to run. Returns (variances, the plain
    version's, max |Δv| / v)."""
    import torch

    from mpsfm_tpu_torch.integration import bini_diag

    st, dfl, rows, cols, iters = args
    Bn, H, W = dfl.minv.shape
    pl = bini_diag.plan(H, W)
    n0 = bini_diag.KERNEL.launches
    v = bini_diag.deflated_pcg(*args)
    torch.cuda.synchronize()
    if bini_diag.KERNEL.launches != n0 + 1:
        raise AssertionError(f"K3 ({what}) made {bini_diag.KERNEL.launches - n0} launches, not 1")
    ref = bini_diag.deflated_pcg_plain(*args)
    rel = float(((v - ref).abs() / ref.abs()).max())
    same = bool(torch.equal(bini_diag.deflated_pcg(*args), v))
    where = "p and r in global memory" if pl.gmem else "p and r in shared memory"
    print(f"K3 deflated PCG ({what}: B={Bn} {H}x{W}, {rows.shape[1]} queries a lane, {iters} iterations; "
          f"clusters of C={pl.C} CTAs of {pl.bh} rows, R={pl.R} right-hand sides, {where}, {pl.smem} B of shared memory, "
          f"{bini_diag.active_clusters(H, W, dfl.minv.device)} clusters co-resident): max|kernel - plain| / plain = "
          f"{rel:.3e} (tolerance {K3_REL}); run to run {'bit-identical' if same else 'DIFFERENT'}; "
          f"variances {float(ref.min()):.3e} .. {float(ref.max()):.3e}")
    if not (bool((v > 0).all()) and rel <= K3_REL and same):
        raise AssertionError(f"K3 ({what}) disagrees with its plain version ({rel}) or is not bit-identical ({same})")
    return v, ref, rel


def k3_phase(dev, inputs, cov):
    """K3 vs its plain version at the main path's shapes (8 × 145×193,
    2048 queries a lane, 16 iterations) and at 2 × 193×193, 2 × 290×387
    (grids above one block's shared memory) and 2 × 400×600 (bands in global
    memory), 64 queries a lane: max |Δv| / v ≤ K3_REL, bit-identical from
    run to run, one launch each; the same check failing a kernel without the
    projection and one that drops p's halo row at a band edge; the global
    mode equal bit for bit to the shared-memory mode at the main grid (64
    queries a lane). Times of the kernel and the plain version at the main
    path's shapes and at 400×600, and of both modes at the main grid."""
    import torch

    from mpsfm_tpu_torch.integration import bini_diag

    args = k3_inputs(inputs.priors, cov, dev)
    st, dfl, rows, cols, iters = args
    Bn, H, W = dfl.minv.shape
    v, ref, rel = k3_check("main path", args)
    with k3_no_projection():
        bad = bini_diag.deflated_pcg_plain(*args)
    rel_bad = float(((bad - ref).abs() / ref.abs()).max())
    print(f"K3 check vs a kernel without the projection: max|Δv| / v = {rel_bad:.3e} (tolerance {K3_REL})")
    if rel_bad <= K3_REL:
        raise AssertionError("K3's check would pass a kernel without the deflation's projection")
    pl = bini_diag.plan(H, W)
    seam = pl.bh * (pl.C // 2)  # the first row of the middle band
    with k3_seam_fault(seam, iters):
        bad = bini_diag.deflated_pcg_plain(*args)
    rel_seam = float(((bad - ref).abs() / ref.abs()).max())
    print(f"K3 check vs a kernel that drops p's halo row above band {pl.C // 2} (row {seam - 1}): max|Δv| / v = "
          f"{rel_seam:.3e}, the sound kernel {rel:.3e} (tolerance {K3_REL})")
    if rel_seam <= K3_REL:
        raise AssertionError("K3's check would pass a kernel that drops a band's halo row")
    for h, w in ((193, 193), (290, 387)):  # an aspect of 1:1; downscaled: False at 4:3
        pr = synthetic_priors(inputs.bundle, 2, DOWNSCALE * h, DOWNSCALE * w)
        k3_check(f"{h}x{w}", k3_inputs(pr, cov, dev, queries=64))
    # bands of 50 rows of 600 pixels: above a CTA's shared memory at R = 1, global mode
    big = k3_inputs(synthetic_priors(inputs.bundle, 2, DOWNSCALE * 400, DOWNSCALE * 600), cov, dev, queries=64)
    if not bini_diag.plan(400, 600).gmem:
        raise AssertionError("the 400x600 plan should keep its bands in global memory")
    k3_check("400x600, global memory", big)
    big_ms = cuda_ms(lambda: bini_diag.deflated_pcg(*big), 2)
    big_plain_ms = cuda_ms(lambda: bini_diag.deflated_pcg_plain(*big), 1)
    print(f"K3 at 2 x 400x600, 64 queries a lane (global memory): kernel {big_ms:.3f} ms, plain {big_plain_ms:.3f} ms")
    # the global mode at the main grid's (C, R): the shared-memory mode's arithmetic, bit for bit
    few = k3_inputs(inputs.priors, cov, dev, queries=64)
    pl_g = pl._replace(gmem=True, smem=bini_diag.smem_bytes(H, W, pl.C, pl.R, gmem=True))
    shared = bini_diag._pcg_cuda(*few)
    glob = bini_diag._pcg_cuda(*few, pl=pl_g)
    torch.cuda.synchronize()
    if not torch.equal(glob, shared):
        raise AssertionError(f"K3's global mode differs from its shared-memory mode at {H}x{W}: "
                             f"max |Δv| / v {float(((glob - shared).abs() / shared.abs()).max())}")
    shared_ms = cuda_ms(lambda: bini_diag._pcg_cuda(*few), 3)
    glob_ms = cuda_ms(lambda: bini_diag._pcg_cuda(*few, pl=pl_g), 3)
    print(f"K3 global vs shared memory at B={Bn} {H}x{W}, 64 queries a lane, C={pl.C} R={pl.R}: bit-identical; "
          f"shared {shared_ms:.3f} ms, global {glob_ms:.3f} ms ({bini_diag.active_clusters(H, W, dev, pl_g)} "
          f"clusters co-resident in global mode)")
    ms = cuda_ms(lambda: bini_diag.deflated_pcg(*args), 2)
    plain_ms = cuda_ms(lambda: bini_diag.deflated_pcg_plain(*args), 1)
    n_rhs, n_pix = Bn * rows.shape[1], H * W
    # per pixel: 33 FLOP an iteration (stencil 13, p.Hp 2, r 2, M^-1 r 1,
    # (HZ)^T V 6, projection 5, r.z 2, p 2), 31 for the coarse start
    flops = float(n_rhs) * n_pix * (33 * iters + 31)
    nbytes = 4.0 * (7 * Bn * n_pix + 9 * Bn + H + W + 3 * n_rhs)  # maps, E^-1, axes, queries, variances
    # the design's reads of the maps from L2: 12 distinct values a pixel-iteration, once per group of R
    l2_bytes = 48.0 * Bn * -(-rows.shape[1] // pl.R) * n_pix * (iters + 1)
    print(f"K3: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3:.4f} ms; "
          f"the design's map reads from L2 {l2_bytes / 1e9:.1f} GB (R = {pl.R})")
    return dict(err=rel, ms=ms, plain_ms=plain_ms, library_ms=None,
                ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)


@contextlib.contextmanager
def k2_card_holds(n):
    """K2's lane-group planner sees a card that holds n CTAs at once."""
    from mpsfm_tpu_torch.integration import bini_fused

    capacity = bini_fused._capacity
    bini_fused._capacity = lambda dev, W: n
    try:
        yield
    finally:
        bini_fused._capacity = capacity


@contextlib.contextmanager
def k2_seam_fault(kind, chunk, cta):
    """The plain PCG turned into a kernel with a faulty seam: from the second
    CG iteration on, CTA `cta` of every lane (pixels [cta·chunk, (cta+1)·chunk)
    of the flattened image) computes Ap from a halo whose p is that of the
    previous iteration (kind "stale": p_old read in place of p_new) or 0
    ("dropped"). Every other pixel's Ap is right."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    matvec, pcg_plain = bini_fused.matvec, bini_fused.pcg_plain

    def faulty_pcg(*args):
        seen = {"calls": 0, "prev": None}  # matvec is given A x0 first, then p of each iteration

        def faulty_matvec(st, v):
            out = matvec(st, v)
            if seen["calls"] >= 2:
                B = v.shape[0]
                s, e = cta * chunk, min((cta + 1) * chunk, v[0].numel())
                halo = seen["prev"] if kind == "stale" else torch.zeros_like(v)
                mix = halo.reshape(B, -1).clone()
                mix[:, s:e] = v.reshape(B, -1)[:, s:e]
                out = out.reshape(B, -1).clone()
                out[:, s:e] = matvec(st, mix.view_as(v)).reshape(B, -1)[:, s:e]
                out = out.view_as(v)
            seen["calls"] += 1
            seen["prev"] = v
            return out

        bini_fused.matvec = faulty_matvec
        try:
            return pcg_plain(*args)
        finally:
            bini_fused.matvec = matvec

    bini_fused.pcg_plain = faulty_pcg
    try:
        yield
    finally:
        bini_fused.pcg_plain = pcg_plain


def k2_pcg_check(what, args, active):
    """K2's PCG vs its plain version on the same inputs: max |Δx| ≤ K2_TOL
    and per-lane iteration counts within 1. Returns (x, iterations, max |Δx|,
    the plain version's x and iterations)."""
    from mpsfm_tpu_torch.integration import bini_fused

    x, iters = bini_fused.pcg(*args, active)
    xr, iters_r = bini_fused.pcg_plain(*args, active)
    err = float((x - xr).abs().max())
    gap = int((iters - iters_r).abs().max())
    print(f"K2 pcg ({what}): max|kernel - plain| = {err:.3e} (tolerance {K2_TOL}); "
          f"iterations kernel {iters.cpu().tolist()} plain {iters_r.cpu().tolist()}")
    if not (err <= K2_TOL and gap <= 1):
        raise AssertionError(f"K2 PCG disagrees with its plain version ({what}): {err}, iterations {gap} apart")
    return x, iters, err, xr, iters_r


def k2_floor_ms(dev, B, cpl, iters=200):
    """Time per iteration of K2's PCG at B lanes of cpl CTAs each with one
    pixel a thread (16 rows of PCG_THREADS cpl / 16 pixels a lane, a random
    diagonally dominant stencil, fixed budget): the design's own floor, its
    two lane barriers and its reads of partials and halo with almost no
    arithmetic."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (B, 16, bini_fused.PCG_THREADS // 16 * cpl)
    ex, ey, pa, b, x0 = (torch.rand(shape, device=dev, generator=g) for _ in range(5))
    ex[..., -1] = 0.0  # the stencil's border: no edge beyond the last column and row
    ey[..., -1, :] = 0.0
    st = bini_fused.Stencil(ex, ey, pa + 1.0)
    dg = bini_fused.diag(st)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if len(bini_fused.plan_groups(B, shape[1] * shape[2], B * cpl)) != 1:
        raise AssertionError("the floor's lanes do not fit one group")
    with k2_card_holds(B * cpl):
        return cuda_ms(lambda: bini_fused.pcg(st, b, dg, x0, iters, -1.0, active), 3) / iters


def k2_phase(dev, inputs):
    """K2 vs its plain version at the main path's shapes: the PCG core on
    the first IRLS round's operator (tolerance and budget of the main
    path; run-to-run identity; B = 16 as two lane groups; an oversized grid
    refused), and the fixed-budget solve (BiniParams(max_iter=10,
    cg_max_iter=1000), clamped to 500 CG iterations). Times per solve and
    per CG iteration, and the design's floor."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.integration import bini, bini_fused

    from mpsfm_tpu_torch.ba.covariance import point_covariances

    pr = inputs.priors
    anch, prev, pairs = lane_state(pr, dev)
    cov = point_covariances(convert.ba_data(inputs.ba, device=dev))
    inp = bini._unpack(bini._assemble_batch_anchors(anch, cov, pairs))
    p = bini.BiniParams(**MAIN_BINI)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, b, dg = bini._operator(inp, p, wx, wy)
    Bn, H, W = inp.z0.shape
    args = (st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol)
    active = torch.ones(Bn, dtype=torch.bool, device=dev)
    cap = bini_fused._capacity(inp.z0.device.index, W)
    groups = bini_fused.plan_groups(Bn, H * W, cap)
    print(f"K2 pcg plan: {cap} co-resident CTAs of {bini_fused.PCG_THREADS} threads; B = {Bn}: {groups}")
    x, iters, err, xr, iters_r = k2_pcg_check(f"main path, tol {p.cg_tol}", args, active)
    its = iters.cpu().tolist()
    x2, iters2 = bini_fused.pcg(*args, active)
    if not (torch.equal(x2, x) and torch.equal(iters2, iters)):
        raise AssertionError("K2 PCG is not bit-identical from run to run")
    print("K2 pcg run to run: x and iterations bit-identical")

    # B = 2 Bn: the second half starts from a noisier z0; the planner makes two groups
    noise = torch.randn(inp.z0.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    args16 = (bini_fused.Stencil(*(torch.cat([f, f]) for f in st)), torch.cat([b, b]), torch.cat([dg, dg]),
              torch.cat([inp.z0, inp.z0 + 0.01 * noise]), p.cg_max_iter, p.cg_tol)
    active16 = torch.ones(2 * Bn, dtype=torch.bool, device=dev)
    groups16 = bini_fused.plan_groups(2 * Bn, H * W, cap)
    n0 = bini_fused.KERNEL.launches
    x16, _, err16, _, _ = k2_pcg_check(f"B = {2 * Bn}, {len(groups16)} lane groups", args16, active16)
    if len(groups16) < 2 or bini_fused.KERNEL.launches - n0 != len(groups16):
        raise AssertionError(f"K2 at B = {2 * Bn}: {bini_fused.KERNEL.launches - n0} launches for {groups16}")
    if groups16[0] == groups[0]:  # the same lanes on the same CTAs
        if not torch.equal(x16[:Bn], x):
            raise AssertionError("K2's first lane group at B = 16 differs from the same lanes at B = 8")
        print(f"K2 pcg B = {2 * Bn}: first group bit-identical to the B = {Bn} run")

    too_many = Bn * -(-H * W // bini_fused.PCG_THREADS)  # one pixel a thread: more CTAs than the card holds
    try:
        with k2_card_holds(too_many):
            bini_fused.pcg(*args, active)
    except RuntimeError as e:
        print(f"K2 pcg on {too_many} CTAs: refused ({e})")
    else:
        raise AssertionError(f"K2's cooperative launch of {too_many} CTAs was not refused")

    ms = cuda_ms(lambda: bini_fused.pcg(*args, active), 5)
    plain_ms = cuda_ms(lambda: bini_fused.pcg_plain(*args, active), 1)
    floor_iter = k2_floor_ms(dev, Bn, groups[0].cpl)
    print(f"K2 pcg: {ms:.4f} ms per solve, {1e3 * ms / max(its):.3f} us per CG iteration ({max(its)} iterations); "
          f"design floor {1e3 * floor_iter:.3f} us per iteration ({floor_iter * max(its):.4f} ms per solve)")
    err = max(err, err16)
    flops = 26.0 * H * W * sum(its)  # per pixel-iteration: stencil 15, three dots 6, updates 5
    nbytes = 4.0 * 7 * Bn * H * W  # ex, ey, pa, b, diag, x0 read once; x written once

    pf = bini.BiniParams(max_iter=10, cg_max_iter=1000)
    zf = bini_fused.bini_solve_fused(inp, pf)
    zr = bini_fused.bini_solve_fused_plain(inp, pf)
    err_f = float((zf - zr).abs().max())
    print(f"K2 bini_solve_fused (10 x {min(pf.cg_max_iter, bini_fused.PALLAS_CG_CAP)} CG, B={Bn} {H}x{W}): "
          f"max|kernel - plain| = {err_f:.3e} (tolerance {K2_TOL}); max|z - z0| {float((zr - inp.z0).abs().max()):.3e}")
    if not err_f <= K2_TOL:
        raise AssertionError(f"K2 fixed-budget solve disagrees with its plain version: {err_f}")

    # the same two checks must fail a kernel with a faulty halo at the seams of
    # one CTA a lane; the middle CTA's seams fall mid-row (W does not divide chunk)
    g0 = groups[0]
    cta, passed = g0.cpl // 2, []
    for kind in ("stale", "dropped"):
        with k2_seam_fault(kind, bini_fused.PCG_THREADS * g0.ppt, cta):
            xf, itf = bini_fused.pcg_plain(*args, active)
            zff = bini_fused.bini_solve_fused_plain(inp, pf)
        e_pcg, gap = float((xf - xr).abs().max()), int((itf - iters_r).abs().max())
        e_fix = float((zff - zr).abs().max())
        print(f"K2 checks vs a {kind} halo at CTA {cta}'s seams: PCG max|Δx| {e_pcg:.3e}, iterations up to "
              f"{gap} apart; fixed budget max|Δz| {e_fix:.3e} (tolerance {K2_TOL})")
        if (e_pcg <= K2_TOL and gap <= 1) or e_fix <= K2_TOL:
            passed.append(kind)
    if passed:
        raise AssertionError(f"K2's checks would pass a kernel with a {passed} halo at one seam")
    f_ms = cuda_ms(lambda: bini_fused.bini_solve_fused(inp, pf), 1)
    f_plain_ms = cuda_ms(lambda: bini_fused.bini_solve_fused_plain(inp, pf), 1)
    print(f"K2 bini_solve_fused: kernel {f_ms:.3f} ms, plain {f_plain_ms:.3f} ms")
    return dict(err=max(err, err_f), ms=ms, plain_ms=plain_ms, library_ms=None,
                ops_ms=flops / PEAK_F32 * 1e3, bytes_ms=nbytes / PEAK_BYTES * 1e3)


PLANE = dict(normal=(0.1, -0.05, 1.0), offset=4.5)  # the world plane n·X = offset of the consistent scenes


def plane_depth(bundle, c, rays):
    """Depth along rays (..., 3) (camera coordinates with z = 1) of the
    bundle's camera c to the world plane PLANE."""
    n = np.asarray(PLANE["normal"]) / np.linalg.norm(PLANE["normal"])
    R = _rotmat(bundle.quat[c].astype(np.float64))
    center = -R.T @ bundle.t[c].astype(np.float64)
    return (PLANE["offset"] - n @ center) / (rays @ (R @ n))  # X = center + d Rᵀ ray on the plane


def plane_depths(bundle, cams, H, W):
    """The depth maps (len(cams), H, W) of the plane PLANE rendered exactly
    into the bundle's cameras `cams` on an H×W grid."""
    K = grid_K(H, W).astype(np.float64)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    rays = np.stack([(xx - K[0, 2]) / K[0, 0], (yy - K[1, 2]) / K[1, 1], np.ones_like(xx)], -1)
    return np.stack([plane_depth(bundle, c, rays) for c in cams]).astype(np.float32)


def dc_phase(dev, bundle, H, W, shift=1.5):
    """The depth-consistency check on a consistent scene at the main path's
    grid: one world plane rendered exactly into 6 of the bundle's cameras
    (the main path's lanes 0-5), variances (5% of the depth)² ÷
    prior_std_multiplier², the query lane 0 against lanes 1-5. The score
    must stay below depth_cons_thresh, and exceed it once lane 1's depth is
    shifted by `shift` (tests/test_mapper_units.py's make_dc_rec). Returns
    (score, shifted score, wall ms of one check)."""
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.mapper.depth_consistency import _bundle_counts, bundle_score

    cams = np.linspace(0, bundle.quat.shape[0] - 1, 8).round().astype(int)[:6]
    depth = plane_depths(bundle, cams, H, W)
    var = ((depth * 0.05) ** 2).astype(np.float32) / np.float32(DC["psm"] ** 2)
    K = grid_K(H, W)
    images = [(depth[i], var[i], K, bundle.quat[c], bundle.t[c]) for i, c in enumerate(cams)]

    def score(imgs):
        args = convert.dc_inputs(imgs[0], imgs[1:], device=dev)
        return bundle_score(_bundle_counts(*args, DC["c"], DC["valid_thresh"]))

    score(images)  # warm-up
    t = time.perf_counter()
    s0 = score(images)
    ms = (time.perf_counter() - t) * 1e3
    shifted = list(images)
    shifted[1] = (depth[1] + np.float32(shift), *images[1][1:])
    s1 = score(shifted)
    line = (f"depth consistency on a plane seen by cameras {cams.tolist()} at {H}x{W}: score {s0:.4f}, "
            f"with lane 1's depth +{shift}: {s1:.4f} (threshold {DC['score_thresh']}); one check of 5 refs "
            f"{ms:.2f} ms wall")
    print(line)
    if not (s0 < DC["score_thresh"] < s1):
        raise AssertionError(f"depth consistency: {line}")
    return s0, s1, ms


def two_view_scene(bundle, cams, rng, n=TWO_VIEW_MATCHES):
    """Every pair of the bundle's cameras `cams`: n matches of points seen by
    both (pixels uniform in the first image, depth uniform in [4, 8]), with
    NOISE_PX of Gaussian noise and the first OUTLIERS·n second keypoints
    replaced by random pixels. Returns (pairs for
    estimate_two_view_geometry_batch, true (R, unit t) of cam2_from_cam1)."""
    cam = SimpleNamespace(fx=FOCAL, fy=FOCAL, cx=IMG_W / 2, cy=IMG_H / 2)
    wh = np.array([IMG_W, IMG_H])
    pairs, truth = [], []
    for i, c1 in enumerate(cams):
        for c2 in cams[i + 1:]:
            X = np.zeros((0, 3))
            while len(X) < n:
                px = rng.uniform(0, wh, size=(4 * n, 2))
                Xw = _lift(bundle, c1, px, rng.uniform(4.0, 8.0, 4 * n))
                p2, z2 = _project(bundle, c2, Xw)
                X = np.concatenate([X, Xw[(z2 > 0.1) & (p2 >= 0).all(-1) & (p2 < wh).all(-1)]])
            X = X[:n]
            k1 = _project(bundle, c1, X)[0] + rng.normal(scale=NOISE_PX, size=(n, 2))
            k2 = _project(bundle, c2, X)[0] + rng.normal(scale=NOISE_PX, size=(n, 2))
            k2[:int(OUTLIERS * n)] = rng.uniform(0, wh, size=(int(OUTLIERS * n), 2))
            pairs.append((cam, cam, k1, k2, np.stack([np.arange(n)] * 2, -1)))
            R1, R2 = _rotmat(bundle.quat[c1]), _rotmat(bundle.quat[c2])
            R = R2 @ R1.T
            t = bundle.t[c2] - R @ bundle.t[c1]
            truth.append((R, t / np.linalg.norm(t)))
    return pairs, truth


def pnp_scene(bundle, c, rng, planar, n=PNP_MATCHES):
    """n 2D-3D matches of the bundle's camera c: points at pixels uniform in
    the image, at depths uniform in [4, 8] or on one world plane, NOISE_PX of
    noise on the keypoints, the first OUTLIERS·n keypoints random. Returns
    (xyz (n, 3), normalized keypoints (n, 2)), float32."""
    wh = np.array([IMG_W, IMG_H])
    px = rng.uniform(0, wh, size=(n, 2))
    if planar:
        d = plane_depth(bundle, c, np.concatenate([(px - wh / 2) / FOCAL, np.ones((n, 1))], -1))
    else:
        d = rng.uniform(4.0, 8.0, n)
    X = _lift(bundle, c, px, d)
    kp = _project(bundle, c, X)[0] + rng.normal(scale=NOISE_PX, size=(n, 2))
    kp[:int(OUTLIERS * n)] = rng.uniform(0, wh, size=(int(OUTLIERS * n), 2))
    return X.astype(np.float32), ((kp - wh / 2) / FOCAL).astype(np.float32)


def _lift(bundle, c, px, d):
    R, t = _rotmat(bundle.quat[c]), bundle.t[c]
    xc = np.stack([(px[:, 0] - IMG_W / 2) / FOCAL * d, (px[:, 1] - IMG_H / 2) / FOCAL * d, d], -1)
    return (xc - t) @ R


def _project(bundle, c, X):
    p = X @ _rotmat(bundle.quat[c]).T + bundle.t[c]
    return p[:, :2] / p[:, 2:] * FOCAL + np.array([IMG_W / 2, IMG_H / 2]), p[:, 2]


def _angle_deg(R1, R2):
    return float(np.rad2deg(np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1.0, 1.0))))


def _dir_deg(a, b):
    return float(np.rad2deg(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1.0, 1.0))))


def library_solvers(dev, n):
    """Times of the library solvers behind two-view verification at its
    shapes: the complete QR of the n transposed minimal systems (9×8) of the
    essential or the homography hypotheses, and the batched eigh of 3×3
    matrices at EIGH_CHUNK; and whether the library takes 2·EIGH_CHUNK in
    one call (cuSOLVER 12.8 refuses it, so geometry.linalg.eigh chunks)."""
    import torch

    from mpsfm_tpu_torch.geometry.linalg import EIGH_CHUNK

    g = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn(n, 9, 8, device=dev, generator=g)
    qr_ms = cuda_ms(lambda: torch.linalg.qr(A, mode="complete"), 1)
    M = torch.randn(2 * EIGH_CHUNK, 3, 3, device=dev, generator=g)
    S = M @ M.transpose(-1, -2)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(S[:EIGH_CHUNK]), 3)
    try:
        torch.linalg.eigh(S)
        torch.cuda.synchronize()
        big = "taken"
    except RuntimeError as e:
        big = f"refused ({str(e)[:60]})"
    print(f"library solvers: torch.linalg.qr(mode='complete') of {n} 9x8 matrices {qr_ms:.1f} ms; torch.linalg.eigh "
          f"of {EIGH_CHUNK} 3x3 matrices {eigh_ms:.3f} ms; of {2 * EIGH_CHUNK} in one call: {big}")


def estimators_phase(dev, bundle, rng):
    """Two-view verification of the 66 pairs of TWO_VIEW_CAMS of the
    bundle's cameras and PnP of camera 6 on points in general position and
    on one plane, with the mapper's budget of NUM_HYP hypotheses, through
    the port's entry points on the card (wall time after a warm-up), against
    the truth and against the CPU with the same samples. Returns a dict of
    the wall times."""
    import torch

    from mpsfm_tpu_torch.estimators.ransac import ransac_pnp, sample_indices
    from mpsfm_tpu_torch.estimators.two_view import (
        TwoViewConfig,
        _estimate_pair,
        estimate_two_view_geometry_batch,
    )

    n_out = int(OUTLIERS * TWO_VIEW_MATCHES)
    pairs, truth = two_view_scene(bundle, np.arange(TWO_VIEW_CAMS), rng)
    gen = torch.Generator().manual_seed(SEED)  # on the CPU: the same samples for the card and the CPU
    valid = torch.ones(TWO_VIEW_MATCHES, dtype=torch.bool)
    idx = [(sample_indices(gen, NUM_HYP, 8, valid), sample_indices(gen, NUM_HYP, 4, valid)) for _ in pairs]
    estimate_two_view_geometry_batch(pairs, MAX_ERROR_PX, NUM_HYP, indices=idx, device=dev)  # warm-up
    t = time.perf_counter()
    tvg = estimate_two_view_geometry_batch(pairs, MAX_ERROR_PX, NUM_HYP, indices=idx, device=dev)
    times = {"two_view_ms": (time.perf_counter() - t) * 1e3}
    rot = np.array([_angle_deg(_rotmat(g.pose.quat.astype(np.float64)), R) for g, (R, _) in zip(tvg, truth)])
    tra = np.array([_dir_deg(g.pose.t.astype(np.float64), tt) for g, (_, tt) in zip(tvg, truth)])
    recall = np.array([(g.inlier_matches[:, 0] >= n_out).sum() / (TWO_VIEW_MATCHES - n_out) for g in tvg])
    configs = [g.config for g in tvg]
    strict = int(((rot <= 1.0) & (tra <= 2.0) & (recall >= 0.9)).sum())
    line = (f"two-view verification, {len(pairs)} pairs x {TWO_VIEW_MATCHES} matches ({NOISE_PX} px noise, "
            f"{OUTLIERS:.0%} outliers), {NUM_HYP} hypotheses: {times['two_view_ms']:.1f} ms wall; "
            f"{configs.count(TwoViewConfig.CALIBRATED)} CALIBRATED; rotation error median {np.median(rot):.3f} max "
            f"{rot.max():.3f} deg, translation direction median {np.median(tra):.3f} max {tra.max():.3f} deg, "
            f"true-inlier recall median {np.median(recall):.4f} min {recall.min():.4f}; "
            f"{strict} pairs within 1 deg, 2 deg and 90%")
    print(line)
    # every pair CALIBRATED; the median pair within 1 deg, 2 deg and 90% of the true inliers; no
    # pair off by more than 5 deg of rotation or below half the true inliers (a fixed budget with
    # one local refit, as the JAX package's, misses the per-pair bounds on some pairs: PERF.md)
    if not (all(c == TwoViewConfig.CALIBRATED for c in configs) and np.median(rot) <= 1.0
            and np.median(tra) <= 2.0 and np.median(recall) >= 0.9 and rot.max() <= 5.0 and recall.min() >= 0.5):
        raise AssertionError(f"two-view verification against the truth: {line}")

    library_solvers(dev, len(pairs) * NUM_HYP)

    # card vs CPU on the same samples, through the batched core (which returns the winning hypothesis)
    xy = [torch.as_tensor(np.stack([(p[k] - [IMG_W / 2, IMG_H / 2]) / FOCAL for p in pairs]), dtype=torch.float32)
          for k in (2, 3)]
    thr = torch.full((len(pairs),), (MAX_ERROR_PX / FOCAL) ** 2)
    core = [torch.stack([i[k] for i in idx]) for k in (0, 1)]
    vmask = torch.ones(len(pairs), TWO_VIEW_MATCHES, dtype=torch.bool)
    outs = [_estimate_pair(*(a.to(d) for a in (*core, *xy, vmask, thr, thr))) for d in (dev, "cpu")]
    g, c = ({k: (v.cpu() if torch.is_tensor(v) else type(v)(*(f.cpu() for f in v))) for k, v in o.items()} for o in outs)
    same = g["best"] == c["best"]
    n_gap = float(((g["num_inliers"] - c["num_inliers"]).abs() / c["num_inliers"]).max())
    pose_gap = max([float((g["pose"][k] - c["pose"][k])[same].abs().max()) for k in (0, 1) if same.any()] + [0.0])
    line = (f"two-view card vs CPU, same samples: configs {'equal' if torch.equal(g['config'], c['config']) else 'DIFFER'}, "
            f"best hypothesis the same on {int(same.sum())} of {len(pairs)} pairs, inlier counts within "
            f"{n_gap:.4%} (tolerance 1%), poses within {pose_gap:.3e} where the best is the same (tolerance 1e-3)")
    print(line)
    if not (torch.equal(g["config"], c["config"]) and n_gap <= 0.01 and pose_gap <= 1e-3):
        raise AssertionError(line)

    cam = 6
    Rt, tt = _rotmat(bundle.quat[cam]), bundle.t[cam].astype(np.float64)
    baseline = float(np.linalg.norm(Rt.T @ tt - _rotmat(bundle.quat[0]).T @ bundle.t[0]))  # centres of cameras 6 and 0
    n_out = int(OUTLIERS * PNP_MATCHES)
    for planar in (False, True):
        xyz, xyn = pnp_scene(bundle, cam, rng, planar)
        valid = torch.ones(PNP_MATCHES, dtype=torch.bool)
        pidx = sample_indices(torch.Generator().manual_seed(SEED), NUM_HYP, 6, valid)
        args = {d: [torch.as_tensor(a, device=d) for a in (pidx, xyz, xyn, valid)] + [(MAX_ERROR_PX / FOCAL) ** 2]
                for d in (dev, "cpu")}
        ransac_pnp(*args[dev])  # warm-up
        t = time.perf_counter()
        o = ransac_pnp(*args[dev])
        int(o["num_inliers"])
        what = "coplanar" if planar else "general"
        times[f"pnp_{what}_ms"] = (time.perf_counter() - t) * 1e3
        oc = ransac_pnp(*args["cpu"])
        rot_err = _angle_deg(_rotmat(o["pose"].quat.cpu().double().numpy()), Rt)
        t_err = float(np.linalg.norm(o["pose"].t.cpu().double().numpy() - tt))
        rec = float(o["inlier_mask"].cpu()[n_out:].double().mean())
        n_gap = abs(int(o["num_inliers"]) - int(oc["num_inliers"])) / int(oc["num_inliers"])
        pose_gap = max(float((o["pose"].quat.cpu() - oc["pose"].quat).abs().max()),
                       float((o["pose"].t.cpu() - oc["pose"].t).abs().max()))
        same = int(o["best"]) == int(oc["best"])
        line = (f"PnP ({what} points), {PNP_MATCHES} matches, {NUM_HYP} samples x 2 hypotheses: "
                f"{times[f'pnp_{what}_ms']:.1f} ms wall; rotation error {rot_err:.4f} deg, |Δt| {t_err:.4g} "
                f"({t_err / baseline:.3%} of the baseline {baseline:.3f}), true-inlier recall {rec:.4f}; card vs CPU: "
                f"best {'the same' if same else 'DIFFERENT'}, inliers within {n_gap:.3%}, poses within {pose_gap:.3e}")
        print(line)
        if not (rot_err <= 1.0 and t_err <= 0.01 * baseline and rec >= 0.9 and n_gap <= 0.01
                and (pose_gap <= 1e-3 or not same)):
            raise AssertionError(line)
    return times


def scene_reconstruction(bundle, cams, quat, t):
    """A port Reconstruction of the bundle's cameras `cams`: one 640×480
    HostCamera; image c's keypoints are its observations (r_uv, keypoint k
    of every image sees point k), registered at pose (quat[c], t[c]),
    cam_from_world. No point yet."""
    from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Pose, Reconstruction

    P = bundle.xyz.shape[0]
    rec = Reconstruction()
    rec.add_camera(HostCamera(1, np.array([FOCAL, FOCAL, IMG_W / 2, IMG_H / 2]), int(IMG_W), int(IMG_H)))
    for c in cams:
        im = ImageRecord(int(c), f"im{int(c):03d}.jpg", 1)
        im.keypoints = bundle.r_uv[c * P:(c + 1) * P].astype(np.float64)
        im.point3D_ids = np.full(P, -1, np.int64)
        q = np.asarray(quat[c], np.float64)
        im.pose = Pose(q / np.linalg.norm(q), np.asarray(t[c], np.float64))
        im.registered = True
        rec.add_image(im)
    return rec


def scene_invariants(rec, what):
    """The pool and the images agree: the observation table holds alive
    points only, each observation is its image's point3D_ids entry, and the
    observation count equals the track lengths' sum and the images' count
    of assigned keypoints. Returns the observation count."""
    o_pid, o_im, o_kp = rec.observations()
    alive = rec.point_ids()
    held = sum(int((im.point3D_ids >= 0).sum()) for im in rec.images.values())
    ok = (len(o_pid) == int(rec.track_len[alive].sum()) == held and rec.num_points3D() == len(alive)
          and bool(rec.alive[o_pid].all())
          and all(np.array_equal(rec.images[int(i)].point3D_ids[o_kp[o_im == i]], o_pid[o_im == i])
                  for i in np.unique(o_im)))
    if not ok:
        raise AssertionError(f"scene state after {what}: {len(o_pid)} observations, track lengths sum to "
                             f"{int(rec.track_len[alive].sum())}, {held} keypoints hold a point")
    return len(o_pid)


def scene_state_phase(bundle, quat, t, xyz, rng):
    """(a) The scene state at the bench bundle's size: every point with a
    track through every image, then the passes of the mapper's host state,
    each timed on the host clock; invariants after each. Returns the times."""
    C, P = quat.shape[0], xyz.shape[0]
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        times[name] = time.perf_counter() - t0
        return r

    rec = timed("images", lambda: scene_reconstruction(bundle, range(C), quat, t))
    pids = timed("add_points", lambda: [rec.add_point3D(xyz[k], [(c, k) for c in range(C)]) for k in range(P)])
    if pids != list(range(P)) or scene_invariants(rec, "adding the points") != C * P:
        raise AssertionError(f"adding {P} points of {C} observations each")
    obs = timed("observations", rec.observations)
    if len(obs[0]) != C * P:
        raise AssertionError(f"observations: {len(obs[0])}, not {C * P}")
    ang = timed("triangulation_angles", lambda: rec.triangulation_angles(rec.point_ids()))
    if not (np.isfinite(ang).all() and (ang > 0).all()):
        raise AssertionError("a triangulation angle is not finite and positive")
    changed = timed("filter_points3D", lambda: rec.filter_points3D(*SCENE_FILTER, rec.point_ids()))
    n_filtered = scene_invariants(rec, "filter_points3D")
    local = timed("find_local_bundle_ids", lambda: rec.find_local_bundle_ids(0))
    if len(local) != 5 or 0 in local:
        raise AssertionError(f"local bundle of image 0: {local}")
    last = rec.images[C - 1]
    n_last = last.num_points3D()
    dying = int((rec.track_len[last.point3D_ids[last.point3D_ids >= 0]] == 2).sum())  # their other observation goes too
    timed("deregister_image", lambda: rec.deregister_image(C - 1))
    n_obs = scene_invariants(rec, "deregister_image")
    if last.registered or last.num_points3D() or n_obs != n_filtered - n_last - dying:
        raise AssertionError(f"deregistering image {C - 1} ({n_last} observations)")
    alive = rec.point_ids()
    victims = rng.choice(alive, int(SCENE_REDO * len(alive)), replace=False)
    saved = [(rec.xyz[p].copy(), rec.tracks[p]) for p in victims]
    timed("delete_points", lambda: [rec.delete_point3D(int(p)) for p in victims])
    if rec.num_points3D() != len(alive) - len(victims):
        raise AssertionError("deleting points")
    scene_invariants(rec, "delete_point3D")
    new = timed("readd_points", lambda: [rec.add_point3D(x, tr) for x, tr in saved])
    if new != [int(p) for p in victims[::-1]] or scene_invariants(rec, "re-adding") != n_obs:
        raise AssertionError("the re-added points did not take the freed ids, last freed first")
    px0 = rec.project_points_into_image(0, rec.point_ids())[0]
    scale = timed("normalize", rec.normalize)
    px1 = rec.project_points_into_image(0, rec.point_ids())[0]
    gap = float(np.abs(px1 - px0).max())
    if not (np.isfinite(scale) and scale > 0 and gap <= 1e-6):
        raise AssertionError(f"normalize: scale {scale}, pixels moved by {gap}")
    print(f"scene state: {C} images x {P} points, {C * P} observations in the native store; filter_points3D at "
          f"{SCENE_FILTER[0]} px and {SCENE_FILTER[1]} deg changed {changed} observations; triangulation angle median "
          f"{np.median(ang):.2f} deg; local bundle of image 0 {local}; {len(victims)} points deleted and re-added into "
          f"their ids; normalize scale {scale:.4f}, pixels within {gap:.2e}")
    for name, sec in times.items():
        print(f"scene state {name}: {sec:.4f} s wall")
    return times


def store_parity_phase(bundle, quat, t, xyz, cams, seed):
    """(b) The native track store against the plain one (PyTrackStore, put
    in before any point) under the same op sequence on the first `cams`
    images: add every point, filter, deregister an image, delete and re-add
    a tenth of the points, remove and re-add observations. Their xyz,
    alive, track_len, point3D_ids, tracks and observations must be equal.
    Returns the two runs' times."""
    from mpsfm_tpu_torch import native
    from mpsfm_tpu_torch.scene.reconstruction import PyTrackStore

    P = xyz.shape[0]
    recs, times = [], []
    for plain in (False, True):
        rng = np.random.default_rng(seed)
        rec = scene_reconstruction(bundle, range(cams), quat, t)
        if plain:
            rec._store = PyTrackStore()
        t0 = time.perf_counter()
        for k in range(P):
            rec.add_point3D(xyz[k], [(c, k) for c in range(cams)])
        rec.filter_points3D(*SCENE_FILTER, rec.point_ids())
        rec.deregister_image(cams - 1)
        victims = rng.choice(rec.point_ids(), int(SCENE_REDO * rec.num_points3D()), replace=False)
        saved = [(rec.xyz[p].copy(), rec.tracks[p]) for p in victims]
        for p in victims:
            rec.delete_point3D(int(p))
        for x, tr in saved:
            rec.add_point3D(x, tr)
        removed = []
        for p in rng.choice(rec.point_ids(), P // 4, replace=False):
            tr = rec.tracks[p]
            imid, kp = tr[rng.integers(0, len(tr))]
            removed.append((int(p), imid, kp, len(tr) > 2))
            rec.remove_observation(int(p), imid, kp)
        for p, imid, kp, kept in removed:
            if kept:
                rec.add_observation(p, imid, kp)
        times.append(time.perf_counter() - t0)
        recs.append(rec)
    nat, py = recs
    if not isinstance(nat._store, native.NativeTrackStore) or not isinstance(py._store, PyTrackStore):
        raise AssertionError("store parity: the stores are not the native and the plain one")
    same = (np.array_equal(nat.xyz, py.xyz) and np.array_equal(nat.alive, py.alive)
            and np.array_equal(nat.track_len, py.track_len)
            and all(np.array_equal(nat.images[i].point3D_ids, py.images[i].point3D_ids) for i in nat.images)
            and np.array_equal(nat.point_ids(), py.point_ids())
            and all(nat.tracks[p] == py.tracks[p] for p in nat.point_ids())
            and all(np.array_equal(a, b) for a, b in zip(nat.observations(), py.observations())))
    line = (f"track store, native vs plain (PyTrackStore), {cams} images x {P} points, the same op sequence: "
            f"{'equal' if same else 'DIFFERENT'} state ({nat.num_points3D()} points, "
            f"{len(nat.observations()[0])} observations)")
    print(line)
    print(f"track store op sequence, native: {times[0]:.4f} s wall")
    print(f"track store op sequence, plain: {times[1]:.4f} s wall")
    if not same:
        raise AssertionError(line)
    return times


@contextlib.contextmanager
def fixed_draws(indices):
    """Correspondences.populate verifies with the given RANSAC samples (a
    list, per pair, of (idx_e, idx_h)) in place of its device's generator's."""
    import mpsfm_tpu_torch.scene.correspondences as corr

    estimate = corr.estimate_two_view_geometry_batch
    corr.estimate_two_view_geometry_batch = lambda pairs, **kw: estimate(pairs, indices=indices, **kw)
    try:
        yield
    finally:
        corr.estimate_two_view_geometry_batch = estimate


def verification_phase(dev, bundle, rng, cams=TWO_VIEW_CAMS, n=TWO_VIEW_MATCHES):
    """(c) Geometric verification through Correspondences.populate on `dev`
    for the first `cams` cameras: keypoints are the bundle's observations;
    each pair gets n matches of shared points, OUTLIERS of them with the
    second image's keypoint id replaced by a random one. Wall time after a
    warm-up. Held: every pair CALIBRATED, the median pair within 1 deg of
    rotation and 90% of the true inliers, the correspondence graph equal to
    each pair's inlier matches and inlier_match_scores to their counts; and
    populate on `dev` against populate on the CPU with the same samples:
    the same configs, inlier counts within 1%. The translation direction
    and the worst pair are printed, not held: on these points the
    reference's algorithm (one local refit of a fixed budget) misses
    estimators_phase's per-pair bounds, as the JAX package does on the
    same samples (PERF.md). Returns the wall seconds."""
    import torch

    from mpsfm_tpu_torch.estimators.ransac import sample_indices
    from mpsfm_tpu_torch.estimators.two_view import TwoViewConfig
    from mpsfm_tpu_torch.scene.correspondences import Correspondences

    P = bundle.xyz.shape[0]
    rec = scene_reconstruction(bundle, range(cams), bundle.quat, bundle.t)
    names = {c: rec.images[c].name for c in range(cams)}
    keypoints = {names[c]: rec.images[c].keypoints for c in range(cams)}
    matches, truth = {}, {}
    for i in range(cams):
        for j in range(i + 1, cams):
            ids = rng.choice(P, n, replace=False)
            m = np.stack([ids, ids], -1)
            n_out = int(OUTLIERS * n)
            m[:n_out, 1] = rng.integers(0, P, n_out)
            matches[(names[i], names[j])] = m
            R1, R2 = _rotmat(bundle.quat[i]), _rotmat(bundle.quat[j])
            R = R2 @ R1.T
            tt = bundle.t[j] - R @ bundle.t[i]
            truth[(i, j)] = (R, tt / np.linalg.norm(tt))
    Correspondences({}, rec, device=dev).populate(keypoints, matches)  # warm-up
    corr = Correspondences({}, rec, device=dev)
    t0 = time.perf_counter()
    corr.populate(keypoints, matches)
    wall = time.perf_counter() - t0
    pairs = corr.image_pairs()
    rot, tra, recall, configs, graph_ok = [], [], [], [], True
    for (i, j) in pairs:
        g = corr.two_view_geom_by_ids(i, j)
        m = matches[(names[i], names[j])]
        R, tt = truth[(i, j)]
        rot.append(_angle_deg(_rotmat(np.asarray(g.pose.quat, np.float64)), R))
        tra.append(_dir_deg(np.asarray(g.pose.t, np.float64), tt))
        inl = g.inlier_matches
        recall.append((inl[:, 0] == inl[:, 1]).sum() / (m[:, 0] == m[:, 1]).sum())
        configs.append(g.config)
        graph_ok &= (np.array_equal(corr.matches(i, j), inl)
                     and corr.inlier_match_scores[frozenset((i, j))] == float(len(inl)))
    rot, tra, recall = map(np.array, (rot, tra, recall))
    line = (f"geometric verification, Correspondences.populate on {dev}: {len(pairs)} pairs of {cams} images x {n} "
            f"matches ({OUTLIERS:.0%} outliers), {configs.count(TwoViewConfig.CALIBRATED)} CALIBRATED; rotation "
            f"error median {np.median(rot):.3f} max {rot.max():.3f} deg, translation direction median "
            f"{np.median(tra):.3f} max {tra.max():.3f} deg, true-inlier recall median {np.median(recall):.4f} min "
            f"{recall.min():.4f}; {int(((rot <= 1.0) & (tra <= 2.0) & (recall >= 0.9)).sum())} pairs within 1 deg, "
            f"2 deg and 90%; correspondence graph {'holds' if graph_ok else 'DIFFERS FROM'} the inlier matches and "
            f"scores")
    print(line)
    print(f"geometric verification (populate, {len(pairs)} pairs): {wall:.4f} s wall")
    if not (len(pairs) == cams * (cams - 1) // 2 and graph_ok and corr.cg.finalized
            and all(c == TwoViewConfig.CALIBRATED for c in configs) and np.median(rot) <= 1.0
            and np.median(recall) >= 0.9):
        raise AssertionError(f"geometric verification: {line}")

    gen = torch.Generator().manual_seed(SEED)  # on the CPU: the same samples for both devices
    valid = torch.ones(n, dtype=torch.bool)
    idx = [(sample_indices(gen, NUM_HYP, 8, valid), sample_indices(gen, NUM_HYP, 4, valid)) for _ in matches]
    runs = [Correspondences({}, rec, device=d) for d in (dev, "cpu")]
    with fixed_draws(idx):
        for r in runs:
            r.populate(keypoints, matches)
    g, c = ([r.two_view_geom_by_ids(*p) for p in pairs] for r in runs)
    same_config = all(a.config == b.config for a, b in zip(g, c))
    n_gap = max(abs(a.num_inliers - b.num_inliers) / b.num_inliers for a, b in zip(g, c))
    same_inl = sum(np.array_equal(a.inlier_matches, b.inlier_matches) for a, b in zip(g, c))
    line = (f"geometric verification, populate on {dev} vs the CPU with the same samples: configs "
            f"{'equal' if same_config else 'DIFFER'}, inlier counts within {n_gap:.4%} (tolerance 1%), the same "
            f"inlier matches on {same_inl} of {len(pairs)} pairs")
    print(line)
    if not (same_config and n_gap <= 0.01):
        raise AssertionError(line)
    return wall


def cov_store_phase(cov):
    """(d) The point covariances' store (LazyCovDict) with the card's
    tensor: device_view() hands back that same tensor without a host read,
    a pop reads nothing either, and every point_covs[pid] then equals the
    tensor's row read to the host. Returns the first host access's wall
    seconds (the one read)."""
    from mpsfm_tpu_torch.scene.reconstruction import LazyCovDict

    P = cov.shape[0]
    point_covs = LazyCovDict()
    point_covs.set_pending(cov, np.arange(P))
    view = point_covs.device_view()
    slots = point_covs.slots_for(np.arange(P))
    point_covs.pop(7, None)  # a deleted point, as Reconstruction._clear_slot pops it
    unread = bool(point_covs._pendings)
    t0 = time.perf_counter()
    n = len(point_covs)  # the first host access: one read of the tensor
    read_s = time.perf_counter() - t0
    ref = cov.cpu().double().numpy()
    keep = np.arange(P) != 7
    host = np.stack([point_covs[int(p)] for p in np.flatnonzero(keep)])
    ok = (view[0] is cov and view[0].device == cov.device and np.array_equal(slots, np.arange(P)) and unread
          and n == P - 1 and 7 not in point_covs and np.array_equal(host, ref[keep]))
    line = (f"point covariances' store: {P} covariances on {cov.device} parked; device_view the same tensor, no host "
            f"read before the first access; {'every entry equal to' if ok else 'DIFFERENT from'} the tensor's rows")
    print(line)
    print(f"point covariances' store, first host access (one read of {P}x3x3): {read_s:.4f} s wall")
    if not ok:
        raise AssertionError(line)
    return read_s


def scene_phase(dev, bundle, out, rng, cams=TWO_VIEW_CAMS, n_matches=TWO_VIEW_MATCHES):
    """The scene's host state (slice 5a): (a) a Reconstruction of the bundle
    at the main path's refined poses and points, (b) the native store
    against the plain one, (c) geometric verification through
    Correspondences.populate on `dev`, (d) the covariance store with the
    main path's covariances. Returns a dict of the wall times."""
    quat, t, xyz = (out[k].cpu().double().numpy() for k in ("quat", "t", "xyz"))
    times = {f"scene_{k}_s": v for k, v in scene_state_phase(bundle, quat, t, xyz, rng).items()}
    times["store_native_s"], times["store_plain_s"] = store_parity_phase(bundle, quat, t, xyz, cams, SEED + 3)
    times["populate_s"] = verification_phase(dev, bundle, rng, cams, n_matches)
    times["cov_read_s"] = cov_store_phase(out["cov"])
    return times


# ---- the scene refinement phase (slices 5b and the front of 6a) ----

def bench_points(n_pts, seed=SEED):
    """The bench bundle's true points (synthetic_bundle's first draws,
    before their noise)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 9, n_pts)], -1)


def refine_scene(bundle, B, H, W, device, seed=SEED):
    """A port Reconstruction of the bundle on `device`: every image
    registered at the bundle's pose, keypoint k of every image observing
    point k (at the bundle's noisy xyz), the camera's integration grid
    H×W; and ImagePriors (the main path's conf) on B images spread over
    the bundle, activated. Image b's depth prior is the plane fitted (in
    inverse depth) to its true points' depths, times a scale error in
    [0.9, 1.1] and 3% log-normal noise, with a 5% std; its normals are the
    plane's, with a 2° std. Returns (rec, pris, truth): truth[imid] the
    true points' depths in the image (keypoint order)."""
    from mpsfm_tpu_torch.scene.image_priors import ImagePriors

    rng = np.random.default_rng(seed + 5)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    rec = scene_reconstruction(bundle, range(C), bundle.quat, bundle.t)
    cam = rec.cameras[1]
    cam.int_width, cam.int_height = W, H
    lanes = np.linspace(0, C - 1, B).round().astype(int)
    for k in range(P):
        rec.add_point3D(bundle.xyz[k].astype(np.float64), [(c, k) for c in range(C)])
    fx, fy, cx, cy = FOCAL * cam.sx, FOCAL * cam.sy, IMG_W / 2 * cam.sx, IMG_H / 2 * cam.sy
    xs, ys = np.meshgrid((np.arange(W) + 0.5 - cx) / fx, (np.arange(H) + 0.5 - cy) / fy)
    pts = bench_points(P, seed)
    pris, truth = [], {}
    for c in lanes:
        pose = rec.images[c].pose
        z = pose.transform(pts)[:, 2]
        truth[int(c)] = z
        uv = (rec.images[c].keypoints - [IMG_W / 2, IMG_H / 2]) / FOCAL
        abc = np.linalg.lstsq(np.c_[uv, np.ones(P)], 1.0 / z, rcond=None)[0]  # 1/z = a·x + b·y + c
        plane = 1.0 / np.clip(abc[0] * xs + abc[1] * ys + abc[2], 1e-3, None)
        prior = plane * rng.uniform(0.9, 1.1) * np.exp(rng.normal(scale=0.03, size=plane.shape))
        n = -abc / np.linalg.norm(abc)
        pri = ImagePriors(
            {}, rec, int(c),
            depth_dict={"depth": prior, "depth_variance": (0.05 * prior) ** 2},
            normals_dict={"normals": np.broadcast_to(n, (H, W, 3)).copy(),
                          "normals_variance": np.full((H, W), (np.pi / 180 * 2) ** 2)},
            device=device,
        )
        im = rec.images[int(c)]
        im.priors, im.depth, im.normals = pri, pri.depth, pri.normals
        pri.depth.activate()
        pris.append(pri)
    return rec, pris, truth


def global_bundle(rec):
    """The mapper's global bundle (mapper/mapper.py:find_global_bundle)."""
    return {"optim_ids": set(rec.reg_image_ids()), "pts3D": set(rec.point_ids().tolist()), "constpoints": set()}


def local_bundle(rec, ref, n=5):
    """The mapper's local bundle of image ref (find_local_bundle)."""
    optim_ids = set(rec.find_local_bundle_ids(ref, n)) | {ref}
    pts = set()
    for imid in optim_ids:
        ids = rec.images[imid].point3D_ids
        pts.update(ids[ids >= 0].tolist())
    ids = rec.images[ref].point3D_ids
    own = set(ids[ids >= 0].tolist())
    return {"ref_id": ref, "optim_ids": optim_ids, "pts3D": own, "constpoints": pts - own}


def run_scene_refinement(rec, pris, device, times=None, opt_conf=None):
    """The refinement steps of the JAX package's Mapper.adjust_bundle with
    int_covs on, through the port's entry points on `device`: point
    covariances; a global step (integrate_bundle_deferred over every
    prior lane; more than 2 lanes, so finalize_integration, then
    int_covs_bundle_batched on the changed lanes; Optimizer.ba_fused with
    update_trunc); a local step of one image (integrate_bundle_deferred,
    int_covs_bundle_deferred, ba_fused with the chained variances); then
    optimize_prior_shiftscale, Depth.rescale and refine_3d_points. `times`
    (a dict) collects each entry point's wall seconds, the host
    build_ba_data passes apart; opt_conf is the Optimizer's conf (the main
    path's by default). Returns what the checks read."""
    import torch

    from mpsfm_tpu_torch.mapper.optimizer import Optimizer
    from mpsfm_tpu_torch.scene import image_priors as ip
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    times = {} if times is None else times
    dev = torch.device(device)
    opt = Optimizer(opt_conf or {}, rec, device=dev)
    TIMERS.reset()

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0
        return r

    out = {"unc0": {p.imid: np.array(p.depth.uncertainty_update) for p in pris}}
    bundle = global_bundle(rec)
    timed("calculate_point_covs", opt.calculate_point_covs, bundle)
    out["cov"] = rec.point_covs.device_view()[0]
    out["slots"] = rec.point_covs.slots_for(rec.point_ids())
    handles, pending = timed("integrate_bundle_deferred", ip.integrate_bundle_deferred, pris)
    changed = timed("finalize_integration", ip.finalize_integration, pending)
    out["changed"] = changed
    out["z"] = {p.imid: handles[p.imid][0][handles[p.imid][1]] for p in pris}
    need = [p for p in pris if changed[p.imid]]
    timed("int_covs_bundle_batched", ip.int_covs_bundle_batched, need)
    out["unc1"] = {p.imid: np.array(p.depth.uncertainty_update) for p in pris}

    def z_getter(h):
        return lambda imid: (h[imid][0][h[imid][1]], 0.0) if imid in h else rec.images[imid].priors._z0_shift_dev()

    out["ba_global"] = timed("ba_fused_global", opt.ba_fused, bundle, "global", z_getter(handles),
                             allow_scale_filter=True, update_trunc=True)
    out["device_resident"] = {p.imid: p.depth._data is None and p.depth._data_dev is not None for p in need}
    out["trunc"] = opt.truncation_multiplier

    ref = pris[len(pris) // 2]
    lb = local_bundle(rec, ref.imid)
    handles, pending = timed("integrate_bundle_deferred_local", ip.integrate_bundle_deferred, [ref])
    info_map = {p.imid: (info, k) for g, _z, info in pending for k, p in enumerate(g)}
    unc_over, pending_covs = timed("int_covs_bundle_deferred", ip.int_covs_bundle_deferred, [ref], handles,
                                   info_map)
    out["ba_local"] = timed("ba_fused_local", opt.ba_fused, lb, "local", z_getter(handles), pending=pending,
                            allow_scale_filter=True, unc_overrides=unc_over, pending_covs=pending_covs)

    shift_scale, ok = timed("optimize_prior_shiftscale", opt.optimize_prior_shiftscale, bundle)
    t0 = time.perf_counter()
    for imid, (shift, scale) in shift_scale.items():
        rec.images[imid].depth.rescale(shift, scale)
    times["rescale"] = time.perf_counter() - t0
    out["shift_scale"] = shift_scale
    out["refine"] = timed("refine_3d_points", opt.refine_3d_points, bundle)
    times["build_ba_data (ba_fused, refine_3d_points)"] = TIMERS.totals["ba.build_data"]
    times["build_ba_data (calculate_point_covs)"] = TIMERS.totals["point_covs.build"]
    out["quat"] = np.stack([rec.images[i].pose.q for i in sorted(rec.images)])
    out["t"] = np.stack([rec.images[i].pose.t for i in sorted(rec.images)])
    out["xyz"] = rec.xyz[rec.point_ids()].copy()
    out["unc"] = {p.imid: np.array(p.depth.uncertainty_update) for p in pris}
    return out


def check_scene_refinement(out, rec, pris, truth, bundle):
    """The scene refinement phase's checks; raises on the first that
    fails. Returns numbers to print."""
    cov = out["cov"].double().cpu().numpy()
    asym = np.abs(cov - cov.transpose(0, 2, 1)).max() / np.abs(cov).max()
    if not (np.isfinite(cov).all() and asym < 1e-5 and (np.einsum("pii->pi", cov) > 0).all()):
        raise AssertionError(f"scene covariances not finite, symmetric ({asym}) or with a positive diagonal")
    if not (out["slots"] >= 0).all():  # else the anchors take the default covariance (slot -1) silently
        raise AssertionError(f"{int((out['slots'] < 0).sum())} points have no slot in the parked covariances")
    for k in ("ba_global", "ba_local", "refine"):
        info, ok = out[k]
        if not (ok and info["cost"] < info["cost0"] and info["accepted"] >= 1):
            raise AssertionError(f"{k}: {info}, success {ok}")
    C = bundle.quat.shape[0]
    moved_q = np.abs(out["quat"] - bundle.quat.astype(np.float64)).max(1)
    moved_x = np.abs(out["xyz"] - bundle.xyz.astype(np.float64)).max()
    if not (moved_q[0] <= 1e-6 and (moved_q[1:] > 1e-6).all() and moved_x > 1e-6 and np.isfinite(out["xyz"]).all()):
        raise AssertionError(f"poses or points not written back: quat moved {moved_q}, xyz moved {moved_x}")
    changed = [p for p in pris if out["changed"][p.imid]]
    if not changed or not all(out["device_resident"].values()):
        raise AssertionError(f"changed lanes {out['changed']}, device-resident after the BA {out['device_resident']}")
    gaps = {}
    for p in changed:
        kps = rec.images[p.imid].keypoints
        inside = (kps[:, 0] >= 0) & (kps[:, 0] < IMG_W) & (kps[:, 1] >= 0) & (kps[:, 1] < IMG_H)
        t = truth[p.imid][inside]
        refined = np.abs(np.log(p.depth.data_at_kps(kps[inside]) / t)).mean()
        prior = np.abs(np.log(out["prior_kps"][p.imid][inside] / t)).mean()
        gaps[p.imid] = (float(refined), float(prior))
    if not all(r < q for r, q in gaps.values()):
        raise AssertionError(f"refined maps not closer to the points' true depths than their priors: {gaps}")
    moved = {}
    for p in changed:
        u0, u1 = out["unc0"][p.imid], out["unc1"][p.imid]
        moved[p.imid] = float((u1 != u0).mean())
        if not (np.isfinite(u1).all() and (u1 > 0).all() and moved[p.imid] > 0.9):
            raise AssertionError(f"uncertainty_update of image {p.imid}: finite {np.isfinite(u1).all()}, "
                                 f"positive {(u1 > 0).all()}, moved at {moved[p.imid]:.3f} of the keypoints")
    if not np.isfinite(out["trunc"]):
        raise AssertionError(f"truncation multiplier {out['trunc']}")
    return dict(gaps=gaps, moved=moved, cams=C)


def scene_k3_args(rec, pris, dev):
    """K3's inputs as int_covs_bundle_batched gives them for the lanes
    `pris`: the downscaled problems with their anchors priced by the
    parked covariances, the operator at the working z, the deflation
    set-up, every keypoint's query and the iteration count."""
    from mpsfm_tpu_torch.integration import bini, bini_diag, bini_fused
    from mpsfm_tpu_torch.scene import image_priors as ip

    with rec.tri_angle_cache():
        entries = [(p, p._int_cov_query()) for p in pris]
    params = entries[0][1][6]
    anch = ip._group_anchors(entries, tuple(entries[0][1][0][4][1].shape[-2:]), dev)
    inp = bini._unpack(bini._assemble_batch_anchors(anch, ip._cov_dev_or_dummy(rec, dev), [q[0][4] for _, q in entries]))
    st, _, dg = bini._operator(inp, params, *bini_fused.weights(inp.z0, params.k))
    rowcol = ip._query_rows(entries, dev)
    return st, bini_diag.deflation(st, dg), rowcol[:, 0], rowcol[:, 1], params.cg_max_iter


def scene_refinement_phase(dev, bundle, counted, size=FULL):
    """The refinement steps driven from the scene (slices 5b and the front
    of 6a) at `size`: a Reconstruction of the bundle with ImagePriors on
    size["B"] images at size["H"]×size["W"], run once to warm up, then
    once on a fresh scene with the launch counts set to 0 just before;
    checks, one line per entry point's wall time, the launches, and K3
    held to its plain version (k3_check) and timed at
    int_covs_bundle_batched's shapes. Returns (times, launches)."""
    import torch

    dev = torch.device(dev)
    t = time.perf_counter()
    rec, pris, truth = refine_scene(bundle, size["B"], size["H"], size["W"], dev)
    build_s = time.perf_counter() - t
    run_scene_refinement(rec, pris, dev)  # warm-up
    rec, pris, truth = refine_scene(bundle, size["B"], size["H"], size["W"], dev)
    prior_kps = {p.imid: p.depth.data_prior_at_kps(rec.images[p.imid].keypoints) for p in pris}
    for k in counted.values():
        k.launches = 0
    times = {}
    t = time.perf_counter()
    out = run_scene_refinement(rec, pris, dev, times)
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in counted.items()}
    out["prior_kps"] = prior_kps
    q = check_scene_refinement(out, rec, pris, truth, bundle)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    print(f"scene refinement: {C} images x {P} points, ImagePriors on {len(pris)} images at {size['H']}x{size['W']} "
          f"(scene and priors built in {build_s:.3f} s); {wall:.3f} s wall")
    for k in ("ba_global", "ba_local", "refine"):
        info = out[k][0]
        print(f"scene refinement {k}: cost {info['cost0']:.6g} -> {info['cost']:.6g}, {info['accepted']} accepted")
    print(f"scene refinement: changed lanes {sorted(i for i, c in out['changed'].items() if c)}, device-resident "
          f"until read; mean |log(d / z_true)| at the keypoints, refined vs prior "
          f"{ {i: (round(a, 5), round(b, 5)) for i, (a, b) in q['gaps'].items()} }; uncertainty_update moved at "
          f"{ {i: round(v, 4) for i, v in q['moved'].items()} } of the keypoints; truncation multiplier "
          f"{out['trunc']:.6g}; shift/scale {len(out['shift_scale'])} images")
    for name, sec in times.items():
        print(f"scene refinement {name}: {sec:.4f} s wall")
    if dev.type == "cuda":
        from mpsfm_tpu_torch.integration import bini_diag

        args = scene_k3_args(rec, pris, dev)
        k3_check("scene refinement", args)
        n_rhs = args[2].numel()
        print(f"scene refinement K3 at int_covs_bundle_batched's shapes ({args[2].shape[0]} lanes x {args[2].shape[1]} "
              f"keypoints of {'x'.join(map(str, args[1].minv.shape[1:]))}, {n_rhs} right-hand sides, {args[4]} "
              f"iterations): {cuda_ms(lambda: bini_diag.deflated_pcg(*args), 2):.3f} ms")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched in the scene refinement phase")
    return times, launches


def scene_refinement_card_vs_cpu(dev, size=SMALL):
    """The scene refinement phase at a small size on the card and on the
    CPU from the same seed, twice. With the main path's 20 LM iterations:
    the same changed maps, and z of the global step, covariances,
    uncertainty_update and each BA's cost within the small chain's
    tolerances; the accepted counts are printed, not held, since the LM's
    rel_tol latch fires at an iteration that float32 order decides
    (ROADMAP queue 3; tests/test_torch_dense_ba.py). With LATCH_FREE_ITERS
    iterations, before any latch: the same accepted counts, and poses,
    points, costs and the truncation multiplier within the tolerances.
    Returns the gaps."""
    b = synthetic_bundle(size["n_cams"], size["n_pts"])
    gaps = {}
    tol = dict(z_max=1e-3, z_mean=1e-4, cov_rel=COV_REL, unc_rel=VAR_REL, cost_rel=1e-3, quat=1e-4, t=1e-4,
               xyz=1e-3, trunc_rel=1e-4)
    bas = ("ba_global", "ba_local", "refine")
    for iters in (LM_ITERS, LATCH_FREE_ITERS):
        runs = []
        for d in (dev, "cpu"):
            rec, pris, _ = refine_scene(b, size["B"], size["H"], size["W"], d)
            runs.append(run_scene_refinement(rec, pris, d, opt_conf={"max_iters": iters}))
        g, c = runs
        accepted = {k: (g[k][0]["accepted"], c[k][0]["accepted"]) for k in bas}
        gap = dict(cost_rel=max(abs(g[k][0]["cost"] - c[k][0]["cost"]) / c[k][0]["cost"] for k in bas))
        if iters == LM_ITERS:
            dz = np.concatenate([(g["z"][i].cpu() - c["z"][i]).abs().numpy().ravel() for i in c["z"]])
            gap.update(
                z_max=float(dz.max()), z_mean=float(dz.mean()),
                cov_rel=float((g["cov"].cpu() - c["cov"]).abs().max() / c["cov"].abs().max()),
                unc_rel=max(float((np.abs(g["unc"][i] - c["unc"][i]) / c["unc"][i]).max()) for i in c["unc"]),
            )
        else:
            gap.update(
                quat=float(np.abs(g["quat"] - c["quat"]).max()), t=float(np.abs(g["t"] - c["t"]).max()),
                xyz=float(np.abs(g["xyz"] - c["xyz"]).max()), trunc_rel=abs(g["trunc"] - c["trunc"]) / abs(c["trunc"]),
            )
        line = (f"scene refinement, small ({size['n_cams']} x {size['n_pts']}, {size['B']} priors at "
                f"{size['H']}x{size['W']}), {iters} LM iterations, card vs CPU: changed maps "
                f"{'equal' if g['changed'] == c['changed'] else 'DIFFER'}; {gap} (tolerances "
                f"{ {k: tol[k] for k in gap} }); accepted steps card, CPU {accepted}")
        print(line)
        bad = [k for k in gap if not gap[k] <= tol[k]]
        if g["changed"] != c["changed"] or bad or (iters == LATCH_FREE_ITERS and any(a != b for a, b in accepted.values())):
            raise AssertionError(line)
        gaps.update(gap)
    return gaps


def small_reference(dev):
    """The chain at a small size on the card (kernels) and on the CPU
    (plain versions): the same inputs must give the same result, with the
    depth std floored at INT_COV_FLOOR and unfloored (0, where K3's
    variances reach the depth rows; sigma² must then differ from the
    floored run's). Also the covariances' scatter path (no per-(point,
    camera) tables), card vs CPU."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.covariance import point_covariances

    inputs = make_inputs(**SMALL)
    tol = dict(z=1e-3, quat=1e-4, t=1e-4, xyz=1e-3, cost_rel=1e-3, cov_rel=COV_REL, varlog_rel=VAR_REL,
               sigma2_rel=VAR_REL)
    sigma2 = {}
    for floor in (INT_COV_FLOOR, 0.0):
        gpu = run_slice(inputs, dev, floor=floor)
        cpu = run_slice(inputs, "cpu", floor=floor)
        gaps = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in ("z", "quat", "t", "xyz")}
        gaps["cost_rel"] = abs(gpu["cost"] - cpu["cost"]) / cpu["cost"]
        gaps["cov_rel"] = float((gpu["cov"].cpu() - cpu["cov"]).abs().max() / cpu["cov"].abs().max())
        for k in ("varlog", "sigma2"):
            gaps[f"{k}_rel"] = float(((gpu[k].cpu() - cpu[k]).abs() / cpu[k].abs()).max())
        print(f"small chain (depth std floor {floor}), card vs CPU: {gaps} (tolerances {tol})")
        bad = [k for k in tol if not gaps[k] <= tol[k]]
        if bad:
            raise AssertionError(f"card and CPU disagree on {bad} at floor {floor}: {gaps}")
        sigma2[floor] = gpu["sigma2"][:, :inputs.priors.Sd].cpu()[torch.as_tensor(inputs.priors.ptidx < inputs.P)]
    if bool((sigma2[0.0] == sigma2[INT_COV_FLOOR]).any()):
        raise AssertionError("an unfloored keypoint variance equals the floored one: K3's value does not reach sigma²")
    print(f"small chain: unfloored sigma² / floored, median {float((sigma2[0.0] / sigma2[INT_COV_FLOOR]).median()):.4g}")
    arrays = {**inputs.ba, "pc_r_slot": None, "pc_r_mask": None, "pc_d_slot": None, "pc_d_mask": None}
    gpu = point_covariances(convert.ba_data(arrays, device=dev))
    cpu = point_covariances(convert.ba_data(arrays, device="cpu"))
    rel = float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())
    print(f"covariances by the scatter path (index_put_ accumulate), card vs CPU: max|Δcov| / max|cov| = {rel:.3e} "
          f"(tolerance {COV_REL})")
    if not rel <= COV_REL:
        raise AssertionError(f"scatter-path covariances disagree card vs CPU: {rel}")


def profile_slice(inputs, dev, top=12):
    """Device time of one main-path run by kernel (torch.profiler), and the
    device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_slice(inputs, dev)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    launches = 0
    for e in prof.events():  # device-side events: kernels and copies
        launches += e.name in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel")
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = sorted(((k, n, us) for k, (n, us) in by_name.items()), key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"profile: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}% of wall), {launches} kernel launches from the host"
          if busy else "profile: no device time recorded")
    for name, n, us in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<6d} {name[:90]}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import convert, kernels
    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.ba.covariance import point_covariances
    from mpsfm_tpu_torch.integration import bini_diag, bini_fused

    dev = torch.device("cuda:0")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_s = kernels.build_all(kernels.all_kernels())
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, one process per source, in parallel)")
    for k in kernels.all_kernels():  # ptxas: registers, shared memory and spills of each kernel
        for ln in k.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"  {k.name}: {ln.strip()}")

    t = time.perf_counter()
    inputs = make_inputs(**FULL)
    print(f"inputs: {time.perf_counter() - t:.1f} s")
    k1 = k1_phase(dev, np.random.default_rng(SEED))
    k1_many = k1_many_phase(dev, np.random.default_rng(SEED + 1))
    k2 = k2_phase(dev, inputs)
    k3 = k3_phase(dev, inputs, point_covariances(convert.ba_data(inputs.ba, device=dev)))

    t = time.perf_counter()
    run_slice(inputs, dev)  # warm-up: the first call of each torch op loads its CUDA module
    print(f"main path warm-up: {time.perf_counter() - t:.3f} s wall")
    phases = {}
    counted = {"cholesky": cholesky.KERNEL, "cholesky_many": cholesky.KERNEL_MANY, "bini": bini_fused.KERNEL,
               "bini_diag": bini_diag.KERNEL}
    for k in counted.values():
        k.launches = 0
    t = time.perf_counter()
    out = run_slice(inputs, dev, phases=phases)
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in counted.items()}
    quality = check_slice(out, inputs)
    print(f"main path: {wall:.3f} s wall; phases (s) {json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    print(f"main path: cost0 {out['cost0']:.6g} -> cost {out['cost']:.6g}, {out['accepted']} accepted, "
          f"{int((out['d_w'] > 0).sum())} depth rows with weight, truncation {float(out['trunc']):.4g}, "
          f"mean |z - z_gt| {quality['depth_err']:.4g} (prior {quality['prior_err']:.4g}); "
          f"covariance depth-variance vs depth correlation {quality['cov_depth_corr']:.3f}; diag(H^-1) "
          f"{float(out['varlog'].min()):.3e} .. {float(out['varlog'].max()):.3e}, median new/old keypoint "
          f"variance {quality['var_ratio']:.4f}; launches {launches}")
    print(f"main path depth consistency: {phases['dc'] * 1e3:.2f} ms wall for {len(out['dc_scores'])} queries x "
          f"{out['dc_counts'].shape[1]} refs; scores {[round(x, 4) for x in out['dc_scores']]}; {quality['dc_line']}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if launches["bini_diag"] != 1:  # all 8 × 2048 right-hand sides in one launch
        raise AssertionError(f"K3 made {launches['bini_diag']} launches on the main path, not 1")

    small_reference(dev)
    dc_phase(dev, inputs.bundle, *inputs.priors.z_gt.shape[1:])
    estimators_phase(dev, inputs.bundle, np.random.default_rng(SEED + 2))
    scene_phase(dev, inputs.bundle, out, np.random.default_rng(SEED + 4))
    _, scene_launches = scene_refinement_phase(dev, inputs.bundle, counted)
    scene_refinement_card_vs_cpu(dev)
    if "--profile" in sys.argv[1:]:
        profile_slice(inputs, dev)

    rows = []
    for name, route_src, replaces, k, n in (
        ("cholesky_solve", "mpsfm_tpu_torch/csrc/cholesky.cu", "mpsfm_tpu/ba/pallas_cholesky.py:25",
         k1, launches["cholesky"]),
        # K1's factorization with many right-hand sides: on the JAX path XLA's cho_factor + cho_solve
        ("cholesky_solve_many", "mpsfm_tpu_torch/csrc/cholesky_many.cu", "mpsfm_tpu/ba/covariance.py:91",
         k1_many, launches["cholesky_many"]),
        ("bini_pcg", "mpsfm_tpu_torch/csrc/bini.cu", "mpsfm_tpu/integration/bini_pallas.py:83",
         k2, launches["bini"]),
        # no TPU kernel: on the JAX path _diag_inverse_at_impl runs as XLA ops
        ("bini_diag_pcg", "mpsfm_tpu_torch/csrc/bini_diag.cu", "mpsfm_tpu/integration/bini.py:592",
         k3, launches["bini_diag"]),
    ):
        bound = max(k["ops_ms"], k["bytes_ms"])
        rows.append(dict(
            name=name, route="cuda", source=route_src, replaces=replaces, launches=n,
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=bound,
            bound_by="operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes", library_ms=k["library_ms"],
        ))
        print(f"{name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, library {k['library_ms']}, "
              f"bound {bound:.5f} ms), {n} launches on the main path")
    print(f"scene refinement launches: {json.dumps(scene_launches)}")
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
