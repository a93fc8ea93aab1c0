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
   (cholesky_many.cu) at K = 384, N = 24 576 (the covariances' solve) and
   K = 390, N = 1000 (ragged blocks and column tile), timed beside its
   plain version and the library call; K2 (bini.cu) as the PCG core of
   the main path's first IRLS round (iteration counts within 1,
   bit-identical from run to run, and at B = 16 as two lane groups; a
   cooperative launch larger than the card refused) and as the
   fixed-budget solve, at B = 8 images of 290×387, timed per solve, per
   CG iteration and against the design's floor (its two lane barriers
   per iteration with almost no arithmetic), its checks shown to fail
   the plain version turned into a kernel with a stale or dropped halo
   at one CTA's seams; K3 (bini_diag.cu), the deflated PCG of diag(H⁻¹), at
   8 images of 145×193 with 2048 queries each and 16 iterations,
   bit-identical from run to run, timed beside its plain version, and its
   check shown to fail a kernel without the deflation's projection.
3. Drives the main path at full size, once to warm up and once measured
   with every launch count set to 0 just before: the mapper's refinement
   step in the order of the JAX package's Mapper (calculate_point_covs,
   then Optimizer.ba_fused with the int_covs chain) — point covariances of
   the bench bundle (64 cameras × 8192 points), BiNI energy gate +
   IRLS/PCG solve of 8 depth maps (290×387, the main path's BiNI
   parameters; anchors priced by those covariances), the fresh depth
   downscaled to 145×193 and diag(H⁻¹) there at 2048 keypoints per image
   (16 deflated PCG iterations), the keypoints' depth variances updated
   from it, depth rows with those variances sampled from the refined
   maps, then 20 LM iterations of the dense LM-Schur BA. It checks
   finite, symmetric covariances with a positive diagonal whose depth
   variance grows with depth, finite positive variances that moved on the
   changed lanes, a lower cost, ≥ 3 accepted steps, depth rows with
   weight, depth maps closer to the ground truth than their priors, and
   that every kernel entry point was launched.
4. Runs the same chain at a small size on the card and on the CPU (plain
   versions) and compares the results.

`python3 chip_smoke.py --profile` adds one main-path run under
torch.profiler and prints its device time by kernel.

Prints the card's name and power limit, each kernel's times and launch
count, the wall time per phase, a `{"kernels": [...]}` line, and last
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
IMG_W, IMG_H, FOCAL = 640.0, 480.0, 500.0

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
# the order of the dot products' sums (4.6e-6 on an H100); k3_phase shows that a
# kernel that skips the deflation's projection (keeping the coarse start) fails
# it (1.7e-2 on an H100).
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
    plane's."""
    import torch

    from mpsfm_tpu_torch.integration.bini import build_prior2, build_static6, resize_log_dev

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
    return SimpleNamespace(
        anch=anch, prev=np.zeros((B, 2), np.float32), pairs=pairs,
        z_gt=np.stack(z_gt), gx=gx, gy=gy, sigma2=sigma2, ptidx=ptidx, cam_rows=cam_rows,
        anch_ds=anch_ds, stat8_ds=stat8_ds, rowcol=rowcol, dprior=dprior, Sd=Sd,
    )


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

def run_slice(inputs, device, lm_iters=LM_ITERS, phases=None):
    """The refinement step on `device`, through the port's entry points,
    in the JAX package's order (Mapper: calculate_point_covs, then
    Optimizer.ba_fused with the int_covs chain of _integrate_deferred).
    Returns a dict of tensors and numbers; `phases` (a dict) collects wall
    seconds per phase."""
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
    sigma2 = torch.stack([_updated_unc_dev(varlog, b, sigma2_old[b], dprior[b], info4, b, INT_COV_FLOOR)
                          for b in range(Bn)])
    t0 = mark("int_covs", t0)
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
                quat=quat, t=t, xyz=xyz,
                cost0=float(info["cost0"]), cost=float(info["cost"]), accepted=int(info["accepted"]))


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
    return dict(depth_err=float(err.mean()), prior_err=float(err0.mean()), cov_depth_corr=float(corr),
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


def k1_many_phase(dev, rng):
    """K1 with many right-hand sides vs its plain version at K = 384, N =
    24 576 (the covariances' solve at the bench bundle: 6C × 3P) and K =
    390, N = 1000 (a ragged last block and column tile), on S = A·Aᵀ +
    shift·K·I for each shift of K1_REL: max |ΔX| ≤ K1_TOL, max |ΔX| / max
    |X| and ‖S·X − B‖_F / ‖B‖_F within the shift's bound. Times of the
    kernel, the plain version and the library call at the main shape."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    out = {}
    for K, N in ((384, 24576), (390, 1000)):
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
        print(line)
    return out


def k3_inputs(inputs, dev):
    """K3's inputs at the main path's shapes: each lane's int_covs problem
    (the downscaled grid, its anchors priced by the bundle's covariances)
    with the resized prior as z, its operator, the deflation set-up and the
    keypoint queries; and the iteration count."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.covariance import point_covariances
    from mpsfm_tpu_torch.integration import bini, bini_diag, bini_fused

    pr = inputs.priors
    cov = point_covariances(convert.ba_data(inputs.ba, device=dev))
    pairs = [(torch.as_tensor(s8[1], device=dev), torch.as_tensor(s8, device=dev)) for s8 in pr.stat8_ds]
    packed = bini._assemble_batch_anchors(torch.as_tensor(pr.anch_ds, device=dev), cov, pairs)
    inp = bini._unpack(packed)
    p = bini.BiniParams(**MAIN_BINI)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, _, dg = bini._operator(inp, p, wx, wy)
    rowcol = torch.as_tensor(pr.rowcol, device=dev)
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


def k3_phase(dev, inputs):
    """K3 vs its plain version at the main path's shapes (8 × 145×193,
    2048 queries a lane, 16 iterations): max |Δv| / v ≤ K3_REL,
    bit-identical from run to run, and the same check failing a kernel
    without the projection. Times of the kernel and the plain version."""
    from mpsfm_tpu_torch.integration import bini_diag

    args = k3_inputs(inputs, dev)
    st, dfl, rows, cols, iters = args
    Bn, H, W = dfl.minv.shape
    n0 = bini_diag.KERNEL.launches
    v = bini_diag.deflated_pcg(*args)
    if bini_diag.KERNEL.launches != n0 + 1:
        raise AssertionError("K3 was not launched")
    ref = bini_diag.deflated_pcg_plain(*args)
    rel = float(((v - ref).abs() / ref.abs()).max())
    print(f"K3 deflated PCG (B={Bn} {H}x{W}, {rows.shape[1]} queries a lane, {iters} iterations): "
          f"max|kernel - plain| / plain = {rel:.3e} (tolerance {K3_REL}); variances {float(ref.min()):.3e} .. "
          f"{float(ref.max()):.3e}")
    if not (bool((v > 0).all()) and rel <= K3_REL):
        raise AssertionError(f"K3 disagrees with its plain version: {rel}")
    if not bool((bini_diag.deflated_pcg(*args) == v).all()):
        raise AssertionError("K3 is not bit-identical from run to run")
    print("K3 run to run: bit-identical")
    with k3_no_projection():
        bad = bini_diag.deflated_pcg_plain(*args)
    rel_bad = float(((bad - ref).abs() / ref.abs()).max())
    print(f"K3 check vs a kernel without the projection: max|Δv| / v = {rel_bad:.3e} (tolerance {K3_REL})")
    if rel_bad <= K3_REL:
        raise AssertionError("K3's check would pass a kernel without the deflation's projection")
    ms = cuda_ms(lambda: bini_diag.deflated_pcg(*args), 2)
    plain_ms = cuda_ms(lambda: bini_diag.deflated_pcg_plain(*args), 1)
    n_rhs, n_pix = Bn * rows.shape[1], H * W
    # per pixel: 33 FLOP an iteration (stencil 13, p.Hp 2, r 2, M^-1 r 1,
    # (HZ)^T V 6, projection 5, r.z 2, p 2), 31 for the coarse start
    flops = float(n_rhs) * n_pix * (33 * iters + 31)
    nbytes = 4.0 * (7 * Bn * n_pix + 9 * Bn + H + W + 3 * n_rhs)  # maps, E^-1, axes, queries, variances
    print(f"K3: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3:.4f} ms")
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


def small_reference(dev):
    """The chain at a small size on the card (kernels) and on the CPU
    (plain versions): the same inputs must give the same result."""
    inputs = make_inputs(**SMALL)
    gpu = run_slice(inputs, dev)
    cpu = run_slice(inputs, "cpu")
    gaps = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in ("z", "quat", "t", "xyz")}
    gaps["cost_rel"] = abs(gpu["cost"] - cpu["cost"]) / cpu["cost"]
    gaps["cov_rel"] = float((gpu["cov"].cpu() - cpu["cov"]).abs().max() / cpu["cov"].abs().max())
    for k in ("varlog", "sigma2"):
        gaps[f"{k}_rel"] = float(((gpu[k].cpu() - cpu[k]).abs() / cpu[k].abs()).max())
    tol = dict(z=1e-3, quat=1e-4, t=1e-4, xyz=1e-3, cost_rel=1e-3, cov_rel=COV_REL, varlog_rel=VAR_REL,
               sigma2_rel=VAR_REL)
    print(f"small chain, card vs CPU: {gaps} (tolerances {tol})")
    bad = [k for k in tol if not gaps[k] <= tol[k]]
    if bad:
        raise AssertionError(f"card and CPU disagree on {bad}: {gaps}")


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
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.ba import cholesky
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
    k3 = k3_phase(dev, inputs)

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
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    small_reference(dev)
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
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
