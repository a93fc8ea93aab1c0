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
   library call at 384 and 1024; K2
   (bini.cu) as the PCG core of the main path's first IRLS round and as
   the fixed-budget solve, at B = 8 images of 290×387.
3. Drives the main path at full size, once to warm up and once measured
   with every launch count set to 0 just before: the mapper's refinement step in the order of the JAX
   package's Optimizer.ba_fused — BiNI energy gate + IRLS/PCG solve of 8
   depth maps (290×387, the main path's BiNI parameters), depth rows
   sampled from the refined maps, then 20 LM iterations of the dense
   LM-Schur BA on the bench bundle (64 cameras × 8192 points). It checks
   finite outputs, a lower cost, ≥ 3 accepted steps, depth rows with
   weight, depth maps closer to the ground truth than their priors, and
   that both kernels were launched.
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
K2_TOL = 2e-3  # max |Δz| in log-depth of K2 vs its plain version (the JAX Pallas-vs-XLA bar)


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


def synthetic_priors(bundle, B, H, W, seed=SEED, Ka=512, n_anchors=300):
    """Depth/normal priors of B images of the bundle on an H×W integration
    grid, with everything the refinement step takes: anchor rows
    (B,6,Ka) of every slot code, gate state prev (B,2) (no lane integrated
    yet), point covariances, the cached (z0, stat8) pair of each lane, and
    the keypoint rows (grid coords, depth variances, point index, camera)
    for the BA's depth residuals. The scene depth of image b is a slanted
    plane at the median depth of its points; the prior is that plane with
    3% log-normal noise; the normals are the plane's."""
    from mpsfm_tpu_torch.integration.bini import build_prior2, build_static6

    rng = np.random.default_rng(seed + 1)
    C, P = bundle.quat.shape[0], bundle.xyz.shape[0]
    sx, sy = W / IMG_W, H / IMG_H
    fx, fy, cx, cy = FOCAL * sx, FOCAL * sy, IMG_W / 2 * sx, IMG_H / 2 * sy
    Sd = max(P // 4, 1)
    cam_rows = np.linspace(0, C - 1, B).round().astype(np.int32)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    covs = np.zeros((H, W, 3, 3))
    for k in range(3):
        covs[..., k, k] = (np.pi / 180 * 2) ** 2
    Pc = P
    A = rng.normal(size=(Pc, 3, 3)) * 0.01
    cov = (A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3)).astype(np.float32)
    anch = np.zeros((B, 6, Ka), np.float32)
    anch[:, 0] = H  # padding: out of range, dropped
    anch[:, 4] = -1.0
    pairs, z_gt = [], []
    gx = np.zeros((B, Sd), np.float32)
    gy = np.zeros((B, Sd), np.float32)
    sigma2 = np.ones((B, Sd), np.float32)
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
        static6 = build_static6(np.ones((H, W), bool), np.broadcast_to(n, (H, W, 3)), covs, fx, fy, cx, cy)
        prior2 = build_prior2(prior, (prior * 0.05) ** 2)
        pairs.append((np.log(prior).astype(np.float32), np.concatenate([prior2, static6]).astype(np.float32)))
        z_gt.append(np.log(depth).astype(np.float32))
        # keypoint rows: a random subset of the seen points, the rest padding
        kp = rng.permutation(seen)[:Sd]
        m = len(kp)
        ptidx[b, :m] = kp
        gx[b, :m], gy[b, :m] = u[kp], v[kp]
        d_kp = depth[np.clip(v[kp].astype(int), 0, H - 1), np.clip(u[kp].astype(int), 0, W - 1)]
        sigma2[b, :m] = (0.05 * d_kp) ** 2
        # anchors: SfM depths at de-duplicated keypoint pixels, slot codes >=0 / -1 / -2
        pix = v[kp].astype(np.int64) * W + u[kp].astype(np.int64)
        _, first = np.unique(pix, return_index=True)
        sel = kp[np.sort(first)][:min(n_anchors, Ka)]
        L = len(sel)
        code = np.where(np.arange(L) % 3 == 0, sel, np.where(np.arange(L) % 3 == 1, -1, -2))
        ay, ax = v[sel].astype(np.int64), u[sel].astype(np.int64)
        d3 = depth[ay, ax] * np.exp(rng.normal(scale=0.01, size=L))  # SfM depth on the scene plane
        anch[b, 0, :L] = ay
        anch[b, 1, :L] = ax
        anch[b, 2, :L] = np.where(code == -2, d3 ** 2 / 1e-2, d3)  # -2: the value is the precision
        anch[b, 3, :L] = np.log(d3)
        anch[b, 4, :L] = code
        anch[b, 5, 2:5] = R[2]
    return SimpleNamespace(
        anch=anch, prev=np.zeros((B, 2), np.float32), cov=cov, pairs=pairs,
        z_gt=np.stack(z_gt), gx=gx, gy=gy, sigma2=sigma2, ptidx=ptidx, cam_rows=cam_rows,
    )


def make_inputs(n_cams, n_pts, B, H, W, seed=SEED):
    bundle = synthetic_bundle(n_cams, n_pts, seed)
    return SimpleNamespace(bundle=bundle, priors=synthetic_priors(bundle, B, H, W, seed), C=n_cams, P=n_pts)


# ---- the main path ----

def run_slice(inputs, device, lm_iters=LM_ITERS, phases=None):
    """The refinement step on `device`, through the port's entry points,
    in Optimizer.ba_fused's order. Returns a dict of tensors and numbers;
    `phases` (a dict) collects wall seconds per phase."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.dense import densify, solve_ba_dense
    from mpsfm_tpu_torch.ba.device_depth import build_depth_grids, sample_logd
    from mpsfm_tpu_torch.integration.bini import BiniParams, bini_gate_solve_batch_anchors

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
    anch, prev, cov, pairs = convert.anchor_state(pr.anch, pr.prev, pr.cov, pr.pairs, device=dev)
    rows = [torch.as_tensor(a, device=dev) for a in (pr.gx, pr.gy, pr.sigma2, pr.ptidx, pr.cam_rows)]
    t0 = mark("upload", t0)
    z, info4 = bini_gate_solve_batch_anchors(anch, prev, BiniParams(**MAIN_BINI), cov, *pairs)
    t0 = mark("bini_gate_solve", t0)
    gx, gy, sigma2, ptidx, cam_rows = rows
    logd = torch.stack([sample_logd(z[b], 0.0, gx[b], gy[b]) for b in range(z.shape[0])])
    d_logt, d_w, d_scale, trunc = build_depth_grids(
        logd, sigma2, ptidx, cam_rows, dense.quat, dense.t, dense.xyz,
        ROWS["m_base"], ROWS["sff"], ROWS["min_trunc"], C=inputs.C, P=inputs.P,
        scale_filter=ROWS["scale_filter"], compute_trunc=ROWS["compute_trunc"],
    )
    dense = dense._replace(d_logt=d_logt, d_w=d_w, d_scale=d_scale)
    t0 = mark("depth_rows", t0)
    quat, t, xyz, info = solve_ba_dense(dense, max_iters=lm_iters)
    mark("dense_ba", t0)
    return dict(z=z, info4=info4, d_w=d_w, trunc=trunc, quat=quat, t=t, xyz=xyz,
                cost0=float(info["cost0"]), cost=float(info["cost"]), accepted=int(info["accepted"]))


def check_slice(out, inputs):
    """The main path's own checks; raises on the first that fails."""
    import torch

    for k in ("z", "info4", "d_w", "quat", "t", "xyz"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")
    pr = inputs.priors
    B, H, W = pr.z_gt.shape
    if tuple(out["z"].shape) != (B, H, W) or tuple(out["xyz"].shape) != (inputs.P, 3):
        raise AssertionError("unexpected output shapes")
    if not out["cost"] < out["cost0"]:
        raise AssertionError(f"cost {out['cost']} not below cost0 {out['cost0']}")
    if out["accepted"] < 3:
        raise AssertionError(f"only {out['accepted']} accepted LM steps")
    if int((out["d_w"] > 0).sum()) == 0:
        raise AssertionError("no depth row has weight")
    info4 = out["info4"].cpu().numpy()
    if not (info4[:, 2] == 1).all() or (info4[:, 3] == 1).any():
        raise AssertionError(f"every lane should refine and none abort: {info4}")
    z = out["z"].cpu().numpy()
    z0 = np.stack([q[0] for q in pr.pairs])
    err, err0 = np.abs(z - pr.z_gt).mean((1, 2)), np.abs(z0 - pr.z_gt).mean((1, 2))
    if not (err < 0.5 * err0).all():
        raise AssertionError(f"refined depth not closer to the truth: {err} vs prior {err0}")
    return dict(depth_err=float(err.mean()), prior_err=float(err0.mean()))


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


def k2_phase(dev, inputs):
    """K2 vs its plain version at the main path's shapes: the PCG core on
    the first IRLS round's operator (tolerance and budget of the main
    path), and the fixed-budget solve (BiniParams(max_iter=10,
    cg_max_iter=1000), clamped to 500 CG iterations)."""
    import torch

    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.integration import bini, bini_fused

    pr = inputs.priors
    anch, prev, cov, pairs = convert.anchor_state(pr.anch, pr.prev, pr.cov, pr.pairs, device=dev)
    inp = bini._unpack(bini._assemble_batch_anchors(anch, cov, pairs))
    p = bini.BiniParams(**MAIN_BINI)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, b, dg = bini._operator(inp, p, wx, wy)
    active = torch.ones(inp.z0.shape[0], dtype=torch.bool, device=dev)
    x, iters = bini_fused.pcg(st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol, active)
    xr, iters_r = bini_fused.pcg_plain(st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol, active)
    err = float((x - xr).abs().max())
    its, its_r = iters.cpu().tolist(), iters_r.cpu().tolist()
    print(f"K2 pcg (main path, tol {p.cg_tol}): max|kernel - plain| = {err:.3e} (tolerance {K2_TOL}); "
          f"iterations kernel {its} plain {its_r}")
    if not err <= K2_TOL:
        raise AssertionError(f"K2 PCG disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: bini_fused.pcg(st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol, active), 3)
    plain_ms = cuda_ms(lambda: bini_fused.pcg_plain(st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol, active), 1)
    Bn, H, W = inp.z0.shape
    flops = 26.0 * H * W * sum(its)  # per pixel-iteration: stencil 15, three dots 6, updates 5
    nbytes = 4.0 * 7 * Bn * H * W  # ex, ey, pa, b, diag, x0 read once; x written once

    pf = bini.BiniParams(max_iter=10, cg_max_iter=1000)
    zf = bini_fused.bini_solve_fused(inp, pf)
    zr = bini_fused.bini_solve_fused_plain(inp, pf)
    err_f = float((zf - zr).abs().max())
    print(f"K2 bini_solve_fused (10 x {min(pf.cg_max_iter, bini_fused.PALLAS_CG_CAP)} CG, B={Bn} {H}x{W}): "
          f"max|kernel - plain| = {err_f:.3e} (tolerance {K2_TOL})")
    if not err_f <= K2_TOL:
        raise AssertionError(f"K2 fixed-budget solve disagrees with its plain version: {err_f}")
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
    tol = dict(z=1e-3, quat=1e-4, t=1e-4, xyz=1e-3, cost_rel=1e-3)
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
        launches += e.name == "cudaLaunchKernel"
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
    from mpsfm_tpu_torch.integration import bini_fused

    dev = torch.device("cuda:0")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_s = kernels.build_all(kernels.all_kernels())
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, both sources in parallel)")
    for k in kernels.all_kernels():  # ptxas: registers, shared memory and spills of each kernel
        for ln in k.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"  {k.name}: {ln.strip()}")

    t = time.perf_counter()
    inputs = make_inputs(**FULL)
    print(f"inputs: {time.perf_counter() - t:.1f} s")
    k1 = k1_phase(dev, np.random.default_rng(SEED))
    k2 = k2_phase(dev, inputs)

    t = time.perf_counter()
    run_slice(inputs, dev)  # warm-up: the first call of each torch op loads its CUDA module
    print(f"main path warm-up: {time.perf_counter() - t:.3f} s wall")
    phases = {}
    cholesky.KERNEL.launches = 0
    bini_fused.KERNEL.launches = 0
    t = time.perf_counter()
    out = run_slice(inputs, dev, phases=phases)
    wall = time.perf_counter() - t
    launches = {"cholesky": cholesky.KERNEL.launches, "bini": bini_fused.KERNEL.launches}
    quality = check_slice(out, inputs)
    print(f"main path: {wall:.3f} s wall; phases (s) {json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    print(f"main path: cost0 {out['cost0']:.6g} -> cost {out['cost']:.6g}, {out['accepted']} accepted, "
          f"{int((out['d_w'] > 0).sum())} depth rows with weight, truncation {float(out['trunc']):.4g}, "
          f"mean |z - z_gt| {quality['depth_err']:.4g} (prior {quality['prior_err']:.4g}); launches {launches}")
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
        ("bini_pcg", "mpsfm_tpu_torch/csrc/bini.cu", "mpsfm_tpu/integration/bini_pallas.py:83",
         k2, launches["bini"]),
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
