"""Host-side BA problem construction from the Reconstruction (port of
mpsfm_tpu/ba/problem.py).

Mirrors the reference Optimizer's problem setup
(mpsfm/sfm/mapper/bundle_adjustment.py:67-185): bundle image set, local
vs global point variability (track<15 rule), gauge fixing (first pose
constant, second pose tx frozen), constant intrinsics, median-kp_std loss
scaling, and per-observation depth residual weighting (magnitude d²/σ²,
robust scale m·σ/d, optional scale filter). The host passes are the JAX
package's numpy, line for line, so every host-built array is equal to
its counterpart; the padded BAData / DenseBAData then go to `device` (the
card unless the caller asks for the CPU) as tensors, with the index
fields int64. The padding buckets (_bucket) are kept: they make the
arrays equal to the JAX package's, and a padded camera or point carries
weight 0.

A problem too large for the dense layout (Pb·Cb > DENSE_MAX) gets the
slot-table BAData only; with a representation other than "sparse" also
the explicit block-sparse Schur tables (ba/schur_sparse.py, built on the
host, timed as the `ba.block_schur_tables` phase), unless they would be
too large, when the solver keeps its matrix-free PCG.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba.dense import DenseBAData
from mpsfm_tpu_torch.ba.schur_sparse import make_block_schur_tables, tables_to
from mpsfm_tpu_torch.ba.solver import BAData, make_pc_tables, make_slot_tables
from mpsfm_tpu_torch.scene.reconstruction import Reconstruction
from mpsfm_tpu_torch.utils.profiling import TIMERS

DENSE_MAX = 8_000_000  # Pb·Cb up to which the dense (C,P) layout is built


def _pad_to(arr, n, fill=0):
    out = np.full((n, *arr.shape[1:]), fill, arr.dtype)
    out[: len(arr)] = arr
    return out


def _bucket(n, minimum=16):
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class BAProblem:
    data: BAData | None
    cam_ids: list  # local cam index -> imid
    pt_ids: np.ndarray  # local point index -> pid
    n_cams: int
    n_pts: int
    dense: DenseBAData | None = None  # when Pb·Cb ≤ DENSE_MAX and asked for
    # device-depth mode (ba/device_depth.py): host-built sampling specs;
    # the depth grids are then derived on the device from the
    # device-resident log-depth maps
    depth_specs: dict | None = None


def build_ba_data(
    rec: Reconstruction,
    bundle: dict,
    mode: str = "global",
    fix_pose: bool = False,
    reproj_loss_scale_mult: float = 1.5,
    depth_rob_scale: float = 2.0,  # rob_std
    param_multiplier: float = 1.0,
    truncation_multiplier: float = 1.0,
    depth_type: str = "update",
    allow_scale_filter: bool = False,
    scale_filter_factor: float = 1.5,
    use_depth: bool = True,
    local_variable_track_max: int = 15,
    dtype=np.float32,
    representation: str = "both",
    device_depth: bool = False,
    device="cuda",
) -> BAProblem:
    """representation selects which device arrays are built: "both",
    "solve" (the dense grids when Pb·Cb fits, else the sparse tables),
    "sparse" (observation tables + slot/pc tables only: the covariance
    path)."""
    dev = resolve_device(device)
    optim_ids = sorted(bundle["optim_ids"])
    pts3D = set(int(p) for p in bundle.get("pts3D", set()))
    constpoints = set(int(p) for p in bundle.get("constpoints", set()))

    # --- involved points and their variability (vectorized over the pool) ---
    all_pts_arr = np.asarray(sorted(pts3D | constpoints), np.int64)
    all_pts_arr = all_pts_arr[rec.alive[all_pts_arr]] if len(all_pts_arr) else all_pts_arr
    all_pts = all_pts_arr.tolist()
    pt_local = {p: i for i, p in enumerate(all_pts)}
    if len(all_pts_arr):
        const_mask = np.isin(all_pts_arr, np.asarray(sorted(constpoints), np.int64))
        var_mask = ~const_mask
        if mode == "local":
            var_mask &= rec.track_len[all_pts_arr] < local_variable_track_max
        point_var = var_mask.astype(np.float32)
    else:
        point_var = np.zeros(0, np.float32)

    # --- one bulk observation pass: observers + reprojection table ---
    o_pid, o_im, o_kp = rec.observations(all_pts_arr)
    im_unique, im_inv = np.unique(o_im, return_inverse=True) if len(o_im) else (
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    im_reg = np.array([rec.images[i].registered for i in im_unique], bool)
    observer_ids = set(im_unique[im_reg].tolist())
    cam_ids = list(optim_ids) + sorted(observer_ids - set(optim_ids))
    cam_local = {imid: i for i, imid in enumerate(cam_ids)}

    C = len(cam_ids)
    cam_dof = np.zeros((C, 6), np.float32)
    for ii, imid in enumerate(optim_ids):
        if fix_pose or ii == 0:
            continue
        cam_dof[ii] = 1.0
        if ii == 1:
            cam_dof[ii, 3] = 0.0  # freeze tx of the second pose (gauge scale)

    quat = np.stack([rec.images[i].pose.q for i in cam_ids]).astype(dtype)
    t = np.stack([rec.images[i].pose.t for i in cam_ids]).astype(dtype)
    fx = np.array([rec.camera(i).fx for i in cam_ids], dtype)
    fy = np.array([rec.camera(i).fy for i in cam_ids], dtype)
    cx = np.array([rec.camera(i).cx for i in cam_ids], dtype)
    cy = np.array([rec.camera(i).cy for i in cam_ids], dtype)
    xyz = rec.xyz[all_pts].astype(dtype) if all_pts else np.zeros((0, 3), dtype)

    # --- reprojection observations (camera-major padded layout) ---
    kp_std = float(np.median([rec.images[i].kp_std for i in optim_ids]))
    reproj_mag = 1.0 / kp_std**2
    reproj_scale = reproj_loss_scale_mult * kp_std

    # vectorized (cam, pt)-sorted reprojection observation table
    if len(o_im):
        cam_of_im = np.full(int(im_unique.max()) + 1, -1, np.int64)
        for imid, c in cam_local.items():
            if imid <= im_unique.max():
                cam_of_im[imid] = c
        pt_of_pid = np.full(int(all_pts_arr.max()) + 1, -1, np.int64)
        pt_of_pid[all_pts_arr] = np.arange(len(all_pts_arr))
        obs_cam = cam_of_im[o_im]
        keep = obs_cam >= 0
        obs_cam = obs_cam[keep]
        obs_pt = pt_of_pid[o_pid[keep]]
        obs_kp = o_kp[keep]
        obs_im = o_im[keep]
        obs_uv = np.zeros((len(obs_cam), 2), np.float64)
        for imid in np.unique(obs_im):
            sel = obs_im == imid
            obs_uv[sel] = rec.images[imid].keypoints[obs_kp[sel]]
        order = np.lexsort((obs_pt, obs_cam))  # point-sorted within camera
        obs_cam, obs_pt, obs_uv = obs_cam[order], obs_pt[order], obs_uv[order]
    else:
        obs_cam = np.zeros(0, np.int64)
        obs_pt = np.zeros(0, np.int64)
        obs_uv = np.zeros((0, 2), np.float64)

    # --- depth observations (per optim image with activated depth) ---
    per_cam_d: dict[int, tuple] = {}
    depth_specs = None
    if use_depth and device_depth:
        # device-depth mode: the host builds only the z-independent
        # sampling specs (kp grid coords, variances, point indices); the
        # sampled depths, scale filter, magnitudes and robust scales are
        # computed on the device from the device-resident log-depth grids
        # (ba/device_depth.py)
        rows = []
        if len(all_pts_arr):
            pt_lookup = np.full(int(all_pts_arr.max()) + 1, -1, np.int64)
            pt_lookup[all_pts_arr] = np.arange(len(all_pts_arr))
        else:
            pt_lookup = np.full(1, -1, np.int64)
        for imid in optim_ids:
            im = rec.images[imid]
            depth = getattr(im, "depth", None)
            if depth is None or not depth.activated:
                continue
            kp_ids = im.observed_kp_ids()
            if len(kp_ids) == 0:
                continue
            kps = im.keypoints[kp_ids]
            valid = depth.valid_at_kps(kps)
            kp_ids, kps = kp_ids[valid], kps[valid]
            if len(kp_ids) == 0:
                continue
            pids = im.point3D_ids[kp_ids]
            ptl = np.where(
                (pids >= 0) & (pids < len(pt_lookup)),
                pt_lookup[np.clip(pids, 0, len(pt_lookup) - 1)],
                -1,
            )
            sigma2 = np.asarray(depth.uncertainty_update)[kp_ids]
            sx, sy = depth._grid_scale
            rows.append(
                (imid, cam_local[imid], kps[:, 0] * sx, kps[:, 1] * sy, sigma2, ptl,
                 kp_ids.astype(np.int32))
            )
        if rows:
            Sd = _bucket(max(len(r[2]) for r in rows), 32)
            Cr = len(rows)
            gx = np.zeros((Cr, Sd), np.float32)
            gy = np.zeros((Cr, Sd), np.float32)
            s2 = np.ones((Cr, Sd), np.float32)
            kpi = np.zeros((Cr, Sd), np.int32)
            pti = np.full((Cr, Sd), 0, np.int32)
            cam_rows = np.zeros(Cr, np.int32)
            imids_r = []
            Pb_spec = _bucket(max(len(all_pts), 1))
            pti[:] = Pb_spec  # padding sentinel (dropped by the scatter)
            for r, (imid, c, gxr, gyr, s2r, ptlr, kpr) in enumerate(rows):
                L = len(gxr)
                gx[r, :L], gy[r, :L], s2[r, :L] = gxr, gyr, s2r
                kpi[r, :L] = kpr
                pti[r, :L] = np.where(ptlr < 0, Pb_spec, ptlr)
                cam_rows[r] = c
                imids_r.append(imid)
            depth_specs = {
                "gx": gx, "gy": gy, "sigma2": s2, "ptidx": pti, "kp_ids": kpi,
                "cam_rows": cam_rows, "imids": imids_r,
            }
        else:
            depth_specs = {"imids": []}
    elif use_depth:
        m = param_multiplier * truncation_multiplier * depth_rob_scale
        for imid in optim_ids:
            im = rec.images[imid]
            depth = getattr(im, "depth", None)
            if depth is None or not depth.activated:
                continue
            kp_ids = im.observed_kp_ids()
            if len(kp_ids) == 0:
                continue
            kps = im.keypoints[kp_ids]
            valid = depth.valid_at_kps(kps)
            kp_ids = kp_ids[valid]
            kps = kps[valid]
            if len(kp_ids) == 0:
                continue
            if depth_type == "update" and depth.data is not None:
                depths = depth.data_at_kps(kps)
            else:
                depths = depth.data_prior_at_kps(kps)
            pids = im.point3D_ids[kp_ids]
            _, z = rec.project_points_into_image(imid, pids)
            mask = depths > 0
            if allow_scale_filter:
                div = depths / np.clip(z, 1e-6, None)
                mask &= (div < scale_filter_factor) & (div > 1 / scale_filter_factor)
            variances = np.array([depth.uncertainty_update[kp] for kp in kp_ids])
            if mask.sum() == 0:
                continue
            depths, variances, pids = depths[mask], variances[mask], pids[mask]
            inv_unc = 1.0 / np.clip(variances, 1e-6, None)
            pt_ls = np.asarray([pt_local[int(p)] for p in pids], np.int64)
            per_cam_d[cam_local[imid]] = (
                pt_ls,
                np.log(np.maximum(depths, 1e-8)),
                depths**2 * inv_unc,
                m * np.sqrt(variances) / depths,
            )

    # --- camera-major padded flat arrays (vectorized scatter fill) ---
    Cb = _bucket(C, 2)
    Pb = _bucket(max(len(all_pts), 1))
    cam_counts = np.bincount(obs_cam, minlength=max(C, 1)) if len(obs_cam) else np.zeros(max(C, 1), np.int64)
    Sc = _bucket(max(int(cam_counts.max()) if len(cam_counts) else 1, 1))
    Sdc = _bucket(max([len(v[0]) for v in per_cam_d.values()] + [1]), 1)
    No = Cb * Sc
    Nd = Cb * Sdc

    r_pt = np.zeros(No, np.int32)
    r_uv = np.zeros((No, 2), dtype)
    r_valid = np.zeros(No, np.float32)
    d_pt = np.zeros(Nd, np.int32)
    d_log = np.zeros(Nd, dtype)
    d_mag_arr = np.zeros(Nd, dtype)
    d_scale_arr = np.ones(Nd, dtype)
    d_valid = np.zeros(Nd, np.float32)
    if len(obs_cam):
        starts = np.concatenate([[0], np.cumsum(cam_counts)[:-1]])
        pos = obs_cam * Sc + (np.arange(len(obs_cam)) - starts[obs_cam])
        r_pt[pos] = obs_pt
        r_uv[pos] = obs_uv
        r_valid[pos] = 1.0
    for c, (pl, lg, mg, sc_) in per_cam_d.items():
        if len(pl) == 0:
            continue
        ord2 = np.argsort(pl, kind="stable")  # point-sorted within camera
        idx = c * Sdc + np.arange(len(pl))
        d_pt[idx] = pl[ord2]
        d_log[idx] = lg[ord2]
        d_mag_arr[idx] = mg[ord2]
        d_scale_arr[idx] = sc_[ord2]
        d_valid[idx] = 1.0
    r_cam = np.minimum(np.arange(No, dtype=np.int32) // Sc, Cb - 1)
    d_cam = np.minimum(np.arange(Nd, dtype=np.int32) // Sdc, Cb - 1)

    dense_ok = Pb * Cb <= DENSE_MAX
    want_dense = representation in ("both", "solve") and dense_ok
    want_sparse = representation in ("both", "sparse") or not dense_ok

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def i64(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)

    quat_p = _pad_to(quat, Cb)
    quat_p[C:, 0] = 1.0  # identity quats for padded cameras (zero NaNs normalize)
    shared = dict(
        quat=f32(quat_p),
        t=f32(_pad_to(t, Cb)),
        cam_dof=f32(_pad_to(cam_dof, Cb)),
        fx=f32(_pad_to(fx, Cb, 1)),
        fy=f32(_pad_to(fy, Cb, 1)),
        cx=f32(_pad_to(cx, Cb)),
        cy=f32(_pad_to(cy, Cb)),
        xyz=f32(_pad_to(xyz, Pb)),
        point_var=f32(_pad_to(point_var, Pb)),
    )

    data = None
    if want_sparse:
        r_pt_slots, r_pt_mask = make_slot_tables(r_pt[r_valid > 0], Pb)
        # remap slot indices back to padded positions
        valid_pos = np.where(r_valid > 0)[0]
        r_pt_slots = valid_pos[r_pt_slots].astype(np.int32) if len(valid_pos) else r_pt_slots
        dvalid_pos = np.where(d_valid > 0)[0]
        d_pt_slots, d_pt_mask = make_slot_tables(d_pt[d_valid > 0], Pb)
        d_pt_slots = dvalid_pos[d_pt_slots].astype(np.int32) if len(dvalid_pos) else d_pt_slots

        # per-(point, camera) coupling tables of the dense-Schur path
        pc = {}
        if dense_ok:
            pc_r_slot, pc_r_mask = make_pc_tables(r_pt, r_valid, Pb, Cb, Sc)
            pc_d_slot, pc_d_mask = make_pc_tables(d_pt, d_valid, Pb, Cb, Sdc)
            if pc_r_slot is not None and pc_d_slot is not None:
                pc = dict(
                    pc_r_slot=i64(pc_r_slot),
                    pc_r_mask=f32(pc_r_mask),
                    pc_d_slot=i64(pc_d_slot),
                    pc_d_mask=f32(pc_d_mask),
                )
        elif representation != "sparse":
            # the large-scene single-device path: explicit block-sparse
            # Schur structure (the distributed solver's "sparse" build
            # partitions its own tables)
            with TIMERS.phase("ba.block_schur_tables"):
                bs = make_block_schur_tables(r_pt, r_cam, r_valid, d_pt, d_cam, d_valid, Pb, Cb)
            if bs is not None:
                pc = dict(bs=tables_to(bs, dev))

        data = BAData(
            **shared,
            r_cam=i64(r_cam),
            r_pt=i64(r_pt),
            r_uv=f32(r_uv),
            r_valid=f32(r_valid),
            r_mag=f32(np.full(No, reproj_mag, dtype)),
            r_scale=f32(np.full(No, reproj_scale, dtype)),
            d_cam=i64(d_cam),
            d_pt=i64(d_pt),
            d_logtarget=f32(d_log),
            d_valid=f32(d_valid),
            d_mag=f32(d_mag_arr),
            d_scale=f32(d_scale_arr),
            r_pt_slots=i64(r_pt_slots),
            r_pt_slot_mask=f32(r_pt_mask),
            d_pt_slots=i64(d_pt_slots),
            d_pt_slot_mask=f32(d_pt_mask),
            **pc,
        )
    dense = None
    if want_dense:
        # the seven (Cb,Pb) observation grids, built on the host
        grids = np.zeros((7, Cb, Pb), dtype)
        grids[3] += 1.0  # r_scale default
        grids[6] += 1.0  # d_scale default
        v = r_valid > 0
        grids[0][r_cam[v], r_pt[v]] = r_uv[v, 0]
        grids[1][r_cam[v], r_pt[v]] = r_uv[v, 1]
        grids[2][r_cam[v], r_pt[v]] = reproj_mag
        grids[3][r_cam[v], r_pt[v]] = reproj_scale
        vd = d_valid > 0
        grids[4][d_cam[vd], d_pt[vd]] = d_log[vd]
        grids[5][d_cam[vd], d_pt[vd]] = d_mag_arr[vd]
        grids[6][d_cam[vd], d_pt[vd]] = d_scale_arr[vd]
        grids_dev = f32(grids)
        dense = DenseBAData(
            **shared,
            uv_x=grids_dev[0], uv_y=grids_dev[1],
            r_w=grids_dev[2], r_scale=grids_dev[3],
            d_logt=grids_dev[4], d_w=grids_dev[5], d_scale=grids_dev[6],
        )
    return BAProblem(
        data=data, cam_ids=cam_ids, pt_ids=np.asarray(all_pts, np.int64),
        n_cams=C, n_pts=len(all_pts), dense=dense, depth_specs=depth_specs,
    )


def apply_ba_result(rec: Reconstruction, problem: BAProblem, quat, t, xyz):
    """Write optimized poses/points (host arrays or tensors) back into the
    Reconstruction."""
    quat, t, xyz = (
        (a.cpu().numpy() if torch.is_tensor(a) else a).astype(np.float64) for a in (quat, t, xyz)
    )
    for i, imid in enumerate(problem.cam_ids):
        pose = rec.images[imid].pose
        pose.q = quat[i] / np.linalg.norm(quat[i])
        pose.t = t[i]
    if len(problem.pt_ids):
        rec.xyz[problem.pt_ids] = xyz[: problem.n_pts]
