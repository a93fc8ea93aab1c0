"""Optimizer facade: the reference Optimizer's public API
(mpsfm/sfm/mapper/bundle_adjustment.py:18-333) over the port's LM core
(port of mpsfm_tpu/mapper/optimizer.py, its dense path).

Bundles whose dense (C,P) layout fits (ba/problem.py: Pb·Cb ≤ 8e6, 64
cameras × 8192 points and every mapper bundle of that size) solve with
ba/dense.solve_ba_dense, whose reduced system goes to K1 on the card.
The results the host needs are read with `.cpu()`; the JAX package packs
them into one read for its TPU transport. Not ported, each raising
NotImplementedError before anything is built or finalized: the sparse
slot-table LM (`solve_ba`, slice 6a) for a bundle above the dense layout
(build_ba_data refuses it), and the distributed BA over several cards
(ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.ba.covariance import MAX_CAMS_DENSE
from mpsfm_tpu_torch.ba.covariance import calculate_point_covs as _calc_covs
from mpsfm_tpu_torch.ba.dense import solve_ba_dense
from mpsfm_tpu_torch.ba.device_depth import build_depth_grids, sample_logd
from mpsfm_tpu_torch.ba.problem import apply_ba_result, build_ba_data
from mpsfm_tpu_torch.ba.shift_scale import optimize_prior_shiftscale as _shift_scale
from mpsfm_tpu_torch.ba.shift_scale import update_truncation_multiplier as _trunc
from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.scene.image_priors import (
    finalize_int_covs,
    finalize_integration,
    read_varlogs,
)
from mpsfm_tpu_torch.scene.reconstruction import Reconstruction
from mpsfm_tpu_torch.utils.profiling import TIMERS


class Optimizer(BaseClass):
    default_conf = {
        "depth_loss_name": "cauchy",
        "ref3d_loss_name": "trivial",
        "reproj_loss_name": "softl1",
        "reproj_loss_scale": 1.5,
        "scale_filter": True,
        "scale_filter_factor": 1.5,
        "metric_scale_filter": True,
        "rob_std": 2,
        "min_truncation_mult": None,
        "single_rescale": True,
        "max_iters": 20,
        "cg_iters": 32,
        "use_depth": True,
        # distributed BA over several devices: "auto" | "on" | "off"
        # (the sharded solve is not ported: a bundle given to it raises)
        "dist_ba": "auto",
        "dist_ba_min_cams": 96,
        "dist_ba_shards": 0,  # 0 -> all local devices
        "verbose": 0,
    }

    def _init(self, rec: Reconstruction, device="cuda"):
        self.rec = rec
        self.device = resolve_device(device)
        self.truncation_multiplier = 1.0

    def _solve(self, bundle, mode, fix_pose, depth_loss_name, param_multiplier=1.0,
               allow_scale_filter=False, depth_type="update"):
        self._refuse_dist_ba(bundle, mode, fix_pose)
        with TIMERS.phase("ba.build_data"):
            prob = self._build(
                bundle, mode, fix_pose, param_multiplier,
                allow_scale_filter, depth_type,
            )
        return self._run_solve(prob, mode, depth_loss_name)

    def _build(self, bundle, mode, fix_pose, param_multiplier,
               allow_scale_filter, depth_type, device_depth=False):
        return build_ba_data(
            self.rec,
            bundle,
            mode=mode,
            fix_pose=fix_pose,
            reproj_loss_scale_mult=self.conf.reproj_loss_scale,
            depth_rob_scale=self.conf.rob_std,
            param_multiplier=param_multiplier,
            truncation_multiplier=self.truncation_multiplier,
            depth_type=depth_type,
            allow_scale_filter=allow_scale_filter and self.conf.scale_filter,
            scale_filter_factor=self.conf.scale_filter_factor,
            use_depth=self.conf.use_depth,
            representation="solve",
            device_depth=device_depth,
            device=self.device,
        )

    def _use_dist_ba(self, bundle, mode):
        """How many devices a global BA is sharded over, as the JAX package
        decides it (0: one device; a CPU tensor counts one)."""
        if self.conf.dist_ba == "off" or mode != "global":
            return 0
        n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        n = int(self.conf.dist_ba_shards) or n_dev
        n = min(n, n_dev)
        if n < 2:
            return 0
        if self.conf.dist_ba == "on":
            return n
        C = len(bundle["optim_ids"])
        return n if C >= int(self.conf.dist_ba_min_cams) else 0

    def _refuse_dist_ba(self, bundle, mode, fix_pose):
        """Raises on a sharded decision of _use_dist_ba, before anything is
        built or finalized: the distributed BA is not ported."""
        n_shards = 0 if fix_pose else self._use_dist_ba(bundle, mode)
        if n_shards:
            raise NotImplementedError(
                f"Optimizer: the distributed BA over {n_shards} devices (_run_solve_dist) is not ported; it comes "
                "with the multi-card slice (ROADMAP queue 1 item 5). dist_ba='off' solves on one device."
            )

    def _run_solve(self, prob, mode, depth_loss_name):
        quat, t, xyz, info = solve_ba_dense(
            prob.dense,
            reproj_loss=losses.LOSS_IDS[self.conf.reproj_loss_name],
            depth_loss=losses.LOSS_IDS[depth_loss_name],
            max_iters=self.conf.max_iters,
        )
        cost0, cost, accepted = float(info["cost0"]), float(info["cost"]), int(info["accepted"])
        if not np.isfinite(cost):
            return None, False
        apply_ba_result(self.rec, prob, quat, t, xyz)
        self.log(
            f"BA[{mode}] cost {cost0:.1f} -> {cost:.1f} ({accepted} steps)",
            level=2,
        )
        return {"cost0": cost0, "cost": cost, "accepted": accepted}, True

    def ba(self, bundle, mode="global", param_multiplier=1.0, allow_scale_filter=False, **kw):
        return self._solve(
            bundle, mode, fix_pose=False, depth_loss_name=self.conf.depth_loss_name,
            param_multiplier=param_multiplier, allow_scale_filter=allow_scale_filter,
        )

    def ba_fused(self, bundle, mode, z_getter, pending=None, param_multiplier=1.0,
                 allow_scale_filter=False, fix_pose=False, depth_type="update",
                 update_trunc=False, unc_overrides=None, pending_covs=None):
        """Integrate->BA chained solve: the depth-observation grids are
        derived on the device from the device-resident log-depth maps
        (ba/device_depth.py), so the refinement iteration (BiNI gate and
        solve, depth rows, LM-Schur BA, the optional MAD truncation
        multiplier) reads the host nothing before the BA's result.

        z_getter(imid) -> (log-depth grid tensor, scalar shift).
        pending: integrate_bundle_deferred's finalize payload, finalized
        after the BA with its info rows; unc_overrides / pending_covs:
        int_covs_bundle_deferred's device variance rows and its payload.
        The JAX package's fallback (finalize_deferred_all, then the host
        depth rows) serves the layouts this port refuses: a sharded
        decision raises here and a bundle above the dense layout in
        build_ba_data, both before pending is touched."""
        depth_loss_name = (
            self.conf.ref3d_loss_name if fix_pose else self.conf.depth_loss_name
        )
        self._refuse_dist_ba(bundle, mode, fix_pose)
        with TIMERS.phase("ba.build_data"):
            prob = self._build(
                bundle, mode, fix_pose, param_multiplier, allow_scale_filter,
                depth_type, device_depth=True,
            )
        specs = prob.depth_specs or {}
        dense = prob.dense
        dev = dense.quat.device
        Cb = int(dense.quat.shape[0])
        Pb = int(dense.xyz.shape[0])
        trunc_dev = None
        if specs.get("imids"):
            gx_dev = torch.as_tensor(specs["gx"], device=dev)
            gy_dev = torch.as_tensor(specs["gy"], device=dev)
            rows = []
            sig_rows = []
            kpi_dev = (
                torch.as_tensor(specs["kp_ids"], device=dev).long() if unc_overrides else None
            )
            for r, imid in enumerate(specs["imids"]):
                z2d, shift = z_getter(imid)
                rows.append(sample_logd(z2d, float(np.float32(shift)), gx_dev[r], gy_dev[r]))
                if unc_overrides and imid in unc_overrides:
                    # freshly chained int_covs variances (device rows)
                    sig_rows.append(unc_overrides[imid][kpi_dev[r]])
                else:
                    sig_rows.append(torch.as_tensor(specs["sigma2"][r], device=dev))
            logd = torch.stack(rows)
            sigma2_dev = torch.stack(sig_rows)
            m_base = param_multiplier * self.conf.rob_std * (
                1.0 if update_trunc else self.truncation_multiplier
            )
            min_trunc = (
                self.conf.min_truncation_mult
                if self.conf.min_truncation_mult is not None
                else -1e30
            )
            d_logt, d_w, d_scale, trunc_dev = build_depth_grids(
                logd,
                sigma2_dev,
                torch.as_tensor(specs["ptidx"], device=dev),
                torch.as_tensor(specs["cam_rows"], device=dev),
                dense.quat, dense.t, dense.xyz,
                float(np.float32(m_base)),
                float(np.float32(self.conf.scale_filter_factor)),
                float(np.float32(min_trunc)),
                C=Cb, P=Pb,
                scale_filter=bool(allow_scale_filter and self.conf.scale_filter),
                compute_trunc=bool(update_trunc),
            )
            dense = dense._replace(d_logt=d_logt, d_w=d_w, d_scale=d_scale)

        with TIMERS.phase(f"ba[{mode}]"):
            quat, t, xyz, info = solve_ba_dense(
                dense,
                reproj_loss=losses.LOSS_IDS[self.conf.reproj_loss_name],
                depth_loss=losses.LOSS_IDS[depth_loss_name],
                max_iters=self.conf.max_iters,
            )
            quat, t, xyz = (a.cpu().numpy() for a in (quat, t, xyz))
            cost0, cost, accepted = float(info["cost0"]), float(info["cost"]), int(info["accepted"])
        changed_map = {}
        if pending:
            changed_map = finalize_integration(pending)
        if pending_covs:
            finalize_int_covs(pending_covs, read_varlogs(pending_covs), changed_map)
        if trunc_dev is not None and update_trunc:
            self.truncation_multiplier = float(trunc_dev)
        if not np.isfinite(cost):
            return None, False
        apply_ba_result(self.rec, prob, quat, t, xyz)
        self.log(
            f"BA[{mode}/fused] cost {cost0:.1f} -> {cost:.1f} ({accepted} steps)",
            level=2,
        )
        return {"cost0": cost0, "cost": cost, "accepted": accepted}, True

    def refine_3d_points(self, bundle, depth_type="update", **kw):
        """Poses fixed, points refined with depth regularization
        (reference :276-283). MPSFM_FUSED_REFINE=0 (the JAX package's
        switch) takes the classic path with host depth rows."""
        if depth_type == "update" and os.environ.get("MPSFM_FUSED_REFINE", "1") == "1":
            # device-depth path: the depth targets are sampled from the
            # device-resident log-depth grids
            def z_getter(imid):
                return self.rec.images[imid].priors._z0_shift_dev()

            return self.ba_fused(
                bundle, "global", z_getter, fix_pose=True, depth_type=depth_type
            )
        return self._solve(
            bundle, "global", fix_pose=True, depth_loss_name=self.conf.ref3d_loss_name,
            depth_type=depth_type,
        )

    def optimize_prior_shiftscale(self, bundle, allow_metric_scale_filter=False, **kw):
        with TIMERS.phase("shift_scale"):
            return self._optimize_prior_shiftscale(bundle, allow_metric_scale_filter, **kw)

    def _optimize_prior_shiftscale(self, bundle, allow_metric_scale_filter=False, **kw):
        return _shift_scale(
            self.rec,
            bundle,
            allow_scale_filter=kw.get("allow_scale_filter", False),
            allow_metric_scale_filter=allow_metric_scale_filter,
            scale_filter=self.conf.scale_filter,
            scale_filter_factor=self.conf.scale_filter_factor,
            metric_scale_filter=self.conf.metric_scale_filter,
            single_rescale=self.conf.single_rescale,
            verbose=self.conf.verbose,
        )

    def calculate_point_covs(self, bundle):
        with TIMERS.phase("point_covs"):
            return self._calculate_point_covs(bundle)

    def _calculate_point_covs(self, bundle):
        with TIMERS.phase("point_covs.build"):
            prob = build_ba_data(
                self.rec, bundle, mode="global", use_depth=False, representation="sparse",
                device=self.device,
            )
        if prob.n_cams > MAX_CAMS_DENSE:
            # too many cameras for the dense reduced system: per-point
            # Hpp⁻¹ (ignores pose uncertainty)
            self._fallback_point_covs(bundle)
            return
        with TIMERS.phase("point_covs.device"):
            _calc_covs(self.rec, prob)

    def _fallback_point_covs(self, bundle):
        rec = self.rec
        for pid in bundle["pts3D"]:
            if not rec.alive[pid]:
                continue
            H = np.zeros((3, 3))
            kp_std = np.median([im.kp_std for im in rec.images.values()])
            for imid, kp in rec.tracks[pid]:
                im = rec.images[imid]
                cam = rec.camera(imid)
                X = rec.xyz[pid]
                p_cam = im.pose.transform(X[None])[0]
                z = max(p_cam[2], 1e-6)
                R = im.pose.rotation_matrix()
                # d(px)/dX = K_f * [1/z, 0, -x/z²; 0, 1/z, -y/z²] @ R
                J = (
                    np.array(
                        [
                            [cam.fx / z, 0, -cam.fx * p_cam[0] / z**2],
                            [0, cam.fy / z, -cam.fy * p_cam[1] / z**2],
                        ]
                    )
                    @ R
                )
                H += J.T @ J / kp_std**2
            rec.point_covs[int(pid)] = np.linalg.inv(H + 1e-8 * np.eye(3))

    def update_truncation_multiplier(self, imids):
        self.truncation_multiplier = _trunc(self.rec, imids, self.conf.min_truncation_mult)
