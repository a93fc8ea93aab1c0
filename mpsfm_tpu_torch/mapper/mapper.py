"""MpsfmMapper: the incremental mapping controller (port of
mpsfm_tpu/mapper/mapper.py).

Port of the reference's mapper main loop (mpsfm/sfm/mapper/base.py:239-417)
— init-pair search with threshold relaxation, the next-view loop with the
multi-level failure ladder (freeze candidates → halve AP inliers / relax
DC thresholds / skip DC), post-init and post-registration refinement with
prior shift/scale alignment and depth integration, iterative local/global
refinement with growth-triggered global BA, and the final robustified
global pass. Host logic is the JAX package's, sequential and cheap; every
numeric step runs on the mapper's device (the card unless the caller asks
for the CPU): the RANSACs, the BiNI integration (K2), the int_covs
propagation (K3), the point covariances (K1 many), the dense LM-Schur BA
(K1; above the dense layout the sparse LM of ba/solver.py with its
block-sparse Schur CG) and the depth-consistency check.

With two ranks or more in a process group every rank runs this loop on
the same inputs and takes the same decisions; the global BAs of
dist_ba_min_cams cameras or more are then sharded over the ranks
(Optimizer._run_solve_dist, parallel/dist_ba.py), the only step that
communicates. Nothing falls back: a failed collective or a rank whose
state diverged raises, and the mapper does not catch it.
"""

from __future__ import annotations

import os

import numpy as np

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.integration.bini import take_z
from mpsfm_tpu_torch.mapper.depth_consistency import DepthConsistencyChecker
from mpsfm_tpu_torch.mapper.image_selection import ImageSelection
from mpsfm_tpu_torch.mapper.optimizer import Optimizer
from mpsfm_tpu_torch.mapper.registration import Registration
from mpsfm_tpu_torch.mapper.triangulator import Triangulator
from mpsfm_tpu_torch.scene.image_priors import (
    finalize_deferred_all,
    finalize_integration,
    int_covs_bundle_batched,
    int_covs_bundle_deferred,
    integrate_bundle_batched,
    integrate_bundle_deferred,
    materialize_depths,
)
from mpsfm_tpu_torch.scene.reconstruction import Reconstruction
from mpsfm_tpu_torch.utils.profiling import TIMERS


class MpsfmMapper(BaseClass):
    default_conf = {
        "verbose": 0,
        # COLMAP operating points used by the controller:
        "filter_max_reproj_error": 4.0,
        "filter_min_tri_angle": 0.001,
        "ba_local_max_refinements": 2,
        "ba_local_max_refinement_change": 0.001,
        "ba_global_max_refinements": 5,
        "ba_global_max_refinement_change": 0.0005,
        # MP-SfM logic:
        "integrate": True,
        "int_covs": True,
        "int_covs_every_iter": False,
        "depth_consistency": True,
        "depth_consistency_init": False,
        "dc_num_frames": 5,
        "dc_all_frames": False,
        # exploration: skip registering a candidate whose previous DC score
        # already exceeds the threshold (reference base.py:364-366; its
        # checker body is unfinished upstream — depthconsistency.py:169-187
        # raises NotImplementedError — we implement the documented intent).
        "pre_fail": False,
        "final_robustification": 0.125,
        "times_relax_init_thresh": 1,
        "local_bundle_size": 5,
        # subobject confs:
        "registration": {},
        "triangulator": {},
        "ba": {},
        "next_view": {},
        "depth_consistency_checker": {},
    }

    def _propagate_conf(self):
        for sub in ("registration", "triangulator", "ba", "next_view", "depth_consistency_checker"):
            self.conf[sub]["verbose"] = self.conf.verbose

    def _init(self, rec: Reconstruction, correspondences, device="cuda"):
        """device: where every numeric step runs (the card unless the caller
        asks for the CPU; no GPU raises). The Optimizer, Registration and
        DepthConsistencyChecker take it; each image's ImagePriors must hold
        its rows there already (ValueError otherwise: no silent copies)."""
        self.device = resolve_device(device)
        for imid, im in rec.images.items():
            pri = getattr(im, "priors", None)
            if pri is not None and pri.device != self.device:
                raise ValueError(f"MpsfmMapper on {self.device}: the ImagePriors of image {imid} are on {pri.device}")
        self.rec = rec
        self.correspondences = correspondences
        self.optimizer = Optimizer(self.conf.ba, rec, device=self.device)
        self.triangulator = Triangulator(self.conf.triangulator, rec, correspondences.cg)
        self.registration = Registration(self.conf.registration, rec, correspondences, self.triangulator,
                                         device=self.device)
        self.nextview = ImageSelection(self.conf.next_view, rec, correspondences)
        self.dc = DepthConsistencyChecker(self.conf.depth_consistency_checker, rec, device=self.device)
        self.prev_num_reg_images = 0
        self.prev_num_points3D = 0
        self.first_refinement = True

    # ---------- state transitions (reference :207-237) ----------
    def _priors(self, imid):
        return getattr(self.rec.images[imid], "priors", None)

    def deregister_image(self, imid):
        self.rec.deregister_image(imid)

    def at_registration_failure(self):
        cand = self.nextview.candid
        if cand is not None and self.rec.images[cand].registered:
            self.deregister_image(cand)

    def at_init_failure(self, init_pair):
        for imid in init_pair:
            if self.rec.images[imid].registered:
                self.deregister_image(imid)
            d = getattr(self.rec.images[imid], "depth", None)
            if d is not None and d.activated:
                d.reset()

    def at_success(self):
        self.nextview.at_success()
        self.dc.at_registration_success()
        self.registration.half_ap_min_inliers = 0
        for imid, im in self.rec.images.items():
            if not im.registered:
                im.failed_normal_registration = False

    def at_failure(self, imid):
        self.nextview.at_failure(imid)
        if not self.rec.images[imid].failed_dc_check:
            self.rec.images[imid].failed_normal_registration = True

    # ---------- main loop ----------
    def __call__(self, exclude_init_pairs=None):
        rec = self.rec
        exclude_init_pairs = exclude_init_pairs or set()

        # Phase A — initialization (reference :244-285)
        relax = 0
        success = False
        while True:
            ranked = self.nextview.find_init_pairs(exclude_init_pairs)
            if not ranked:
                if relax > self.conf.times_relax_init_thresh:
                    self.log("Failed to find init pair")
                    return rec, False
                relax += 1
                continue
            relax += 1
            for init_pair in ranked:
                with TIMERS.phase("init.register_pair"):
                    success = self.registration.register_and_triangulate_init_pair(*init_pair)
                if success:
                    with TIMERS.phase("init.post_init_refinement"):
                        success = self.post_init_refinement()
                if success and self.conf.depth_consistency and self.conf.depth_consistency_init:
                    success = self.dc.check_init_pair(init_pair)
                if success:
                    with TIMERS.phase("init.global_refinement"):
                        success = self.iterative_global_refinement()
                if not success:
                    exclude_init_pairs.add(init_pair)
                    self.at_init_failure(init_pair)
                    continue
                break
            if success:
                self.log(f"Init pair: {init_pair}", level=1)
                break
            if relax > self.conf.times_relax_init_thresh and not ranked:
                return rec, False
            if not success and len(exclude_init_pairs) >= len(self.correspondences.image_pairs()):
                return rec, False

        # Phase B — incremental loop (reference :287-399)
        while True:
            if self.nextview.candid is not None:
                if not rec.images[self.nextview.candid].registered:
                    self.at_failure(self.nextview.candid)
                else:
                    self.at_success()

            # DC-failure batch gate: after dc_num_frames failures in one
            # registration batch (or every remaining candidate failed),
            # retry only resampled candidates / give up on DC
            # (reference base.py:295-318).
            if not self.conf.dc_all_frames and (
                len(self.nextview.freeze_imids) > 0
                and (
                    self.dc.reg_batch_dc_times_failed >= self.conf.dc_num_frames
                    or self.dc.reg_batch_dc_times_failed
                    == rec.num_images() - rec.num_reg_images()
                )
            ):
                if self.dc.conf.depth_consistency_resample:
                    resample_imids = {
                        imid
                        for imid in self.nextview.freeze_imids
                        if rec.images[imid].dc_times_inliers_resampled == 1
                        and rec.images[imid].failed_dc_check
                    }
                    for imid in resample_imids:
                        rec.images[imid].failed_dc_check = False
                    success = self.nextview.next_image(list(resample_imids))
                    if not success:
                        self.log("Resample failed: skipping DC checks", level=1)
                        self.dc.skip_dc_check = True
                        for im in rec.images.values():
                            im.ignore_matches_AP = {}
                else:
                    success = False
            else:
                with TIMERS.phase("next_image_selection"):
                    success = self.nextview.next_image()
            if not success:
                if rec.num_reg_images() == rec.num_images():
                    self.log("All images registered")
                    break
                if (
                    self.registration.half_ap_min_inliers
                    >= self.registration.conf.reduce_min_inliers_at_failure
                ):
                    self.log("Ending: AP inliers reduced too many times")
                    break
                # failure ladder (reference :332-349)
                if not self.conf.depth_consistency or self.dc.skip_dc_check:
                    self.registration.half_ap_min_inliers += 1
                    self.log(f"Halving AP inliers ({self.registration.half_ap_min_inliers})", level=1)
                    for im in rec.images.values():
                        im.failed_normal_registration = False
                elif self.dc.depth_cons_thresh >= 1 or self.dc.cons_thresh_times_increased >= 4:
                    self.dc.skip_dc_check = True
                else:
                    self.dc.relax_thresholds()
                self.nextview.freeze_imids = {
                    imid
                    for imid, im in rec.images.items()
                    if im.failed_normal_registration
                }
                self.nextview.candid = None
                continue

            cand = self.nextview.candid
            self.log(
                f"({rec.num_reg_images()}/{rec.num_images()}) Registering image {cand}: "
                f"{rec.images[cand].name}",
                level=1,
            )
            if self.conf.depth_consistency and self.conf.pre_fail:
                if self.dc.pre_fail(cand):
                    continue  # top of loop marks the candidate failed
            if rec.best_next_ref_imid is not None:
                ref_imids = set(rec.find_local_bundle_ids(rec.best_next_ref_imid)) | {
                    rec.best_next_ref_imid
                }
                ref_imids = {i for i in ref_imids if rec.images[i].registered}
            else:
                ref_imids = None
            with TIMERS.phase("register+triangulate"):
                # batch-materialize the refs' device-resident depths: the
                # 2D-3D lifting below samples each of them on the host
                materialize_depths(
                    self.rec,
                    (ref_imids or set(self.rec.reg_image_ids())) | {cand},
                )
                reg_ok = self.registration.register_and_triangulate_next_image(cand, ref_imids=ref_imids)
            if not reg_ok:
                self.at_registration_failure()
                continue
            with TIMERS.phase("post_registration_refinement"):
                prr_ok = self.post_registration_refinement(
                    cand, check_depth_consistency=not self.dc.skip_dc_check
                )
            if not prr_ok:
                self.at_registration_failure()
                continue
            with TIMERS.phase("local_refinement"):
                ilr_ok = self.iterative_local_refinement(cand)
            if not ilr_ok:
                self.at_registration_failure()
                continue
            if rec.num_reg_images() != rec.num_images() and self.check_run_global_refinement():
                with TIMERS.phase("global_refinement"):
                    igr_ok = self.iterative_global_refinement()
                if not igr_ok:
                    self.at_registration_failure()
                    continue

        # final robustified global pass (reference :401-417)
        with TIMERS.phase("final_global_pass"):
            ok_final = self.iterative_global_refinement(
                param_multiplier=self.conf.final_robustification
                if self.conf.final_robustification is not None
                else 1.0,
                final=True,
            )
        del ok_final  # reference ignores the final pass's verdict
        return rec, True

    # ---------- refinement (reference :420-667) ----------
    def _refinement(self, bundle, mode="global", refimid=None, allow_scale_filter=False, **kw):
        _, success = self.adjust_bundle(
            bundle, mode=mode, refimid=refimid, allow_scale_filter=allow_scale_filter, **kw
        )
        if not success:
            return None, False
        num_obs = max(len(bundle["pts3D"]), 1)
        num_changed, filtered_imids = self.filter_bundle(bundle)
        num_changed += self.triangulator.complete_and_merge_tracks(list(bundle["pts3D"]))
        changed = num_changed / num_obs
        if filtered_imids:
            return "deregistered", False
        return changed, True

    def adjust_bundle(self, bundle, mode="global", refimid=None, allow_scale_filter=False, **kw):
        if self.conf.integrate and self._fused_refine_enabled():
            # fused refinement: the BiNI gate + solve, the depth-observation
            # rows and the LM-Schur BA chain on the device, with the depth
            # maps read by the host only after the BA; the truncation
            # multiplier is fitted there too (ba/device_depth.build_depth_grids)
            integrate_imids = bundle["optim_ids"] if mode == "global" else [refimid]
            handles, pending, unc_over, pending_covs = self._integrate_deferred(
                integrate_imids
            )
            z_getter = self._make_z_getter(handles)
            info, success = self.optimizer.ba_fused(
                bundle, mode, z_getter, pending=pending,
                allow_scale_filter=allow_scale_filter,
                update_trunc=(mode == "global"),
                unc_overrides=unc_over, pending_covs=pending_covs, **kw
            )
            return info, success
        if self.conf.integrate:
            integrate_imids = bundle["optim_ids"] if mode == "global" else [refimid]
            if not self.integrate_bundle(integrate_imids):
                return None, False
        if mode == "global":
            with TIMERS.phase("truncation_multiplier"):
                self.optimizer.update_truncation_multiplier(self.rec.reg_image_ids())
        with TIMERS.phase(f"ba[{mode}]"):
            info, success = self.optimizer.ba(
                bundle, mode=mode, allow_scale_filter=allow_scale_filter, **kw
            )
        return info, success

    def _fused_refine_enabled(self):
        return os.environ.get("MPSFM_FUSED_REFINE", "1") == "1"

    def _make_z_getter(self, handles):
        """(imid) -> (device log-depth grid, scalar shift): the freshly
        integrated z for handled images (its lane of the batch), the cached
        device z0 otherwise."""

        def z_getter(imid):
            h = handles.get(imid) if handles else None
            if h is not None:
                z_b, lane = h
                return take_z(z_b, lane), 0.0
            return self._priors(imid)._z0_shift_dev()

        return z_getter

    def _integrate_deferred(self, imids):
        """integrate_bundle's deferred twin: dispatches the gate+solve
        without a read. On int_covs iterations the diag(H⁻¹)
        propagation chains off the fresh z on device too — the updated
        depth variances reach the BA as device rows and the host
        bookkeeping follows the read of the BA result."""
        with TIMERS.phase("integrate_bundle"):
            pris = [self._priors(imid) for imid in imids]
            pris = [p for p in pris if p is not None]
            if not pris:
                return None, None, None, None
            handles, pending = integrate_bundle_deferred(pris)
            unc_over = pending_covs = None
            if self.conf.int_covs and self.first_refinement:
                if len(pris) <= 2:
                    # small bundles (local refinements): chain the
                    # diag(H⁻¹) propagation off the fresh z — no read
                    info_map = {}
                    for pris_g, _z, info_dev in pending:
                        for k, pri in enumerate(pris_g):
                            info_map[pri.imid] = (info_dev, k)
                    with TIMERS.phase("int_covs_at_kps"):
                        unc_over, pending_covs = int_covs_bundle_deferred(
                            pris, handles, info_map
                        )
                else:
                    # large (global) bundles: the all-lane CG compute of
                    # an ungated device chain exceeds the read it saves —
                    # finalize early and propagate only the changed subset
                    with TIMERS.phase("bini.fetch_finalize"):
                        changed_map = finalize_integration(pending)
                    pending = None
                    need_covs = [pri for pri in pris if changed_map.get(pri.imid)]
                    if need_covs:
                        with TIMERS.phase("int_covs_at_kps"):
                            int_covs_bundle_batched(need_covs)
            if not self.conf.int_covs_every_iter:
                self.first_refinement = False
            return handles, pending, unc_over, pending_covs

    def integrate_bundle(self, imids, **kw):
        with TIMERS.phase("integrate_bundle"):
            pris = [self._priors(imid) for imid in imids]
            pris = [p for p in pris if p is not None]
            # one gate + solve over the whole bundle (single images too)
            changed_map = integrate_bundle_batched(pris) if pris else {}
            need_covs = [
                pri
                for pri in pris
                if self.conf.int_covs and changed_map.get(pri.imid) and self.first_refinement
            ]
            if need_covs:
                with TIMERS.phase("int_covs_at_kps"):
                    int_covs_bundle_batched(need_covs)
            if not self.conf.int_covs_every_iter:
                self.first_refinement = False
        return True

    def iterative_local_refinement(self, imid):
        with TIMERS.phase("complete_and_merge"):
            self.triangulator.complete_and_merge_all_tracks()
        self.first_refinement = True
        for _ in range(self.conf.ba_local_max_refinements):
            local_bundle = self.find_local_bundle(imid)
            observed = self.find_subset_bundle(local_bundle)
            self.optimizer.calculate_point_covs(observed)
            changed, success = self._refinement(
                local_bundle, mode="local", refimid=imid, allow_scale_filter=True
            )
            if not success:
                if changed == "deregistered" and not self.rec.images[imid].registered:
                    return False
                if changed == "deregistered":
                    continue
                return False
            if changed < self.conf.ba_local_max_refinement_change:
                break
            if not self.rec.images[imid].registered:
                return False
        return True

    def iterative_global_refinement(self, param_multiplier=1.0, final=False):
        with TIMERS.phase("complete_and_merge"):
            self.triangulator.complete_and_merge_all_tracks()
        self.first_refinement = True
        self.triangulator.retriangulate()
        for _ in range(self.conf.ba_global_max_refinements):
            bundle = self.find_global_bundle()
            if not bundle["pts3D"]:
                return False
            self.optimizer.calculate_point_covs(bundle)
            changed, success = self._refinement(
                bundle, mode="global", allow_scale_filter=True, param_multiplier=param_multiplier
            )
            if not success and changed is None:
                return False
            self.normalize()
            if changed == "deregistered" or (
                isinstance(changed, float) and changed < self.conf.ba_global_max_refinement_change
            ):
                if final:
                    continue
                break
        self.prev_num_reg_images = self.rec.num_reg_images()
        self.prev_num_points3D = self.rec.num_points3D()
        return True

    def post_init_refinement(self):
        """Reference :516-539: point covs -> shift/scale -> activate ->
        refine points -> filter."""
        self.first_refinement = True
        bundle = self.find_global_bundle()
        if not bundle["pts3D"]:
            return False
        self.optimizer.calculate_point_covs(bundle)
        shift_scale, ok = self.optimizer.optimize_prior_shiftscale(bundle)
        if not ok:
            return False
        self.rescale_all(shift_scale)
        self.activate_depths(bundle["optim_ids"])
        if not self.optimizer.refine_3d_points(bundle)[1]:
            return False
        self.filter_all()
        if not self.rec.registered_images:
            return False
        return True

    def post_registration_refinement(self, imid, check_depth_consistency=True):
        """Reference :541-617."""
        rec = self.rec
        self.first_refinement = True
        d = getattr(rec.images[imid], "depth", None)
        if d is not None and d.activated:
            d.reset()
        local_bundle = self.find_local_bundle(imid)
        if not self.conf.depth_consistency or not check_depth_consistency:
            _, filtered = self.filter_bundle(local_bundle)
            if filtered and imid in filtered:
                return False
        with TIMERS.phase("refine_3d_points"):
            ok3d = self.optimizer.refine_3d_points(
                local_bundle, depth_type="prior" if not self.conf.integrate else "update"
            )[1]
        if not ok3d:
            return False
        with TIMERS.phase("postreg.bundles"):
            local_bundle = self.find_local_bundle(imid)
            observed = self.find_subset_bundle(local_bundle)
        self.optimizer.calculate_point_covs(observed)
        local_bundle["ref_id"] = imid
        shift_scale, ok = self.optimizer.optimize_prior_shiftscale(
            local_bundle, allow_metric_scale_filter=True
        )
        if not ok:
            return False
        self.rescale_all(shift_scale)
        self.activate_depths({imid})
        # fused tail: deferred integrate -> the DC check reads the fresh z
        # through a device override -> refine_3d's read of the BA result
        # also finalizes the integration and int_covs
        handles = pending = unc_over = pending_covs = None
        fuse_tail = (
            self.conf.integrate
            and self._fused_refine_enabled()
            and self._priors(imid) is not None
        )
        with TIMERS.phase("postreg.integrate"):
            if fuse_tail:
                handles, pending, unc_over, pending_covs = self._integrate_deferred(
                    [imid]
                )
            elif self.conf.integrate and not self.integrate_bundle([imid]):
                return False
        if self.conf.depth_consistency and check_depth_consistency:
            bundle = {
                "optim_ids": set(rec.find_local_bundle_ids(imid, self.conf.local_bundle_size))
                | {imid}
            }
            dc_overrides = None
            if handles and imid in handles:
                z_b, lane = handles[imid]
                dc_overrides = {imid: (take_z(z_b, lane), 0.0)}
            with TIMERS.phase("dc_check"):
                dc_ok = self._priors(imid) is None or self.dc.check_image(
                    imid, bundle, z_overrides=dc_overrides
                )
            if not dc_ok:
                if pending is not None or pending_covs:
                    finalize_deferred_all(pending, pending_covs)
                return False
        with TIMERS.phase("refine_3d_points"):
            if fuse_tail and handles is not None:
                ok3d = self.optimizer.ba_fused(
                    local_bundle, "global", self._make_z_getter(handles),
                    pending=pending, fix_pose=True, depth_type="update",
                    unc_overrides=unc_over, pending_covs=pending_covs,
                )[1]
            else:
                if fuse_tail:
                    # priors exist but nothing integrated (no handles)
                    finalize_deferred_all(pending, pending_covs)
                ok3d = self.optimizer.refine_3d_points(
                    local_bundle, depth_type="prior" if not self.conf.integrate else "update"
                )[1]
        if not ok3d:
            return False
        local_bundle = self.find_local_bundle(imid)
        _, filtered = self.filter_bundle(local_bundle)
        if imid not in rec.registered_images:
            return False
        return True

    def check_run_global_refinement(self):
        """Growth triggers (reference :657-667)."""
        n_reg = self.rec.num_reg_images()
        n_pts = self.rec.num_points3D()
        thresh = 0.3
        prev_reg = max(self.prev_num_reg_images, 1)
        prev_pts = max(self.prev_num_points3D, 1)
        return (
            ((n_reg - prev_reg) / prev_reg) > thresh
            or (n_reg - prev_reg) > 500
            or ((n_pts - prev_pts) / prev_pts) > thresh
            or (n_pts - prev_pts) > 250000
        )

    # ---------- depth state ----------
    def normalize(self):
        """Normalize the reconstruction AND rescale all depth state by the
        same factor (reference scene/reconstruction/base.py:105-121)."""
        scale = self.rec.normalize()
        if scale != 1.0:
            for im in self.rec.images.values():
                d = getattr(im, "depth", None)
                if d is not None:
                    d.rescale(0.0, scale, rescale_working=True)
        return scale

    def activate_depths(self, imids):
        for imid in imids:
            d = getattr(self.rec.images[imid], "depth", None)
            if d is not None:
                d.activate()

    def rescale_all(self, shift_scales):
        for imid, (shift, scale) in shift_scales.items():
            d = getattr(self.rec.images[imid], "depth", None)
            if d is not None:
                d.rescale(shift, scale)

    # ---------- filters / bundles (reference :686-826) ----------
    def filter_bundle(self, bundle, filter_ims=True):
        with TIMERS.phase("filter_bundle"):
            return self._filter_bundle(bundle, filter_ims)

    def _filter_bundle(self, bundle, filter_ims=True):
        rec = self.rec
        rec.filter_observations_with_negative_depth()
        max_err = self.conf.filter_max_reproj_error * np.median(
            [im.kp_std for im in rec.images.values()]
        )
        # depth-invalid risky points: invalid in every bundle image
        risky_sets = []
        for imid in bundle["optim_ids"]:
            im = rec.images[imid]
            d = getattr(im, "depth", None)
            if d is None:
                risky_sets = []
                break
            kp_ids = im.observed_kp_ids()
            if len(kp_ids) == 0:
                risky_sets.append(set())
                continue
            valid = d.valid_at_kps(im.keypoints[kp_ids])
            risky_sets.append(set(im.point3D_ids[kp_ids][~valid].tolist()))
        changed = 0
        if risky_sets:
            risky = set.intersection(*risky_sets) if risky_sets else set()
            changed += rec.filter_points3D(max_err, 1.5, risky)
        pts = set(bundle.get("pts3D", set())) | set(bundle.get("constpoints", set()))
        changed += rec.filter_points3D(max_err, self.conf.filter_min_tri_angle, pts)
        filtered_imids = rec.filter_images() if filter_ims else set()
        return changed, filtered_imids

    def filter_all(self):
        rec = self.rec
        rec.filter_observations_with_negative_depth()
        max_err = self.conf.filter_max_reproj_error * np.median(
            [im.kp_std for im in rec.images.values()]
        )
        n = rec.filter_all_points3D(max_err, self.conf.filter_min_tri_angle)
        filtered = rec.filter_images()
        return n, filtered

    def find_local_bundle(self, refimid, num_images=None):
        rec = self.rec
        optim_ids = set(rec.find_local_bundle_ids(refimid, num_images)) | {refimid}
        out = {"ref_id": refimid, "optim_ids": optim_ids}
        pts = set()
        for imid in optim_ids:
            im = rec.images[imid]
            pts.update(im.point3D_ids[im.point3D_ids >= 0].tolist())
        ref_im = rec.images[refimid]
        out["pts3D"] = set(ref_im.point3D_ids[ref_im.point3D_ids >= 0].tolist())
        out["constpoints"] = pts - out["pts3D"]
        return out

    def find_global_bundle(self):
        rec = self.rec
        return {
            "optim_ids": set(rec.reg_image_ids()),
            "pts3D": set(rec.point_ids().tolist()),
            "constpoints": set(),
        }

    def find_subset_bundle(self, bundle):
        rec = self.rec
        optim_ids = set(bundle["optim_ids"])
        seen_mark = np.zeros(len(rec.alive), bool)
        for imid in bundle["optim_ids"]:
            im = rec.images[imid]
            seen_mark[im.point3D_ids[im.point3D_ids >= 0]] = True
        for imid, im in rec.registered_images.items():
            if imid in optim_ids:
                continue
            pids = im.point3D_ids[im.point3D_ids >= 0]
            if len(pids) and seen_mark[pids].any():
                optim_ids.add(imid)
        seen = set(np.where(seen_mark)[0].tolist())
        return {"optim_ids": optim_ids, "pts3D": seen}
