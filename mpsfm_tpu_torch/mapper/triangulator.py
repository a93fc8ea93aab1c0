"""Incremental triangulation: track creation, continuation, completion,
merging, retriangulation, and MP-SfM's low-parallax lifting (a copy of
mpsfm_tpu/mapper/triangulator.py on the port's Reconstruction and
CorrespondenceGraph; host numpy, no device work).

Replacement for COLMAP's IncrementalTriangulator + the reference's
MpsfmTriangulator wrapper (mpsfm/sfm/mapper/triangulator.py). The
pointer-chasing COLMAP recursion becomes flat batched passes: candidate
tracks are padded to (N, T) observation tables and triangulated with one
masked n-view DLT (batched 4x4 eigh), and all acceptance gates
(reprojection error, triangulation angle, cheirality) are vectorized.
"""

from __future__ import annotations

import numpy as np

from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.scene.corrgraph import CorrespondenceGraph
from mpsfm_tpu_torch.scene.reconstruction import INVALID, Reconstruction, quat_rotate_np


def _nview_triangulate(P_mats, xy_norm, mask):
    """Masked n-view DLT, batched in numpy.

    P_mats: (N,T,3,4), xy_norm: (N,T,2), mask: (N,T). Returns xyz (N,3).
    """
    a0 = xy_norm[..., 0:1] * P_mats[..., 2, :] - P_mats[..., 0, :]  # (N,T,4)
    a1 = xy_norm[..., 1:2] * P_mats[..., 2, :] - P_mats[..., 1, :]
    A = np.concatenate([a0, a1], axis=1)  # (N,2T,4)
    m = np.concatenate([mask, mask], axis=1).astype(A.dtype)  # (N,2T)
    Aw = A * m[..., None]
    AtA = np.einsum("nti,ntj->nij", Aw, Aw)
    # batched eigh, smallest eigenvector
    _, v = np.linalg.eigh(AtA)
    X = v[..., :, 0]
    w = X[..., 3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


class Triangulator(BaseClass):
    default_conf = {
        # COLMAP IncrementalTriangulatorOptions analogs:
        "complete_max_reproj_error": 4.0,
        "merge_max_reproj_error": 4.0,
        "min_angle": 0.001,  # reference overrides COLMAP's 1.5 (mapper/base.py:36-38)
        "ignore_two_view_tracks": False,
        # MP-SfM extras (reference triangulator.py:19-28):
        "hard_angle": 1.5,
        "retri_min_angle": 1.5,
        "lift_low_parallax": True,
        "nsafe_threshold": 60,
        "new_retry_nbatch": 5,
        "verbose": 0,
    }

    def _init(self, rec: Reconstruction, cg: CorrespondenceGraph):
        self.rec = rec
        self.cg = cg

    # ---------- helpers ----------
    def _reproj_error_px(self, imid, pids, kps_px):
        px, z = self.rec.project_points_into_image(imid, pids)
        err = np.sqrt(((px - kps_px) ** 2).sum(-1))
        return np.where(z > 0, err, np.inf)

    def _gather_candidates(self, imid):
        """For each unassigned kp of imid: correspondences in registered
        images, split into (a) those pointing at existing 3D points and
        (b) fully untriangulated groups."""
        im = self.rec.images[imid]
        indptr, adj_im, adj_kp = self.cg.correspondences_all(imid)
        reg = {i for i in self.rec.reg_image_ids()}
        return im, indptr, adj_im, adj_kp, reg

    # ---------- main ops ----------
    def triangulate_image(self, imid):
        """Create/continue tracks for a newly registered image
        (IncrementalTriangulator.triangulate_image analog), then lift
        low-parallax creations from refined depth (reference
        triangulator.py:46-85)."""
        before = set(self.rec.point_ids().tolist()) if self.conf.lift_low_parallax else None
        self._triangulate_image_core(imid)
        if self.conf.lift_low_parallax:
            new_pids = np.array(sorted(set(self.rec.point_ids().tolist()) - before), np.int64)
            self._lift_low_parallax(new_pids)
        return True

    def _triangulate_image_core(self, imid):
        im, indptr, adj_im, adj_kp, reg = self._gather_candidates(imid)
        if not self.rec.images[imid].registered:
            return
        max_err = self.conf.complete_max_reproj_error * np.median(
            [i.kp_std for i in self.rec.images.values()]
        )
        n_kp = len(im.keypoints)

        # Pass 1 — continue existing tracks: kp unassigned, a correspondence
        # has a 3D point, and that point reprojects into imid within budget.
        continue_kp, continue_pid = [], []
        create_groups = []  # (kp, [(imid2, kp2), ...]) with no 3D anywhere
        for kp in range(n_kp):
            if im.point3D_ids[kp] >= 0:
                continue
            a, b = indptr[kp], indptr[kp + 1]
            if a == b:
                continue
            oims = adj_im[a:b]
            okps = adj_kp[a:b]
            found_pid = -1
            group = []
            for oim, okp in zip(oims, okps):
                if oim not in reg:
                    continue
                pid = self.rec.images[oim].point3D_ids[okp]
                if pid >= 0:
                    found_pid = int(pid)
                    break
                group.append((int(oim), int(okp)))
            if found_pid >= 0:
                continue_kp.append(kp)
                continue_pid.append(found_pid)
            elif group:
                create_groups.append((kp, group))

        if continue_kp:
            kps_px = im.keypoints[continue_kp]
            err = self._reproj_error_px(imid, continue_pid, kps_px)
            for kp, pid, e in zip(continue_kp, continue_pid, err):
                if e < max_err and self.rec.alive[pid]:
                    self.rec.add_observation(pid, imid, int(kp))

        # Pass 2 — create new tracks (batched masked DLT).
        if create_groups:
            if self.conf.ignore_two_view_tracks:
                create_groups = [g for g in create_groups if len(g[1]) >= 2]
            self._create_tracks(imid, create_groups)

    def _create_tracks(self, imid, groups):
        rec = self.rec
        T = max(len(g[1]) for g in groups) + 1
        N = len(groups)
        P_mats = np.zeros((N, T, 3, 4))
        xy_n = np.zeros((N, T, 2))
        mask = np.zeros((N, T), bool)
        obs_tbl = []  # per group list of (imid, kp)
        pose_cache = {}
        for i in rec.reg_image_ids():
            pose_cache[i] = rec.images[i].pose.matrix()
        for gi, (kp, group) in enumerate(groups):
            obs = [(imid, kp)] + group
            obs_tbl.append(obs)
            for ti, (oim, okp) in enumerate(obs):
                cam = rec.camera(oim)
                P_mats[gi, ti] = pose_cache[oim]
                xy_n[gi, ti] = cam.cam_from_img(rec.images[oim].keypoints[okp])
                mask[gi, ti] = True
        xyz = _nview_triangulate(P_mats, xy_n, mask)

        # acceptance: cheirality in all views, reproj errors, min angle
        max_err = self.conf.complete_max_reproj_error * np.median(
            [i.kp_std for i in rec.images.values()]
        )
        # per-image tables for the vectorized per-group reprojection test
        max_im = max(rec.images.keys())
        qarr = np.zeros((max_im + 1, 4))
        tarr = np.zeros((max_im + 1, 3))
        farr = np.ones((max_im + 1, 2))
        carr = np.zeros((max_im + 1, 2))
        ctrarr = np.zeros((max_im + 1, 3))
        for i in rec.reg_image_ids():
            pose = rec.images[i].pose
            qarr[i], tarr[i], ctrarr[i] = pose.q, pose.t, pose.center()
            cam = rec.camera(i)
            farr[i] = (cam.fx, cam.fy)
            carr[i] = (cam.cx, cam.cy)
        for gi, obs in enumerate(obs_tbl):
            X = xyz[gi]
            ok = np.isfinite(X).all()
            if not ok:
                continue
            oims = np.asarray([o for o, _ in obs], np.int64)
            p_cam = quat_rotate_np(qarr[oims], X) + tarr[oims]
            front = p_cam[:, 2] > 1e-8
            zsafe = np.where(front[:, None], p_cam[:, 2:3], 1.0)
            px = p_cam[:, :2] / zsafe * farr[oims] + carr[oims]
            kps = np.stack([rec.images[o].keypoints[k] for o, k in obs])
            good = front & (np.linalg.norm(px - kps, axis=1) < max_err)
            good_obs = [obs[i] for i in np.where(good)[0]]
            if len(good_obs) < 2:
                continue
            centers = ctrarr[oims[good]]
            r = X[None] - centers
            rn = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
            cosang = np.clip(rn @ rn.T, -1, 1)
            ang = np.arccos(cosang)
            ang = np.minimum(ang, np.pi - ang)
            iu = np.triu_indices(len(good_obs), 1)
            if len(iu[0]) == 0 or np.rad2deg(ang[iu].max()) < self.conf.min_angle:
                continue
            rec.add_point3D(X, good_obs)

    def _lift_low_parallax(self, new_pids):
        """Delete freshly created low-parallax points and recreate them by
        lifting from the first depth-activated observer
        (reference triangulator.py:49-83)."""
        rec = self.rec
        if len(new_pids) == 0:
            return
        risky = rec.find_points3D_with_small_triangulation_angle(self.conf.hard_angle, new_pids)
        for pid in new_pids[risky]:
            self._lift_point(int(pid))

    def _lift_point(self, pid):
        rec = self.rec
        tr = list(rec.tracks[pid])
        rec.delete_point3D(pid)
        for oim, okp in tr:
            im = rec.images[oim]
            depth = getattr(im, "depth", None)
            if depth is None or not depth.activated:
                continue
            xy = im.keypoints[okp][None]
            if not depth.valid_at_kps(xy)[0]:
                continue
            d = depth.data_at_kps(xy)
            cam = rec.camera(oim)
            xyn = cam.cam_from_img(xy)
            p_cam = np.concatenate([xyn, np.ones((1, 1))], -1) * d[:, None]
            X = im.pose.inverse().transform(p_cam)[0]
            track = []
            for oim2, okp2 in tr:
                p2 = rec.images[oim2].pose.transform(X[None])[0]
                if p2[2] >= np.finfo(float).eps:
                    track.append((oim2, okp2))
            if len(track) >= 2:
                rec.add_point3D(X, track)
            break

    def _alive_pids_in_order(self, pids):
        rec = self.rec
        out, seen = [], set()
        for p in pids:
            p = int(p)
            if 0 <= p < len(rec.alive) and rec.alive[p] and p not in seen:
                seen.add(p)
                out.append(p)
        return np.asarray(out, np.int64)

    def _expand_candidates(self, o_pid, o_im, o_kp):
        """One-level correspondence expansion of an observation stream:
        returns (order, src_pid, cand_im, cand_kp) sorted by the stream
        position of the source observation (pid-major, track order) —
        the visit order of the sequential COLMAP loops."""
        cg = self.cg
        parts = []
        for oim in np.unique(o_im):
            sel = np.where(o_im == oim)[0]
            indptr, adj_im, adj_kp = cg.correspondences_all(oim)
            a = indptr[o_kp[sel]]
            lens = indptr[o_kp[sel] + 1] - a
            nz = lens > 0
            if not nz.any():
                continue
            a, lens, sel = a[nz], lens[nz], sel[nz]
            cum = np.cumsum(lens)
            flat = np.ones(int(cum[-1]), np.int64)
            flat[0] = a[0]
            if len(a) > 1:
                flat[cum[:-1]] = a[1:] - (a[:-1] + lens[:-1]) + 1
            flat = np.cumsum(flat)
            src = np.repeat(sel, lens)
            parts.append((src, o_pid[src], adj_im[flat], adj_kp[flat]))
        if not parts:
            z = np.zeros(0, np.int64)
            return z, z.copy(), z.copy(), z.copy()
        order = np.concatenate([p[0] for p in parts])
        srt = np.argsort(order, kind="stable")
        return (
            order[srt],
            np.concatenate([p[1] for p in parts])[srt],
            np.concatenate([p[2] for p in parts])[srt],
            np.concatenate([p[3] for p in parts])[srt],
        )

    def complete_tracks(self, pids):
        """Extend tracks through correspondences of current observations
        (COLMAP CompleteTracks analog, one transitive level). Candidate
        discovery, the registered/unassigned gates, and the reprojection
        test run as vectorized passes; only accepted additions touch the
        store."""
        rec = self.rec
        pids = self._alive_pids_in_order(pids)
        if len(pids) == 0:
            return 0
        o_pid, o_im, o_kp = rec.observations(pids)
        if len(o_pid) == 0:
            return 0
        _, c_pid, c_im, c_kp = self._expand_candidates(o_pid, o_im, o_kp)
        if len(c_pid) == 0:
            return 0
        max_im = max(rec.images.keys())
        reg_mask = np.zeros(max_im + 1, bool)
        for i in rec.reg_image_ids():
            reg_mask[i] = True
        keep = reg_mask[c_im]
        c_pid, c_im, c_kp = c_pid[keep], c_im[keep], c_kp[keep]
        if len(c_pid) == 0:
            return 0
        # unassigned keypoints only + reprojection gate, grouped per image
        max_err = self.conf.complete_max_reproj_error * np.median(
            [i.kp_std for i in rec.images.values()]
        )
        ok = np.zeros(len(c_pid), bool)
        for cim in np.unique(c_im):
            sel = np.where(c_im == cim)[0]
            im = rec.images[cim]
            free = im.point3D_ids[c_kp[sel]] < 0
            sel = sel[free]
            if len(sel) == 0:
                continue
            err = self._reproj_error_px(cim, c_pid[sel], im.keypoints[c_kp[sel]])
            ok[sel[err < max_err]] = True
        n = 0
        for i in np.where(ok)[0]:
            cim, ckp, pid = int(c_im[i]), int(c_kp[i]), int(c_pid[i])
            if rec.images[cim].point3D_ids[ckp] >= 0:  # first-wins within the pass
                continue
            rec.add_observation(pid, cim, ckp)
            n += 1
        return n

    def complete_all_tracks(self):
        return self.complete_tracks(self.rec.point_ids().tolist())

    def merge_tracks(self, pids):
        """Merge point pairs linked by correspondences when the weighted
        merged point reprojects within budget everywhere (COLMAP
        MergeTracks analog). Partner discovery is one vectorized expansion
        pass; partners are re-validated at apply time so earlier merges in
        the same pass are respected (sequential semantics preserved)."""
        rec = self.rec
        n = 0
        max_err = self.conf.merge_max_reproj_error * np.median(
            [i.kp_std for i in rec.images.values()]
        )
        apids = self._alive_pids_in_order(pids)
        if len(apids) == 0:
            return 0
        o_pid, o_im, o_kp = rec.observations(apids)
        if len(o_pid) == 0:
            return 0
        _, c_pid, c_im, c_kp = self._expand_candidates(o_pid, o_im, o_kp)
        if len(c_pid) == 0:
            return 0
        max_im = max(rec.images.keys())
        reg_mask = np.zeros(max_im + 1, bool)
        for i in rec.reg_image_ids():
            reg_mask[i] = True
        keep = reg_mask[c_im]
        c_pid, c_im, c_kp = c_pid[keep], c_im[keep], c_kp[keep]
        # prefilter to candidates whose target kp holds a (different) point.
        # Any kp assigned mid-pass by a merge was already assigned at
        # discovery (merges only reassign kps of the two deleted points),
        # so this cannot drop a partner the sequential loop would find.
        tgt_pid = np.full(len(c_pid), -1, np.int64)
        for cim in np.unique(c_im):
            sel = c_im == cim
            tgt_pid[sel] = rec.images[cim].point3D_ids[c_kp[sel]]
        keep = (tgt_pid >= 0) & (tgt_pid != c_pid)
        c_pid, c_im, c_kp = c_pid[keep], c_im[keep], c_kp[keep]
        # candidate partner locations per source pid, in visit order
        cand_locs: dict[int, list] = {}
        for i in range(len(c_pid)):
            cand_locs.setdefault(int(c_pid[i]), []).append((int(c_im[i]), int(c_kp[i])))
        # per-image pose/intrinsics tables for the vectorized reprojection
        # test (poses are constant during the pass; per-obs Pose.transform
        # calls were ~4s/scene on the host profile)
        qarr = np.zeros((max_im + 1, 4))
        tarr = np.zeros((max_im + 1, 3))
        farr = np.ones((max_im + 1, 2))
        carr = np.zeros((max_im + 1, 2))
        for i in rec.reg_image_ids():
            qarr[i] = rec.images[i].pose.q
            tarr[i] = rec.images[i].pose.t
            cam = rec.camera(i)
            farr[i] = (cam.fx, cam.fy)
            carr[i] = (cam.cx, cam.cy)
        for pid in apids.tolist():
            if not rec.alive[pid]:
                continue
            partner = -1
            for cim, ckp in cand_locs.get(pid, ()):
                pid2 = int(rec.images[cim].point3D_ids[ckp])
                if pid2 >= 0 and pid2 != pid and rec.alive[pid2]:
                    partner = pid2
                    break
            if partner < 0:
                continue
            l1, l2 = rec.track_len[pid], rec.track_len[partner]
            X = (rec.xyz[pid] * l1 + rec.xyz[partner] * l2) / (l1 + l2)
            obs = list(rec.tracks[pid]) + list(rec.tracks[partner])
            oims = np.asarray([o for o, _ in obs], np.int64)
            p_cam = quat_rotate_np(qarr[oims], X) + tarr[oims]
            if (p_cam[:, 2] <= 1e-8).any():
                continue
            px = p_cam[:, :2] / p_cam[:, 2:3] * farr[oims] + carr[oims]
            kps = np.stack([rec.images[o].keypoints[k] for o, k in obs])
            if (np.linalg.norm(px - kps, axis=1) >= max_err).any():
                continue
            rec.delete_point3D(pid)
            rec.delete_point3D(partner)
            merged = rec.add_point3D(X, obs)
            if merged != INVALID:
                n += 1
        return n

    def merge_all_tracks(self):
        return self.merge_tracks(self.rec.point_ids().tolist())

    def complete_and_merge_all_tracks(self):
        return self.complete_all_tracks() + self.merge_all_tracks()

    def complete_and_merge_tracks(self, pids):
        return self.complete_tracks(pids) + self.merge_tracks(pids)

    def retriangulate(self):
        """Re-run creation for images with few long tracks, protecting
        "safe" images (reference triangulator.py:102-163): recreate
        under-reconstructed areas, then lift low-parallax survivors."""
        rec = self.rec
        risky_imids = []
        for imid in rec.reg_image_ids():
            pids = rec.images[imid].point3D_ids
            pids = pids[pids >= 0]
            nsafe = int((rec.track_len[pids] > 2).sum()) if len(pids) else 0
            if nsafe < self.conf.nsafe_threshold:
                risky_imids.append(imid)
        expanded = []
        for imid in risky_imids:
            expanded.extend(rec.find_local_bundle_ids(imid, self.conf.new_retry_nbatch))
        ignore = set(risky_imids) | set(expanded)
        num_obs_before = sum(
            int((rec.images[i].point3D_ids >= 0).sum()) for i in rec.reg_image_ids()
        )
        for imid in rec.reg_image_ids():
            if imid in ignore:
                continue
            self._triangulate_image_core(imid)
        # lift all surviving low-parallax points
        p3ds = rec.point_ids()
        if len(p3ds):
            risky = rec.find_points3D_with_small_triangulation_angle(self.conf.retri_min_angle, p3ds)
            for pid in p3ds[risky]:
                self._lift_point(int(pid))
        num_obs_after = sum(
            int((rec.images[i].point3D_ids >= 0).sum()) for i in rec.reg_image_ids()
        )
        return max(0, num_obs_after - num_obs_before)
