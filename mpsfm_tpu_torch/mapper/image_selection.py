"""Next-view and init-pair selection (a copy of
mpsfm_tpu/mapper/image_selection.py on the port's Reconstruction and
Correspondences; host numpy, no device work).

Port of the reference's ImageSelection (mpsfm/sfm/mapper/image_selection.py):
init pairs ranked per two-view-geometry config class 2..8 by inlier count;
next image by MAX_MATCHER_INLIER_SCORES — the sum of inlier match scores
against registered images, discounted by ignored-match masks.
"""

from __future__ import annotations

import numpy as np

from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.scene.reconstruction import Reconstruction


class ImageSelection(BaseClass):
    default_conf = {
        "image_selection_method": "MAX_MATCHER_INLIER_SCORES",
        "init_max_config": 8,
        # COLMAP's IncrementalMapper init_min_num_inliers guardrail: a
        # config-2 (calibrated) pair with few verified inliers is usually
        # a chance-consistent false-match set on self-similar texture and
        # must not outrank a well-supported planar (config-6) pair just
        # because class 2 sorts first. Pairs below the floor are dropped
        # from init ranking; if NO pair passes, ranking falls back to the
        # unfiltered order (small scenes / sparse coverage still init).
        "init_min_num_inliers": 50,
        "verbose": 0,
    }

    def _init(self, rec: Reconstruction, corr):
        self.rec = rec
        self.corr = corr  # Correspondences facade
        self.freeze_imids: set = set()
        self.candid = None
        self.registration_order: list = []

    def find_init_pairs(self, exclude_init_pairs=None):
        """Ranked init pairs: config classes 2..8 in order, by inliers
        (reference :42-76)."""
        exclude = exclude_init_pairs or set()

        def ranked(min_inliers):
            proposals = []
            for config_class in range(2, self.conf.init_max_config + 1):
                impairs = []
                inliers = []
                for (imid1, imid2) in self.corr.image_pairs():
                    if (imid1, imid2) in exclude or (imid2, imid1) in exclude:
                        continue
                    tvg = self.corr.two_view_geom_by_ids(imid1, imid2)
                    if tvg is None or int(tvg.config) != config_class:
                        continue
                    if len(tvg.inlier_matches) < min_inliers:
                        continue
                    impairs.append((imid1, imid2))
                    inliers.append(len(tvg.inlier_matches))
                order = np.argsort(np.asarray(inliers))[::-1] if impairs else []
                proposals.extend(impairs[i] for i in order)
            return proposals

        proposals = ranked(self.conf.init_min_num_inliers)
        return proposals or ranked(0)

    def rank_image(self, imid):
        method = self.conf.image_selection_method
        fn = {
            "MAX_MATCHER_INLIER_SCORES": self._rank_max_inlier_scores,
            "MAX_NUM_INLIER_SCORES_TOT": self._rank_inlier_scores_tot,
            "MAX_VISIBLE_POINTS_NUM": self._rank_visible_points_num,
            "MAX_VISIBLE_POINTS_RATIO": self._rank_visible_points_ratio,
            "MIN_UNCERTAINTY": self._rank_visibility_score,
            "MAX_NUM_CORRESPONDENCES": self._rank_num_correspondences,
            "MAX_NUM_INLIER_CORRESPONDENCES": self._rank_inlier_correspondences,
            "MAX_NUM_INLIER_CORRESPONDENCES_TOT": self._rank_inlier_correspondences_tot,
        }.get(method)
        if fn is None:
            raise ValueError(f"Unknown image selection method {method}")
        return fn(imid)

    def _per_ref_scores(self, imid):
        rec = self.rec
        im = rec.images[imid]
        out = []
        for ref_id in rec.registered_images:
            s = self.corr.inlier_match_score(imid, ref_id)
            if ref_id in im.ignore_matches_AP:
                mask = im.ignore_matches_AP[ref_id]
                if mask.sum() > 0:
                    s *= (~mask).sum() / mask.sum()
            out.append((ref_id, s))
        return out

    def _rank_max_inlier_scores(self, imid):
        """MAX_MATCHER_INLIER_SCORES (reference :134-148) — default."""
        scores = self._per_ref_scores(imid)
        if not scores:
            return {"score": 0.0, "refid": None}
        best_ref, best = max(scores, key=lambda rs: rs[1])
        return {"score": best, "refid": best_ref}

    def _rank_inlier_scores_tot(self, imid):
        """Sum of inlier scores over all registered refs (reference :122-132)."""
        scores = self._per_ref_scores(imid)
        if not scores:
            return {"score": 0.0, "refid": None}
        best_ref, _ = max(scores, key=lambda rs: rs[1])
        return {"score": sum(s for _, s in scores), "refid": best_ref}

    def _visible_counts(self, imid):
        """(#kps whose correspondences see a triangulated point, #kps with
        any correspondence) — COLMAP num_visible_points3D analog."""
        rec = self.rec
        indptr, adj_im, adj_kp = self.corr.cg.correspondences_all(imid)
        n_kp = len(rec.images[imid].keypoints)
        visible = 0
        observed = 0
        reg = set(rec.reg_image_ids())
        for kp in range(n_kp):
            a, b = indptr[kp], indptr[kp + 1]
            if a == b:
                continue
            observed += 1
            for oim, okp in zip(adj_im[a:b], adj_kp[a:b]):
                if int(oim) in reg and rec.images[int(oim)].point3D_ids[int(okp)] >= 0:
                    visible += 1
                    break
        return visible, observed

    def _rank_visible_points_num(self, imid):
        v, _ = self._visible_counts(imid)
        return {"score": float(v), "refid": self._rank_max_inlier_scores(imid)["refid"]}

    def _rank_visible_points_ratio(self, imid):
        v, o = self._visible_counts(imid)
        return {"score": v / max(o, 1), "refid": self._rank_max_inlier_scores(imid)["refid"]}

    def _rank_visibility_score(self, imid):
        """COLMAP point3D_visibility_score analog: multi-level grid coverage
        of visible points (finer levels weighted higher)."""
        rec = self.rec
        im = rec.images[imid]
        cam = rec.camera(imid)
        indptr, adj_im, adj_kp = self.corr.cg.correspondences_all(imid)
        reg = set(rec.reg_image_ids())
        vis_kps = []
        for kp in range(len(im.keypoints)):
            a, b = indptr[kp], indptr[kp + 1]
            for oim, okp in zip(adj_im[a:b], adj_kp[a:b]):
                if int(oim) in reg and rec.images[int(oim)].point3D_ids[int(okp)] >= 0:
                    vis_kps.append(im.keypoints[kp])
                    break
        score = 0.0
        if vis_kps:
            pts = np.stack(vis_kps)
            for level in range(1, 7):
                n_cells = 2**level
                gx = np.clip((pts[:, 0] / max(cam.width, 1) * n_cells).astype(int), 0, n_cells - 1)
                gy = np.clip((pts[:, 1] / max(cam.height, 1) * n_cells).astype(int), 0, n_cells - 1)
                filled = len(set(zip(gx.tolist(), gy.tolist())))
                score += filled * n_cells * n_cells
        return {"score": score, "refid": self._rank_max_inlier_scores(imid)["refid"]}

    def _rank_num_correspondences(self, imid):
        rec = self.rec
        best_ref, best = None, 0
        for ref_id in rec.registered_images:
            n = self.corr.cg.num_correspondences_between_images(imid, ref_id)
            if n > best:
                best, best_ref = n, ref_id
        return {"score": float(best), "refid": best_ref}

    def _tvg_inliers(self, imid):
        rec = self.rec
        out = []
        for ref_id in rec.registered_images:
            tvg = self.corr.two_view_geom_by_ids(imid, ref_id)
            out.append((ref_id, len(tvg.inlier_matches) if tvg is not None else 0))
        return out

    def _rank_inlier_correspondences(self, imid):
        counts = self._tvg_inliers(imid)
        if not counts:
            return {"score": 0.0, "refid": None}
        best_ref, best = max(counts, key=lambda rs: rs[1])
        return {"score": float(best), "refid": best_ref}

    def _rank_inlier_correspondences_tot(self, imid):
        counts = self._tvg_inliers(imid)
        if not counts:
            return {"score": 0.0, "refid": None}
        best_ref, _ = max(counts, key=lambda rs: rs[1])
        return {"score": float(sum(c for _, c in counts)), "refid": best_ref}

    def next_image(self, qry_imids=None):
        rec = self.rec
        if qry_imids is None:
            qry_imids = [
                i
                for i, im in rec.images.items()
                if not im.registered and i not in self.freeze_imids
            ]
        if not qry_imids:
            return False
        ranked = [self.rank_image(i) for i in qry_imids]
        scores = [r["score"] for r in ranked]
        best = int(np.argmax(scores))
        rec.best_next_ref_imid = ranked[best]["refid"]
        self.candid = qry_imids[best]
        return True

    def at_success(self):
        self.freeze_imids = set()
        self.registration_order.append(self.candid)

    def at_failure(self, imid):
        self.freeze_imids.add(imid)
