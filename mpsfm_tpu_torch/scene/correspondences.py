"""Correspondences facade: keypoints + verified matches + two-view geometry
(port of mpsfm_tpu/scene/correspondences.py).

Port of the reference's Correspondences
(mpsfm/sfm/scene/correspondences/base.py): ingests per-image keypoints and
per-pair matches (from the extraction caches), runs geometric verification
— here batched device calls over all pairs (one per match-count bucket) on
the card instead of a process pool — populates the correspondence graph
with inlier matches, and keeps the per-pair inlier score table used for
next-view ranking. The RANSAC samples come from the estimator's seeded
torch.Generator (seed 0), not from jax.random, so the port's verified
inliers equal the JAX package's only where the same samples are given.
"""

from __future__ import annotations

import numpy as np

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.estimators.two_view import estimate_two_view_geometry_batch
from mpsfm_tpu_torch.scene.corrgraph import CorrespondenceGraph
from mpsfm_tpu_torch.scene.reconstruction import Reconstruction


class Correspondences(BaseClass):
    default_conf = {
        "max_error": 4.0,
        "num_hyp": 512,
        "min_num_matches": 15,
        "verbose": 0,
    }

    def _init(self, rec: Reconstruction, device="cuda"):
        """device: where verification runs (the card unless the caller asks
        for the CPU; no GPU raises)."""
        self.rec = rec
        self.device = resolve_device(device)
        self.cg = CorrespondenceGraph()
        self._tvg: dict[tuple[int, int], object] = {}
        self.inlier_match_scores: dict[frozenset, float] = {}

    def populate(self, keypoints: dict, matches: dict, scores: dict | None = None,
                 cache_path=None):
        """keypoints: name -> (N,2) px; matches: (name0,name1) -> (M,2);
        scores: frozenset(names) -> (M,) match confidences (optional).
        cache_path: optional store (.h5 or .npyd) caching verified two-view
        geometries keyed by pair + a digest of matches/keypoints/RANSAC
        params (parity with COLMAP's two_view_geometries database table —
        verification results are a pure function of those inputs)."""
        rec = self.rec
        for name, kps in keypoints.items():
            imid = rec.imid(name)
            im = rec.images[imid]
            im.keypoints = np.asarray(kps, np.float64)
            if len(im.point3D_ids) != len(im.keypoints):
                im.point3D_ids = np.full(len(im.keypoints), -1, np.int64)
            self.cg.add_image(imid, len(kps))

        pair_list = []
        pair_names = []
        pair_digests = {}
        cached_tvgs = {}
        cache = _TvgCache(cache_path) if cache_path else None
        for (name0, name1), m in matches.items():
            if m is None or len(m) < self.conf.min_num_matches:
                continue
            id0, id1 = rec.imid(name0), rec.imid(name1)
            if cache is not None:
                digest = _TvgCache._digest(
                    m, keypoints[name0], keypoints[name1],
                    self.conf.max_error, self.conf.num_hyp,
                )
                pair_digests[(name0, name1)] = digest
                hit = cache.get(name0, name1, digest)
                if hit is not None:
                    cached_tvgs[(name0, name1)] = hit
                    continue
            pair_list.append(
                (
                    rec.camera(id0).device(self.device),
                    rec.camera(id1).device(self.device),
                    keypoints[name0],
                    keypoints[name1],
                    np.asarray(m, np.int64),
                )
            )
            pair_names.append((name0, name1))
        self.log(
            f"Verifying {len(pair_list)} pairs ({len(cached_tvgs)} cached)...", level=1
        )
        tvgs = estimate_two_view_geometry_batch(
            pair_list, max_error_px=self.conf.max_error, num_hyp=self.conf.num_hyp, device=self.device
        )
        if cache is not None:
            for (name0, name1), tvg in zip(pair_names, tvgs):
                cache.put(name0, name1, pair_digests[(name0, name1)], tvg)
            cache.close()
        pair_names = pair_names + list(cached_tvgs.keys())
        tvgs = tvgs + list(cached_tvgs.values())
        for (name0, name1), tvg in zip(pair_names, tvgs):
            id0, id1 = rec.imid(name0), rec.imid(name1)
            self._tvg[(id0, id1)] = tvg
            if len(tvg.inlier_matches) == 0:
                self.inlier_match_scores[frozenset((id0, id1))] = 0.0
                continue
            self.cg.add_correspondences(id0, id1, tvg.inlier_matches)
            key = frozenset((name0, name1))
            if scores is not None and key in scores:
                m = matches[(name0, name1)]
                s = np.asarray(scores[key])
                inl = np.zeros(len(m), bool)
                mset = {tuple(r) for r in tvg.inlier_matches.tolist()}
                for i, r in enumerate(np.asarray(m).tolist()):
                    if tuple(r) in mset:
                        inl[i] = True
                self.inlier_match_scores[frozenset((id0, id1))] = float(s[inl].sum())
            else:
                self.inlier_match_scores[frozenset((id0, id1))] = float(len(tvg.inlier_matches))
        self.cg.finalize()
        return True

    # --- query API ---
    def matches(self, imid1, imid2):
        return self.cg.matches(imid1, imid2)

    def two_view_geom_by_ids(self, imid1, imid2):
        if (imid1, imid2) in self._tvg:
            return self._tvg[(imid1, imid2)]
        if (imid2, imid1) in self._tvg:
            return self._tvg[(imid2, imid1)].invert()
        return None

    def inlier_match_score(self, imid1, imid2):
        return self.inlier_match_scores.get(frozenset((imid1, imid2)), 0.0)

    def image_pairs(self):
        return sorted(self._tvg.keys())


class _TvgCache:
    """Cache of TwoViewGeometry results keyed by pair name, a digest
    of the verification inputs (match array + matched keypoint coords) and
    the verification parameters. Mirrors COLMAP's two_view_geometries
    table: recomputation is skipped only when matches, keypoints and
    RANSAC settings are all unchanged (COLMAP invalidates the table when
    the matches table changes). The layout and digest are the JAX
    package's, so a cache written by one package reads in the other. The
    store is an HDF5 file or a directory store, by the path's suffix
    (utils.io.open_store)."""

    def __init__(self, path):
        from mpsfm_tpu_torch.utils.io import open_store

        self.path = path
        self._f = open_store(path, "a")

    @staticmethod
    def _key(name0, name1):
        from mpsfm_tpu_torch.utils.io import names_to_pair

        # '/' and '.' both create/ambiguate h5 group nesting; reuse the
        # same canonicalization every other cache in the repo uses.
        return names_to_pair(name0, name1, separator="-").replace(".", "_")

    @staticmethod
    def _digest(matches, kps0, kps1, max_error, num_hyp):
        import hashlib

        h = hashlib.sha1()
        h.update(np.ascontiguousarray(np.asarray(matches, np.int64)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(kps0, np.float64)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(kps1, np.float64)).tobytes())
        h.update(np.float64(max_error).tobytes())
        h.update(np.int64(num_hyp).tobytes())
        return h.hexdigest()

    def get(self, name0, name1, digest):
        from mpsfm_tpu_torch.estimators.two_view import TwoViewGeometry
        from mpsfm_tpu_torch.geometry.rotations import Rigid3d

        k = self._key(name0, name1)
        if k not in self._f:
            return None
        g = self._f[k]
        if g.attrs.get("digest") != digest:
            return None
        E = np.asarray(g["E"]) if "E" in g else None
        pose = Rigid3d(np.asarray(g["quat"]), np.asarray(g["t"]))
        return TwoViewGeometry(
            int(g.attrs["config"]),
            np.asarray(g["inlier_matches"]),
            pose,
            float(g.attrs["tri_angle"]),
            E,
            int(g.attrs["num_inliers"]),
        )

    def put(self, name0, name1, digest, tvg):
        k = self._key(name0, name1)
        if k in self._f:
            del self._f[k]
        g = self._f.create_group(k)
        g.attrs["digest"] = digest
        g.attrs["config"] = int(tvg.config)
        g.attrs["tri_angle"] = tvg.tri_angle
        g.attrs["num_inliers"] = tvg.num_inliers
        g.create_dataset("inlier_matches", data=np.asarray(tvg.inlier_matches, np.int64))
        g.create_dataset("quat", data=np.asarray(tvg.pose.quat, np.float64))
        g.create_dataset("t", data=np.asarray(tvg.pose.t, np.float64))
        if tvg.E is not None:
            g.create_dataset("E", data=np.asarray(tvg.E, np.float64))

    def close(self):
        self._f.close()
