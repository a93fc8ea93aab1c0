"""Correspondence graph: per-pair verified matches + per-keypoint adjacency
(a copy of mpsfm_tpu/scene/corrgraph.py).

Replaces pycolmap.CorrespondenceGraph (reference:
mpsfm/sfm/scene/correspondences/base.py:33-139). Pairwise inlier matches
are stored as flat int arrays; ``finalize`` builds a CSR adjacency per
image (keypoint -> list of (other_image, other_kp)) used by the
triangulator for track building and by registration for 2D-3D pairs.
"""

from __future__ import annotations

import numpy as np


class CorrespondenceGraph:
    def __init__(self):
        self._num_kps: dict[int, int] = {}
        self._pair_matches: dict[tuple[int, int], np.ndarray] = {}
        # CSR adjacency, built in finalize():
        self._indptr: dict[int, np.ndarray] = {}
        self._adj_im: dict[int, np.ndarray] = {}
        self._adj_kp: dict[int, np.ndarray] = {}
        self.finalized = False

    def add_image(self, imid: int, num_keypoints: int):
        self._num_kps[imid] = num_keypoints

    def add_correspondences(self, imid1: int, imid2: int, matches: np.ndarray):
        """matches: (M,2) kp index pairs (imid1 kp, imid2 kp)."""
        if imid1 > imid2:
            imid1, imid2 = imid2, imid1
            matches = matches[:, ::-1]
        key = (imid1, imid2)
        matches = np.asarray(matches, np.int64).reshape(-1, 2)
        if key in self._pair_matches:
            matches = np.concatenate([self._pair_matches[key], matches])
            matches = np.unique(matches, axis=0)
        self._pair_matches[key] = matches
        self.finalized = False

    def find_correspondences_between_images(self, imid1: int, imid2: int) -> np.ndarray:
        if imid1 <= imid2:
            m = self._pair_matches.get((imid1, imid2))
            return m.copy() if m is not None else np.zeros((0, 2), np.int64)
        m = self._pair_matches.get((imid2, imid1))
        return m[:, ::-1].copy() if m is not None else np.zeros((0, 2), np.int64)

    matches = find_correspondences_between_images

    def num_correspondences_between_images(self, imid1: int, imid2: int) -> int:
        key = (imid1, imid2) if imid1 <= imid2 else (imid2, imid1)
        m = self._pair_matches.get(key)
        return 0 if m is None else len(m)

    def num_correspondences_for_image(self, imid: int) -> int:
        return sum(
            len(m) for (i, j), m in self._pair_matches.items() if i == imid or j == imid
        )

    def image_pairs(self):
        return sorted(self._pair_matches.keys())

    def finalize(self):
        """Build the per-image CSR keypoint adjacency."""
        buf: dict[int, list] = {imid: [] for imid in self._num_kps}
        for (i, j), m in self._pair_matches.items():
            if len(m) == 0:
                continue
            buf[i].append((m[:, 0], np.full(len(m), j, np.int64), m[:, 1]))
            buf[j].append((m[:, 1], np.full(len(m), i, np.int64), m[:, 0]))
        for imid, chunks in buf.items():
            nk = self._num_kps[imid]
            if not chunks:
                self._indptr[imid] = np.zeros(nk + 1, np.int64)
                self._adj_im[imid] = np.zeros(0, np.int64)
                self._adj_kp[imid] = np.zeros(0, np.int64)
                continue
            kp = np.concatenate([c[0] for c in chunks])
            oim = np.concatenate([c[1] for c in chunks])
            okp = np.concatenate([c[2] for c in chunks])
            order = np.argsort(kp, kind="stable")
            kp, oim, okp = kp[order], oim[order], okp[order]
            counts = np.bincount(kp, minlength=nk)
            self._indptr[imid] = np.concatenate([[0], np.cumsum(counts)])
            self._adj_im[imid] = oim
            self._adj_kp[imid] = okp
        self.finalized = True

    def correspondences(self, imid: int, kp: int):
        """All (other_imid, other_kp) seen from (imid, kp)."""
        assert self.finalized, "call finalize() first"
        a, b = self._indptr[imid][kp], self._indptr[imid][kp + 1]
        return self._adj_im[imid][a:b], self._adj_kp[imid][a:b]

    def correspondences_all(self, imid: int):
        """CSR arrays (indptr, other_im, other_kp) for the whole image."""
        assert self.finalized, "call finalize() first"
        return self._indptr[imid], self._adj_im[imid], self._adj_kp[imid]
