"""Extraction facade: features, matches, priors, masks, with caches (port of
the main path's part of mpsfm_tpu/extraction/base.py).

Port of the reference's Extraction orchestrator (mpsfm/extraction/base.py):
every artifact is a cache keyed by image/pair names, present keys are
skipped unless the artifact class is listed in ``extract`` (the overwrite
flags), and the mapper consumes the caches — files are the seam between
extraction and mapping. The fork's measured-RGB-D injection
(use_measured, base.py:177-224) is a first-class backend here.

The caches are HDF5 files (``cache_format: h5``, the JAX package's, which
either package reads) or directory stores (``cache_format: npy``, for a
host without h5py); utils.io.open_store picks by the path's suffix. The
detector, the matchers (the mutual NN and the dense NCC flow) and the sky
masks run on ``device``. Not ported yet, and raising: SuperPoint,
LightGlue, NetVLAD and the neural dense matchers (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.extraction.features.classical import ClassicalFeatures
from mpsfm_tpu_torch.extraction.masks import SkyMask
from mpsfm_tpu_torch.extraction.matchers.dense_ncc import DenseNCCMatcher, assign_flow_to_keypoints
from mpsfm_tpu_torch.extraction.matchers.nn import MutualNNMatcher
from mpsfm_tpu_torch.extraction.pairs import pairs_exhaustive, pairs_from_retrieval, pairs_sequential
from mpsfm_tpu_torch.extraction.priors import MissingDepthError, get_prior_backend, normals_from_depth
from mpsfm_tpu_torch.parallel.sharded_inference import run_sharded_batches
from mpsfm_tpu_torch.utils import io
from mpsfm_tpu_torch.utils.workqueue import WorkQueue

FEATURE_MODELS = {"classical": ClassicalFeatures}
MATCHER_MODELS = {"nn": MutualNNMatcher}
NEURAL = "not ported yet (ROADMAP queue 1 item 6: neural extraction)"
NEURAL_DENSE = ("two_view", "mast3r_class", "mast3r", "warp", "roma_class", "roma")


def get_dense_matcher(name: str, conf=None, device="cuda"):
    """Dense matcher registry: the classical NCC flow; the JAX package's
    neural ones (MASt3R-class, RoMa-class) are not ported yet."""
    if name in ("dense_ncc", "ncc"):
        return DenseNCCMatcher(conf, device=device)
    if name in NEURAL_DENSE:
        raise NotImplementedError(f"dense matcher {name!r}: {NEURAL}")
    raise ValueError(f"unknown dense matcher '{name}'")


class Extraction(BaseClass):
    default_conf = {
        "features": "classical",  # superpoint once weights are present
        "matcher": "nn",  # nn | dense_anchor (the dense flow at the detected keypoints)
        "dense_matcher": "dense_ncc",
        "sharded_inference": True,  # shape buckets shared out over the ranks of the process group
        "matches_mode": "sparse",  # sparse | dense | sparse+dense (+measured)
        "depth": "oracle",
        "normals": "from_depth",
        "pairs_type": "exhaustive",  # exhaustive | sequential | retrieval
        "n_retrieval": 20,
        "seq_overlap": 10,
        "retrieval": "grid",  # grid | netvlad (not ported)
        "masks": "none",  # none | heuristic | onnx (sky masking)
        "mask_conf": {},
        "feature_conf": {},
        "matcher_conf": {},
        "dense_matcher_conf": {},
        "depth_conf": {},
        "resize_max": 1600,
        "cache_format": "h5",  # h5 (the JAX package's HDF5) | npy (a directory of .npy files)
        "verbose": 0,
    }

    def _init(self, scene_parser, cache_dir, extract=(), device="cuda"):
        self.scene_parser = scene_parser
        self.device = resolve_device(device)
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.extract = set(extract)
        self.feature_model = self.matcher_model = self.depth_backend = None

        def store(stem):
            return io.store_path(self.cache_dir, stem, self.conf.cache_format)

        self.paths = {
            "sfeats": store(f"feats-{self.conf.features}"),
            "smatches": store(f"matches-{self.conf.matcher}"),
            "dpairs": store(f"dense-{self.conf.dense_matcher}"),
            "pair_depth": store(f"pair-depth-{self.conf.dense_matcher}"),
            "depth": store(f"depth-{self.conf.depth}"),
            "masks": store("masks"),
            "pairs": self.cache_dir / "pairs.txt",
        }

    # ---------- models ----------
    def _get_feature_model(self):
        if self.feature_model is None:
            if self.conf.features not in FEATURE_MODELS:
                raise NotImplementedError(f"features {self.conf.features!r}: {NEURAL}")
            self.feature_model = FEATURE_MODELS[self.conf.features](dict(self.conf.feature_conf), device=self.device)
        return self.feature_model

    def _get_matcher(self):
        if self.matcher_model is None:
            if self.conf.matcher not in MATCHER_MODELS:
                raise NotImplementedError(f"matcher {self.conf.matcher!r}: {NEURAL}")
            self.matcher_model = MATCHER_MODELS[self.conf.matcher](dict(self.conf.matcher_conf), device=self.device)
        return self.matcher_model

    # ---------- image loading ----------
    def _load_gray(self, name):
        """(gray image in [0, 1], at most resize_max a side; its scale; the
        file's (width, height))."""
        img = io.read_image(self.scene_parser.image_path(name), grayscale=True)
        size = img.shape[::-1]
        scale = 1.0
        m = self.conf.resize_max
        if m and max(img.shape) > m:
            import cv2

            scale = m / max(img.shape)
            img = cv2.resize(img, (int(round(img.shape[1] * scale)), int(round(img.shape[0] * scale))))
        return img.astype(np.float32) / 255.0, scale, size

    # ---------- pairs ----------
    def extract_pairs(self):
        names = self.scene_parser.image_names()
        if self.paths["pairs"].exists() and "p" not in self.extract:
            return io.read_pairs(self.paths["pairs"])
        if self.conf.pairs_type == "exhaustive":
            pairs = pairs_exhaustive(names)
        elif self.conf.pairs_type == "sequential":
            pairs = pairs_sequential(names, self.conf.seq_overlap)
        elif self.conf.pairs_type == "retrieval":
            descs = self._global_descriptors(names)
            pairs = pairs_from_retrieval(names, descs, self.conf.n_retrieval, device=self.device)
        else:
            raise ValueError(self.conf.pairs_type)
        io.write_pairs(self.paths["pairs"], pairs)
        return pairs

    def _global_descriptors(self, names):
        """Global descriptors for retrieval (reference
        pairs_from_retrieval.py:47-114): the dependency-free grid-intensity
        descriptor (OpenCV's resize to 16×16)."""
        if self.conf.retrieval == "netvlad":
            raise NotImplementedError(f"netvlad retrieval: {NEURAL}")
        import cv2

        descs = []
        for name in names:
            img = self._load_gray(name)[0]
            d = cv2.resize(img, (16, 16)).reshape(-1)
            d = (d - d.mean()) / max(d.std(), 1e-6)
            descs.append(d)
        return np.stack(descs)

    # ---------- sky masks (reference extract_masks, base.py:345-354) ----------
    def extract_masks(self):
        """Per-image sky masks -> the masks store, one bool dataset an image
        at the root (True = valid/non-sky); skipped when the backend is
        'none'. Cached like every other artifact ('k' in --extract forces
        recompute)."""
        if self.conf.masks == "none":
            return None
        path = self.paths["masks"]
        names = self.scene_parser.image_names()
        if path.exists() and "k" not in self.extract:
            with io.open_store(path, "r") as f:
                names = [n for n in names if str(n) not in f]
        if not names:
            return path
        model = SkyMask({"backend": self.conf.masks, **dict(self.conf.mask_conf)}, device=self.device)
        for name in names:
            mask = model(io.read_image(self.scene_parser.image_path(name)))
            with io.open_store(path, "a") as f:
                key = str(name)
                if key in f:
                    del f[key]
                f.create_dataset(key, data=mask.astype(bool), compression="gzip")
            self.log(f"mask {name}: {(~mask).mean():.1%} sky", level=2)
        return path

    def load_mask(self, name):
        """Valid-region (non-sky) mask for one image, or None."""
        if self.conf.masks == "none" or not self.paths["masks"].exists():
            return None
        with io.open_store(self.paths["masks"], "r") as f:
            key = str(name)
            if key not in f:
                return None
            return f[key][:]

    # ---------- features ----------
    def extract_features(self):
        names = self.scene_parser.image_names()
        path = self.paths["sfeats"]
        done = set(io.list_h5_names(path)) if path.exists() and "f" not in self.extract else set()
        todo = [n for n in names if n not in done]
        if not todo:
            return path
        model = self._get_feature_model()
        loaded = [self._load_gray(n) for n in todo]
        preds = self._feature_preds(model, [im for im, _, _ in loaded])
        for name, pred, (_, scale, size) in zip(todo, preds, loaded):
            kps = (pred["keypoints"] + 0.5) / scale - 0.5
            io.write_features(
                path,
                name,
                kps,
                pred["descriptors"],
                pred["scores"],
                uncertainty=model.detection_noise / scale,
                image_size=np.array(size),
            )
            self.log(f"features {name}: {len(kps)} kps", level=2)
        return path

    def _feature_preds(self, model, images):
        """Per-image detections; images of one shape go through the detector
        together: with sharded_inference as shape buckets shared out over
        the ranks of the process group (parallel.sharded_inference; with
        one rank plain batching), else model.batch per shape."""
        if self.conf.sharded_inference and hasattr(model, "batch_fn") and len(images) > 1:
            outs = run_sharded_batches(model.batch_fn(), images, lambda x: x, device=model.device)
            return [model.postprocess(o) for o in outs]
        preds = [None] * len(images)
        by_shape = {}
        for i, im in enumerate(images):
            by_shape.setdefault(im.shape, []).append(i)
        for idxs in by_shape.values():
            for i, pred in zip(idxs, model.batch([images[i] for i in idxs])):
                preds[i] = pred
        return preds

    # ---------- matches ----------
    def extract_matches(self, pairs):
        path = self.paths["smatches"]
        # pair keys are "name0/name1": two levels of groups
        existing = io.pair_keys(path) if path.exists() and "m" not in self.extract else set()
        matcher = self._get_matcher()
        feats = {}

        def feat(name):
            if name not in feats:
                feats[name] = io.get_descriptors(self.paths["sfeats"], name)
            return feats[name]

        writer = WorkQueue(
            lambda item: io.write_matches(path, item[0], item[1], item[2], item[3])
        )
        todo = [p for p in pairs if io.names_to_pair(*p) not in existing]
        for name0, name1 in todo:
            out = matcher(feat(name0), feat(name1))
            writer.put((name0, name1, out["matches0"], out["matching_scores0"]))
            self.log(f"matches {name0}-{name1}: {(out['matches0'] >= 0).sum()}", level=2)
        writer.join()
        return path

    # ---------- dense matches (reference match_dense_2view.py) ----------
    def extract_dense_matches(self, pairs):
        """Per-pair dense matching; writes keypoints of both images + the
        match certainties into the dense cache (dfeats/dmatches streams of
        the reference collapsed into one store keyed by pair)."""
        path = self.paths["dpairs"]
        existing = io.pair_keys(path) if path.exists() and "m" not in self.extract else set()
        todo = [p for p in pairs if io.names_to_pair(*p) not in existing]
        if not todo:
            return path
        matcher = get_dense_matcher(self.conf.dense_matcher, dict(self.conf.dense_matcher_conf), device=self.device)
        for name0, name1 in todo:
            g0, s0, _ = self._load_gray(name0)
            g1, s1, _ = self._load_gray(name1)
            out = matcher(g0, g1)
            io.write_dense_pair(path, name0, name1, (out["keypoints0"] + 0.5) / s0 - 0.5,
                                (out["keypoints1"] + 0.5) / s1 - 0.5, out["certainty"])
            self.log(f"dense {name0}-{name1}: {len(out['certainty'])}", level=2)
        return path

    def extract_matches_dense_anchored(self, pairs):
        """RoMa-sparse mode: dense flow assigned to detected sparse
        keypoints (<=2px), written as a regular sparse match stream."""
        self.extract_dense_matches(pairs)
        path = io.store_path(self.cache_dir, f"matches-{self.conf.dense_matcher}-anchored", self.conf.cache_format)
        existing = io.pair_keys(path) if path.exists() and "m" not in self.extract else set()
        for name0, name1 in pairs:
            if io.names_to_pair(name0, name1) in existing:
                continue
            k0, k1, cert = self.load_dense_pair(name0, name1)
            kpsA = io.get_keypoints(self.paths["sfeats"], name0)
            kpsB = io.get_keypoints(self.paths["sfeats"], name1)
            out = assign_flow_to_keypoints(k0, k1 - k0, cert, kpsA, kpsB)
            io.write_matches(path, name0, name1, out["matches0"], out["matching_scores0"])
        self.paths["smatches"] = path
        return path

    def extract_pair_depths(self, pairs):
        """'depth' matching mode: per-pair depth maps with a variance
        (reference match_dense_2view.py:191-199 + mast3r.py:303-315; the
        scene-level consumer picks the best-confidence pair per image).

        The JAX package prefers a two-view depth predictor (MASt3R's
        pointmap depth) for images without sensor depth; none is ported
        (ROADMAP queue 1 item 6) and the NCC flow has none, so each image
        takes its depth from the prior backend, sensor depth where the
        scene has it, at a fixed 1% relative uncertainty (the fork's
        measured-depth calibration)."""
        path = self.paths["pair_depth"]
        existing = io.pair_keys(path) if path.exists() and "d" not in self.extract else set()
        for name0, name1 in pairs:
            if io.names_to_pair(name0, name1) in existing:
                continue
            kws = {name: self.scene_parser.prior_inputs(name) for name in (name0, name1)}
            if kws[name0].get("depth_measured") is None and self.conf.dense_matcher in NEURAL_DENSE:
                # where the first image has no sensor depth, the JAX package takes both from the matcher
                raise NotImplementedError(f"two-view depth of {self.conf.dense_matcher!r}: {NEURAL}")
            per_image = {}
            for name, kw in kws.items():
                depth = kw.get("depth_measured")
                if depth is None:
                    if self.depth_backend is None:
                        self.depth_backend = get_prior_backend(self.conf.depth, dict(self.conf.depth_conf))
                    try:
                        # the ported backends (measured, oracle) take no image
                        out = self.depth_backend(None, **kw)
                    except MissingDepthError:  # an image without sensor depth is skipped, as in the reference
                        out = None
                    if out is None:
                        continue
                    depth = out["depth"]
                depth = np.asarray(depth, np.float32)
                valid = depth > 0
                variance = np.square(0.01 * np.maximum(depth, 1e-6))
                variance[~valid] = 1e6
                per_image[name] = {"depth": depth, "valid": valid, "variance": variance}
            if per_image:
                io.write_pair_mono_map(path, name0, name1, per_image)
                self.log(f"pair depth {name0}-{name1}", level=2)
        return path

    def load_mono_from_pairs(self, name, pairs):
        """Best-confidence per-pair depth for one image (reference
        utils/io.py:17-42)."""
        if not self.paths["pair_depth"].exists():
            return None
        return io.get_mono_map_from_pairs(self.paths["pair_depth"], name, pairs)

    def load_dense_pair(self, name0, name1):
        return io.get_dense_pair(self.paths["dpairs"], name0, name1)

    # ---------- monocular priors ----------
    def extract_mono(self):
        names = self.scene_parser.image_names()
        dpath = self.paths["depth"]
        done = io.mono_names(dpath) if dpath.exists() and "d" not in self.extract else set()
        todo = [n for n in names if str(Path(n).name) not in done]
        if not todo:
            return dpath
        if self.depth_backend is None:
            self.depth_backend = get_prior_backend(self.conf.depth, dict(self.conf.depth_conf))
        if self.conf.normals not in (None, "", "from_depth"):
            # a dedicated normals model (DSINE in the reference)
            raise NotImplementedError(f"normals backend {self.conf.normals!r}: {NEURAL}")
        for name in todo:
            kw = self.scene_parser.prior_inputs(name)
            # the ported backends (measured, oracle) take no image: the neural ones, which read it, are not ported
            out = self.depth_backend(None, **kw)
            if "normals" not in out and "intrinsics" in kw:
                fx, fy, cx, cy = kw["intrinsics"]
                out["normals"] = normals_from_depth(out["depth"], fx, fy, cx, cy)
                out["normals_variance"] = np.full(out["depth"].shape, (np.deg2rad(5.0)) ** 2)
            io.write_mono_map(dpath, name, out)
        return dpath

    def use_measured(self):
        """Fork parity: overwrite the depth cache with sensor depth at 1%
        relative uncertainty (tauzn-clock extraction/base.py:177-224)."""
        self.conf["depth"] = "measured"
        self.depth_backend = get_prior_backend("measured", dict(self.conf.depth_conf))
        self.extract.add("d")
        self.paths["depth"] = io.store_path(self.cache_dir, "depth-measured", self.conf.cache_format)
        return self.extract_mono()

    # ---------- load for the mapper ----------
    def load_correspondence_inputs(self, pairs):
        """Per-image keypoints + per-pair matches. In dense modes, dense
        grid keypoints are appended after the sparse set with index
        offsets (reference gather_dense_2view,
        scene/correspondences/utils.py:101-173)."""
        mode = self.conf.matches_mode
        use_sparse = "sparse" in mode
        names = self.scene_parser.image_names()
        if use_sparse:
            keypoints = {name: io.get_keypoints(self.paths["sfeats"], name) for name in names}
        else:
            keypoints = {name: np.zeros((0, 2)) for name in names}
        matches, scores = {}, {}
        if use_sparse:
            for name0, name1 in pairs:
                m, s = io.get_matches(self.paths["smatches"], name0, name1)
                matches[(name0, name1)] = m
                scores[frozenset((name0, name1))] = s
        if "dense" in mode:
            for name0, name1 in pairs:
                k0, k1, cert = self.load_dense_pair(name0, name1)
                off0 = len(keypoints[name0])
                off1 = len(keypoints[name1])
                keypoints[name0] = np.concatenate([keypoints[name0], k0])
                keypoints[name1] = np.concatenate([keypoints[name1], k1])
                dm = np.stack([off0 + np.arange(len(k0)), off1 + np.arange(len(k1))], -1).astype(np.int64)
                key = frozenset((name0, name1))
                if (name0, name1) in matches:
                    matches[(name0, name1)] = np.concatenate([matches[(name0, name1)], dm])
                    scores[key] = np.concatenate([scores[key], cert])
                else:
                    matches[(name0, name1)] = dm
                    scores[key] = cert
        return keypoints, matches, scores

    def load_mono(self, name):
        return io.get_mono_map(self.paths["depth"], name)
