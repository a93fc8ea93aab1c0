"""The pipeline: extraction -> correspondences -> mapping -> outputs
(port of mpsfm_tpu/pipeline.py).

Port of the reference's ReconstructionManager + SimpleTest
(mpsfm/sfm/reconstruction_manager.py, mpsfm/test/simple.py): builds the
scene from a SimpleParser, runs the extraction facade, populates
correspondences, attaches priors, runs the mapper, and writes
COLMAP-format outputs + the depth store. Every device stage (detector,
matcher, verification, priors, mapper) runs on ``device``: the card unless
the caller asks for the CPU. ``cache_format`` picks the store of every
artifact, caches and depth output alike: ``h5``, the JAX package's HDF5,
or ``npy``, a directory of .npy files for a host without h5py.
"""

from __future__ import annotations

from pathlib import Path

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass, Config
from mpsfm_tpu_torch.datasets.simple import SimpleParser
from mpsfm_tpu_torch.extraction.base import Extraction
from mpsfm_tpu_torch.mapper import MpsfmMapper
from mpsfm_tpu_torch.scene.correspondences import Correspondences
from mpsfm_tpu_torch.scene.image_priors import ImagePriors
from mpsfm_tpu_torch.utils import colmap_io, io
from mpsfm_tpu_torch.utils.profiling import TIMERS


class ReconstructionManager(BaseClass):
    default_conf = {
        "extractors": {**Extraction.default_conf},
        "mapper": {**MpsfmMapper.default_conf},
        "correspondences": {},
        "image_priors": {},
        "use_priors": True,
        "matches_mode": "sparse",
        "cache_format": "h5",  # h5 | npy: the store of every cache and of the depth output
        "verbose": 0,
    }

    def _propagate_conf(self):
        self.conf.extractors["verbose"] = self.conf.verbose
        self.conf.extractors["cache_format"] = self.conf.cache_format
        self.conf.mapper["verbose"] = self.conf.verbose

    def _init(self, scene_parser: SimpleParser, cache_dir, sfm_outputs_dir, extract=(), device="cuda"):
        self.scene_parser = scene_parser
        self.device = resolve_device(device)
        self.cache_dir = Path(cache_dir)
        self.sfm_outputs_dir = Path(sfm_outputs_dir)
        self.extractor = Extraction(
            self.conf.extractors, scene_parser, self.cache_dir, extract=extract, device=self.device
        )

    def __call__(self, extract_only=False):
        mode = self.conf.matches_mode
        # 1) extraction
        self.extractor.conf["matches_mode"] = mode
        with TIMERS.phase("pipe.extract_pairs"):
            pairs = self.extractor.extract_pairs()
        with TIMERS.phase("pipe.extract_features"):
            self.extractor.extract_features()
        if "sparse" in mode:
            with TIMERS.phase("pipe.extract_matches"):
                if self.conf.extractors.matcher == "dense_anchor":
                    # RoMa-sparse mode: dense flow anchored at detected keypoints
                    self.extractor.extract_matches_dense_anchored(pairs)
                else:
                    self.extractor.extract_matches(pairs)
        if "dense" in mode:
            with TIMERS.phase("pipe.extract_dense"):
                self.extractor.extract_dense_matches(pairs)
        if "depth" in mode:
            with TIMERS.phase("pipe.extract_pair_depths"):
                self.extractor.extract_pair_depths(pairs)
        if self.conf.use_priors:
            with TIMERS.phase("pipe.extract_mono"):
                if "measured" in mode:
                    self.extractor.use_measured()
                else:
                    self.extractor.extract_mono()
        with TIMERS.phase("pipe.extract_masks"):
            self.extractor.extract_masks()
        if extract_only:
            return None, True

        # 2) scene + correspondences
        with TIMERS.phase("pipe.correspondences"):
            rec = self.scene_parser.build_reconstruction()
            keypoints, matches, scores = self.extractor.load_correspondence_inputs(pairs)
            corr = Correspondences(self.conf.correspondences, rec, device=self.device)
            corr.populate(
                keypoints, matches, scores,
                cache_path=io.store_path(self.cache_dir, "two_view_geometry", self.conf.cache_format),
            )

        # 3) priors
        if self.conf.use_priors:
            with TIMERS.phase("pipe.priors"):
                self._load_priors(rec, pairs)

        # 4) mapping
        mapper = MpsfmMapper(self.conf.mapper, rec, corr, device=self.device)
        rec, ok = mapper()
        self.log(
            f"Registered {rec.num_reg_images()}/{rec.num_images()} images, "
            f"{rec.num_points3D()} points",
            level=0,
        )

        # 5) outputs
        out = self.sfm_outputs_dir
        with TIMERS.phase("pipe.outputs"):
            colmap_io.write_text(rec, out)
            # standard COLMAP binary model alongside the text one — the
            # reference writes binary via pycolmap (scene/reconstruction/
            # base.py:135-141); downstream COLMAP tooling defaults to it
            colmap_io.write_binary(rec, out)
            colmap_io.write_depths(rec, io.store_path(out, "depths", self.conf.cache_format))
        self.log("3d.html is not written: utils/viz.py is not ported (ROADMAP queue 1 item 6)", level=1)
        return rec, ok

    def _load_priors(self, rec, pairs):
        for imid, im in rec.images.items():
            with TIMERS.phase("pipe.priors.load_mono"):
                mono = self.extractor.load_mono(im.name)
            if mono is None:
                continue
            depth_dict = {
                k: mono[k]
                for k in ("depth", "depth_variance", "depth2", "depth_variance2", "valid", "valid2")
                if k in mono
            }
            if "depth" in self.conf.matches_mode:
                # 'depth' matching mode: per-pair two-view depth beats
                # the mono prior (best-confidence pair, reference
                # utils/io.py:17-42); normals stay from the mono pass.
                pair_mono = self.extractor.load_mono_from_pairs(im.name, pairs)
                if pair_mono is not None:
                    depth_dict = {
                        "depth": pair_mono["depth"],
                        "depth_variance": pair_mono["depth_variance"],
                        "valid": pair_mono["valid"],
                    }
            normals_dict = {
                k: mono[k]
                for k in ("normals", "normals_variance", "normals2", "normals2_variance")
                if k in mono
            }
            if "normals" not in normals_dict:
                continue
            # per-kp uncertainty of detected features
            _, unc = io.get_keypoints(self.extractor.paths["sfeats"], im.name, return_uncertainty=True)
            im.kp_std = float(unc) if unc else 1.0
            # sky mask (reference Image.init_depth, scene/image/base.py:89-116)
            mask = self.extractor.load_mask(im.name)
            with TIMERS.phase("pipe.priors.build"):
                pri = ImagePriors(
                    self.conf.image_priors, rec, imid,
                    depth_dict=depth_dict, normals_dict=normals_dict, mask=mask, device=self.device,
                )
            im.priors = pri
            im.depth = pri.depth
            im.normals = pri.normals


def reconstruct(
    data_dir,
    conf=None,
    images_dir=None,
    intrinsics_path=None,
    cache_dir=None,
    sfm_outputs_dir=None,
    extract=(),
    verbose=0,
    device="cuda",
):
    """One-call API mirroring reconstruct.py of the reference; every device
    stage runs on `device` (no GPU and no device="cpu" raises)."""
    device = resolve_device(device)
    data_dir = Path(data_dir)
    parser = SimpleParser(data_dir, images_dir, intrinsics_path)
    cache_dir = Path(cache_dir) if cache_dir else data_dir / "cache"
    out_dir = Path(sfm_outputs_dir) if sfm_outputs_dir else data_dir / "sfm_outputs"
    conf = Config.create({"verbose": verbose}).merged(conf or {})
    manager = ReconstructionManager(conf, parser, cache_dir, out_dir, extract=extract, device=device)
    return manager()
