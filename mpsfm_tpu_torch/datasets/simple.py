"""SimpleParser: images dir + intrinsics.yaml -> reconstruction skeleton
(port of mpsfm_tpu/datasets/simple.py).

Port of the reference's SimpleParser (mpsfm/data_proc/simple.py:14-91):
intrinsics.yaml maps camera ids to PINHOLE params [fx, fy, cx, cy] and an
image list ('all' or explicit names); optional sensor depth maps sit next
to the images for the measured-RGB-D path. The port reads the intrinsics
as JSON where their text is JSON (utils.io.read_intrinsics) and PNG images
and depth maps with its own decoder, so an RGB-D directory of PNG images,
.npy or 16-bit PNG depth and JSON intrinsics needs neither OpenCV nor
PyYAML.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Reconstruction
from mpsfm_tpu_torch.utils.io import image_size, read_depth_png, read_intrinsics

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".JPG", ".PNG", ".JPEG"}


class SimpleParser:
    def __init__(self, data_dir, images_dir=None, intrinsics_path=None, depth_dir=None, normscale=387.0):
        self.data_dir = Path(data_dir)
        self.rgb_dir = Path(images_dir) if images_dir else self.data_dir / "images"
        self.intrinsics_path = (
            Path(intrinsics_path) if intrinsics_path else self.data_dir / "intrinsics.yaml"
        )
        if depth_dir:
            self.depth_dir = Path(depth_dir)
        elif (self.data_dir / "depth").is_dir():
            self.depth_dir = self.data_dir / "depth"  # RGB-D layout auto-detect
        else:
            self.depth_dir = None
        self.normscale = normscale
        self._names = sorted(
            p.name for p in self.rgb_dir.iterdir() if p.suffix in IMAGE_EXTS
        )
        # name -> intrinsics params (fx, fy, cx, cy) for prior backends
        self._intrinsics_of: dict[str, np.ndarray] = {}
        if self.intrinsics_path.exists():
            for _, spec in read_intrinsics(self.intrinsics_path).items():
                params = np.asarray(spec["params"], np.float64)
                targets = self._names if spec.get("images", "all") == "all" else [
                    Path(n).name for n in spec["images"]
                ]
                for n in targets:
                    self._intrinsics_of[n] = params

    def image_names(self):
        return list(self._names)

    def image_path(self, name):
        return self.rgb_dir / name

    def build_reconstruction(self) -> Reconstruction:
        rec = Reconstruction()
        name_to_cam = {}
        for cam_id, spec in read_intrinsics(self.intrinsics_path).items():
            params = np.asarray(spec["params"], np.float64)
            images = spec.get("images", "all")
            if images == "all":
                targets = self._names
            else:
                targets = [Path(n).name for n in images]
            # image size from the first target (a PNG's from its header)
            W, H = image_size(self.rgb_dir / targets[0])
            cam = HostCamera(int(cam_id), params, W, H)
            cam.set_integration_grid(self.normscale)
            rec.add_camera(cam)
            for name in targets:
                name_to_cam[name] = int(cam_id)
        for imid, name in enumerate(self._names):
            if name not in name_to_cam:
                continue
            rec.add_image(ImageRecord(imid, name, name_to_cam[name]))
        return rec

    def prior_inputs(self, name) -> dict:
        """Extra inputs for prior backends (sensor depth, intrinsics)."""
        out = {}
        if name in self._intrinsics_of:
            p = self._intrinsics_of[name]
            out["intrinsics"] = (float(p[0]), float(p[1]), float(p[2]), float(p[3]))
        if self.depth_dir is not None:
            for ext in (".npy", ".png"):
                p = self.depth_dir / (Path(name).stem + ext)
                if p.exists():
                    if ext == ".npy":
                        out["depth_measured"] = np.load(p)
                    else:  # millimetres, as OpenCV's IMREAD_ANYDEPTH reads them
                        out["depth_measured"] = read_depth_png(p).astype(np.float64) / 1000.0
                    break
        return out
