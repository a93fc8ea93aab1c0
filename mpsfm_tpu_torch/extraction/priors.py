"""Prior backends: depth + normals with calibrated uncertainties (port of
mpsfm_tpu/extraction/priors.py).

* ``measured``: RGB-D sensor depth at fixed 1% relative uncertainty — the
  tauzn-clock fork's use_measured path (extraction/base.py:177-224),
  normals derived from it geometrically (``normals_from_depth``);
* ``oracle``: ground-truth maps given by the caller (tests);
* ``metric3dv2-{small,large,giant2}``, their ``-fc`` (flip-consistency)
  variants and ``metric3dv2-normals``: Metric3Dv2 (nets/metric3d.py) on the
  device; ``dsine*`` (``dsine-kappa``, ``dsine-kappa-fc``): DSINE's normals
  (nets/dsine.py) on the device; ``depthanythingv2-*`` (``-outdoor``,
  ``-indoor``): DepthAnythingV2's metric depth (nets/depth_anything.py) on
  the device; ``depthpro``: DepthPro's metric depth (nets/depth_pro.py) on
  the device, normals derived from it; any other name: the framework's
  ViT-DPT net (nets/mono.py). Each once ``conf.weights_path`` names a
  checkpoint (a file, or a registry name whose file is in
  $MPSFM_WEIGHTS_DIR or ./local/weights); without one, calling the backend
  raises MissingWeightsError;
* ``vit_mono*``: the framework's ViT-DPT depth + normal net (nets/mono.py,
  trained on the scene by nets/train_mono.py) on the device, from
  ``conf.weights_path``; without weights, calling it raises
  MissingWeightsError.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mpsfm_tpu_torch.extraction.weights import maybe_resolve

# Calibration constants per estimator (reference configs/defaults/*.yaml +
# mpsfm/sfm/scene/image/depth.py:14-30).
CALIBRATIONS = {
    "metric3dv2-giant2": {"depth_uncertainty": 0.0263, "prior_std_multiplier": 3.33},
    "metric3dv2-large": {"depth_uncertainty": 0.05, "prior_std_multiplier": 3.7757},
    "metric3dv2-small": {"depth_uncertainty": 0.0433, "prior_std_multiplier": 2.045},
    "depthpro": {"depth_uncertainty": 0.0875, "prior_uncertainty": False},
    "depthanythingv2-outdoor": {"depth_uncertainty": 0.079, "prior_uncertainty": False},
    "mast3r": {"depth_uncertainty": None, "prior_std_multiplier": 0.862},
    "measured": {"depth_uncertainty": None, "prior_uncertainty": True},
}


def normals_from_depth(depth: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """Per-pixel camera-frame normals from a depth map (central
    differences of the unprojected surface; normalized, facing camera)."""
    H, W = depth.shape
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    X = (xx - cx) / fx * depth
    Y = (yy - cy) / fy * depth
    P = np.stack([X, Y, depth], -1)
    dx = np.zeros_like(P)
    dy = np.zeros_like(P)
    dx[:, 1:-1] = (P[:, 2:] - P[:, :-2]) / 2
    dx[:, 0] = P[:, 1] - P[:, 0]
    dx[:, -1] = P[:, -1] - P[:, -2]
    dy[1:-1] = (P[2:] - P[:-2]) / 2
    dy[0] = P[1] - P[0]
    dy[-1] = P[-1] - P[-2]
    n = np.cross(dx, dy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.clip(norm, 1e-12, None)
    # orient toward camera (n_z < 0 with z forward)
    flip = n[..., 2] > 0
    n[flip] = -n[flip]
    return n


class MissingDepthError(ValueError):
    """A depth backend was asked for an image that has no depth it can read
    (the measured backend, for an image without sensor depth)."""


class MissingWeightsError(RuntimeError):
    """A neural backend was called without a checkpoint (conf.weights_path
    unset or not a file): the one fault the mono loop's separate normals
    backend may skip, keeping the depth-derived normals."""


class MeasuredDepthBackend:
    """RGB-D measured depth (fork parity): sensor depth maps, 1% relative
    uncertainty, normals derived geometrically."""

    name = "measured"

    def __init__(self, conf=None):
        self.conf = conf or {}
        self.rel_uncertainty = self.conf.get("rel_uncertainty", 0.01)

    def __call__(self, image_rgb, depth_measured=None, intrinsics=None, **kw):
        if depth_measured is None:
            raise MissingDepthError("measured backend needs sensor depth")
        d = np.asarray(depth_measured, np.float64)
        valid = d > 0
        var = (d * self.rel_uncertainty) ** 2
        out = {"depth": d, "depth_variance": var, "valid": valid}
        if intrinsics is not None:
            fx, fy, cx, cy = intrinsics
            out["normals"] = normals_from_depth(np.where(valid, d, np.median(d[valid]) if valid.any() else 1.0), fx, fy, cx, cy)
            out["normals_variance"] = np.full(d.shape, (np.deg2rad(5.0)) ** 2)
        return out


class SyntheticOracleBackend:
    """Test backend: caller provides ground-truth maps (+noise knobs).
    Without depth_gt it raises MissingDepthError, where the JAX package's
    writes 0-d NaN maps that its store cannot read back (ROADMAP queue 3)."""

    name = "oracle"

    def __init__(self, conf=None):
        self.conf = conf or {}

    def __call__(self, image_rgb, depth_gt=None, normals_gt=None, noise=0.0, rel_unc=0.03, rng=None, **kw):
        if depth_gt is None:
            raise MissingDepthError("oracle backend needs depth_gt")
        rng = rng or np.random.default_rng(0)
        d = np.asarray(depth_gt, np.float64)
        if noise:
            d = d * np.exp(rng.normal(scale=noise, size=d.shape))
        out = {
            "depth": d,
            "depth_variance": (d * rel_unc) ** 2,
            "valid": d > 0,
        }
        if normals_gt is not None:
            out["normals"] = np.asarray(normals_gt, np.float64)
            out["normals_variance"] = np.full(d.shape, (np.deg2rad(2.0)) ** 2)
        return out


# Architecture presets of the named neural backends: metric3dv2-* route to the exact Metric3Dv2
# (nets/metric3d.py: giant2 ViT-g 1536x40, large ViT-L 1024x24, small ViT-S 384x12). The JAX package's
# entries whose keys their nets do not read (depthpro's depth_blocks, num_heads and feat, MonoViT's names: DepthPro
# reads dim only, its official 1024; depthanythingv2-outdoor, whose "dim" is vitl's own; dsine) are kept for parity.
ARCH_PRESETS = {
    "metric3dv2-giant2": {"encoder": "vit_giant2_reg"},
    # normals-only variant (reference defaults/*: normals from the default metric3dv2, its depth not kept)
    "metric3dv2-normals": {"encoder": "vit_giant2_reg", "normals_only": True},
    "metric3dv2-large": {"encoder": "vit_large_reg"},
    "metric3dv2-small": {"encoder": "vit_small_reg"},
    "depthpro": {"dim": 1024, "depth_blocks": 24, "num_heads": 16, "feat": 256},
    "depthanythingv2-outdoor": {"dim": 1024, "depth_blocks": 24, "num_heads": 16, "feat": 256},
    "dsine": {"dim": 384, "depth_blocks": 12, "num_heads": 6, "feat": 128},
}


class NeuralDepthBackend:
    """Named neural depth/normal backends: the metric3dv2 family, DSINE,
    DepthAnythingV2, DepthPro and, for any other name, MonoViT
    (ViTMonoBackend). Per-name uncertainty calibrations and arch presets
    are applied; the
    ``-fc`` variants add the flipped pass. The net activates once
    ``conf.weights_path`` is a file; without it, calling the backend
    raises MissingWeightsError (the repository ships no checkpoint).
    Replaces the reference wrappers at
    mpsfm/extraction/imagewise/geometry/models/depth/metric3dv2.py:29-120."""

    needs_image = True

    def __init__(self, name, conf=None, device="cuda"):
        self.name = name
        conf = dict(conf or {})
        base = name[:-3] if name.endswith("-fc") else name
        for k, v in ARCH_PRESETS.get(base, {}).items():
            conf.setdefault(k, v)
        for k, v in CALIBRATIONS.get(base, {}).items():
            if v is not None:
                conf.setdefault(k, v)
        if name.endswith("-fc"):
            conf.setdefault("flip_consistency", True)
        conf.setdefault("canonical_focal", 1000.0)
        self.conf = conf
        self.backend = None
        self._missing = ""
        wp = conf.get("weights_path")
        if wp:  # a file, or a registry name looked for in $MPSFM_WEIGHTS_DIR and ./local/weights
            try:
                wp = maybe_resolve(wp)
            except FileNotFoundError as e:
                self._missing = f" {e}"
            else:
                if Path(wp).exists():
                    conf["weights_path"] = wp
                    if base.startswith("depthanythingv2"):
                        self.backend = _DA2Backend(conf, base, device)
                    elif base == "depthpro":
                        self.backend = _DepthProBackend(conf, device)
                    elif base.startswith("metric3dv2"):
                        self.backend = _Metric3DBackend(conf, device)
                    elif base.startswith("dsine"):
                        self.backend = _DSINEBackend(conf, device)
                    else:
                        self.backend = _vit_mono(conf, device)
                else:
                    self._missing = f" weights_path {wp!r} is not a file."

    def __call__(self, image_rgb, **kw):
        if self.backend is not None:
            return self.backend(image_rgb, **kw)
        raise MissingWeightsError(
            f"Depth backend '{self.name}' has no weights in this environment. "
            "Use 'measured' (RGB-D), provide cached priors, or supply conf.weights_path." + self._missing
        )


class _DA2Backend:
    """DepthAnythingV2 (metric) -> depth priors: the official
    depth_anything_v2_metric_*_vit{s,b,l}.pth loads as it is; the depth
    variance from the estimator's calibration (a relative uncertainty),
    normals derived geometrically from the depth. Replaces the reference
    wrapper mpsfm/extraction/imagewise/geometry/models/depth/depthanything_v2.py."""

    def __init__(self, conf, base, device="cuda"):
        from mpsfm_tpu_torch.extraction.nets.depth_anything import DepthAnythingV2

        conf = dict(conf)
        conf.setdefault("depth_estimation_type", "metric")
        # outdoor checkpoints were trained with max_depth 80, indoor 20
        conf.setdefault("max_depth", 20.0 if base.endswith("indoor") else 80.0)
        self.net = DepthAnythingV2(conf, device=device)
        if self.net.params is None:
            self.net.init_random(0)
        self.rel_unc = conf.get("depth_uncertainty", 0.079)

    def __call__(self, image_rgb, intrinsics=None, **kw):
        d = np.asarray(self.net.infer_image(image_rgb), np.float64)
        valid = d > 0
        out = {"depth": d, "depth_variance": (d * self.rel_unc) ** 2, "valid": valid}
        if intrinsics is not None:
            fx, fy, cx, cy = intrinsics
            fill = np.median(d[valid]) if valid.any() else 1.0
            out["normals"] = normals_from_depth(np.where(valid, d, fill), fx, fy, cx, cy)
            out["normals_variance"] = np.full(d.shape, (np.deg2rad(8.0)) ** 2)
        return out


class _DepthProBackend:
    """DepthPro -> metric depth priors: the intrinsics' focal, mean(fx, fy)
    as the reference's wrapper takes it (else the FOV head's) for the
    canonical inverse depth's metric conversion, the variance from the
    estimator's calibration, (d · 0.0875)², normals derived geometrically.
    Replaces the reference wrapper
    mpsfm/extraction/imagewise/geometry/models/depth/depthpro.py."""

    def __init__(self, conf, device="cuda"):
        from mpsfm_tpu_torch.extraction.nets.depth_pro import DepthPro

        self.net = DepthPro(conf, device=device)
        if self.net.params is None:
            self.net.init_random(0)
        self.rel_unc = conf.get("depth_uncertainty", 0.0875)

    def __call__(self, image_rgb, intrinsics=None, **kw):
        f_px = 0.5 * (intrinsics[0] + intrinsics[1]) if intrinsics is not None else None
        d = np.asarray(self.net.infer_image(image_rgb, f_px=f_px)["depth"], np.float64)
        valid = np.isfinite(d) & (d > 0)
        out = {"depth": d, "depth_variance": (d * self.rel_unc) ** 2, "valid": valid}
        if intrinsics is not None:
            fx, fy, cx, cy = intrinsics
            fill = np.median(d[valid]) if valid.any() else 1.0
            out["normals"] = normals_from_depth(np.where(valid, d, fill), fx, fy, cx, cy)
            out["normals_variance"] = np.full(d.shape, (np.deg2rad(8.0)) ** 2)
        return out


class _Metric3DBackend:
    """Metric3Dv2 -> metric depth + normal priors: the scale-canonical
    transform, the confidence -> error model and the BNI coordinates of the
    reference wrapper (metric3dv2.py:29-120), plus the flipped second pass
    of the flip-consistency configs (:88-109)."""

    def __init__(self, conf, device="cuda"):
        from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2

        self.net = Metric3Dv2(conf, device=device)
        if self.net.params is None:
            self.net.init_random(0)
        self.flip_consistency = bool(conf.get("flip_consistency", False))
        self.normals_only = bool(conf.get("normals_only", False))

    def __call__(self, image_rgb, intrinsics=None, **kw):
        if intrinsics is None:
            h, w = np.asarray(image_rgb).shape[:2]
            intrinsics = (max(h, w) * 1.2, max(h, w) * 1.2, w / 2, h / 2)
        out = self.net.infer_image(image_rgb, intrinsics)
        if self.flip_consistency:
            out2 = self.net.infer_image(image_rgb, intrinsics, flip=True)
            out.update({
                "depth2": out2["depth"],
                "depth_variance2": out2["depth_variance"],
                "normals2": out2["normals"],
                "normals2_variance": out2["normals_variance"],
                "valid2": out2["valid"],
            })
        if self.normals_only:
            out = {k: v for k, v in out.items() if k.startswith("normals")}
        return out


class _DSINEBackend:
    """DSINE -> surface-normal priors: kappa -> angular variance and the BNI
    coordinates of the reference wrapper (normals/dsine.py:26-141), plus the
    flipped second pass for the ``-fc`` return types (:96-99), as
    ``normals2``. Normals only: no depth."""

    def __init__(self, conf, device="cuda"):
        from mpsfm_tpu_torch.extraction.nets.dsine import DSINE

        self.net = DSINE(conf, device=device)
        if self.net.params is None:
            self.net.init_random(0)
        self.flip_consistency = bool(conf.get("flip_consistency", False))

    def __call__(self, image_rgb, intrinsics=None, **kw):
        if intrinsics is None:
            h, w = np.asarray(image_rgb).shape[:2]
            intrinsics = (max(h, w) * 1.2, max(h, w) * 1.2, w / 2, h / 2)
        out = self.net.infer_image(image_rgb, intrinsics)
        if self.flip_consistency:
            out2 = self.net.infer_image(image_rgb, intrinsics, flip=True)
            out["normals2"] = out2["normals"]
            out["normals2_variance"] = out2["normals_variance"]
        return out


def _vit_mono(conf=None, device="cuda"):
    from mpsfm_tpu_torch.extraction.nets.mono import ViTMonoBackend

    return ViTMonoBackend(conf, device=device)


BACKENDS = {
    "measured": MeasuredDepthBackend,
    "oracle": SyntheticOracleBackend,
}


def get_prior_backend(name: str, conf=None, device="cuda"):
    """The backend of a config name (case-insensitive, as the reference's
    DSINE-kappa-fc); the neural ones run on `device`. ``vit_mono`` and every
    name it begins (the JAX package's BACKENDS entry and prefix) take the
    framework's ViT-DPT net (ViTMonoBackend) from conf.weights_path."""
    name = str(name).lower()
    if name.startswith("vit_mono"):
        return _vit_mono(conf, device=device)
    if name in BACKENDS:
        return BACKENDS[name](conf)
    return NeuralDepthBackend(name, conf, device=device)
