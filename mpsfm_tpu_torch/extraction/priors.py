"""Prior backends of the main path: depth + normals with calibrated
uncertainties (port of the numpy part of mpsfm_tpu/extraction/priors.py).

* ``measured``: RGB-D sensor depth at fixed 1% relative uncertainty — the
  tauzn-clock fork's use_measured path (extraction/base.py:177-224),
  normals derived from it geometrically (``normals_from_depth``);
* ``oracle``: ground-truth maps given by the caller (tests).

The neural backends (Metric3Dv2, DepthPro, DepthAnythingV2, DSINE, the
ViT-DPT net) are not ported yet: asking for one raises.
"""

from __future__ import annotations

import numpy as np


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
    """Test backend: caller provides ground-truth maps (+noise knobs)."""

    name = "oracle"

    def __init__(self, conf=None):
        self.conf = conf or {}

    def __call__(self, image_rgb, depth_gt=None, normals_gt=None, noise=0.0, rel_unc=0.03, rng=None, **kw):
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


BACKENDS = {
    "measured": MeasuredDepthBackend,
    "oracle": SyntheticOracleBackend,
}


def get_prior_backend(name: str, conf=None):
    name = str(name).lower()  # reference config names like DSINE-kappa-fc
    if name in BACKENDS:
        return BACKENDS[name](conf)
    raise NotImplementedError(
        f"prior backend {name!r} is a neural net, not ported yet (ROADMAP queue 1, item 6: neural "
        "extraction); the port has the 'measured' and 'oracle' backends"
    )
