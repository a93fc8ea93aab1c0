"""Host-side monocular prior state: Depth and Normals with calibrated
uncertainties (a copy of mpsfm_tpu/scene/priors.py; the device working
map Depth._data_dev is a torch tensor).

Ports the reference's uncertainty model (mpsfm/sfm/scene/image/depth.py,
normals.py) to numpy: model variance + flip-consistency fusion +
proportional depth_uncertainty floor for depth; spherical two-view
covariance with eigenvalue flooring and Jacobian pushforward for normals;
continuity masks from the fg/bg ratio test (scene/image/utils.py:12-42).
All maps live at the camera's integration-grid resolution.
"""

from __future__ import annotations

import numpy as np

from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.utils.interp import resize_bilinear, resize_nearest, sample_bilinear

LARGE = 1e6


def get_continuity_mask(depth: np.ndarray, t: float = 1.015) -> np.ndarray:
    """Continuity mask from inverse-depth fg/bg ratio test
    (reference scene/image/utils.py:26-42)."""
    inv = 1.0 / np.clip(depth, 1e-6, None)
    r_l = (inv[:, 1:] / inv[:, :-1]) > t
    l_l = (inv[:, :-1] / inv[:, 1:]) > t
    b_l = (inv[1:, :] / inv[:-1, :]) > t
    t_l = (inv[:-1, :] / inv[1:, :]) > t
    lr_ok = ~(r_l | l_l)
    tb_ok = ~(b_l | t_l)
    cont = np.ones_like(depth, dtype=bool)
    cont[:, 1:] &= lr_ok
    cont[:, :-1] &= lr_ok
    cont[1:, :] &= tb_ok
    cont[:-1, :] &= tb_ok
    return cont


class Depth(BaseClass):
    """Per-image depth prior + uncertainty + shift/scale alignment state."""

    default_conf = {
        "inherent_noise": 0.02,
        "std_multiplier": 1,
        "prior_std_multiplier": 3.33,
        "max_std": None,
        "use_continuity": True,
        "depth_lim": None,
        "fixed_uncertainty_val": 0.03,
        "fixed_uncertainty": False,
        "prior_uncertainty": True,
        "flip_consistency": False,
        "depth_uncertainty": 0.0263,  # m3dv2-giant2 calibration (BASELINE.md)
        "verbose": 0,
    }

    def _init(self, depth_dict, int_hw, kps=None, mask=None):
        conf = self.conf
        H, W = int_hw
        mews, variances = [], []
        if conf.flip_consistency and not conf.prior_uncertainty:
            mews.append((depth_dict["depth2"] + depth_dict["depth"]) / 2)
            variances.append((depth_dict["depth"] - depth_dict["depth2"]) ** 2)
        elif conf.flip_consistency:
            mews += [depth_dict["depth"], depth_dict["depth2"]]
            variances += [depth_dict["depth_variance"], depth_dict["depth_variance2"]]
        elif conf.prior_uncertainty:
            mews.append(depth_dict["depth"])
            variances.append(depth_dict["depth_variance"])
        else:
            mews.append(depth_dict["depth"])

        valid = depth_dict["depth"] > 0
        for key in ("valid", "valid2"):
            if key in depth_dict:
                valid = valid & depth_dict[key]

        continuity = None
        if conf.use_continuity:
            continuity = get_continuity_mask(depth_dict["depth"])
            if "depth2" in depth_dict:
                continuity &= get_continuity_mask(depth_dict["depth2"])

        if len(mews) > 1:
            prec = sum(1.0 / (v + 1e-6) for v in variances)
            self.data_prior = sum(m / (v + 1e-6) for m, v in zip(mews, variances)) / (prec + 1e-6)
        else:
            self.data_prior = np.array(mews[0], np.float64)

        if conf.depth_uncertainty is not None:
            if conf.prior_uncertainty:
                new_var = [
                    np.maximum(v * conf.prior_std_multiplier**2, (m * conf.depth_uncertainty) ** 2)
                    for m, v in zip(mews, variances)
                ]
                if len(new_var) > 1:
                    self.uncertainty = 1.0 / (sum(1.0 / (v + 1e-6) for v in new_var) + 1e-6)
                else:
                    self.uncertainty = new_var[0]
            else:
                self.uncertainty = (self.data_prior * conf.depth_uncertainty) ** 2
        elif conf.flip_consistency:
            self.uncertainty = (
                1.0 / (sum(1.0 / (v + 1e-6) for v in variances) + 1e-6)
            ) * conf.prior_std_multiplier**2
        elif conf.fixed_uncertainty:
            self.uncertainty = np.ones_like(mews[0]) * conf.fixed_uncertainty_val
        else:
            self.uncertainty = np.array(variances[0])

        max_clip = None if conf.max_std is None else conf.max_std**2
        self.uncertainty = np.clip(self.uncertainty, conf.inherent_noise**2, max_clip)
        self.uncertainty = self.uncertainty * conf.std_multiplier**2

        if self.data_prior.shape != (H, W):
            self.data_prior = resize_bilinear(self.data_prior, (H, W))
            self.uncertainty = resize_bilinear(self.uncertainty, (H, W))
            valid = resize_bilinear(valid.astype(np.float64), (H, W)) == 1
            if continuity is not None:
                continuity = resize_bilinear(continuity.astype(np.float64), (H, W)) == 1
        if mask is not None:
            if mask.shape != (H, W):
                mask = resize_nearest(mask.astype(np.float32), (H, W)) > 0.5
            valid = valid & mask
        self.uncertainty = np.where(valid, self.uncertainty, LARGE)
        zero = self.data_prior == 0
        self.data_prior = np.where(zero, 0.1, self.data_prior)
        valid = valid & ~zero
        if conf.depth_lim is not None:
            valid = valid & (self.data_prior <= conf.depth_lim)
        self.valid = valid
        self.continuity_mask = continuity

        self.scale = 1.0
        self.shift = 0.0
        self.activated = False
        self.data = None  # refined/working depth (activated copies prior)
        # bumped whenever the prior grids (data_prior/uncertainty) change —
        # device-side caches of prior-derived arrays key on this
        self.version = 0
        # working-copy cache keys: data_epoch bumps when `data` is
        # REPLACED; pure multiplicative rescales of the working map keep
        # the epoch and accumulate data_log_shift instead (device z0
        # caches apply it as a scalar: log(s·d) = log d + log s)
        self.data_epoch = 0
        self.data_log_shift = 0.0
        self.kps = kps
        self._grid_scale = (1.0, 1.0)  # (sx, sy) image->grid, set by owner
        # Per-keypoint uncertainty store (updated by integration covs).
        self.uncertainty_update = (
            self.uncertainty_at_kps(kps) if kps is not None else None
        )

    @property
    def data(self):
        """Working (refined) depth map; assignment bumps data_epoch and
        clears the accumulated log-shift (device z0 caches key on both).

        The working map may live ONLY on device (set_data_from_device —
        the fused refinement never reads the integration output back per
        iteration); first host access materializes it with one blocking
        transfer: exp(z + accumulated log-shift)."""
        if self._data is None and getattr(self, "_data_dev", None) is not None:
            self._data = np.exp(
                self._data_dev.cpu().numpy().astype(np.float64) + self.data_log_shift
            )
        return self._data

    @data.setter
    def data(self, v):
        self._data = v
        self._data_dev = None
        self.data_epoch = getattr(self, "data_epoch", 0) + 1
        self.data_log_shift = 0.0

    def set_data_from_device(self, zlog_dev):
        """Adopt a device log-depth grid as the working map WITHOUT a
        host transfer (fused-refinement accept path). Same bookkeeping
        as the data setter; host copies materialize lazily."""
        self._data = None
        self._data_dev = zlog_dev
        self.data_epoch = getattr(self, "data_epoch", 0) + 1
        self.data_log_shift = 0.0

    def data_log_dev(self):
        """(device log-depth grid at its upload scale, scalar log-shift
        since) — or None when the working map is host-only."""
        dev = getattr(self, "_data_dev", None)
        if dev is None:
            return None
        return dev, float(self.data_log_shift)

    def set_grid_scale(self, sx, sy):
        self._grid_scale = (sx, sy)
        if self.kps is not None:
            self.uncertainty_update = self.uncertainty_at_kps(self.kps)

    # --- sampling (image-frame kps -> integration grid) ---
    def data_at_kps(self, kps):
        return sample_bilinear(self.data, np.asarray(kps), self._grid_scale)

    def data_prior_at_kps(self, kps):
        return sample_bilinear(self.data_prior, np.asarray(kps), self._grid_scale)

    def uncertainty_at_kps(self, kps):
        return sample_bilinear(self.uncertainty, np.asarray(kps), self._grid_scale)

    def valid_at_kps(self, kps):
        return sample_bilinear(self.valid.astype(np.float64), np.asarray(kps), self._grid_scale) > 0.99

    def activate(self):
        if not self.activated:
            self.activated = True
            self.data = self.data_prior.copy()

    def rescale(self, shift, scale, rescale_working=False):
        """Rescale the prior (reference mixins/depth_utils.py:60-66);
        rescale_working also scales the refined map (normalize_depths path,
        :93)."""
        if shift == 0.0 and scale == 1.0:
            return
        self.data_prior = self.data_prior * scale + shift
        self.scale *= scale
        self.shift = self.shift * scale + shift
        self.uncertainty = self.uncertainty * scale**2
        if shift != 0.0:
            self.version += 1
        if self.uncertainty_update is not None:
            self.uncertainty_update = self.uncertainty_update * scale**2
        if rescale_working and self.activated and (
            self._data is not None or getattr(self, "_data_dev", None) is not None
        ):
            if shift == 0.0:
                # multiplicative-only: keep the working-copy epoch and
                # accumulate the scalar log-shift instead (z0 device
                # caches stay valid: log(s·d) = log d + log s)
                if self._data is not None:
                    self._data = self._data * scale
                self.data_log_shift += float(np.log(scale))
            else:
                self.data = self.data * scale + shift

    def reset(self):
        """Undo alignment; deactivate (reference depth.py:132-140)."""
        self.data_prior = self.data_prior / self.scale
        self.uncertainty = self.uncertainty / self.scale**2
        if self.kps is not None:
            self.uncertainty_update = self.uncertainty_at_kps(self.kps)
        self.scale = 1.0
        self.shift = 0.0
        self.activated = False
        self.data = None


def _cart_to_spherical(n):
    n = n / np.clip(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12, None)
    theta = np.arccos(np.clip(n[..., 2], -1, 1))
    phi = np.sign(n[..., 1]) * np.arccos(
        np.clip(n[..., 0] / (1e-6 + np.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)), -1, 1)
    )
    return np.stack([theta, phi], -1)


def _diff_angle(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


def _spherical_jacobian(sph):
    """Jacobian spherical->Cartesian (reference normals.py:82-94)."""
    ct, cp = np.cos(sph[..., 0]), np.cos(sph[..., 1])
    st, sp = np.sin(sph[..., 0]), np.sin(sph[..., 1])
    J = np.zeros((*sph.shape[:-1], 3, 2))
    J[..., 0, 0] = ct * cp
    J[..., 0, 1] = -st * sp
    J[..., 1, 0] = ct * sp
    J[..., 1, 1] = st * cp
    J[..., 2, 0] = -st
    return J


def two_view_normal_covariance(n1, n2, noise, var1=None, var2=None, prior_std_multiplier=None, lc_std_multiplier=None):
    """Flip-consistency covariance of normals (reference normals.py:97-134)."""
    s1 = _cart_to_spherical(n1)
    s2 = _cart_to_spherical(n2)
    diff = s2 - s1
    s2 = np.where(diff > np.pi, s2 - 2 * np.pi, np.where(diff < -np.pi, s2 + 2 * np.pi, s2))
    mean = (s1 + s2) / 2

    cov_diag = _diff_angle(s1, mean) ** 2 + _diff_angle(s2, mean) ** 2
    cov_off = _diff_angle(s1[..., 0], mean[..., 0]) * _diff_angle(s1[..., 1], mean[..., 1]) + _diff_angle(
        s2[..., 0], mean[..., 0]
    ) * _diff_angle(s2[..., 1], mean[..., 1])
    C = np.stack(
        [cov_diag[..., 0], cov_off, cov_off, cov_diag[..., 1]], axis=-1
    ).reshape(*s1.shape[:-1], 2, 2)

    # Eigenvalue flooring at `noise`.
    w, R = np.linalg.eigh(C)
    w = np.maximum(w, noise)
    C = R @ (w[..., None] * np.swapaxes(R, -1, -2))
    if lc_std_multiplier is not None:
        C = C * lc_std_multiplier**2
    if prior_std_multiplier is not None:
        if var1 is not None:
            var1 = var1 * prior_std_multiplier**2
        if var2 is not None:
            var2 = var2 * prior_std_multiplier**2
    for v in (var1, var2):
        if v is not None:
            C[..., 0, 0] = np.maximum(C[..., 0, 0], v)
            C[..., 1, 1] = np.maximum(C[..., 1, 1], v)
    J = _spherical_jacobian(mean)
    cov = J @ C @ np.swapaxes(J, -1, -2)
    for k in range(3):
        cov[..., k, k] = np.clip(cov[..., k, k], 0, None)
    return cov


class Normals(BaseClass):
    """Per-image surface-normal prior + 3x3 covariances (+downscaled copies)."""

    default_conf = {
        "inherent_polar_noise": np.pi / 180,
        "std_multiplier": 1,
        "lc_std_multiplier": 1,
        "prior_std_multiplier": 1,
        "downscale_factor": 2,
        "prior_uncertainty": True,
        "flip_consistency": False,
        "verbose": 0,
    }

    def _init(self, normals_dict, int_hw, mask=None, continuity_mask=None):
        conf = self.conf
        H, W = int_hw

        def norm(x):
            return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12, None)

        n1 = norm(resize_bilinear(np.asarray(normals_dict["normals"], np.float64), (H, W)))
        Hd, Wd = int(H // conf.downscale_factor), int(W // conf.downscale_factor)
        d1 = norm(resize_bilinear(n1, (Hd, Wd)))
        var = normals_dict.get("normals_variance")
        if var is not None:
            var = resize_bilinear(np.asarray(var, np.float64), (H, W))
            vard = resize_bilinear(var, (Hd, Wd))

        if conf.flip_consistency:
            n2 = norm(resize_bilinear(np.asarray(normals_dict["normals2"], np.float64), (H, W)))
            d2 = norm(resize_bilinear(n2, (Hd, Wd)))
            var2 = normals_dict.get("normals2_variance")
            if var2 is not None:
                var2 = resize_bilinear(np.asarray(var2, np.float64), (H, W))
                var2d = resize_bilinear(var2, (Hd, Wd))
            else:
                var2d = None
            self.data = norm((n1 + n2) / 2)
            self.data_downscaled = norm((d1 + d2) / 2)
            self.uncertainty = two_view_normal_covariance(
                n1, n2, conf.inherent_polar_noise, var, var2,
                conf.prior_std_multiplier, conf.lc_std_multiplier,
            )
            self.uncertainty_downscaled = two_view_normal_covariance(
                d1, d2, conf.inherent_polar_noise, vard if var is not None else None, var2d,
                conf.prior_std_multiplier, conf.lc_std_multiplier,
            )
        else:
            self.data = n1
            self.data_downscaled = d1
            if var is None:
                var = np.full((H, W), conf.inherent_polar_noise**2)
                vard = np.full((Hd, Wd), conf.inherent_polar_noise**2)
            self.uncertainty = self._isotropic_cov(n1, var)
            self.uncertainty_downscaled = self._isotropic_cov(d1, vard)

        self.uncertainty *= conf.std_multiplier**2
        self.uncertainty_downscaled *= conf.std_multiplier**2
        if mask is not None:
            if mask.shape != (H, W):
                mask = resize_nearest(mask.astype(np.float32), (H, W)) > 0.5
            self.uncertainty[~mask] = LARGE
        if continuity_mask is not None:
            self.uncertainty[~continuity_mask] = LARGE

    @staticmethod
    def _isotropic_cov(n, var):
        """Isotropic spherical variance pushed to Cartesian
        (reference normals.py:220-230). With C = var·I the pushforward
        J C Jᵀ reduces to var·(J Jᵀ) — one einsum instead of two
        (H,W,3,2)@(H,W,2,2) matmul sweeps."""
        sph = _cart_to_spherical(n)
        J = _spherical_jacobian(sph)
        return var[..., None, None] * np.einsum("...ij,...kj->...ik", J, J)
