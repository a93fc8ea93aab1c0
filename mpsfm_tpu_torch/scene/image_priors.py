"""Per-image prior state + integration bridge (port of
mpsfm_tpu/scene/image_priors.py).

Binds Depth/Normals priors and the BiNI solver to an image in the
reconstruction: projecting the image's sparse 3D points into the
integration grid, filtering low-parallax points, pricing the anchors by
the point covariances, running the gate + solve (K2 on the card), and
propagating diag(H⁻¹) (K3 on the card) back to per-keypoint depth
variances.

The device rows (static and prior rows, the working log-depth z0) live
on the ImagePriors' device as torch tensors, cached as in the JAX
package; each call builds only the anchor rows on the host. Results the
host needs are read with `.cpu()`. Two deviations from the JAX package,
neither of which changes a real lane's result: the batch of lanes is
not padded to a power of two (the port's gates solve every lane when
any lane is live, so a padded lane would cost a real K2 or K3 solve),
and the query rows are padded to the longest lane only (K3 groups them
itself). The anchor width keeps its power-of-two bucket, so the anchor
rows equal the JAX package's.

`_changed_flag_dev` and `_updated_unc_dev` turn the diag(H⁻¹) variances
of log-depth at a lane's keypoints into the keypoints' depth variances,
which become the BA depth rows' sigma2, where that lane's integration
changed this iteration (refine and not aborted, from the gate + solve's
info4 rows [e0, e, refine, aborted]).
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass, Config
from mpsfm_tpu_torch.integration.bini import (
    BiniParams,
    Integrator,
    bini_gate_solve_batch_anchors,
    build_integration_inputs,
    build_prior2,
    build_static6,
    diag_inverse_at_batch_anchors,
    diag_inverse_gated_batch_anchors,
    prior_z0,
    resize_log_dev,
    take_z,
)
from mpsfm_tpu_torch.scene.priors import Depth, Normals
from mpsfm_tpu_torch.utils.interp import resize_bilinear
from mpsfm_tpu_torch.utils.profiling import TIMERS


def _f32(x) -> float:
    """A host scalar rounded to float32, as the JAX package passes it."""
    return float(np.float32(x))


class ImagePriors(BaseClass):
    """Attached to ImageRecord as `.priors`; `.depth`/`.normals` forwarded.
    Its device rows live on `device` (the card unless the caller asks for
    the CPU)."""

    default_conf = {
        "depth": {},
        "normals": {},
        # integration conf (reference scene/image/base.py:30-55):
        "max_iter": 10,
        "tol": 5e-2,
        "cg_max_iter": 1000,
        "cg_tol": 1e-3,
        "lambda1": 1.0,
        "lambda2": 1.0,
        "k": 1.0,
        "depth_magnitude_multiplier": 1.0,
        "normals_magnitude_multiplier": 1.0,
        "downscale_factor": 2,
        "downscaled": True,
        "cov_cg_iters": 16,  # deflated PCG: ~1% diag err at 10 iters
        # Relative floor on the int_covs posterior depth std (fraction of
        # prior depth); a deviation of the JAX package from the reference,
        # kept (mpsfm_tpu/scene/image_priors.py:46-56).
        "int_cov_rel_floor": 0.01,
        "scale_filter": True,
        "scale_filter_factor": 1.5,
        "robust_triangles": 2,
        "verbose": 0,
    }

    def _propagate_conf(self):
        self.conf.depth = Config.create(Depth.default_conf).merged(self.conf.depth)
        self.conf.normals = Config.create(Normals.default_conf).merged(self.conf.normals)

    def _init(self, rec, imid, depth_dict, normals_dict, mask=None, device="cuda"):
        self.device = resolve_device(device)
        self.rec = rec
        self.imid = imid
        cam = rec.camera(imid)
        int_hw = (cam.int_height, cam.int_width)
        kps = rec.images[imid].keypoints
        self.depth = Depth(self.conf.depth, depth_dict, int_hw, kps=kps, mask=mask)
        self.depth.set_grid_scale(cam.sx, cam.sy)
        self.normals = Normals(
            self.conf.normals,
            normals_dict,
            int_hw,
            mask=mask,
            continuity_mask=self.depth.continuity_mask,
        )
        self.integrator = Integrator(
            BiniParams(
                lambda1=float(self.conf.lambda1),
                lambda2=float(self.conf.lambda2),
                k=float(self.conf.k),
                max_iter=int(self.conf.max_iter),
                cg_max_iter=int(self.conf.cg_max_iter),
                cg_tol=float(self.conf.cg_tol),
                tol=float(self.conf.tol),
            ),
            device=self.device,
        )
        self._reset_caches()

    def _reset_caches(self):
        # Device caches, keyed by downscale factor: the static rows
        # (normals-derived), prior rows (keyed by Depth.version), and the
        # working log-depth z0 (keyed by Depth.data_epoch, moved by a
        # scalar log-shift under rescales).
        self._static6_cache: dict = {}
        self._prior_cache: dict = {}
        self._packed_dev: dict = {}
        self._z0_cache: dict = {}

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # --- sparse anchors (reference _prepare_integration_variables :92-131) ---
    def _sparse_anchors(self):
        rec = self.rec
        imid = self.imid
        cam = rec.camera(imid)
        kp_ids, pids, kps_px, depth3d, ok = rec.project_image_3d_points(imid)
        if not ok or pids is None or len(pids) == 0:
            return None
        pids = np.asarray(pids)
        if self.conf.robust_triangles is not None:
            safe = ~rec.find_points3D_with_small_triangulation_angle(
                self.conf.robust_triangles, pids
            )
            pids, kps_px, depth3d = pids[safe], kps_px[safe], depth3d[safe]
        if len(pids) == 0:
            return None
        grid_px = kps_px * np.array([cam.sx, cam.sy])
        H, W = cam.int_height, cam.int_width
        inb = (
            (grid_px[:, 0] >= 0)
            & (grid_px[:, 0] < W)
            & (grid_px[:, 1] >= 0)
            & (grid_px[:, 1] < H)
        )
        pids, grid_px, depth3d = pids[inb], grid_px[inb], depth3d[inb]
        if len(pids) == 0:
            return None
        return grid_px, depth3d, pids

    def _point_zvars(self, pids):
        """z-variance of points in this camera: (Rᵀ Σ R)[2,2]
        (reference scene/pointcov.py:10-20)."""
        rec = self.rec
        R = rec.images[self.imid].pose.rotation_matrix()
        covs = np.stack(
            [rec.point_covs.get(int(p), np.eye(3) * 1e-2) for p in pids]
        )
        return np.einsum("i,nij,j->n", R[2], covs, R[2]).clip(1e-12, None)

    def _R2(self):
        """Third world->cam rotation row for the device z-variance; [0,0,1]
        when the image has no pose yet (anchors then carry host codes)."""
        pose = self.rec.images[self.imid].pose
        if pose is None:
            return np.array([0.0, 0.0, 1.0])
        return pose.rotation_matrix()[2]

    def _grid_K(self):
        cam = self.rec.camera(self.imid)
        return cam.fx * cam.sx, cam.fy * cam.sy, cam.cx * cam.sx, cam.cy * cam.sy

    def build_inputs(self, downscale=1):
        depth = self.depth
        normals = self.normals
        fx, fy, cx, cy = self._grid_K()
        anchors = self._sparse_anchors()
        kw = {}
        if anchors is not None:
            px, d3, pids = anchors
            zv = self._point_zvars(pids)
            kw = dict(sparse_px=px / downscale, sparse_depth=d3, sparse_zvar=zv)
        if downscale > 1:
            H, W = depth.data_prior.shape
            hw = (int(H // downscale), int(W // downscale))
            dp = resize_bilinear(depth.data_prior, hw)
            du = resize_bilinear(depth.uncertainty, hw)
            vm = resize_bilinear(depth.valid.astype(np.float64), hw) > 0.5
            nm = normals.data_downscaled
            nc = normals.uncertainty_downscaled
            z_init = resize_bilinear(
                depth.data if (depth.activated and depth.data is not None) else depth.data_prior, hw
            )
            return build_integration_inputs(
                dp, du, vm, nm, nc, fx / downscale, fy / downscale, cx / downscale, cy / downscale,
                z_init=z_init,
                scale_filter=self.conf.scale_filter,
                scale_filter_factor=self.conf.scale_filter_factor,
                depth_magnitude_multiplier=self.conf.depth_magnitude_multiplier,
                normals_magnitude_multiplier=self.conf.normals_magnitude_multiplier,
                **kw,
            )
        z_init = depth.data if (depth.activated and depth.data is not None) else depth.data_prior
        return build_integration_inputs(
            depth.data_prior, depth.uncertainty, depth.valid, normals.data,
            normals.uncertainty, fx, fy, cx, cy,
            z_init=z_init,
            scale_filter=self.conf.scale_filter,
            scale_filter_factor=self.conf.scale_filter_factor,
            depth_magnitude_multiplier=self.conf.depth_magnitude_multiplier,
            normals_magnitude_multiplier=self.conf.normals_magnitude_multiplier,
            **kw,
        )

    # --- device-resident rows ---
    def _hw(self, downscale):
        H, W = self.depth.data_prior.shape
        return (int(H // downscale), int(W // downscale)) if downscale > 1 else (H, W)

    def _static6_np(self, downscale):
        s = self._static6_cache.get(downscale)
        if s is not None:
            return s
        depth, normals = self.depth, self.normals
        fx, fy, cx, cy = self._grid_K()
        if downscale > 1:
            hw = self._hw(downscale)
            vm = resize_bilinear(depth.valid.astype(np.float64), hw) > 0.5
            nm, nc = normals.data_downscaled, normals.uncertainty_downscaled
            fx, fy, cx, cy = fx / downscale, fy / downscale, cx / downscale, cy / downscale
        else:
            vm, nm, nc = depth.valid, normals.data, normals.uncertainty
        s = build_static6(
            vm, nm, nc, fx, fy, cx, cy,
            normals_magnitude_multiplier=self.conf.normals_magnitude_multiplier,
        )
        self._static6_cache[downscale] = s
        return s

    def _prior_dp_du(self, downscale):
        """(data_prior, uncertainty) at the downscaled grid, cached by
        (Depth.version, cumulative scale)."""
        key = (self.depth.version, float(self.depth.scale))
        c = self._prior_cache.get(downscale)
        if c is not None and c[0] == key:
            return c[1], c[2]
        if downscale > 1:
            hw = self._hw(downscale)
            dp = resize_bilinear(self.depth.data_prior, hw)
            du = resize_bilinear(self.depth.uncertainty, hw)
        else:
            dp, du = self.depth.data_prior, self.depth.uncertainty
        self._prior_cache[downscale] = (key, dp, du)
        return dp, du

    def static_prior_dev(self, downscale=1):
        """(dev8, prior_shift): device (8,H,W) slow rows [prec_prior,
        z_prior, c_x, c_y, nx, ny, prec_x, prec_y] plus the scalar
        log-scale drift since upload. Prior rescales are multiplicative
        (shift fixed at 0), so the cache survives them: log-depth
        precision is scale-invariant and z_prior moves by log(s)."""
        ver = self.depth.version
        s_now = float(self.depth.scale)
        ent = self._packed_dev.get(downscale)
        if ent is not None and ent["ver"] == ver:
            return ent["dev"], float(np.log(s_now / ent["s0"]))
        dp, du = self._prior_dp_du(downscale)
        prior2 = build_prior2(dp, du, self.conf.depth_magnitude_multiplier)
        dev = self._dev(np.concatenate([prior2, self._static6_np(downscale)], 0))
        self._packed_dev[downscale] = {"ver": ver, "s0": s_now, "dev": dev, "zrow": None}
        return dev, 0.0

    def _anchor_payload(self, downscale=1):
        """Host (L,5) float32 anchor rows [y, x, val, logz, slot] after
        the prior scale filter (reference process_sparse_depth,
        integration.py:281-288).

        Slot codes (bini._assemble_batch_anchors): when the point
        covariances live on the device (LazyCovDict.device_view), val is
        the anchor depth and slot indexes the device covariance tensor,
        so the anchor precision d²/zvar is computed on the device;
        slot -1 takes the default covariance (eye·1e-2); slot -2 means
        val is a host-computed precision."""
        anchors = self._sparse_anchors()
        if anchors is None:
            return np.zeros((0, 5), np.float32)
        px, d3, pids = anchors
        px = px / downscale
        dp, _ = self._prior_dp_du(downscale)
        H, W = dp.shape
        xs = np.clip(np.round(px[:, 0]).astype(np.int64), 0, W - 1)
        ys = np.clip(np.round(px[:, 1]).astype(np.int64), 0, H - 1)
        d3 = np.asarray(d3, np.float64)
        keep = d3 > 0
        if self.conf.scale_filter:
            div = d3 / np.clip(dp[ys, xs], 1e-8, None)
            keep &= (div < self.conf.scale_filter_factor) & (
                div > 1 / self.conf.scale_filter_factor
            )
        xs, ys, d3, pids = xs[keep], ys[keep], d3[keep], np.asarray(pids)[keep]
        logz = np.log(np.clip(d3, 1e-8, None))
        covdict = self.rec.point_covs
        view = getattr(covdict, "device_view", lambda: None)()
        if view is not None:
            vals = np.asarray(d3, np.float64).copy()
            slots = covdict.slots_for(pids).astype(np.float64)
            R2 = self._R2()
            # rare fallback: pids absent from the device dispatch but
            # present as raw host covariances
            for i in np.where(slots < 0)[0]:
                raw = dict.get(covdict, int(pids[i]))  # built-in get: no flush
                if raw is not None:
                    zv = max(float(R2 @ raw @ R2), 1e-12)
                    vals[i] = d3[i] ** 2 / zv
                    slots[i] = -2.0
            return np.stack([ys, xs, vals, logz, slots], -1).astype(np.float32)
        zv = np.clip(self._point_zvars(pids), 1e-12, None)
        prec = (1.0 / zv) * d3**2
        slots = np.full(len(d3), -2.0)
        return np.stack([ys, xs, prec, logz, slots], -1).astype(np.float32)

    def _z0_shift_dev(self, downscale=1):
        """(z0_dev (H,W), shift): cached device working log-depth plus the
        scalar log-shift accumulated since its upload. Falls back to the
        z_prior row of the cached static rows when not activated."""
        depth = self.depth
        if depth.activated and (
            depth._data is not None or depth.data_log_dev() is not None
        ):
            key = ("d", depth.data_epoch)
            ent = self._z0_cache.get(downscale)
            if ent is not None and ent[0] == key:
                return ent[2], float(depth.data_log_shift - ent[1])
            handle = depth.data_log_dev()
            if handle is not None:
                # device-resident working map: derive the (downscaled) z0
                # on the device, no host round trip
                zdev, shift = handle
                if downscale > 1:
                    dev = resize_log_dev(zdev, _f32(shift), self._hw(downscale))
                else:
                    dev = zdev if shift == 0.0 else zdev + _f32(shift)
                self._z0_cache[downscale] = (key, float(depth.data_log_shift), dev)
                return dev, 0.0
            if downscale > 1:
                z0 = np.log(np.clip(resize_bilinear(depth.data, self._hw(downscale)), 1e-8, None))
            else:
                z0 = np.log(np.clip(depth.data, 1e-8, None))
            dev = self._dev(z0)
            self._z0_cache[downscale] = (key, float(depth.data_log_shift), dev)
            return dev, 0.0
        # prior fallback: z0 = z_prior row of the cached static rows (at
        # its upload scale) + the same scalar drift
        dev8, prior_shift = self.static_prior_dev(downscale)
        ent = self._packed_dev[downscale]
        if ent["zrow"] is None:
            ent["zrow"] = prior_z0(dev8)
        return ent["zrow"], prior_shift

    def seed_z0(self, z_dev):
        """Seed the full-res z0 cache from a device solve output (called
        right after the batched integrator accepted depth.data)."""
        self._z0_cache[1] = (("d", self.depth.data_epoch), 0.0, z_dev)
        self._z0_cache.pop(self.conf.downscale_factor, None)

    def integrate(self, **kw):
        """Refine the working depth map. Returns True when changed
        (reference Image.integrate, integration.py:133-137)."""
        assert self.rec.images[self.imid].registered and self.depth.activated
        return integrate_bundle_batched([self])[self.imid]

    def calculate_int_covs_for_entire_image(
        self, downscaled=None, ignore_depths=False, estimator=None, stride=16
    ):
        """Per-pixel propagated depth VARIANCE map at the integration grid
        (reference calculate_int_covs_for_entire_image,
        integration.py:618-629): diag(H⁻¹) at every pixel × depth².
        ignore_depths drops the sparse-SfM anchor term from the Hessian.

        estimator: 'exact' runs one indicator solve per pixel; 'subsampled'
        (default) solves the exact diagonal on a stride-subsampled pixel
        grid and interpolates it linearly (scipy's RegularGridInterpolator,
        as the JAX package does)."""
        estimator = estimator or self.conf.get("whole_image_estimator", "subsampled")
        use_ds = self.conf.downscaled if downscaled is None else bool(downscaled)
        ds = self.conf.downscale_factor if use_ds else 1
        pl = self._anchor_payload(downscale=ds)
        stat8, prior_shift = self.static_prior_dev(downscale=ds)
        z0, z0_shift = self._z0_shift_dev(downscale=ds)
        params = self.integrator.params._replace(cg_max_iter=int(self.conf.cov_cg_iters))
        if ignore_depths:
            params = params._replace(lambda2=0.0)
        h, w = stat8.shape[-2:]
        R2 = self._R2()
        anch = _pack_anchors(
            [(pl, z0_shift, prior_shift, R2)], (h, w), 1, _pow2(max(len(pl), 1), 64)
        )
        cov = _cov_dev_or_dummy(self.rec, self.device)
        if estimator == "subsampled":
            ys = np.arange(0, h, stride, dtype=np.int32)
            xs = np.arange(0, w, stride, dtype=np.int32)
            if ys[-1] != h - 1:
                ys = np.append(ys, h - 1)
            if xs[-1] != w - 1:
                xs = np.append(xs, w - 1)
            gy, gx = np.meshgrid(ys, xs, indexing="ij")
            rowcol = np.stack([gy.reshape(-1), gx.reshape(-1)])[None].astype(np.int32)
            sub = diag_inverse_at_batch_anchors(
                self._dev(anch), torch.as_tensor(rowcol, device=self.device), params, 128, cov, (z0, stat8)
            )[0].cpu().numpy().reshape(len(ys), len(xs))
            # exact values on a non-uniform stride grid -> full grid via
            # separable linear interpolation at the true pixel positions
            from scipy.interpolate import RegularGridInterpolator

            interp = RegularGridInterpolator(
                (ys.astype(np.float64), xs.astype(np.float64)), sub, method="linear"
            )
            yy, xx = np.meshgrid(
                np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij"
            )
            varlog = interp(np.stack([yy.reshape(-1), xx.reshape(-1)], -1)).reshape(h, w)
        else:
            yy, xx = np.meshgrid(
                np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32), indexing="ij"
            )
            rowcol = np.stack([yy.reshape(-1), xx.reshape(-1)])[None].astype(np.int32)
            varlog = diag_inverse_at_batch_anchors(
                self._dev(anch), torch.as_tensor(rowcol, device=self.device), params, 128, cov, (z0, stat8)
            )[0].cpu().numpy().reshape(h, w)
        if ds > 1:
            varlog = resize_bilinear(np.asarray(varlog, np.float64), self._hw(1))
        d = self.depth
        data = d.data if (d.activated and d.data is not None) else d.data_prior
        return varlog * np.asarray(data) ** 2

    def _int_cov_query(self, pts2d=None, z_override=None):
        """((payload, z0_shift, prior_shift, R2, (z0, stat8)), rows, cols,
        K, kps_sel, pts2d, params) for the diag(H⁻¹) queries at (a subset
        of) this image's keypoints on the downscaled integration grid."""
        rec = self.rec
        cam = rec.camera(self.imid)
        kps = rec.images[self.imid].keypoints
        if pts2d is None:
            pts2d = np.arange(len(kps))
        kps_sel = kps[pts2d]
        ds = self.conf.downscale_factor if self.conf.downscaled else 1
        pl = self._anchor_payload(downscale=ds)
        stat8, prior_shift = self.static_prior_dev(downscale=ds)
        if z_override is not None:
            # chained: the downscaled z0 derives from the fresh gate/solve
            # output lane (device), not the pre-solve cache
            zfull, zshift = z_override
            if ds > 1:
                z0, z0_shift = resize_log_dev(zfull, _f32(zshift), self._hw(ds)), 0.0
            else:
                z0, z0_shift = zfull, zshift
        else:
            z0, z0_shift = self._z0_shift_dev(downscale=ds)
        params = self.integrator.params._replace(cg_max_iter=int(self.conf.cov_cg_iters))
        h, w = stat8.shape[-2:]
        gx = np.clip(np.round(kps_sel[:, 0] * cam.sx / ds).astype(np.int32), 0, w - 1)
        gy = np.clip(np.round(kps_sel[:, 1] * cam.sy / ds).astype(np.int32), 0, h - 1)
        R2 = self._R2()
        return (
            (pl, z0_shift, prior_shift, R2, (z0, stat8)),
            gy, gx, len(gx), kps_sel, np.asarray(pts2d), params,
        )

    def _apply_int_covs(self, varlog, kps_sel, pts2d):
        d_prior = self.depth.data_prior_at_kps(kps_sel)
        var = varlog * d_prior**2  # var(log d) -> var(d)
        floor = float(self.conf.int_cov_rel_floor or 0.0)
        if floor > 0.0:
            var = np.maximum(var, (floor * d_prior) ** 2)
        for kp, v in zip(pts2d, var):
            self.depth.uncertainty_update[int(kp)] = float(max(v, 1e-12))
        self.int_covs_applied = True
        return var

    def calculate_int_covs_at_kps(self, pts2d=None):
        """Propagate diag(H⁻¹) to per-keypoint depth variances
        (reference calculate_int_covs_at_kps, integration.py:604-616)."""
        (pl, z0_shift, prior_shift, R2, pair), gy, gx, K, kps_sel, pts2d, params = (
            self._int_cov_query(pts2d)
        )
        rowcol = np.stack([gy, gx])[None].astype(np.int32)
        shape = tuple(pair[1].shape[-2:])
        anch = _pack_anchors(
            [(pl, z0_shift, prior_shift, R2)], shape, 1, _pow2(max(len(pl), 1), 64)
        )
        varlog = diag_inverse_at_batch_anchors(
            self._dev(anch), torch.as_tensor(rowcol, device=self.device), params, 128,
            _cov_dev_or_dummy(self.rec, self.device), pair
        )[0, :K].cpu().numpy()
        return self._apply_int_covs(varlog, kps_sel, pts2d)


def materialize_depths(rec, imids) -> None:
    """Materialize host copies of device-resident working depth maps for
    a set of images, one read each, with the lazy getter's math:
    exp(z_f32 + shift) in float64."""
    for imid in imids:
        im = rec.images.get(imid)
        d = getattr(im, "depth", None) if im is not None else None
        if d is None:
            continue
        handle = d.data_log_dev() if d._data is None else None
        if handle is not None:
            d._data = np.exp(handle[0].cpu().numpy().astype(np.float64) + handle[1])


def _cov_dev_or_dummy(rec, device):
    """Device point-covariance tensor for the anchor path ((1,3,3) dummy
    on `device` when no dispatch exists; all anchor slots are then -1/-2)."""
    view = getattr(rec.point_covs, "device_view", lambda: None)()
    if view is None:
        return torch.eye(3, dtype=torch.float32, device=device)[None] * 1e-2
    return view[0]


def _pow2(n: int, base: int = 1) -> int:
    """Smallest base*2^k >= n."""
    b = base
    while b < n:
        b *= 2
    return b


def _pack_anchors(pl_shift, shape, B0, Ka):
    """(B0,6,Ka) float32 anchor rows [y, x, val, logz, slot,
    meta([5,0]=z0 shift, [5,1]=prior shift, [5,2:5]=R2)] from
    [(payload (L,5), z0_shift, prior_shift, R2), ...]; padded slots get
    out-of-range y so the device scatter drops them."""
    H = shape[0]
    anch = np.zeros((B0, 6, Ka), np.float32)
    anch[:, 0, :] = float(H)
    anch[:, 4, :] = -1.0
    for b, (pl, z0_shift, prior_shift, R2) in enumerate(pl_shift):
        L = len(pl)
        if L:
            anch[b, 0, :L] = pl[:, 0]
            anch[b, 1, :L] = pl[:, 1]
            anch[b, 2, :L] = pl[:, 2]
            anch[b, 3, :L] = pl[:, 3]
            anch[b, 4, :L] = pl[:, 4]
        anch[b, 5, 0] = z0_shift
        anch[b, 5, 1] = prior_shift
        anch[b, 5, 2:5] = np.asarray(R2, np.float32)
    n = len(pl_shift)
    if B0 > n:
        anch[n:] = anch[0]
    return anch


def _query_rows(entries, device):
    """(B,2,Kmax) int32 query rows of a group's int_covs entries, padded
    with pixel (0, 0) to the longest lane."""
    Kp = max(q[3] for _, q in entries)
    rowcol = np.zeros((len(entries), 2, Kp), np.int32)
    for b, (_, (_split, gy, gx, K, _, _, _)) in enumerate(entries):
        rowcol[b, 0, :K], rowcol[b, 1, :K] = gy, gx
    return torch.as_tensor(rowcol, device=device)


def _group_anchors(entries, shape, device):
    """(B,6,Ka) anchor rows of a group's int_covs entries on `device`."""
    Ka = _pow2(max(max((len(q[0][0]) for _, q in entries), default=1), 1), 64)
    anch = _pack_anchors([q[0][:4] for _, q in entries], shape, len(entries), Ka)
    return torch.as_tensor(anch, device=device)


def integrate_bundle_deferred(pris):
    """Dispatch the whole-bundle depth refinement without a host read of
    its results: the should_refine energy gate and the gated IRLS solve
    run in one call per grid-shape group (bini_gate_solve_batch_anchors,
    K2 on the card), with the host Integrator state shipped in as (B,2)
    scalars.

    Returns (handles, pending):
      handles: {imid: (z_out_dev (B,H,W), lane)}, each image's current
        log-depth on the device (refined by this call or the gated-through
        z0), for device consumers (the BA depth rows);
      pending: finalize_integration input (device tensors + entry lists).
    """
    handles: dict = {}
    pending: list = []
    groups: dict = {}
    cov_dev = None
    if not pris:
        return handles, pending
    with TIMERS.phase("bini.build_inputs"), pris[0].rec.tri_angle_cache():
        rec0 = pris[0].rec
        if len(pris) > 1:
            # warm the angle cache with one bulk pass over the map
            thr = pris[0].conf.robust_triangles
            if thr is not None:
                rec0.find_points3D_with_small_triangulation_angle(
                    thr, rec0.point_ids()
                )
        for pri in pris:
            if cov_dev is None:
                cov_dev = _cov_dev_or_dummy(pri.rec, pri.device)
            with TIMERS.phase("bini.anchor_payload"):
                pl = pri._anchor_payload()
            with TIMERS.phase("bini.dev_rows"):
                stat8, prior_shift = pri.static_prior_dev()
                z0, z0_shift = pri._z0_shift_dev()
            R2 = pri._R2()
            key = (tuple(stat8.shape[-2:]), pri.integrator.params)
            groups.setdefault(key, []).append(
                (pri, pl, z0_shift, prior_shift, R2, (z0, stat8))
            )

    for (shape, params), entries in groups.items():
        n = len(entries)
        Ka = _pow2(max(max((len(e[1]) for e in entries), default=1), 1), 64)
        with TIMERS.phase("bini.pack_anchors"):
            anch = _pack_anchors(
                [(pl, zs, ps, R2) for _, pl, zs, ps, R2, _ in entries], shape, n, Ka
            )
        pairs = [e[5] for e in entries]
        prev = np.zeros((n, 2), np.float32)
        for k, e in enumerate(entries):
            integ = e[0].integrator
            if integ.integrated and integ.energy_old is not None:
                prev[k] = (integ.energy_old, 1.0)
        device = entries[0][0].device
        with TIMERS.phase("bini.gate_solve"):
            z_out, info4 = bini_gate_solve_batch_anchors(
                torch.as_tensor(anch, device=device), torch.as_tensor(prev, device=device),
                params, cov_dev, *pairs
            )
        for k, e in enumerate(entries):
            handles[e[0].imid] = (z_out, k)
        pending.append(([e[0] for e in entries], z_out, info4))
    return handles, pending


def finalize_integration(pending, fetched=None) -> dict:
    """Apply host-side Integrator bookkeeping from the gate/solve results.
    Only the (B,4) info rows are read; the accepted log-depth grids stay
    on the device (Depth.set_data_from_device; host copies materialize
    lazily). fetched: [info (B,4) numpy] aligned with pending (read by
    the caller), or None to read them here. Returns {imid: changed}."""
    if fetched is None:
        fetched = [info_dev.cpu().numpy() for _, _z, info_dev in pending]
    changed: dict = {}
    for (pris_g, z_dev, _info_dev), info in zip(pending, fetched):
        for k, pri in enumerate(pris_g):
            e0, e_eff, refine, aborted = (float(v) for v in info[k])
            if refine < 0.5:
                changed[pri.imid] = False
                continue
            integ = pri.integrator
            integ.energy_old = e_eff
            integ.integrated = True
            if aborted > 0.5:
                changed[pri.imid] = False
                continue
            z_lane = take_z(z_dev, k)
            pri.depth.set_data_from_device(z_lane)
            pri.seed_z0(z_lane)
            changed[pri.imid] = True
    return changed


def integrate_bundle_batched(pris) -> dict:
    """Whole-bundle depth refinement with one read of the gate/solve
    results (see integrate_bundle_deferred). Returns {imid: changed}."""
    _, pending = integrate_bundle_deferred(pris)
    with TIMERS.phase("bini.fetch_finalize"):
        return finalize_integration(pending)


def int_covs_bundle_batched(pris) -> None:
    """Whole-bundle uncertainty propagation, one call per grid-shape
    group: every image's (downscaled) integration problem and its
    keypoint queries go to diag_inverse_at_batch_anchors (K3 on the
    card) together, and the variances are applied on the host."""
    groups: dict = {}
    cov_dev = None
    for pri in pris:
        if cov_dev is None:
            cov_dev = _cov_dev_or_dummy(pri.rec, pri.device)
        q = pri._int_cov_query()
        key = (tuple(q[0][4][1].shape[-2:]), q[6])
        groups.setdefault(key, []).append((pri, q))

    for (shape, params), entries in groups.items():
        device = entries[0][0].device
        pairs = [q[0][4] for _, q in entries]
        varlog = diag_inverse_at_batch_anchors(
            _group_anchors(entries, shape, device), _query_rows(entries, device), params, 128, cov_dev, *pairs
        ).cpu().numpy()
        for b, (pri, (_, _, _, K, kps_sel, pts2d, _)) in enumerate(entries):
            pri._apply_int_covs(varlog[b, :K], kps_sel, pts2d)


def _changed_flag_dev(info4, lane):
    """1.0 where lane `lane`'s integration changed (refine and not aborted), else 0.0."""
    info = info4[lane]
    return ((info[2] > 0.5) & (info[3] < 0.5)).to(torch.float32)


def _updated_unc_dev(varlog_batch, lane, old_unc, dprior, info4, info_lane, floor):
    """The updated per-keypoint depth variances of lane `lane` (padded to
    the varlog width): max(varlog·dprior², (floor·dprior)², 1e-12) where
    lane `info_lane` of info4 changed, old_unc otherwise."""
    varlog = varlog_batch[lane]
    info = info4[info_lane]
    changed = (info[2] > 0.5) & (info[3] < 0.5)
    new = torch.maximum(varlog * dprior * dprior, (floor * dprior) ** 2).clamp_min(1e-12)
    return torch.where(changed, new, old_unc)


def int_covs_bundle_deferred(pris, handles, info_map):
    """Dispatch the whole-bundle diag(H⁻¹) propagation chained off the
    fresh gate/solve output, with no host read: each image's downscaled
    z0 is resized on the device from its integrate_bundle_deferred
    handle, the solve is gated on the lanes' changed flags
    (diag_inverse_gated_batch_anchors), and the updated per-keypoint
    variances come out as device rows gated per lane (the BA depth rows
    take them). The host bookkeeping (_apply_int_covs) runs later from
    the read that returns the BA result.

    Returns (unc_by_imid {imid: (Kp,) device uncertainty_update indexed
    by keypoint id}, pending_covs [(pri, varlog_dev, lane, K, kps_sel,
    pts2d, info_dev, info_lane)])."""
    groups: dict = {}
    cov_dev = None
    with pris[0].rec.tri_angle_cache():
        for pri in pris:
            if cov_dev is None:
                cov_dev = _cov_dev_or_dummy(pri.rec, pri.device)
            z_b, lane = handles[pri.imid]
            q = pri._int_cov_query(z_override=(take_z(z_b, lane), 0.0))
            key = (tuple(q[0][4][1].shape[-2:]), q[6])
            groups.setdefault(key, []).append((pri, q))

    unc_by_imid: dict = {}
    pending_covs: list = []
    for (shape, params), entries in groups.items():
        device = entries[0][0].device
        rowcol = _query_rows(entries, device)
        Kp = rowcol.shape[-1]
        pairs = [q[0][4] for _, q in entries]
        flags = torch.stack(
            [_changed_flag_dev(info_map[pri.imid][0], info_map[pri.imid][1]) for pri, _ in entries]
        )
        varlog_dev = diag_inverse_gated_batch_anchors(
            _group_anchors(entries, shape, device), rowcol, params, 128, cov_dev, flags, *pairs
        )
        for b, (pri, (_, _, _, K, kps_sel, pts2d, _)) in enumerate(entries):
            info_dev, info_lane = info_map[pri.imid]
            old = np.ones(Kp, np.float32)
            old[:K] = np.asarray(pri.depth.uncertainty_update)[pts2d]
            dprior = np.ones(Kp, np.float32)
            dprior[:K] = pri.depth.data_prior_at_kps(kps_sel)
            floor = _f32(pri.conf.int_cov_rel_floor or 0.0)
            unc_by_imid[pri.imid] = _updated_unc_dev(
                varlog_dev, b, torch.as_tensor(old, device=device), torch.as_tensor(dprior, device=device),
                info_dev, info_lane, floor,
            )
            pending_covs.append(
                (pri, varlog_dev, b, K, kps_sel, pts2d, info_dev, info_lane)
            )
    return unc_by_imid, pending_covs


def finalize_deferred_all(pending, pending_covs):
    """Finalize a deferred integrate (+ chained int_covs) outside the
    fused BA read: the bail-out path. Returns the changed map."""
    changed_map = finalize_integration(pending) if pending else {}
    if pending_covs:
        finalize_int_covs(pending_covs, read_varlogs(pending_covs), changed_map)
    return changed_map


def read_varlogs(pending_covs):
    """The varlog tensor of each pending_covs entry read to the host, once
    per tensor (the entries of a group share one)."""
    read = {}
    for entry in pending_covs:
        if id(entry[1]) not in read:
            read[id(entry[1])] = entry[1].cpu().numpy()
    return [read[id(e[1])] for e in pending_covs]


def finalize_int_covs(pending_covs, fetched_varlogs, changed_map):
    """Host bookkeeping for the deferred int_covs chain: apply the read
    diag(H⁻¹) rows to uncertainty_update for images whose integration
    changed."""
    for (pri, _vd, b, K, kps_sel, pts2d, _i, _l), varlog in zip(
        pending_covs, fetched_varlogs
    ):
        if changed_map.get(pri.imid):
            pri._apply_int_covs(np.asarray(varlog[b, :K], np.float64), kps_sel, pts2d)
