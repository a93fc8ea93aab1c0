"""Closed-form prior shift/scale alignment + robust truncation statistics.

Ports the reference's __build_shiftscale_problem (median log-ratio
estimator with scale/metric-scale filters,
mpsfm/sfm/mapper/bundle_adjustment.py:187-242) and
update_truncation_multiplier (MAD fit of whitened log-depth residuals,
:295-333). Pure host numpy — these are tiny reductions. A copy of
mpsfm_tpu/ba/shift_scale.py.
"""

from __future__ import annotations

import numpy as np

from mpsfm_tpu_torch.scene.reconstruction import Reconstruction


def fit_robust_gaussian_mad(data):
    mu = np.median(data)
    mad = np.median(np.abs(data - mu))
    return mu, 1.4826 * mad


def _image_depth_obs(rec: Reconstruction, imid, use_prior=True):
    """Per-image (kp_ids, kps, prior depths, valid, projected z)."""
    im = rec.images[imid]
    depth = getattr(im, "depth", None)
    if depth is None:
        return None
    kp_ids = im.observed_kp_ids()
    if len(kp_ids) == 0:
        return None
    kps = im.keypoints[kp_ids]
    obsd = depth.data_prior_at_kps(kps) if use_prior else depth.data_at_kps(kps)
    valid = depth.valid_at_kps(kps)
    pids = im.point3D_ids[kp_ids]
    _, z = rec.project_points_into_image(imid, pids)
    return kp_ids, kps, obsd, valid, z, pids


def optimize_prior_shiftscale(
    rec: Reconstruction,
    bundle: dict,
    allow_scale_filter: bool = False,
    allow_metric_scale_filter: bool = False,
    scale_filter: bool = True,
    scale_filter_factor: float = 1.5,
    metric_scale_filter: bool = True,
    single_rescale: bool = True,
    verbose: int = 0,
):
    """Returns ({imid: (shift, scale)}, success). Scale is multiplicative.

    shift is always 0 (the reference fixes shift, bundle_adjustment.py:173).
    """
    shift_scale = {}
    ref_id = bundle.get("ref_id")
    for imid in sorted(bundle["optim_ids"]):
        out = _image_depth_obs(rec, imid)
        if out is None:
            continue
        _, _, obsd, valid, z, _ = out
        if (scale_filter_factor or metric_scale_filter) and (
            ref_id is not None and imid != ref_id and single_rescale
        ):
            continue
        if allow_metric_scale_filter and metric_scale_filter and (imid == ref_id or not single_rescale):
            # Reject observations whose implied metric scale disagrees with
            # the map's mean depth scale by >1.5x (reference :204-228).
            scale = z / np.clip(obsd, 1e-6, None)
            im_scale = rec.images[imid].depth.scale
            proposed = scale * im_scale
            others = [
                rec.images[i].depth.scale
                for i in bundle["optim_ids"]
                if i != imid and getattr(rec.images[i], "depth", None) is not None
            ]
            if others:
                map_scale = float(np.mean(others))
                div = map_scale / np.clip(proposed, 1e-12, None)
                ok = (div < 1.5) & (div > 1 / 1.5)
                valid = valid & ok
                if valid.sum() == 0:
                    if verbose:
                        print("WARNING: all points outliers for metric scale optim; using map scale")
                    shift_scale[imid] = (0.0, map_scale / im_scale)
                    return shift_scale, True
        if allow_scale_filter and scale_filter and not allow_metric_scale_filter:
            div = obsd / np.clip(z, 1e-6, None)
            valid = valid & (div < scale_filter_factor) & (div > 1 / scale_filter_factor)
        zv = z[valid]
        dv = obsd[valid]
        if len(zv) == 0:
            continue
        log_ratio = np.log(np.clip(zv / np.clip(dv, 1e-6, None), 1e-6, None))
        shift_scale[imid] = (0.0, float(np.exp(np.median(log_ratio))))
    return shift_scale, True


def update_truncation_multiplier(rec: Reconstruction, imids, min_truncation_mult=None):
    """MAD sigma of whitened log-depth residuals over registered images
    (reference bundle_adjustment.py:295-333)."""
    D, D3, stds = [], [], []
    for imid in imids:
        im = rec.images[imid]
        depth = getattr(im, "depth", None)
        if depth is None or not depth.activated or depth.data is None:
            continue
        kp_ids = im.observed_kp_ids()
        if len(kp_ids) == 0:
            continue
        kps = im.keypoints[kp_ids]
        valid = depth.valid_at_kps(kps)
        kp_ids, kps = kp_ids[valid], kps[valid]
        if len(kp_ids) == 0:
            continue
        depths = depth.data_at_kps(kps)
        mask = depths > 0
        pids = im.point3D_ids[kp_ids][mask]
        if len(pids) == 0:
            continue
        _, z = rec.project_points_into_image(imid, pids)
        variances = np.array([depth.uncertainty_update[kp] for kp in kp_ids[mask]])
        D.append(depths[mask])
        D3.append(z)
        stds.append(np.sqrt(variances))
    if not D:
        return 1.0
    depths = np.concatenate(D)
    z = np.concatenate(D3)
    stds = np.concatenate(stds)
    log_stds = np.clip(stds / depths, 1e-6, None)
    whitened = (np.log(depths) - np.log(np.clip(z, 1e-8, None))) / log_stds
    _, sigma = fit_robust_gaussian_mad(whitened)
    if min_truncation_mult is not None:
        sigma = max(sigma, min_truncation_mult)
    return float(sigma)
