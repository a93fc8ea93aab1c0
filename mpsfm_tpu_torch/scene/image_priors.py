"""Device functions of the uncertainty chain (port of two functions of
mpsfm_tpu/scene/image_priors.py; the rest of that module, the per-image
prior state, waits for the scene-state slice).

They turn the diag(H⁻¹) variances of log-depth at a lane's keypoints into
the keypoints' depth variances, which become the BA depth rows' sigma2,
where that lane's integration changed this iteration (refine and not
aborted, from the gate + solve's info4 rows [e0, e, refine, aborted]).
"""

from __future__ import annotations

import torch


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
