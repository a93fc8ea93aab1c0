"""Robust estimators (port of mpsfm_tpu/estimators)."""

from mpsfm_tpu_torch.estimators.essential import (
    essential_from_eight_points,
    decompose_essential,
    sampson_error_sq,
)
from mpsfm_tpu_torch.estimators.ransac import ransac_essential, ransac_pnp, ransac_homography, sample_indices
from mpsfm_tpu_torch.estimators.two_view import TwoViewConfig, estimate_two_view_geometry

__all__ = [
    "essential_from_eight_points",
    "decompose_essential",
    "sampson_error_sq",
    "ransac_essential",
    "ransac_pnp",
    "ransac_homography",
    "sample_indices",
    "TwoViewConfig",
    "estimate_two_view_geometry",
]
