"""Scene state (port of mpsfm_tpu/scene): the reconstruction with its
native track store, the correspondence graph, geometric verification, the
per-image depth and normal priors, and ImagePriors with the
bundle-level functions of the integration and the uncertainty chain
(scene/image_priors.py)."""

from mpsfm_tpu_torch.scene.correspondences import Correspondences
from mpsfm_tpu_torch.scene.corrgraph import CorrespondenceGraph
from mpsfm_tpu_torch.scene.image_priors import ImagePriors
from mpsfm_tpu_torch.scene.priors import Depth, Normals
from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Reconstruction

__all__ = ["HostCamera", "ImageRecord", "Reconstruction", "CorrespondenceGraph", "Correspondences", "Depth",
           "Normals", "ImagePriors"]
