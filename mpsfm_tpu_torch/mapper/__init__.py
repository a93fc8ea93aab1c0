"""The mapper (port of mpsfm_tpu/mapper): the incremental mapping
controller and its parts (registration, triangulation, next-view
selection, the depth-consistency check and the Optimizer)."""

from mpsfm_tpu_torch.mapper.mapper import MpsfmMapper

__all__ = ["MpsfmMapper"]
