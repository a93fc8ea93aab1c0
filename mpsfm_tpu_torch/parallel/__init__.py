"""Multi-device execution over torch.distributed (port of mpsfm_tpu/parallel/):
the point-sharded bundle adjustment, process-group setup and sharded
batched inference."""

from mpsfm_tpu_torch.parallel.dist_ba import (
    make_group,
    partition_ba_data,
    solve_ba_block_sharded,
    unpartition_points,
)

__all__ = [
    "make_group",
    "partition_ba_data",
    "solve_ba_block_sharded",
    "unpartition_points",
]
