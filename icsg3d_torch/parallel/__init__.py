"""Data parallelism across processes and depth sharding over a (data,
spatial) device mesh (the counterpart of icsg3d_tpu/parallel's
distributed, mesh and halo modules)."""

from icsg3d_torch.parallel.distributed import (
    all_reduce_sum,
    initialize,
    mean_over_ranks,
    process_count,
    process_index,
    process_shard,
    reduce_gradients,
    sync_hosts,
)
from icsg3d_torch.parallel.halo import conv_sharded, halo_exchange, mesh_divides
from icsg3d_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    make_mesh,
    shard_batch,
)

__all__ = ["DATA_AXIS", "SPATIAL_AXIS", "Mesh", "all_reduce_sum", "conv_sharded",
           "halo_exchange", "initialize", "make_mesh", "mean_over_ranks",
           "mesh_divides", "process_count", "process_index", "process_shard",
           "reduce_gradients", "shard_batch", "sync_hosts"]
