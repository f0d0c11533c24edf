"""Depth sharding over a (data, spatial) device mesh, driven by one process
(the counterpart of icsg3d_tpu/parallel's mesh and halo modules)."""

from icsg3d_torch.parallel.halo import conv_sharded, halo_exchange, mesh_divides
from icsg3d_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, make_mesh

__all__ = ["DATA_AXIS", "SPATIAL_AXIS", "Mesh", "conv_sharded", "halo_exchange",
           "make_mesh", "mesh_divides"]
