"""Device ops of the port: the 3x3x3 conv (and its differentiable form),
the voxelizer, rotations, losses, metrics, grid transforms, binary atom
extraction, and the host watershed (a verbatim copy)."""

from icsg3d_torch.ops.rotations import AXES_CHOICES, rotate90
from icsg3d_torch.ops.voxelize import voxelize_batch
