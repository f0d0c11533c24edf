"""Host data helpers: packed GridDataset store and batch iterator,
train/validation splits, condition binning, class weights, synthetic
structures, and the chunked voxelize + rotate dataset build."""

from icsg3d_torch.data.class_weights import inverse_frequency_weights
from icsg3d_torch.data.store import BatchIterator, GridDataset
from icsg3d_torch.data.voxel_build import default_chunk, voxelize_structures
