"""Configuration dataclasses of the port.

Same fields and defaults as the counterparts in icsg3d_tpu/config.py
(tests/test_torch_guards.py holds them equal); ``voxel_sizes`` uses numpy.
The ``layout`` fields are kept so every JAX flag form parses, but the port
has one activation layout (NDHWC) and ignores them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Geometry of the voxel grids.

    The cell of a structure with lattice lengths (a, b, c) is padded by
    ``eps_frac`` of each length on both sides, then divided into ``d`` voxels
    per axis (reference: utils.py:98-115 for the density grid,
    utils.py:88-94 for the coordinate grid).
    """

    d: int = 32                 # voxels per axis
    eps_frac: float = 0.25      # fractional cell padding per side
    density_channels: int = 1   # electron-density channel count
    coord_channels: int = 3     # absolute-coordinate channels

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.d, self.d, self.d)

    @property
    def channels(self) -> int:
        return self.density_channels + self.coord_channels

    @property
    def input_shape(self) -> Tuple[int, int, int, int]:
        return (self.d, self.d, self.d, self.channels)

    @property
    def num_voxels(self) -> int:
        return self.d ** 3

    def voxel_sizes(self, abc):
        """Per-axis voxel edge lengths dv for lattice lengths abc."""
        abc = np.asarray(abc)
        return abc * (1.0 + 2.0 * self.eps_frac) / self.d


@dataclasses.dataclass(frozen=True)
class VoxelizerConfig:
    """Voxelization of structures into density/species grids.

    Reference: create_matrices.py:41-81 CLI defaults.
    """

    grid: GridSpec = GridSpec()
    sigma_frac: float = 1.0     # Gaussian width as fraction of ionic radius
    label_frac: float = 1.0     # labeling radius as fraction of ionic radius
    max_sites: int = 40         # skip structures with more sites
    site_pad: int = 64          # padded site-array length (device shapes)
    n_rot: int = 10             # 90-degree rotation augmentations per sample


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """3D U-Net species segmenter (reference: unet/unet.py:272-355)."""

    num_classes: int = 95
    in_channels: int = 4
    enc_filters: Tuple[Tuple[int, int], ...] = ((32, 64), (64, 128), (128, 256))
    bottom_filters: Tuple[int, int] = (512, 512)
    dec_filters: Tuple[Tuple[int, int], ...] = ((512, 256), (256, 128), (128, 128))
    bn_momentum: float = 0.99   # Keras BatchNormalization default
    bn_epsilon: float = 1e-3    # Keras BatchNormalization default
    dtype: str = "bfloat16"     # compute dtype; params stay float32
    layout: str = "ndhwc"       # accepted, ignored (one layout here)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Conditional DFC-VAE (reference: vae/lattice_vae.py:89-230).

    ``cond_repeat`` = 4 reproduces the reference's Keras tile quirk
    (44-channel encoder input); the default 1 gives width 14.  See the
    docstring of icsg3d_tpu.config.VAEConfig for the derivation.
    """

    grid: GridSpec = GridSpec()
    filters: Tuple[int, ...] = (16, 32, 64, 128)
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    latent_dim: int = 256
    cond_bins: int = 10
    cond_repeat: int = 1
    alpha: float = 0.5          # perceptual-loss weight (vae/lattice_vae.py:97)
    beta: float = 3e-4          # KLD weight (vae/lattice_vae.py:96)
    kld_floor: float = 0.0
    leaky_slope: float = 0.3    # Keras LeakyReLU default alpha
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3
    perceptual_taps: Tuple[int, ...] = (3, 5, 7, 9)
    perceptual_tap_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    dtype: str = "bfloat16"
    layout: str = "ndhwc"       # accepted, ignored (one layout here)

    def __post_init__(self):
        # The encoder halves the grid once per filter block, so the grid must
        # survive len(filters) poolings; the decoder needs the seed grid
        # d / 2^(len-1) to upsample back exactly.
        n = len(self.filters)
        if self.grid.d < 2 ** n or self.grid.d % 2 ** (n - 1) != 0:
            raise ValueError(
                f"grid d={self.grid.d} is incompatible with {n} filter "
                f"blocks (needs d >= {2 ** n} and d divisible by "
                f"{2 ** (n - 1)}); use fewer/more filter blocks, e.g. "
                f"filters={(16, 32, 64)!r} for d=8"
            )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization + checkpointing knobs shared by the training drivers.

    Reference defaults: U-Net bs=10 lr=3e-6 (train_unet.py:53-61), VAE bs=20
    lr=5e-4 250 epochs (train_vae.py:46-52, vae/lattice_vae.py:98), CGCNN
    bs=32 lr=1e-3 60 epochs (train_cgcnn.py:38,89,102).
    """

    batch_size: int = 20
    learning_rate: float = 5e-4
    epochs: int = 50
    split_frac: float = 0.8
    split_seed: int = 28        # utils.py:36 default seed
    n_rot: int = 10
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    keep_best_only: bool = True
    log_every_steps: int = 50


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the data-parallel and depth-sharded training.

    ``data`` shards the batch (DP); ``spatial`` shards the depth axis of the
    voxel grids with halo exchange.  In the port the data axis is the
    processes of a torch.distributed group (parallel/distributed.py) times
    the data axis of each process's own mesh (parallel/mesh.py).
    """

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    data_parallel: int = -1     # -1: all devices
    spatial_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline (generation/eval) knobs.

    Reference: generate.py:50-103, eval.py:57-105.
    """

    grid: GridSpec = GridSpec()
    cond_bins: int = 10
    target: str = "formation_energy_per_atom"
    sample_var: float = 0.5
    binary_threshold: float = 0.8   # occupancy threshold (generate.py:224)
    watershed_max_iters: int = 5
    watershed_wmin: int = 8
    watershed_min_convexity: float = 0.8
    cell_angles: Tuple[float, float, float] = (90.0, 90.0, 90.0)


@dataclasses.dataclass(frozen=True)
class CGCNNConfig:
    """Crystal-graph convnet property regressor (reference: cgcnn/cgcnn.py:145-160).

    Fixed device shapes: graphs padded to ``max_atoms`` nodes with
    ``max_neighbors`` edges each; bond distances expanded on a Gaussian basis
    of ``num_bond_features`` centers in [dmin, radius] with spacing ``step``
    (reference: cgcnn/data.py:75-112,149-155).
    """

    atom_input_dim: int = 93
    atom_fea_len: int = 64
    max_atoms: int = 50
    max_neighbors: int = 12
    radius: float = 8.0
    dmin: float = 0.0
    step: float = 0.2
    n_conv: int = 1
    hidden_dim: int = 128
    bn_epsilon: float = 1e-5
    dtype: str = "float32"

    @property
    def num_bond_features(self) -> int:
        return self.graph_spec().num_bond_features

    def graph_spec(self):
        """The featurizer's GraphSpec of these shapes (data/graphs.py owns
        the basis width)."""
        from icsg3d_torch.data.graphs import GraphSpec

        return GraphSpec(
            max_atoms=self.max_atoms, max_neighbors=self.max_neighbors,
            radius=self.radius, dmin=self.dmin, step=self.step,
        )
