"""icsg3d-torch: the PyTorch + CUDA port of icsg3d_tpu for NVIDIA Hopper.

The JAX package (icsg3d_tpu) is the reference; every module here mirrors
the path of its counterpart there.  This package imports torch and numpy,
never JAX, so it runs on a machine that has no JAX installed.  Public
functions keep the JAX package's channels-last (NDHWC) layout.
"""

from icsg3d_torch import config
