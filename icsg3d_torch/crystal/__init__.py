"""Crystal-structure stack: verbatim copies of icsg3d_tpu/crystal modules
(elements, lattice, structure, cif, neighbors), which are numpy-only."""

from icsg3d_torch.crystal.neighbors import neighbor_list

__all__ = ["neighbor_list"]
