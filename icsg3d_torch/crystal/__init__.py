"""Crystal-structure stack: verbatim copies of icsg3d_tpu/crystal modules
(elements, lattice, structure, cif), which are numpy-only."""
