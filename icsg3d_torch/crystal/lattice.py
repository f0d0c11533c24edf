# Verbatim copy of icsg3d_tpu/crystal/lattice.py.
"""Lattice math: parameters <-> cell matrix, fractional <-> cartesian.

Replaces pymatgen's Lattice for the subset the pipeline needs
(reference uses mg.Lattice.from_parameters at utils.py:231-238 and
crystal.lattice.abc/alpha/beta/gamma at create_matrices.py:128-137).
"""

from __future__ import annotations

import numpy as np


class Lattice:
    """A 3D crystal lattice defined by a 3x3 row-vector matrix."""

    def __init__(self, matrix):
        self.matrix = np.asarray(matrix, dtype=float).reshape(3, 3)

    @classmethod
    def from_parameters(cls, a, b, c, alpha=90.0, beta=90.0, gamma=90.0) -> "Lattice":
        """Standard crystallographic construction: a along x, b in the xy
        plane, c completing the cell."""
        alpha_r, beta_r, gamma_r = np.radians([alpha, beta, gamma])
        ca, cb, cg = np.cos([alpha_r, beta_r, gamma_r])
        sg = np.sin(gamma_r)
        cx = c * cb
        cy = c * (ca - cb * cg) / sg
        cz_sq = c * c - cx * cx - cy * cy
        cz = np.sqrt(max(cz_sq, 0.0))
        matrix = np.array([
            [a, 0.0, 0.0],
            [b * cg, b * sg, 0.0],
            [cx, cy, cz],
        ])
        matrix[np.abs(matrix) < 1e-12] = 0.0
        return cls(matrix)

    @property
    def a(self) -> float:
        return float(np.linalg.norm(self.matrix[0]))

    @property
    def b(self) -> float:
        return float(np.linalg.norm(self.matrix[1]))

    @property
    def c(self) -> float:
        return float(np.linalg.norm(self.matrix[2]))

    @property
    def abc(self):
        return (self.a, self.b, self.c)

    def _angle(self, i: int, j: int) -> float:
        vi, vj = self.matrix[i], self.matrix[j]
        cosang = np.dot(vi, vj) / (np.linalg.norm(vi) * np.linalg.norm(vj))
        return float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))

    @property
    def alpha(self) -> float:
        return self._angle(1, 2)

    @property
    def beta(self) -> float:
        return self._angle(0, 2)

    @property
    def gamma(self) -> float:
        return self._angle(0, 1)

    @property
    def parameters(self):
        return (self.a, self.b, self.c, self.alpha, self.beta, self.gamma)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.matrix)))

    def plane_spacings(self) -> np.ndarray:
        """Perpendicular distance between lattice planes along each axis:
        1 / |column_i of inv(M)| (the reciprocal-vector norms) — equal to
        volume / face_area_i.  The quantity every periodic-image scan
        sizes its shift range with; one owner so the two formulas cannot
        drift."""
        inv = np.linalg.inv(self.matrix)
        return 1.0 / np.linalg.norm(inv, axis=0)

    def cartesian(self, frac_coords) -> np.ndarray:
        return np.asarray(frac_coords, dtype=float) @ self.matrix

    def fractional(self, cart_coords) -> np.ndarray:
        return np.asarray(cart_coords, dtype=float) @ np.linalg.inv(self.matrix)

    def __repr__(self):
        p = self.parameters
        return (f"Lattice(a={p[0]:.4f}, b={p[1]:.4f}, c={p[2]:.4f}, "
                f"alpha={p[3]:.2f}, beta={p[4]:.2f}, gamma={p[5]:.2f})")
