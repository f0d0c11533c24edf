# Verbatim copy of icsg3d_tpu/crystal/elements.py.
"""Element property tables for Z = 1..100.

Replaces the reference's use of pymatgen element data (utils.py:64-85 reads
per-element mean ionic radii; cgcnn/atom_init.json encodes binned element
properties).  Values are standard literature numbers: Pauling
electronegativity, Cordero covalent radii (pm), NIST first ionization
energies (eV), electron affinities (eV), molar volumes (cm^3/mol), and mean
Shannon ionic radii (Angstrom, averaged over common oxidation states).
Missing entries are None; consumers apply the same fallbacks the reference
did (mean ionic radius NaN -> 1.20 A, utils.py:74).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MAX_Z = 100

# fmt: off
# symbol, electronegativity, covalent_radius_pm, first_ionization_eV,
# electron_affinity_eV, molar_volume_cm3, mean_ionic_radius_A
_ROWS = [
    ("H",  2.20,  31, 13.598,  0.754, 11.42, 0.38),
    ("He", None,  28, 24.587, -0.52,  21.0,  None),
    ("Li", 0.98, 128,  5.392,  0.618, 13.02, 0.90),
    ("Be", 1.57,  96,  9.323, -0.52,   4.85, 0.41),
    ("B",  2.04,  84,  8.298,  0.280,  4.39, 0.25),
    ("C",  2.55,  76, 11.260,  1.262,  5.29, 0.30),
    ("N",  3.04,  71, 14.534, -0.07,  13.54, 0.80),
    ("O",  3.44,  66, 13.618,  1.461, 17.36, 1.26),
    ("F",  3.98,  57, 17.423,  3.401, 11.20, 1.19),
    ("Ne", None,  58, 21.565, -1.2,   13.23, None),
    ("Na", 0.93, 166,  5.139,  0.548, 23.78, 1.16),
    ("Mg", 1.31, 141,  7.646, -0.40,  14.00, 0.86),
    ("Al", 1.61, 121,  5.986,  0.433, 10.00, 0.62),
    ("Si", 1.90, 111,  8.152,  1.390, 12.06, 0.47),
    ("P",  2.19, 107, 10.487,  0.746, 17.02, 0.84),
    ("S",  2.58, 105, 10.360,  2.077, 15.49, 1.03),
    ("Cl", 3.16, 102, 12.968,  3.613, 17.39, 1.15),
    ("Ar", None, 106, 15.760, -1.0,   22.56, None),
    ("K",  0.82, 203,  4.341,  0.501, 45.94, 1.52),
    ("Ca", 1.00, 176,  6.113,  0.025, 26.20, 1.14),
    ("Sc", 1.36, 170,  6.561,  0.188, 15.00, 0.87),
    ("Ti", 1.54, 160,  6.828,  0.079, 10.64, 0.77),
    ("V",  1.63, 153,  6.746,  0.525,  8.32, 0.72),
    ("Cr", 1.66, 139,  6.767,  0.666,  7.23, 0.66),
    ("Mn", 1.55, 139,  7.434, -0.50,   7.35, 0.69),
    ("Fe", 1.83, 132,  7.902,  0.151,  7.09, 0.68),
    ("Co", 1.88, 126,  7.881,  0.662,  6.67, 0.68),
    ("Ni", 1.91, 124,  7.640,  1.156,  6.59, 0.66),
    ("Cu", 1.90, 132,  7.726,  1.235,  7.11, 0.70),
    ("Zn", 1.65, 122,  9.394, -0.60,   9.16, 0.82),
    ("Ga", 1.81, 122,  5.999,  0.43,  11.80, 0.62),
    ("Ge", 2.01, 120,  7.899,  1.233, 13.63, 0.58),
    ("As", 2.18, 119,  9.789,  0.804, 12.95, 0.53),
    ("Se", 2.55, 120,  9.752,  2.021, 16.42, 1.05),
    ("Br", 2.96, 120, 11.814,  3.364, 19.78, 1.28),
    ("Kr", 3.00, 116, 14.000, -1.0,   27.99, None),
    ("Rb", 0.82, 220,  4.177,  0.486, 55.76, 1.66),
    ("Sr", 0.95, 195,  5.695,  0.048, 33.94, 1.32),
    ("Y",  1.22, 190,  6.217,  0.307, 19.88, 1.04),
    ("Zr", 1.33, 175,  6.634,  0.426, 14.02, 0.86),
    ("Nb", 1.60, 164,  6.759,  0.893, 10.83, 0.78),
    ("Mo", 2.16, 154,  7.092,  0.748,  9.38, 0.73),
    ("Tc", 1.90, 147,  7.28,   0.55,   8.63, 0.70),
    ("Ru", 2.20, 146,  7.360,  1.05,   8.17, 0.70),
    ("Rh", 2.28, 142,  7.459,  1.137,  8.28, 0.72),
    ("Pd", 2.20, 139,  8.337,  0.562,  8.56, 0.84),
    ("Ag", 1.93, 145,  7.576,  1.302, 10.27, 1.09),
    ("Cd", 1.69, 144,  8.994, -0.70,  13.00, 1.05),
    ("In", 1.78, 142,  5.786,  0.30,  15.76, 0.88),
    ("Sn", 1.96, 139,  7.344,  1.112, 16.29, 0.88),
    ("Sb", 2.05, 139,  8.608,  1.046, 18.19, 0.85),
    ("Te", 2.10, 138,  9.010,  1.971, 20.46, 1.23),
    ("I",  2.66, 139, 10.451,  3.059, 25.72, 1.44),
    ("Xe", 2.60, 140, 12.130, -0.8,   35.92, 0.55),
    ("Cs", 0.79, 244,  3.894,  0.472, 70.94, 1.81),
    ("Ba", 0.89, 215,  5.212,  0.145, 38.16, 1.49),
    ("La", 1.10, 207,  5.577,  0.47,  22.39, 1.17),
    ("Ce", 1.12, 204,  5.539,  0.5,   20.69, 1.07),
    ("Pr", 1.13, 203,  5.473,  0.5,   20.80, 1.06),
    ("Nd", 1.14, 201,  5.525,  0.5,   20.59, 1.11),
    ("Pm", 1.13, 199,  5.582,  0.5,   20.23, 1.09),
    ("Sm", 1.17, 198,  5.644,  0.5,   19.98, 1.12),
    ("Eu", 1.20, 198,  5.670,  0.5,   28.97, 1.20),
    ("Gd", 1.20, 196,  6.150,  0.5,   19.90, 1.05),
    ("Tb", 1.10, 194,  5.864,  0.5,   19.30, 1.00),
    ("Dy", 1.22, 192,  5.939,  0.5,   19.01, 1.05),
    ("Ho", 1.23, 192,  6.022,  0.5,   18.74, 1.04),
    ("Er", 1.24, 189,  6.108,  0.5,   18.46, 1.03),
    ("Tm", 1.25, 190,  6.184,  1.029, 19.10, 1.02),
    ("Yb", 1.10, 187,  6.254, -0.02,  24.84, 1.04),
    ("Lu", 1.27, 187,  5.426,  0.34,  17.78, 1.00),
    ("Hf", 1.30, 175,  6.825,  0.014, 13.44, 0.85),
    ("Ta", 1.50, 170,  7.550,  0.322, 10.85, 0.78),
    ("W",  2.36, 162,  7.864,  0.815,  9.47, 0.74),
    ("Re", 1.90, 151,  7.834,  0.15,   8.86, 0.69),
    ("Os", 2.20, 144,  8.438,  1.10,   8.42, 0.66),
    ("Ir", 2.20, 141,  8.967,  1.564,  8.52, 0.68),
    ("Pt", 2.28, 136,  8.959,  2.128,  9.09, 0.80),
    ("Au", 2.54, 136,  9.226,  2.309, 10.21, 1.07),
    ("Hg", 2.00, 132, 10.437, -0.50,  14.09, 1.10),
    ("Tl", 1.62, 145,  6.108,  0.377, 17.22, 1.31),
    ("Pb", 2.33, 146,  7.417,  0.356, 18.26, 1.09),
    ("Bi", 2.02, 148,  7.286,  0.942, 21.31, 1.03),
    ("Po", 2.00, 140,  8.414,  1.90,  22.97, 0.94),
    ("At", 2.20, 150,  9.318,  2.80,  30.0,  0.62),
    ("Rn", None, 150, 10.748, -0.7,   50.5,  None),
    ("Fr", 0.70, 260,  4.073,  0.486, 71.0,  1.80),
    ("Ra", 0.90, 221,  5.278,  0.10,  41.09, 1.62),
    ("Ac", 1.10, 215,  5.17,   0.35,  22.55, 1.26),
    ("Th", 1.30, 206,  6.307,  0.60,  19.80, 1.08),
    ("Pa", 1.50, 200,  5.89,   0.55,  15.18, 0.96),
    ("U",  1.38, 196,  6.194,  0.53,  12.49, 0.92),
    ("Np", 1.36, 190,  6.266,  0.48,  11.59, 0.93),
    ("Pu", 1.28, 187,  6.026, -0.50,  12.29, 0.95),
    ("Am", 1.30, 180,  5.974,  0.10,  17.63, 1.08),
    ("Cm", 1.30, 169,  5.991,  0.28,  18.05, 1.02),
    ("Bk", 1.30, 168,  6.198, -0.50,  16.84, 1.01),
    ("Cf", 1.30, 168,  6.282, -0.50,  16.50, 1.00),
    ("Es", 1.30, 165,  6.42,  -0.50,  28.52, 0.99),
    ("Fm", 1.30, 167,  6.50,  -0.50,  30.0,  0.98),
]
# fmt: on

SYMBOLS = [row[0] for row in _ROWS]
SYMBOL_TO_Z: Dict[str, int] = {s: i + 1 for i, s in enumerate(SYMBOLS)}
Z_TO_SYMBOL: Dict[int, str] = {i + 1: s for i, s in enumerate(SYMBOLS)}

IONIC_RADIUS_FALLBACK = 1.20  # utils.py:74: NaN mean ionic radius -> 1.20


def _column(idx: int) -> np.ndarray:
    """Property column as a float array indexed by Z (index 0 unused = NaN)."""
    out = np.full(MAX_Z + 1, np.nan)
    for z, row in enumerate(_ROWS, start=1):
        v = row[idx]
        if v is not None:
            out[z] = float(v)
    return out


ELECTRONEGATIVITY = _column(1)
COVALENT_RADIUS_PM = _column(2)
FIRST_IONIZATION_EV = _column(3)
ELECTRON_AFFINITY_EV = _column(4)
MOLAR_VOLUME_CM3 = _column(5)
_MEAN_IONIC_RADIUS = _column(6)

# Mean ionic radius with the reference's fallback already applied.
MEAN_IONIC_RADIUS_A = np.where(
    np.isnan(_MEAN_IONIC_RADIUS), IONIC_RADIUS_FALLBACK, _MEAN_IONIC_RADIUS
)
MEAN_IONIC_RADIUS_A[0] = IONIC_RADIUS_FALLBACK


def symbol_to_z(symbol: str) -> int:
    """Atomic number for an element symbol (oxidation suffixes stripped)."""
    s = symbol.strip().rstrip("0123456789+-.")
    return SYMBOL_TO_Z[s]


def z_to_symbol(z: int) -> str:
    return Z_TO_SYMBOL[int(z)]


def mean_ionic_radius(z: int) -> float:
    """Mean ionic radius in Angstrom with the 1.20 fallback (utils.py:74)."""
    if 1 <= z <= MAX_Z:
        return float(MEAN_IONIC_RADIUS_A[z])
    return IONIC_RADIUS_FALLBACK


def period(z: int) -> int:
    for p, hi in enumerate((2, 10, 18, 36, 54, 86, 118), start=1):
        if z <= hi:
            return p
    raise ValueError(f"Z={z} out of range")


def group(z: int) -> int:
    """IUPAC group 1-18; f-block elements report group 3."""
    if z in (1,):
        return 1
    if z == 2:
        return 18
    p = period(z)
    if p == 2 or p == 3:
        offset = z - (2 if p == 2 else 10)
        return offset if offset <= 2 else offset + 10
    if p == 4 or p == 5:
        return z - (18 if p == 4 else 36)
    if p == 6:
        if z < 57:
            return z - 54
        if z <= 71:
            return 3
        return z - 68
    if p == 7:
        if z < 89:
            return z - 86
        if z <= 103:
            return 3
        return z - 100
    raise ValueError(f"Z={z} out of range")


def block(z: int) -> str:
    if z in (1, 2):
        return "s"
    if 57 <= z <= 71 or 89 <= z <= 103:
        return "f"
    g = group(z)
    if g <= 2:
        return "s"
    if g >= 13:
        return "p"
    return "d"


def valence_electrons(z: int) -> int:
    """Nominal valence electron count, clipped to [1, 12]."""
    b = block(z)
    if b == "s":
        return group(z) if z != 2 else 2
    if b == "p":
        return group(z) - 10
    if b == "d":
        return group(z)
    # f-block: electrons beyond the preceding noble-gas s2 core
    base = 56 if z <= 71 else 88
    return int(np.clip(z - base, 1, 12))


# Common oxidation states per element (standard chemistry data; the subset
# used by the generation-stats charge-balance check, generate.py:292-294 in
# the reference via pymatgen oxi_state_guesses).  Elements without an entry
# fall back to (0,) so exotic species never crash the check.
# fmt: off
COMMON_OXIDATION_STATES: Dict[str, tuple] = {
    "H": (-1, 1), "He": (0,), "Li": (1,), "Be": (2,), "B": (3,),
    "C": (-4, -3, -2, -1, 1, 2, 3, 4), "N": (-3, 3, 5), "O": (-2,),
    "F": (-1,), "Ne": (0,), "Na": (1,), "Mg": (2,), "Al": (3,),
    "Si": (-4, 4), "P": (-3, 3, 5), "S": (-2, 2, 4, 6), "Cl": (-1, 1, 3, 5, 7),
    "Ar": (0,), "K": (1,), "Ca": (2,), "Sc": (3,), "Ti": (2, 3, 4),
    "V": (2, 3, 4, 5), "Cr": (2, 3, 6), "Mn": (2, 3, 4, 6, 7),
    "Fe": (2, 3), "Co": (2, 3), "Ni": (2, 3), "Cu": (1, 2), "Zn": (2,),
    "Ga": (3,), "Ge": (-4, 2, 4), "As": (-3, 3, 5), "Se": (-2, 2, 4, 6),
    "Br": (-1, 1, 3, 5, 7), "Kr": (0, 2), "Rb": (1,), "Sr": (2,),
    "Y": (3,), "Zr": (4,), "Nb": (3, 5), "Mo": (2, 3, 4, 5, 6),
    "Tc": (4, 7), "Ru": (2, 3, 4, 8), "Rh": (1, 3), "Pd": (2, 4),
    "Ag": (1,), "Cd": (2,), "In": (1, 3), "Sn": (2, 4), "Sb": (-3, 3, 5),
    "Te": (-2, 2, 4, 6), "I": (-1, 1, 3, 5, 7), "Xe": (0, 2, 4, 6, 8),
    "Cs": (1,), "Ba": (2,), "La": (3,), "Ce": (3, 4), "Pr": (3,),
    "Nd": (3,), "Pm": (3,), "Sm": (2, 3), "Eu": (2, 3), "Gd": (3,),
    "Tb": (3, 4), "Dy": (3,), "Ho": (3,), "Er": (3,), "Tm": (2, 3),
    "Yb": (2, 3), "Lu": (3,), "Hf": (4,), "Ta": (5,), "W": (2, 3, 4, 5, 6),
    "Re": (2, 4, 6, 7), "Os": (2, 3, 4, 6, 8), "Ir": (1, 3, 4),
    "Pt": (2, 4), "Au": (1, 3), "Hg": (1, 2), "Tl": (1, 3),
    "Pb": (2, 4), "Bi": (3, 5), "Po": (-2, 2, 4), "At": (-1, 1),
    "Rn": (0, 2), "Fr": (1,), "Ra": (2,), "Ac": (3,), "Th": (4,),
    "Pa": (4, 5), "U": (3, 4, 5, 6), "Np": (3, 4, 5, 6),
    "Pu": (3, 4, 5, 6), "Am": (3, 4, 5, 6), "Cm": (3, 4),
    "Bk": (3, 4), "Cf": (3,), "Es": (3,), "Fm": (3,),
}
# fmt: on


def oxidation_states(z: int) -> tuple:
    """Common oxidation states for atomic number z ((0,) if unknown)."""
    return COMMON_OXIDATION_STATES.get(Z_TO_SYMBOL.get(int(z), ""), (0,))


def average_electronegativity(zs) -> float:
    """Mean Pauling electronegativity over a list of atomic numbers
    (reference generate.py:291 via pymatgen Composition.average_electroneg)."""
    vals = ELECTRONEGATIVITY[np.asarray(zs, dtype=int)]
    vals = vals[~np.isnan(vals)]
    return float(vals.mean()) if len(vals) else float("nan")


def is_charge_balanced(zs) -> bool:
    """True if some per-atom assignment of common oxidation states makes the
    composition neutral (the reference's charge-balance stat,
    generate.py:292-294 via pymatgen oxi_state_guesses).

    Atoms of the same element may take different states — mixed-valence
    compounds like Fe3O4 (2 Fe3+ + 1 Fe2+) count as balanced, matching
    pymatgen's per-element state-combination enumeration.
    """
    zs = np.asarray(zs, dtype=int)
    if len(zs) == 0:
        return False
    uniq, counts = np.unique(zs, return_counts=True)
    achievable = {0}
    for z, n in zip(uniq, counts):
        states = sorted(set(oxidation_states(int(z))))
        # sums reachable by n atoms of this element (multiset of states)
        elem_sums = {0}
        for _ in range(int(n)):
            elem_sums = {s + int(st) for s in elem_sums for st in states}
        achievable = {a + e for a in achievable for e in elem_sums}
        if len(achievable) > 1_000_000:
            # bounded by the total charge range in practice (a few hundred
            # values for padded 64-atom cells); fail conservative if not
            return False
    return 0 in achievable
