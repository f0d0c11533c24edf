# Verbatim copy of icsg3d_tpu/data/atom_features.py.
"""CGCNN-style element feature vectors, generated from the element tables.

The reference ships a static ``cgcnn/atom_init.json`` (100 elements -> 93-dim
binary vectors; the canonical CGCNN initialization from Xie & Grossman,
loaded at cgcnn/data.py:54-72).  Rather than vendoring that file, we
synthesize the same scheme from our own element-property tables
(crystal/elements.py).

Layout and bin conventions (REVERSE-DERIVED from the canonical table —
block boundaries located empirically from the 9-hots-per-element structure,
then each block's property and bin edges identified by fitting against our
element tables; agreement percentages below are measured over all 100
canonical elements):

    offset  width  property            convention                  agreement
    0       10     electron affinity   linear floor [-3.0, 3.7] eV      15%
    10      4      block s/p/d/f       La/Ac treated as d              100%
    14      10     covalent radius     linear floor [30, 260] pm        96%
    24      10     electronegativity   digitize linspace(0.5,4.0,10)    76%
    34      18     group number        one-hot group-1                 100%
    52      10     molar volume        log floor [1.48, 10.0] ln-cm3    88%
    62      10     first ionization    log floor [1.3, 3.3] ln-eV       86%
    72      9      period              pseudo-rows (see below)         100%
    81      12     valence electrons   one-hot count-1, clip 12         26%

Audit notes (why some blocks cannot reach 100%):

* IONIZATION / VOLUME EDGES ARE LOG-SPACE VALUES.  [1.3, 3.3] are ln(eV)
  edges (e^1.3=3.7 eV .. e^3.3=27 eV) applied to ln(value) — round 1
  applied np.log to BOTH the value and these already-log edges, collapsing
  every element into the top bin.  Same for molar volume (ln cm^3).
* The canonical period block is 9 wide because lanthanides Ce-Lu are
  encoded as pseudo-period 8 and actinides Th+ as pseudo-period 9 (the
  separate f-rows of a printed periodic table); La/Ac themselves stay in
  periods 6/7 and are d-block (their ground configs are 5d1/6d1).
  Replicated here.
* The canonical ELECTRON AFFINITY column does not correlate with any
  standard EA table (Spearman rho ~ -0.1 against CRC values, in any unit
  or sign convention, also under +-3 element index shifts) — it appears to
  be a data artifact of the original generator.  We bin real CRC EA values
  instead; the 15% agreement is the honest consequence.
* The canonical VALENCE column is nonstandard: groups 15/16/17/18 get
  6/7/8/10 (not 5/6/7/8), Pd gets 12, Tc gets 1.  We keep the standard
  chemistry count (group-based; f-block = electrons past the s2 core).
* Remaining covrad/EN/volume disagreements are value-source differences
  (e.g. Pyykko vs Cordero radii), not convention differences.

Missing values (e.g. noble-gas electronegativity) are encoded as a hot at
bin 0 of their block, matching the canonical table's structure of EXACTLY
nine ones per element.

Quantified parity vs the canonical table is exercised by
tests/test_data.py::TestAtomFeatures::test_canonical_agreement (skipped
when the reference file is absent) and recorded in COVERAGE.md.
"""

from __future__ import annotations

import functools

import numpy as np

from icsg3d_torch.crystal import elements

ATOM_FEATURE_DIM = 93

# (offset, width) of each property block in canonical order
BLOCKS = {
    "electron_affinity": (0, 10),
    "block": (10, 4),
    "covalent_radius": (14, 10),
    "electronegativity": (24, 10),
    "group": (34, 18),
    "molar_volume": (52, 10),
    "ionization": (62, 10),
    "period": (72, 9),
    "valence": (81, 12),
}


def _floor_bucket(
    value: float, lo: float, hi: float, n: int, log: bool = False
) -> np.ndarray:
    """One-hot of clip(floor((x - lo) / (hi - lo) * n)); lo/hi are given in
    the SAME space as the binning (pass ln-space edges with log=True, which
    transforms only the value).  NaN/None -> hot at bin 0 (canonical
    missing-value convention)."""
    out = np.zeros(n, dtype=np.float32)
    if value is None or np.isnan(value) or (log and value <= 0):
        out[0] = 1.0
        return out
    if log:
        value = np.log(value)
    idx = int(np.clip((value - lo) / (hi - lo) * n, 0, n - 1))
    out[idx] = 1.0
    return out


def _digitize_bucket(value: float, lo: float, hi: float, n: int) -> np.ndarray:
    """One-hot of clip(np.digitize(x, linspace(lo, hi, n))) — the canonical
    electronegativity convention (counts edges <= x)."""
    out = np.zeros(n, dtype=np.float32)
    if value is None or np.isnan(value):
        out[0] = 1.0
        return out
    idx = int(np.clip(np.digitize(value, np.linspace(lo, hi, n)), 0, n - 1))
    out[idx] = 1.0
    return out


def _one_hot(idx: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.float32)
    out[idx] = 1.0
    return out


def _canonical_block(z: int) -> str:
    """s/p/d/f with the La/Ac-are-d ground-configuration convention."""
    if z in (57, 89):
        return "d"
    return elements.block(z)


def _canonical_period_idx(z: int) -> int:
    """0-based period with lanthanide/actinide pseudo-rows 8/9."""
    if 58 <= z <= 71:
        return 7
    if z >= 90:
        return 8
    return elements.period(z) - 1


def atom_features(z: int) -> np.ndarray:
    """93-dim binary feature vector for element Z (1..100), canonical
    layout (see module docstring)."""
    feats = [
        _floor_bucket(elements.ELECTRON_AFFINITY_EV[z], -3.0, 3.7, 10),
        _one_hot("spdf".index(_canonical_block(z)), 4),
        _floor_bucket(elements.COVALENT_RADIUS_PM[z], 30.0, 260.0, 10),
        _digitize_bucket(elements.ELECTRONEGATIVITY[z], 0.5, 4.0, 10),
        _one_hot(elements.group(z) - 1, 18),
        _floor_bucket(elements.MOLAR_VOLUME_CM3[z], 1.48, 10.0, 10, log=True),
        _floor_bucket(elements.FIRST_IONIZATION_EV[z], 1.3, 3.3, 10, log=True),
        _one_hot(_canonical_period_idx(z), 9),
        _one_hot(int(np.clip(elements.valence_electrons(z), 1, 12)) - 1, 12),
    ]
    vec = np.concatenate(feats)
    assert vec.shape == (ATOM_FEATURE_DIM,)
    return vec


@functools.lru_cache(maxsize=1)
def atom_feature_table(max_z: int = elements.MAX_Z) -> np.ndarray:
    """(max_z+1, 93) table indexed by atomic number; row 0 is zeros."""
    table = np.zeros((max_z + 1, ATOM_FEATURE_DIM), dtype=np.float32)
    for z in range(1, max_z + 1):
        table[z] = atom_features(z)
    return table
