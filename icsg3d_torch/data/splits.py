# Verbatim copy of icsg3d_tpu/data/splits.py.
"""Train/validation splitting with rotation-augmentation grouping.

Semantics follow the reference's data_split (utils.py:36-61): the split is
computed over *non-rotated* parent IDs, and every rotated copy follows its
parent into the same split, so no augmented view of a validation sample ever
leaks into training.  Two reference bugs are fixed here:

- ``str.strip(".npy")`` stripped *characters*, silently corrupting IDs ending
  in n/p/y (utils.py:55); we do real suffix handling.
- The reference shuffled with the global ``random`` module; we take an
  explicit seed (default 28 = the reference default).
"""

from __future__ import annotations

import random
import warnings
from typing import List, Optional, Sequence, Tuple


def rotation_ids(parent_id: str, n_rot: int) -> List[str]:
    """IDs of the n_rot rotated copies of a parent sample."""
    return [f"{parent_id}_rot_{r}" for r in range(n_rot)]


def is_rotation(sample_id: str) -> bool:
    return "_rot_" in sample_id


def parent_id(sample_id: str) -> str:
    return sample_id.split("_rot_")[0]


def data_split(
    ids: Sequence[str],
    n: Optional[int] = None,
    frac: float = 0.8,
    n_rot: int = 10,
    shuffle: bool = True,
    seed: Optional[int] = 28,
) -> Tuple[List[str], List[str]]:
    """Split sample IDs into train/validation lists.

    ids: all sample IDs (parents and/or rotations; rotations are ignored for
    split computation and re-derived from n_rot so semantics match the
    reference exactly).
    Returns (training_ids, validation_ids), each parent followed by its
    rotations (utils.py:52-59 ordering).
    """
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    all_parents = sorted({i for i in ids if not is_rotation(i)})
    # rotations whose parent id is absent would vanish from BOTH splits
    # (they are re-derived from parents below) — that is silent data loss,
    # e.g. an ingested file literally named "ABC_rot_x.cif"
    parent_set = set(all_parents)
    orphans = [
        i for i in ids if is_rotation(i) and parent_id(i) not in parent_set
    ]
    if orphans:
        warnings.warn(
            f"data_split: {len(orphans)} sample(s) look like rotations of "
            f"absent parents and are excluded (e.g. {orphans[0]!r})",
            stacklevel=2,
        )
    parents = all_parents[:n]
    if shuffle:
        rng = random.Random(seed)
        rng.shuffle(parents)
    cut = int(frac * len(parents))
    train_parents, val_parents = parents[:cut], parents[cut:]

    available = set(ids)
    missing_rot = 0

    def expand(plist: List[str]) -> List[str]:
        nonlocal missing_rot
        out: List[str] = []
        for p in plist:
            out.append(p)
            # rotations are derived names; include only those the dataset
            # actually contains
            for rid in rotation_ids(p, n_rot):
                if rid in available:
                    out.append(rid)
                else:
                    missing_rot += 1
        return out

    train, val = expand(train_parents), expand(val_parents)
    if n_rot > 0 and missing_rot:
        warnings.warn(
            f"data_split: {missing_rot} of the requested rotation ids are "
            f"not in the dataset (built with a smaller n_rot?) — training "
            "proceeds with fewer samples than n_rot implies",
            stacklevel=2,
        )
    assert not set(train) & set(val)
    return train, val
