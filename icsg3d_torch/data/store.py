"""Packed on-disk dataset store (read and write).

The ``GridDataset`` and ``BatchIterator`` classes of
icsg3d_tpu/data/store.py, unchanged (tests/test_torch_guards.py holds
``BatchIterator`` equal to its original): a dataset is a directory of
packed memory-mapped .npy fields plus an ids.json manifest.  The JAX
device prefetcher becomes ``prefetch_to_device``: a pinned host copy and a
non-blocking transfer per batch, no thread.

Fields:
    density   (N, d, d, d)    float32   Gaussian electron density
    coords    (N, d, d, d, 3) float32   absolute coordinate grid
    species   (N, d, d, d)    uint8     atomic-number labels (0=background)
    lattice   (N, 6)          float32   a, b, c, alpha, beta, gamma
    target    (N,)            float32   conditioning property value
    sites     (N, P, 3)       float32   true cartesian site coords (padded)
    site_z    (N, P)          float32   true atomic numbers (0 = padding)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

FIELDS = ("density", "coords", "species", "lattice", "target", "sites", "site_z")


class GridDataset:
    """A packed voxel-grid dataset on disk."""

    def __init__(self, path: str, mmap: bool = True):
        self.path = path
        with open(os.path.join(path, "ids.json")) as f:
            self.ids: List[str] = json.load(f)
        if len(set(self.ids)) != len(self.ids):
            raise ValueError(
                f"dataset {path} has duplicate ids — the index would "
                "silently collapse duplicates onto the last row"
            )
        mode = "r" if mmap else None
        self.arrays: Dict[str, np.ndarray] = {}
        for field in FIELDS:
            fp = os.path.join(path, f"{field}.npy")
            if os.path.exists(fp):
                arr = np.load(fp, mmap_mode=mode)
                if len(arr) != len(self.ids):
                    raise ValueError(
                        f"dataset {path}: {field}.npy has {len(arr)} rows "
                        f"but ids.json lists {len(self.ids)} — stale or "
                        "partially written field file"
                    )
                self.arrays[field] = arr
        self.index = {sid: i for i, sid in enumerate(self.ids)}

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def d(self) -> int:
        return self.arrays["density"].shape[1]

    def rows(self, ids: Sequence[str]) -> np.ndarray:
        return np.array([self.index[i] for i in ids], dtype=np.int64)

    def gather(self, ids: Sequence[str], fields: Sequence[str]) -> Dict[str, np.ndarray]:
        rows = self.rows(ids)
        return {f: np.asarray(self.arrays[f][rows]) for f in fields}

    @staticmethod
    def write(
        path: str,
        ids: Sequence[str],
        arrays: Dict[str, np.ndarray],
    ) -> "GridDataset":
        os.makedirs(path, exist_ok=True)
        n = len(ids)
        if len(set(ids)) != n:
            raise ValueError("duplicate sample ids")
        unknown = set(arrays) - set(FIELDS)
        if unknown:
            raise ValueError(
                f"unknown fields {sorted(unknown)}: __init__ only loads "
                f"{FIELDS}, so they would silently vanish on reload"
            )
        for field, arr in arrays.items():
            if len(arr) != n:
                raise ValueError(f"{field}: {len(arr)} rows != {n} ids")
            np.save(os.path.join(path, f"{field}.npy"), np.asarray(arr))
        for field in FIELDS:
            # remove stale files from a previous dataset in the same dir
            # (a dropped field would otherwise reload with the wrong N)
            if field not in arrays:
                fp = os.path.join(path, f"{field}.npy")
                if os.path.exists(fp):
                    os.remove(fp)
        tmp = os.path.join(path, "ids.json.tmp")
        with open(tmp, "w") as f:
            json.dump(list(ids), f)
        os.replace(tmp, os.path.join(path, "ids.json"))
        return GridDataset(path)


class BatchIterator:
    """Epoch iterator yielding dict batches of host numpy arrays.

    Matches the reference generators' semantics: remainder batches are
    dropped (vae/data.py:45), optional shuffling re-draws every epoch
    (vae/data.py:60-64).  Rotation grouping is upstream in data_split.
    """

    def __init__(
        self,
        dataset: GridDataset,
        ids: Sequence[str],
        batch_size: int,
        fields: Sequence[str] = ("density", "coords", "species"),
        shuffle: bool = False,
        seed: int = 0,
        extra: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.dataset = dataset
        self.ids = list(ids)
        self.batch_size = batch_size
        self.fields = tuple(fields)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.rows = dataset.rows(self.ids)
        # extra: per-sample arrays aligned with `ids` (e.g. one-hot conds)
        self.extra = extra or {}
        for k, v in self.extra.items():
            if len(v) != len(self.ids):
                raise ValueError(f"extra[{k}] has {len(v)} rows, want {len(self.ids)}")

    def __len__(self) -> int:
        return len(self.ids) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ids))
        if self.shuffle:
            self.rng.shuffle(order)
        for b in range(len(self)):
            sel = order[b * self.batch_size : (b + 1) * self.batch_size]
            rows = self.rows[sel]
            batch = {f: np.asarray(self.dataset.arrays[f][rows]) for f in self.fields}
            for k, v in self.extra.items():
                batch[k] = np.asarray(v[sel])
            yield batch


def prefetch_to_device(iterator, device, group=None):
    """Counterpart of icsg3d_tpu's threaded prefetcher: each host numpy
    batch goes to ``device`` as tensors, on CUDA through pinned memory with
    a non-blocking copy, so the host does not wait on the transfer.  No
    thread is needed at this size.  With a torch.distributed process
    ``group`` only this rank's rows of each batch are shipped
    (parallel/mesh.shard_batch)."""
    import torch

    from icsg3d_torch.parallel.mesh import shard_batch

    cuda = torch.device(device).type == "cuda"
    for batch in iterator:
        batch = shard_batch(batch, group)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
        yield out
