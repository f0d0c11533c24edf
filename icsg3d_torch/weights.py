"""The bridge that carries Flax weights into the port.

The machine that runs the port has no JAX and cannot read Orbax
checkpoints, so weights cross over as a flat ``.npz`` whose keys are the
Flax paths joined by "/" (``"params/encoder/Conv_0/kernel"``,
``"batch_stats/decoder/output_bn/mean"``).  ``tools/export_flax_npz.py``
writes one from an Orbax checkpoint where JAX is installed.

The port's modules keep Flax's names, so the map is mechanical:

- conv ``kernel`` (DHWIO) and Dense ``kernel`` (in, out) are kept as they
  are (the port computes x @ kernel);
- BatchNorm params ``scale``/``bias`` -> ``weight``/``bias``;
  batch_stats ``mean``/``var`` -> ``running_mean``/``running_var``;
- CGCNN's masked-BN params ``gamma1``/``beta1``/``gamma2``/``beta2`` keep
  their names.

``save_npz``/``load_npz`` need only numpy, so the export script runs where
torch is not installed.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np

COLLECTIONS = ("params", "batch_stats")
_LEAF_NAMES = {
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of arrays -> {"a/b/c": np.ndarray}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten(flat: Mapping) -> dict:
    """{"a/b/c": array} -> nested dicts."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_npz(path: str, variables) -> None:
    """Write a Flax ``{"params": ..., "batch_stats": ...}`` tree flat."""
    np.savez(path, **flatten(variables))


def load_npz(path: str) -> dict:
    """Read a flat ``.npz`` back into nested dicts of numpy arrays."""
    with np.load(path) as f:
        return unflatten({k: f[k] for k in f.files})


def port_key(flax_key: str) -> str:
    """"params/encoder/BatchNorm_0/scale" -> "encoder.BatchNorm_0.weight"."""
    collection, *path = flax_key.split("/")
    if collection not in COLLECTIONS or not path:
        raise KeyError(f"{flax_key!r} is not under {COLLECTIONS}")
    leaf = _LEAF_NAMES.get((collection, path[-1]), path[-1])
    return ".".join(path[:-1] + [leaf])


_FLAX_LEAVES = {
    "kernel": ("params", "kernel"),
    "bias": ("params", "bias"),
    "weight": ("params", "scale"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
    **{name: ("params", name) for name in ("gamma1", "beta1", "gamma2", "beta2")},
}


def flax_key(key: str) -> str:
    """The inverse of ``port_key``: "encoder.BatchNorm_0.weight" ->
    "params/encoder/BatchNorm_0/scale"."""
    *path, leaf = key.split(".")
    collection, name = _FLAX_LEAVES[leaf]
    return "/".join([collection, *path, name])


def to_flax_variables(module) -> dict:
    """The inverse map: a port module's state as a Flax variables tree of
    numpy arrays (e.g. to save seeded weights with ``save_npz``)."""
    return unflatten({
        flax_key(key): t.detach().cpu().float().numpy()
        for key, t in module.state_dict().items()
    })


def model_variables(tree: Mapping) -> dict:
    """The model collections of a loaded ``.npz`` tree, without the
    training extras a checkpoint may hold (``step``, ``opt_state``)."""
    return {c: tree[c] for c in COLLECTIONS if c in tree}


def load_flax_variables(module, variables) -> None:
    """Fill ``module`` (a port nn.Module) from a Flax variables tree given
    as nested dicts of numpy arrays.

    Every leaf is consumed exactly once: a leaf with no place in the
    module, a module entry with no leaf, or a shape mismatch raises
    ValueError and leaves the module untouched.
    """
    import torch

    state = module.state_dict()
    flat = flatten(variables)
    mapped: Dict[str, np.ndarray] = {}
    extra = []
    for key, arr in flat.items():
        try:
            tkey = port_key(key)
        except KeyError:
            extra.append(key)
            continue
        if tkey not in state or tkey in mapped:
            extra.append(key)
            continue
        if tuple(arr.shape) != tuple(state[tkey].shape):
            raise ValueError(
                f"{key}: shape {tuple(arr.shape)} does not match the port's "
                f"{tkey} {tuple(state[tkey].shape)}"
            )
        mapped[tkey] = arr
    missing = sorted(set(state) - set(mapped))
    if extra or missing:
        raise ValueError(
            f"Flax variables do not match {type(module).__name__}: "
            f"left-over leaves {sorted(extra)}; missing {missing}"
        )
    with torch.no_grad():
        for tkey, arr in mapped.items():
            t = state[tkey]
            t.copy_(torch.from_numpy(np.asarray(arr, np.float32)).to(t.device))
