"""The port's CLIs under ``python -m torch.distributed.run --standalone
--nproc-per-node 2`` (torchrun) on the CPU, over gloo, at d = 8.

- ``train_vae``, ``train_unet`` and ``train_cgcnn``, one epoch each: the
  history of the two ranks within rtol 1e-4 of the single-process run of
  the same global batch, and only rank 0 writes (every file or directory
  either rank opens for writing under ``--ckpt`` is logged, and rank 1's
  log is empty).
- ``train_vae --device cpu,cpu --spatial 2`` at two ranks against one.
- ``voxelize`` in parts: rank k's ``part-<k>/`` of ``--cifs`` equals JAX's
  ``build_from_cifs(process_index=k, process_count=2)``, and of
  ``--synthetic`` JAX's synthetic build's rows of the same ids; the merged
  parts hold every id once.

Every launch has a timeout; torchrun's standalone rendezvous picks a free
port, so parallel test workers do not collide.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from icsg3d_torch.apps import train_cgcnn as tcgcnn_app
from icsg3d_torch.apps import train_unet as tunet_app
from icsg3d_torch.apps import train_vae as tvae_app
from icsg3d_torch.apps import voxelize as tvox_app
from icsg3d_tpu.apps import voxelize as jvox_app
from icsg3d_tpu.config import GridSpec, VoxelizerConfig
from icsg3d_tpu.data import synthetic as jsyn
from test_torch_train import _write_dataset
from test_torch_voxelize import REAL_CIFS, _assert_builds_equal, _read

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
LAUNCH_TIMEOUT_S = 300
CIFS = os.path.abspath(REAL_CIFS)

# Runs a CLI module as __main__ under torchrun and logs every path under
# the checkpoint directory that this rank opens for writing or creates.
LOGGED = r"""
import builtins, json, os, runpy, sys
watch, module, argv = os.path.abspath(sys.argv[1]), sys.argv[2], sys.argv[3:]
seen, _open, _makedirs = [], builtins.open, os.makedirs

def _log(path):
    path = os.path.abspath(os.fspath(path))
    if path == watch or path.startswith(watch + os.sep):
        seen.append(os.path.relpath(path, watch))

def logged_open(file, mode="r", *args, **kwargs):
    if isinstance(file, (str, bytes, os.PathLike)) and set(mode) & set("wax+"):
        _log(file)
    return _open(file, mode, *args, **kwargs)

def logged_makedirs(name, *args, **kwargs):
    _log(name)
    return _makedirs(name, *args, **kwargs)

builtins.open, os.makedirs = logged_open, logged_makedirs
sys.argv = [module] + argv
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    with _open(watch + f".writes-{os.environ['RANK']}.json", "w") as f:
        json.dump(seen, f)
"""


def torchrun(tmp_path, module, argv, watch):
    """``module``'s CLI on two ranks; returns each rank's logged writes
    under ``watch``."""
    script = tmp_path / "logged.py"
    script.write_text(LOGGED)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(watch), module, *argv],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    writes = []
    for r in range(2):
        with open(f"{watch}.writes-{r}.json") as f:
            writes.append(json.load(f))
    return writes


def _assert_history(ckpt, plain):
    with open(os.path.join(ckpt, "history.json")) as f:
        got = json.load(f)
    assert len(got) == len(plain)
    for hg, hp in zip(got, plain):
        assert hg["steps"] == hp["steps"]
        for split in ("train", "val"):
            assert set(hg[split]) == set(hp[split])
            for key, v in hp[split].items():
                np.testing.assert_allclose(hg[split][key], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{split} {key}")


def _assert_rank0_writes(writes, ckpt_files):
    assert writes[1] == [], writes[1]
    assert ckpt_files <= set(writes[0]), (ckpt_files, writes[0])


def test_train_vae_two_ranks_match_one(tmp_path):
    data = _write_dataset(tmp_path / "data", n=20)  # 16 train (4 steps), 4 val
    base = ["--data", data, "--nrot", "0", "--epochs", "1", "--filters", "4,8",
            "--latent", "8", "--batch-size", "4", "--device", "cpu"]
    plain = tvae_app.main(base + ["--ckpt", str(tmp_path / "one")])
    ckpt = tmp_path / "two"
    writes = torchrun(tmp_path, "icsg3d_torch.apps.train_vae",
                      base + ["--ckpt", str(ckpt)], ckpt)
    _assert_history(ckpt, plain)
    _assert_rank0_writes(writes, {"best.npz.tmp", "latest.npz.tmp", "history.json"})


def test_train_vae_spatial_2_two_ranks_match_one(tmp_path):
    data = _write_dataset(tmp_path / "data", n=10)  # 8 train (4 steps), 2 val
    base = ["--data", data, "--nrot", "0", "--epochs", "1", "--filters", "4,8",
            "--latent", "8", "--batch-size", "2", "--lr", "1e-5",
            "--device", "cpu,cpu", "--spatial", "2"]
    plain = tvae_app.main(base + ["--ckpt", str(tmp_path / "one")])
    ckpt = tmp_path / "two"
    writes = torchrun(tmp_path, "icsg3d_torch.apps.train_vae",
                      base + ["--ckpt", str(ckpt)], ckpt)
    _assert_history(ckpt, plain)
    assert writes[1] == []


def test_train_unet_two_ranks_match_one(tmp_path):
    data = str(tmp_path / "synth")
    tvox_app.main(["--synthetic", "10", "--out", data, "--d", "8", "--nrot", "0",
                   "--kinds", "perovskite,rocksalt", "--seed", "1", "--device", "cpu"])
    base = ["--data", data, "--epochs", "1", "--batch-size", "4", "--nrot", "0",
            "--num-classes", "60", "--device", "cpu"]
    plain = tunet_app.main(base + ["--ckpt", str(tmp_path / "one")])
    ckpt = tmp_path / "two"
    writes = torchrun(tmp_path, "icsg3d_torch.apps.train_unet",
                      base + ["--ckpt", str(ckpt)], ckpt)
    _assert_history(ckpt, plain)
    _assert_rank0_writes(writes, {"class_weights.json", "best.npz.tmp",
                                  "latest.npz.tmp", "history.json"})


def test_train_cgcnn_two_ranks_match_one(tmp_path):
    base = ["--synthetic", "40", "--epochs", "1", "--batch-size", "8",
            "--device", "cpu"]  # 32 train (4 steps), 8 val (1 batch)
    plain = tcgcnn_app.main(base + ["--ckpt", str(tmp_path / "one")])
    ckpt = tmp_path / "two"
    writes = torchrun(tmp_path, "icsg3d_torch.apps.train_cgcnn",
                      base + ["--ckpt", str(ckpt)], ckpt)
    _assert_history(ckpt, plain)
    _assert_rank0_writes(writes, {"best.npz.tmp", "latest.npz.tmp", "history.json"})


def test_voxelize_cifs_in_parts_match_jax(tmp_path):
    out = tmp_path / "parts"
    writes = torchrun(tmp_path, "icsg3d_torch.apps.voxelize",
                      ["--cifs", CIFS, "--targets-csv", f"{CIFS}/targets.csv",
                       "--d", "8", "--nrot", "1", "--seed", "2", "--device", "cpu",
                       "--out", str(out)], out)
    for k in range(2):
        # rank k writes its own part (and may make --out, its parent)
        tops = {w.split(os.sep)[0] for w in writes[k]}
        assert f"part-{k}" in tops and tops <= {".", f"part-{k}"}, writes[k]
        jvox_app.build_from_cifs(
            CIFS, str(tmp_path / "jax"), targets_csv=f"{CIFS}/targets.csv",
            cfg=VoxelizerConfig(grid=GridSpec(d=8)), n_rot=1, seed=2,
            process_index=k, process_count=2)
        _assert_builds_equal(_read(str(out / f"part-{k}")),
                             _read(str(tmp_path / "jax" / f"part-{k}")))


def test_voxelize_synthetic_in_parts_match_jax(tmp_path):
    out = tmp_path / "parts"
    torchrun(tmp_path, "icsg3d_torch.apps.voxelize",
             ["--synthetic", "12", "--kinds", "perovskite,rocksalt", "--d", "8",
              "--nrot", "0", "--device", "cpu", "--out", str(out)], out)
    jsyn.build_dataset(str(tmp_path / "jax"), n=12, cfg=VoxelizerConfig(
        grid=GridSpec(d=8)), kinds=("perovskite", "rocksalt"))
    j_ids, j_arr = _read(str(tmp_path / "jax"))
    for k in range(2):
        ids, arr = _read(str(out / f"part-{k}"))
        assert ids == [f"syn-{i}" for i in range(k, 12, 2)]
        rows = [j_ids.index(i) for i in ids]
        _assert_builds_equal((ids, arr), (ids, {f: v[rows] for f, v in j_arr.items()}))
    merged = tvox_app.merge_parts(str(out))
    assert sorted(merged.ids) == sorted(j_ids)
