"""Guards on the port's boundaries: it runs without JAX, its verbatim copies
stay verbatim, its configs keep the JAX defaults, and its CLI refuses what
it cannot do instead of quietly doing something else."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch.apps import common as tcommon
from icsg3d_torch.apps import generate as tgen
from icsg3d_tpu import config as jcfg

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

VERBATIM = [
    "ops/segmentation.py",
    "data/binning.py",
    "crystal/elements.py",
    "crystal/lattice.py",
    "crystal/structure.py",
    "crystal/cif.py",
]

NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
import icsg3d_torch.apps.generate as gen
from icsg3d_torch.data.store import GridDataset

d = 8
g = np.mgrid[:d, :d, :d].astype(np.float32)
density = np.exp(-((g - 4.0) ** 2).sum(0) / 2.0)[None].repeat(2, 0)
coords = np.moveaxis(g, 0, -1)[None].repeat(2, 0) * 0.5
GridDataset.write(sys.argv[1] + "/data", ["a", "b"], {
    "density": density, "coords": coords,
    "target": np.array([0.1, 0.2], np.float32)})
recs = gen.main(["--data", sys.argv[1] + "/data", "--base", "a",
                 "--vae-ckpt", "none", "--unet-ckpt", "none",
                 "--filters", "4,8", "--latent", "8", "--nsamples", "2",
                 "--batch-size", "2", "--device", "cpu", "--fused",
                 "--output", sys.argv[1] + "/out"])
assert len(recs) == 2
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "flax", "optax", "orbax", "icsg3d_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, str(tmp_path)], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_no_port_module_imports_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|icsg3d_tpu)\b", re.M
    )
    for path in (REPO / "icsg3d_torch").rglob("*.py"):
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_their_originals(rel):
    original = (REPO / "icsg3d_tpu" / rel).read_text()
    copy = (REPO / "icsg3d_torch" / rel).read_text()
    header = f"# Verbatim copy of icsg3d_tpu/{rel}.\n"
    assert copy.startswith(header)
    assert copy[len(header):] == original.replace("icsg3d_tpu", "icsg3d_torch")


@pytest.mark.parametrize("name", ["GridSpec", "VAEConfig", "UNetConfig",
                                  "PipelineConfig"])
def test_config_defaults_match_jax(name):
    jcls, tcls = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_vae_config_checks_grid_like_jax():
    with pytest.raises(ValueError, match="incompatible"):
        tcfg.VAEConfig(grid=tcfg.GridSpec(d=8))


BASE_ARGS = ["--data", "nowhere", "--base", "x", "--vae-ckpt", "v.npz",
             "--unet-ckpt", "u.npz"]


def test_generate_refuses_cuda_when_unavailable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.main(BASE_ARGS)


def test_generate_refuses_cgcnn():
    with pytest.raises(NotImplementedError, match="CGCNN is not ported yet"):
        tgen.main(BASE_ARGS + ["--device", "cpu", "--cgcnn-ckpt", "fe=dir"])


def test_orbax_directory_names_the_export_script(tmp_path, capsys):
    (tmp_path / "best").mkdir()
    with pytest.raises(ValueError, match="export_flax_npz"):
        tcommon.weights_path(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcommon.weights_path(str(empty)) is None
    assert "using fresh weights" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        tcommon.weights_path(str(tmp_path / "missing.npz"))
