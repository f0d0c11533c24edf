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
    "data/splits.py",
    "train/common.py",
    "utils/timeout.py",
    "data/class_weights.py",
    "crystal/neighbors.py",
    "data/atom_features.py",
    "ops/emd.py",
    "apps/query.py",
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
import icsg3d_torch.apps.train_vae as tv
GridDataset.write(sys.argv[1] + "/train", [f"p{i}" for i in range(5)], {
    "density": density[[0] * 5], "lattice": np.full((5, 6), 4.0, np.float32),
    "target": np.arange(5, dtype=np.float32)})
hist = tv.main(["--data", sys.argv[1] + "/train", "--nrot", "0", "--epochs", "1",
                "--filters", "4,8", "--latent", "8", "--batch-size", "2",
                "--device", "cpu", "--ckpt", sys.argv[1] + "/ckpt"])
assert len(hist) == 1
import icsg3d_torch.apps.voxelize as vx
import icsg3d_torch.apps.train_unet as tu
ds = vx.main(["--synthetic", "6", "--kinds", "perovskite,rocksalt", "--d", "8",
              "--nrot", "1", "--out", sys.argv[1] + "/vox", "--device", "cpu"])
assert len(ds) == 12 and "species" in ds.arrays
hist = tu.main(["--data", sys.argv[1] + "/vox", "--nrot", "1", "--epochs", "1",
                "--batch-size", "2", "--num-classes", "12", "--device", "cpu",
                "--ckpt", sys.argv[1] + "/unet"])
assert len(hist) == 1
import icsg3d_torch.apps.train_cgcnn as tc
import icsg3d_torch.apps.predict as tp
import icsg3d_torch.apps.evaluate as te
hist = tc.main(["--synthetic", "12", "--epochs", "1", "--batch-size", "4",
                "--device", "cpu", "--ckpt", sys.argv[1] + "/cgcnn"])
assert len(hist) == 1
import os
cifs = os.path.join(sys.argv[2], "tests", "fixtures", "real_cifs")
recs = tp.main([cifs, "--ckpt", "fe=" + sys.argv[1] + "/cgcnn", "--device", "cpu"])
assert sum("properties" in r for r in recs) >= 12
res = te.main(["--data", sys.argv[1] + "/vox", "--vae-ckpt", "none",
               "--unet-ckpt", "none", "--filters", "4,8", "--latent", "8",
               "--num-classes", "12", "--batch-size", "2", "--device", "cpu"])
assert res["n_evaluated"] + res["n_skipped"] == 2
import icsg3d_torch.apps.interpolate as ti
import icsg3d_torch.apps.query, icsg3d_torch.apps.view as tw
import icsg3d_torch.utils.profiling
grids = ti.main(["--data", sys.argv[1] + "/data", "--vae-ckpt", "none", "--a", "a",
                 "--b", "b", "--ninterps", "2", "--filters", "4,8", "--latent", "8",
                 "--device", "cpu", "--output", sys.argv[1] + "/interp"])
assert grids.shape == (4, d, d, d, 4)
recs = tw.main(["--data", sys.argv[1] + "/vox", "--vae-ckpt", "none", "--unet-ckpt",
                "none", "--num-classes", "12", "--filters", "4,8", "--latent", "8",
                "--n", "1", "--device", "cpu", "--output", sys.argv[1] + "/view"])
assert len(recs) == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "flax", "optax", "orbax", "icsg3d_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_with_jax_blocked(tmp_path):
    """generate, train_vae, voxelize, train_unet, train_cgcnn, predict,
    evaluate, interpolate and view run end to end (query and profiling
    import) with JAX, Flax, optax, Orbax and icsg3d_tpu unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, str(tmp_path), str(REPO)], cwd=str(tmp_path),
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


def test_no_port_module_imports_matplotlib_at_module_level():
    """The card's machine has no matplotlib: the port and chip_smoke.py
    import it only inside functions (viz's lazy pyplot, the plotting
    functions), so every module imports without it."""
    pattern = re.compile(r"^(import|from)\s+(matplotlib|sklearn)\b", re.M)
    jax_pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|icsg3d_tpu)\b", re.M)
    paths = list((REPO / "icsg3d_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in paths:
        text = path.read_text()
        assert not pattern.search(text), path
        assert not jax_pattern.search(text), path


def test_viz_is_the_jax_module_but_its_import_block():
    """icsg3d_torch/viz.py: its docstring and import block are its own (a
    lazy pyplot, ``available`` and the skip message); everything from the
    first plot function down is icsg3d_tpu/viz.py with the package name
    replaced."""
    start = "\n\n\ndef plot_slices("
    original = (REPO / "icsg3d_tpu" / "viz.py").read_text()
    copy = (REPO / "icsg3d_torch" / "viz.py").read_text()
    assert copy[copy.index(start):] == original[original.index(start):].replace(
        "icsg3d_tpu", "icsg3d_torch")
    head = original[:original.index(start)]
    assert "matplotlib.use(\"Agg\")" in head and "def " not in head


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_their_originals(rel):
    original = (REPO / "icsg3d_tpu" / rel).read_text()
    copy = (REPO / "icsg3d_torch" / rel).read_text()
    header = f"# Verbatim copy of icsg3d_tpu/{rel}.\n"
    assert copy.startswith(header)
    assert copy[len(header):] == original.replace("icsg3d_tpu", "icsg3d_torch")


def test_synthetic_is_a_copy_with_a_device_pass_through():
    """data/synthetic.py is verbatim but for build_dataset's ``device``,
    passed on to voxelize_structures."""
    original = (REPO / "icsg3d_tpu" / "data" / "synthetic.py").read_text()
    copy = (REPO / "icsg3d_torch" / "data" / "synthetic.py").read_text()
    header = ("# Copy of icsg3d_tpu/data/synthetic.py; build_dataset adds a "
              "pass-through `device`.\n")
    assert copy.startswith(header)
    want = original.replace("icsg3d_tpu", "icsg3d_torch").replace(
        '    kinds: Tuple[str, ...] = ("perovskite",),\n) -> GridDataset:',
        '    kinds: Tuple[str, ...] = ("perovskite",),\n    device="cuda",\n'
        ') -> GridDataset:').replace(
        "        structures, ids, targets, cfg=cfg, n_rot=n_rot, seed=seed,\n    )",
        "        structures, ids, targets, cfg=cfg, n_rot=n_rot, seed=seed,\n"
        "        device=device,\n    )")
    assert want != original.replace("icsg3d_tpu", "icsg3d_torch")
    assert copy[len(header):] == want


@pytest.mark.parametrize("name", ["GraphSpec", "featurize_structure",
                                  "featurize_batch"])
def test_graph_featurizer_is_a_verbatim_copy(name):
    """data/graphs.py: only gaussian_expand is the port's own."""
    import inspect

    from icsg3d_torch.data import graphs as tgraphs
    from icsg3d_tpu.data import graphs as jgraphs

    assert inspect.getsource(getattr(tgraphs, name)) == inspect.getsource(
        getattr(jgraphs, name))


def test_batch_iterator_is_a_verbatim_copy():
    import inspect

    from icsg3d_torch.data import store as tstore
    from icsg3d_tpu.data import store as jstore

    assert inspect.getsource(tstore.BatchIterator) == inspect.getsource(
        jstore.BatchIterator)


@pytest.mark.parametrize("name", ["GridSpec", "VAEConfig", "UNetConfig",
                                  "PipelineConfig", "VoxelizerConfig",
                                  "TrainConfig", "CGCNNConfig", "MeshConfig"])
def test_config_defaults_match_jax(name):
    jcls, tcls = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_cgcnn_config_bond_width_is_the_featurizers():
    for kw in ({}, {"radius": 4.0, "step": 0.3}):
        assert tcfg.CGCNNConfig(**kw).num_bond_features == \
            jcfg.CGCNNConfig(**kw).num_bond_features
    assert tcfg.CGCNNConfig().num_bond_features == 41


def test_vae_config_checks_grid_like_jax():
    with pytest.raises(ValueError, match="incompatible"):
        tcfg.VAEConfig(grid=tcfg.GridSpec(d=8))


BASE_ARGS = ["--data", "nowhere", "--base", "x", "--vae-ckpt", "v.npz",
             "--unet-ckpt", "u.npz"]


def test_generate_refuses_cuda_when_unavailable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.main(BASE_ARGS)


def test_generate_rejects_a_malformed_cgcnn_ckpt(capsys):
    """A --cgcnn-ckpt without name=dir is a usage error with the JAX CLI's
    message (icsg3d_tpu/apps/generate.py:561-570), before any work."""
    with pytest.raises(SystemExit) as exc:
        tgen.main(BASE_ARGS + ["--device", "cpu", "--cgcnn-ckpt", "fe"])
    assert exc.value.code == 2
    assert "--cgcnn-ckpt must be name=dir[,name=dir...], got 'fe'" in \
        capsys.readouterr().err


def test_evaluate_refuses_plots(monkeypatch, capsys):
    """--plots needs matplotlib: where it does not import, evaluate refuses
    with a usage error naming it, before any model or data loads, instead
    of skipping the plots."""
    from icsg3d_torch.apps import evaluate

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exc:
        evaluate.main(["--data", "nowhere", "--vae-ckpt", "v", "--unet-ckpt", "u",
                       "--device", "cpu", "--plots", "plots"])
    assert exc.value.code == 2
    assert "--plots draws plots, and matplotlib is not installed" in \
        capsys.readouterr().err


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


def test_checkpoint_directory_resolves_to_its_npz(tmp_path):
    (tmp_path / "best.npz").write_bytes(b"")
    (tmp_path / "latest.npz").write_bytes(b"")
    assert tcommon.weights_path(str(tmp_path)) == str(tmp_path / "best.npz")
    assert tcommon.weights_path(str(tmp_path), "latest") == str(tmp_path / "latest.npz")


def test_voxelize_batch_refuses_other_devices():
    from icsg3d_torch.ops.voxelize import voxelize_batch

    t = torch.zeros(1, 4, 3, device="meta")
    z = torch.zeros(1, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        voxelize_batch(t, z, z, z, torch.zeros(1, 3, device="meta"),
                       tcfg.GridSpec(d=8))


def test_voxelize_cuda_refuses_cpu_tensors():
    """The kernel wrapper never falls back to its plain version."""
    from icsg3d_torch.kernels import voxelize as kv

    z = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kv.voxelize_cuda(torch.zeros(1, 4, 3), z, z, z, torch.ones(1, 3), 8, 0.25)


@pytest.mark.parametrize("loader", ["load_vae", "load_unet", "load_cgcnn"])
def test_model_loaders_default_to_the_card(loader, monkeypatch):
    """Without a device the loaders ask for CUDA and raise where it is
    missing, instead of quietly building a CPU model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"load_vae": tcfg.VAEConfig(grid=tcfg.GridSpec(d=8), filters=(4, 8),
                                      latent_dim=8),
           "load_unet": tcfg.UNetConfig(num_classes=12),
           "load_cgcnn": tcfg.CGCNNConfig()}[loader]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tcommon, loader)(cfg, None)


@pytest.mark.parametrize("app", ["voxelize", "train_unet", "train_cgcnn",
                                 "predict", "evaluate", "interpolate", "view"])
def test_new_clis_refuse_cuda_when_unavailable(app, monkeypatch, tmp_path):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"icsg3d_torch.apps.{app}")
    argv = {"voxelize": ["--synthetic", "2", "--out", str(tmp_path / "x")],
            "train_unet": ["--data", str(tmp_path)],
            "train_cgcnn": ["--synthetic", "2", "--ckpt", str(tmp_path / "c")],
            "predict": [str(tmp_path / "a.cif"), "--ckpt", "fe=none"],
            "evaluate": ["--data", str(tmp_path), "--vae-ckpt", "v",
                         "--unet-ckpt", "u"],
            "interpolate": ["--data", str(tmp_path), "--vae-ckpt", "v",
                            "--sweep-conds"],
            "view": ["--data", str(tmp_path), "--vae-ckpt", "v",
                     "--unet-ckpt", "u"]}[app]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


LAUNCHER_ENV = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}


@pytest.mark.parametrize("app", ["train_vae", "train_unet", "train_cgcnn", "voxelize"])
def test_clis_under_a_launcher_refuse_cuda_when_unavailable(app, monkeypatch, tmp_path):
    """Under torchrun's environment the device check comes before any
    rendezvous: no process group is joined."""
    import importlib

    for var, value in LAUNCHER_ENV.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"icsg3d_torch.apps.{app}")
    argv = {"train_vae": ["--data", str(tmp_path)],
            "train_unet": ["--data", str(tmp_path)],
            "train_cgcnn": ["--synthetic", "2", "--ckpt", str(tmp_path / "c")],
            "voxelize": ["--synthetic", "2", "--out", str(tmp_path / "x")]}[app]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not torch.distributed.is_initialized()


def test_cuda_under_a_launcher_is_the_local_rank_card(monkeypatch):
    """``--device cuda`` is cuda:$LOCAL_RANK under a launcher, and raises
    where that card is not visible instead of stacking ranks on one."""
    for var, value in LAUNCHER_ENV.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tcommon.resolve_device("cuda") == torch.device("cuda", 1)
    assert tcommon.resolve_devices("cuda") == (torch.device("cuda", 1),
                                               [torch.device("cuda", 1)])
    assert tcommon.resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        tcommon.resolve_device("cuda")


def test_train_cgcnn_batch_must_split_over_the_data_axis(monkeypatch, capsys):
    """JAX's message (apps/train_cgcnn.py:136-141), counting every
    process's device on the data axis."""
    from icsg3d_torch.apps import train_cgcnn
    from icsg3d_torch.parallel import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(SystemExit):
        train_cgcnn.main(["--synthetic", "4", "--batch-size", "3", "--epochs", "0",
                          "--device", "cpu", "--ckpt", "unused"])
    assert ("--batch-size 3 must be divisible by the data mesh axis (2 devices)"
            in capsys.readouterr().err)
