"""The port's plotting module (icsg3d_torch/viz.py) and the plots rule, on
the CPU.

viz.py is the JAX module's code with a lazy matplotlib import
(tests/test_torch_guards.py holds the text).  Here:

- every plot function writes a valid PNG (GIF for the animation) on tiny
  inputs, the 3D renders at resample_d <= 6;
- ``save_eval_plots`` writes the same files as JAX's on the same results,
  with lattices, without, and with non-finite EMDs;
- ``evaluate --plots`` writes them from the CLI;
- with matplotlib blocked (a subprocess, as test_torch_guards' NO_JAX):
  ``import icsg3d_torch.viz`` and every CLI import succeed, a plot call
  raises an ImportError naming matplotlib, both trainers print
  ``plots skipped: matplotlib is not installed`` once and still write
  history.json (and no plot), interpolate writes its strips and
  sweep.json; and (matplotlib blocked in the process) ``interpolate
  --voxels`` and ``view --voxels`` exit with rc 2 naming matplotlib,
  before any model loads.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import viz
from icsg3d_torch.apps import evaluate as teval
from icsg3d_tpu.apps import evaluate as jeval

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PNG = b"\x89PNG\r\n\x1a\n"

_rng = np.random.default_rng(0)
GRID = _rng.random((6, 6, 6, 4)).astype(np.float32)
LABELS = np.where(GRID[..., 0] > 0.6, _rng.integers(1, 30, (6, 6, 6)), 0)

PLOTS = {
    "plot_slices": lambda p: viz.plot_slices(GRID, p, n_slices=3),
    "plot_real_vs_pred": lambda p: viz.plot_real_vs_pred(GRID[None], GRID[None] * 0.5, p),
    "plot_interpolation": lambda p: viz.plot_interpolation(np.stack([GRID] * 3), p),
    "plot_voxels_3d": lambda p: viz.plot_voxels_3d(GRID, p, resample_d=4),
    "plot_voxels_duo": lambda p: viz.plot_voxels_duo(GRID[..., 0], GRID[..., 1], p,
                                                     resample_d=4),
    "plot_tsne_thumbnails": lambda p: viz.plot_tsne_thumbnails(
        _rng.random((2, 3)), np.stack([GRID] * 2), p),
    "plot_points_3d": lambda p: viz.plot_points_3d(LABELS, p),
    "plot_losses": lambda p: viz.plot_losses([3.0, 2.0, 1.5], [3.5, 2.5, 2.0], p),
    "plot_latent_kde": lambda p: viz.plot_latent_kde(_rng.standard_normal((12, 4)), p),
    "plot_latent_tsne": lambda p: viz.plot_latent_tsne(_rng.random((2, 3)), p),
    "plot_parity": lambda p: viz.plot_parity(np.arange(5.0), np.arange(5.0) + 0.1, p,
                                             label="a"),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_writes_a_png(tmp_path, name):
    path = tmp_path / f"{name}.png"
    PLOTS[name](str(path))
    assert path.read_bytes()[:8] == PNG


def test_slice_animation_writes_a_gif(tmp_path):
    path = tmp_path / "anim.gif"
    viz.save_slice_animation(GRID, GRID[:5, :5, :5], str(path), fps=10)
    assert path.read_bytes()[:6] in (b"GIF87a", b"GIF89a")


def test_every_jax_plot_function_is_ported():
    import inspect

    from icsg3d_tpu import viz as jviz

    names = {n for n, f in vars(jviz).items()
             if inspect.isfunction(f) and f.__module__ == jviz.__name__}
    assert names <= set(vars(viz))
    assert {n for n in names if n.startswith(("plot_", "save_"))} == \
        set(PLOTS) | {"save_slice_animation"}


RESULTS = {
    "lattice": {"lattice_true": [[4.0, 4.1, 4.2], [5.0, 5.5, 6.0], [3.0, 3.1, 3.2]],
                "lattice_pred": [[4.2, 4.0, 4.4], [5.1, 5.0, 6.3], [3.3, 3.0, 3.0]],
                "emds": [0.4, float("nan"), 1.2]},
    "empty": {"lattice_true": [], "lattice_pred": [], "emds": []},
    "emds_only": {"emds": [0.1, 0.2]},
}


@pytest.mark.parametrize("case", sorted(RESULTS))
def test_save_eval_plots_writes_the_jax_files(tmp_path, case):
    jeval.save_eval_plots(RESULTS[case], str(tmp_path / "jax"))
    teval.save_eval_plots(RESULTS[case], str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert all((tmp_path / "port" / f).read_bytes()[:8] == PNG for f in files)
    if case == "lattice":
        assert files == sorted([f"{k}_{a}.png" for k in ("parity", "err_hist")
                                for a in "abc"] + ["emd_hist.png"])


def test_evaluate_cli_writes_its_plots(tmp_path, capsys):
    from icsg3d_torch.data.synthetic import build_dataset

    build_dataset(str(tmp_path / "data"), n=10, seed=1,
                  cfg=tcfg.VoxelizerConfig(grid=tcfg.GridSpec(d=8)),
                  kinds=("perovskite", "rocksalt"), device="cpu")
    res = teval.main(["--data", str(tmp_path / "data"), "--vae-ckpt", "none",
                      "--unet-ckpt", "none", "--filters", "4,8", "--latent", "8",
                      "--num-classes", "12", "--batch-size", "2", "--device", "cpu",
                      "--plots", str(tmp_path / "plots")])
    capsys.readouterr()
    files = set(os.listdir(tmp_path / "plots"))
    if res["lattice_true"]:
        assert {f"parity_{a}.png" for a in "abc"} <= files
    if res["emds"]:
        assert "emd_hist.png" in files


NO_MPL = """
import sys
sys.modules["matplotlib"] = None
import contextlib, io, json, os
import numpy as np
import torch
torch.set_num_threads(1)
import icsg3d_torch.viz as viz
import icsg3d_torch.apps.evaluate, icsg3d_torch.apps.generate
import icsg3d_torch.apps.interpolate as ti
import icsg3d_torch.apps.predict, icsg3d_torch.apps.query
import icsg3d_torch.apps.train_cgcnn, icsg3d_torch.apps.train_unet as tu
import icsg3d_torch.apps.train_vae as tv, icsg3d_torch.apps.view
import icsg3d_torch.apps.voxelize, icsg3d_torch.utils.profiling
assert not viz.available()
try:
    viz.plot_losses([1.0], [1.0], "x.png")
    raise SystemExit("a plot call drew without matplotlib")
except ImportError as e:
    assert "matplotlib" in str(e), e
from icsg3d_torch.data.store import GridDataset
tmp = sys.argv[1]
d = 8
g = np.mgrid[:d, :d, :d].astype(np.float32)
density = np.exp(-((g - 4.0) ** 2).sum(0) / 2.0)[None].repeat(6, 0)
GridDataset.write(tmp + "/train", [f"p{i}" for i in range(6)], {
    "density": density, "lattice": np.full((6, 6), 4.0, np.float32),
    "coords": np.moveaxis(g, 0, -1)[None].repeat(6, 0) * 0.5,
    "target": np.arange(6, dtype=np.float32)})
out = io.StringIO()
with contextlib.redirect_stdout(out):
    hist = tv.main(["--data", tmp + "/train", "--nrot", "0", "--epochs", "2",
                    "--filters", "4,8", "--latent", "8", "--batch-size", "1",
                    "--device", "cpu", "--ckpt", tmp + "/vae"])
assert len(hist) == 2 and out.getvalue().count(viz.PLOTS_SKIPPED) == 1, out.getvalue()
files = set(os.listdir(tmp + "/vae"))
assert "history.json" in files and not {"loss.png", "plots"} & files, files
import icsg3d_torch.apps.voxelize as vx
vx.main(["--synthetic", "4", "--kinds", "perovskite,rocksalt", "--d", "8",
         "--nrot", "0", "--out", tmp + "/vox", "--device", "cpu"])
out = io.StringIO()
with contextlib.redirect_stdout(out):
    hist = tu.main(["--data", tmp + "/vox", "--nrot", "0", "--epochs", "1",
                    "--batch-size", "1", "--num-classes", "12", "--device", "cpu",
                    "--ckpt", tmp + "/unet"])
assert out.getvalue().count(viz.PLOTS_SKIPPED) == 1, out.getvalue()
files = set(os.listdir(tmp + "/unet"))
assert "history.json" in files and not {"loss.png", "plots"} & files, files
rows, meta = ti.main(["--data", tmp + "/train", "--vae-ckpt", "none", "--sweep-conds",
                      "--cond-bins", "3", "--ninterps", "2", "--filters", "4,8",
                      "--latent", "8", "--device", "cpu", "--output", tmp + "/interp"])
assert sorted(os.listdir(tmp + "/interp")) == sorted(
    ["sweep.json"] + [f"interpolation_bin{m['bin']}.npy" for m in meta])
print("NO_MPL_OK")
"""


def test_the_port_runs_without_matplotlib(tmp_path):
    proc = subprocess.run([sys.executable, "-c", NO_MPL, str(tmp_path)],
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_MPL_OK" in proc.stdout


@pytest.mark.parametrize("app,argv", [
    ("interpolate", ["--vae-ckpt", "v", "--sweep-conds", "--voxels"]),
    ("view", ["--vae-ckpt", "v", "--unet-ckpt", "u", "--voxels"]),
])
def test_voxels_refuse_without_matplotlib(app, argv, monkeypatch, capsys):
    """The data path does not exist: the refusal comes before any load.
    (evaluate --plots: test_torch_guards.py::test_evaluate_refuses_plots.)"""
    import importlib

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exc:
        importlib.import_module(f"icsg3d_torch.apps.{app}").main(
            ["--data", "nowhere", "--device", "cpu", *argv])
    assert exc.value.code == 2
    assert "--voxels draws plots, and matplotlib is not installed" in \
        capsys.readouterr().err
