"""The resident epoch programs (``--epoch-scan``, train/graphs.py) on the CPU,
against the JAX package's whole-epoch ``lax.scan`` and the port's own
per-step resident path, in f32 at d = 8.

- ``make_vae_epoch_fns`` (eager on the CPU, through the programs' static
  buffers) against JAX's ``make_vae_epoch_fns`` over two epochs of two
  train steps and two val batches (8 samples, batch 4, lr 1e-3), on the
  same converted variables, the same host permutations and the JAX scan's
  own noise, rebuilt on the host from its key structure (``key, sub =
  split(key)`` per step, then ``normal(sub, (B, latent))``), with the
  DFC U-Net, with the cached true-side features and without a U-Net; the
  same for ``make_unet_epoch_fns`` with and without class weights.  The
  bounds are the per-step parity tests' (tests/test_torch_train.py,
  tests/test_torch_unet_train.py): every metric mean rtol 1e-4, the
  parameters 1e-6 (Adam's bound from gradients within the per-step
  bounds), BatchNorm statistics 1e-5, Adam's first moments as gradients
  (atol 1e-5, rtol 1e-3), second moments rtol 1e-3.  The VAE's conv
  biases that feed a training BatchNorm have a true gradient of 0 and a
  computed one of rounding noise, which Adam turns into +-lr steps of
  random sign in either framework (a random walk of up to 4e-3 over the
  four steps, and through the running means a val loss off by ~1e-3):
  both sides freeze exactly those biases (torch: no gradient; optax:
  ``set_to_zero``), so every other leaf is held to the bounds above.  The
  U-Net trains at lr 1e-7 (as chip_smoke.py's data-parallel phase does):
  its first step's gradients agree within the per-step bounds, but its
  max pools and ReLUs make discrete choices, and at lr 3e-6 (its CLI
  default) the rounding-level difference of the parameters after one
  step already moved Adam's first moments by 2e-3 after the second; at
  1e-7 the parameters stay within rounding, and its gradients (through
  Adam's moments), BatchNorm statistics and metrics are held to the
  bounds above.
- The port's epoch path against its per-step resident path, through
  ``train_vae`` / ``train_unet`` and the CLIs (``--spatial 2`` on
  ``cpu,cpu`` too): histories, parameters, BatchNorm buffers and Adam's
  state bitwise equal; ``--resume`` switching paths between two runs
  gives the same checkpoint as either path alone.
- With a process group (two gloo ranks, as tests/test_torch_distributed.py
  runs them) on the CPU ``epoch_scan`` runs the epoch program, prints no
  refusal line and gives the per-step path's values and state bitwise
  (tests/test_torch_epoch_distributed.py holds it against JAX);
  ``capture_refusal`` for a gloo group on a CUDA model and a mesh on two
  devices, none for an NCCL group; ``EpochProgram`` unit behaviour (rows,
  noise, counter, layout, rebinding).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icsg3d_torch import weights
from icsg3d_torch.apps import train_unet as tunet_app
from icsg3d_torch.apps import train_vae as tvae_app
from icsg3d_torch.apps import voxelize as tvox_app
from icsg3d_torch.parallel.mesh import Mesh
from icsg3d_torch.train import graphs
from icsg3d_torch.train import unet as tunet
from icsg3d_torch.train import vae as tvae
from icsg3d_torch.train.state import TrainState
from icsg3d_tpu.train import unet as junet
from icsg3d_tpu.train import vae as jvae
from icsg3d_tpu.train.state import ModelState
from test_torch_distributed import REPO, run_ranks
from test_torch_models import UNET_KW
from test_torch_train import CLI as VAE_CLI
from test_torch_train import LR, VAE_KW, _batch, _unet_pair, _vae_pair, _write_dataset
from test_torch_unet_train import CLASS_WEIGHTS, NC, _pair, _raw_batch

torch.set_num_threads(1)

N, B, EPOCHS = 8, 4, 2
LATENT = VAE_KW["latent_dim"]
STEPS = N // B
# the VAE's conv biases that feed a training BatchNorm (true gradient 0):
# the encoder's and decoder's block convs and the decoder's output conv
ZERO_GRADIENT_BIASES = {"encoder.Conv_0.bias", "encoder.Conv_1.bias",
                        "decoder.Conv_0.bias", "decoder.Conv_1.bias",
                        "decoder.decoder_output.bias"}
# the U-Net's learning rate here (module note)
UNET_LR = 1e-7


def _vae_split():
    b = _batch(n=N, seed=3)
    abc = np.random.default_rng(1).uniform(3.0, 7.0, (N, 3)).astype(np.float32)
    return {"density": b["density"], "abc": abc, "cond": b["cond"]}


def _perm(epoch):
    return np.random.default_rng((3, epoch)).permutation(N).reshape(STEPS, B)


def _jax_noise(key, n):
    """The noise of the next ``n`` steps of a scan carrying ``key``."""
    rows = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.normal(sub, (B, LATENT))))
    return np.stack(rows)


def _frozen_adam(params, frozen):
    """optax.adam on every leaf but those named in ``frozen``, which stay."""
    def label(path, _):
        name = ".".join(str(getattr(p, "key", p)) for p in path)
        return "frozen" if name in frozen else "adam"

    labels = jax.tree_util.tree_map_with_path(label, params)
    return optax.multi_transform({"adam": optax.adam(LR), "frozen": optax.set_to_zero()},
                                 labels)


def _assert_means(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-4, atol=1e-7,
                                   err_msg=f"{what} {k}")


def _assert_state_matches_jax(state, jstate, adam_state):
    flat = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    mu = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": adam_state.mu}))
    nu = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": adam_state.nu}))
    for name, p in state.model.named_parameters():
        key = weights.flax_key(name)
        np.testing.assert_allclose(p.detach().numpy(), flat[key], atol=1e-6, rtol=0,
                                   err_msg=name)
        st = state.optimizer.state[p]
        if not p.requires_grad:
            assert not st, name
            continue
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[key], atol=1e-5, rtol=1e-3,
                                   err_msg=f"mu {name}")
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[key], atol=1e-9,
                                   rtol=1e-3, err_msg=f"nu {name}")
    for name, t in state.model.named_buffers():
        np.testing.assert_allclose(t.numpy(), flat[weights.flax_key(name)], atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert state.step == int(jstate.step) == EPOCHS * STEPS


@pytest.mark.parametrize("perceptual", ["dfc", "dfc_cached", "no_unet"])
def test_vae_epoch_fns_match_jax(perceptual):
    jmodel, jvars, port = _vae_pair(0.0)
    junet_m, juvars, t_unet = (_unet_pair(UNET_KW, seed=5) if perceptual != "no_unet"
                               else (None, None, None))
    data = _vae_split()
    tx = _frozen_adam(jvars["params"], ZERO_GRADIENT_BIASES)
    jstate = ModelState.create(jmodel.apply, jvars, tx)
    jtrain, jval = jvae.make_vae_epoch_fns(jmodel, junet_m, juvars)
    for name, p in port.named_parameters():
        p.requires_grad_(name not in ZERO_GRADIENT_BIASES)
    state = TrainState.create(port, LR)
    train_epoch, val_epoch = tvae.make_vae_epoch_fns(port, t_unet)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    if perceptual == "dfc_cached":
        tdata.update(tvae.precompute_true_features(port, t_unet, tdata, B))
    val_rows = np.arange(N).reshape(STEPS, B)
    key = jax.random.key(11)
    for epoch in range(EPOCHS):
        perm = _perm(epoch)
        noise = _jax_noise(key, STEPS)
        jstate, key, jm = jtrain(jstate, data, key, jnp.asarray(perm, jnp.int32))
        val_noise = _jax_noise(key, STEPS)
        key, jvm = jval(jstate, data, key, jnp.asarray(val_rows, jnp.int32))
        tm = train_epoch.means(train_epoch(
            state, tdata, torch.from_numpy(perm), torch.from_numpy(noise)).numpy())
        vm = val_epoch.means(val_epoch(
            state, tdata, torch.from_numpy(val_rows), torch.from_numpy(val_noise)).numpy())
        _assert_means(tm, jax.tree_util.tree_map(float, jm), f"epoch {epoch} train")
        _assert_means(vm, jax.tree_util.tree_map(float, jvm), f"epoch {epoch} val")
        if perceptual == "no_unet":
            assert tm["perceptual"] == 0.0
    _assert_state_matches_jax(state, jstate,
                              jstate.opt_state.inner_states["adam"].inner_state[0])


@pytest.mark.parametrize("cw", [CLASS_WEIGHTS, None], ids=["weighted", "unweighted"])
def test_unet_epoch_fns_match_jax(cw):
    jmodel, jvars, port = _pair()
    data = tunet.prepare_unet_batch(_raw_batch(n=N, seed=4), NC, device_coords=True)
    jstate = ModelState.create(jmodel.apply, jvars, optax.adam(UNET_LR))
    jtrain, jval = junet.make_unet_epoch_fns(jmodel, cw)
    state = TrainState.create(port, UNET_LR)
    train_epoch, val_epoch = tunet.make_unet_epoch_fns(port, cw)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    val_rows = np.arange(N).reshape(STEPS, B)
    for epoch in range(EPOCHS):
        perm = _perm(epoch)
        jstate, jm = jtrain(jstate, data, jnp.asarray(perm, jnp.int32))
        jvm = jval(jstate, data, jnp.asarray(val_rows, jnp.int32))
        tm = train_epoch.means(train_epoch(state, tdata, torch.from_numpy(perm)).numpy())
        vm = val_epoch.means(val_epoch(state, tdata, torch.from_numpy(val_rows)).numpy())
        for got, want, what in ((tm, jm, "train"), (vm, jvm, "val")):
            want = {k: np.asarray(v, np.float64).tolist() for k, v in want.items()}
            _assert_means(got, want, f"epoch {epoch} {what}")
            folded = tunet._fold_per_class_ce(dict(got))
            assert len(folded["ce_per_class"]) == NC
            assert sum(got["class_count"]) == pytest.approx(B * 8 ** 3)
    _assert_state_matches_jax(state, jstate, jstate.opt_state[0])


def _resident():
    data = _vae_split()
    return data, {k: v[:B] for k, v in data.items()}


def _state_arrays(state):
    return {k: v.copy() for k, v in state.arrays().items()}


def _assert_same_run(a, b):
    (sa, ha), (sb, hb) = a, b
    assert ha == [dict(h, time=g["time"]) for h, g in zip(hb, ha)]
    fa, fb = _state_arrays(sa), _state_arrays(sb)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("case", ["vae", "vae_cached", "vae_remat", "unet"])
def test_epoch_path_equals_per_step_path(case):
    """train_vae / train_unet with epoch_scan against the per-step resident
    loop from the same state: bitwise the same histories, parameters,
    BatchNorm buffers, Adam moments and step."""
    runs = []
    for scan in (False, True):
        if case == "unet":
            _, _, port = _pair()
            state = TrainState.create(port, LR)
            data = tunet.prepare_unet_batch(_raw_batch(n=N, seed=4), NC,
                                            device_coords=True)
            runs.append(tunet.train_unet(
                port, state, None, None, EPOCHS, class_weights=CLASS_WEIGHTS,
                log_fn=lambda *_: None, resident_data=(data, data), batch_size=B,
                shuffle_seed=3, epoch_scan=scan))
        else:
            _, _, port = _vae_pair(0.0)
            state = TrainState.create(port, LR)
            t_unet = _unet_pair(UNET_KW, seed=5)[2]
            runs.append(tvae.train_vae(
                port, state, None, None, EPOCHS, unet=t_unet, seed=5,
                remat_perceptual=case == "vae_remat", resident_data=_resident(),
                batch_size=B, shuffle_seed=3,
                cache_true_features=case == "vae_cached", epoch_scan=scan))
    assert [h["steps"] for h in runs[1][1]] == [STEPS] * EPOCHS
    assert runs[1][0].step == EPOCHS * STEPS
    _assert_same_run(*runs)


def test_epoch_program_buffers_and_rebinding():
    """An EpochProgram on a toy step: row i's indices and noise reach step
    i, the metrics land in row i, the host step count advances for a train
    program only, and another split or shape binds new buffers."""
    model = torch.nn.Linear(1, 1)
    state = TrainState.create(model, 0.1)
    seen = []

    def step(st, batch, eps):
        seen.append((batch["x"].clone(), eps.clone()))
        return {"sum": batch["x"].sum() + eps.sum(), "vec": batch["x"].float()}

    data = {"x": torch.arange(10.0) * 10}
    rows = torch.tensor([[3, 1], [0, 9], [4, 4]])
    noise = torch.arange(6.0).reshape(3, 2)
    for train, want_step in ((True, 3), (False, 3)):
        program = graphs.EpochProgram("toy", step, train=train)
        seen.clear()
        buf = program(state, data, rows, noise)
        assert state.step == want_step
        assert buf.shape == (3, 3)
        for i, (x, eps) in enumerate(seen):
            assert x.tolist() == (rows[i] * 10.0).tolist()
            assert eps.tolist() == noise[i].tolist()
        np.testing.assert_array_equal(
            buf.numpy(), [[40.0 + 1, 30, 10], [90.0 + 5, 0, 90], [80.0 + 9, 40, 40]])
        means = program.means(buf.numpy())
        assert means == {"sum": pytest.approx(np.mean([41, 95, 89])),
                         "vec": [pytest.approx(70 / 3), pytest.approx(140 / 3)]}
    bound = program.rows
    program(state, data, rows, noise)
    assert program.rows is bound
    program(state, data, rows[:2], noise[:2])
    assert program.rows is not bound and program.mets.shape == (2, 3)


def test_capture_refusal(monkeypatch):
    """Refused: a mesh on two devices, a gloo group on a CUDA model.  Not
    refused: one device, an NCCL group, any group on a CPU model (its
    program runs eagerly)."""
    model = torch.nn.Linear(1, 1)
    state = TrainState.create(model, 0.1)
    assert graphs.capture_refusal(state) is None
    model.spatial_mesh = Mesh(np.array([[torch.device("cpu")] * 2], dtype=object))
    assert graphs.capture_refusal(state) is None
    model.spatial_mesh = Mesh(np.array([[torch.device("cpu"), torch.device("cuda", 1)]],
                                       dtype=object))
    assert "a mesh on 2 devices" in graphs.capture_refusal(state)
    model.spatial_mesh = None
    state.group = object()
    backends = []
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group: backends.append(group) or "gloo")
    assert graphs.capture_refusal(state) is None  # a CPU model: eager
    # the same group on a CUDA model (the lookup of the lead device patched)
    monkeypatch.setattr(graphs, "_indexed", lambda device: torch.device("cuda", 0))
    assert graphs.capture_refusal(state) == (
        "a gloo process group: it moves CUDA tensors through host memory, which "
        "a CUDA graph cannot capture")
    assert backends == [state.group]
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group: "nccl")
    assert graphs.capture_refusal(state) is None


def _vae_cli_argv(data, ckpt, *extra):
    return ["--data", data, "--nrot", "0", "--ckpt", ckpt, "--resident", *extra] + VAE_CLI


def _read_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_resume_switches_paths(tmp_path):
    """One epoch on one path, then --resume for one epoch on the other:
    latest.npz (parameters, BatchNorm statistics, Adam's moments and step)
    and the history equal those of either path run twice."""
    data = _write_dataset(tmp_path / "data")
    ckpts = {}
    for first, second in ((False, False), (False, True), (True, False), (True, True)):
        ckpt = str(tmp_path / f"ck-{int(first)}{int(second)}")
        for scan, resume in ((first, []), (second, ["--resume"])):
            tvae_app.main(_vae_cli_argv(data, ckpt, "--epochs", "1", *resume,
                                        *(["--epoch-scan"] if scan else [])))
        ckpts[(first, second)] = ckpt
    ref = _read_npz(os.path.join(ckpts[(False, False)], "latest.npz"))
    with open(os.path.join(ckpts[(False, False)], "history.json")) as f:
        ref_hist = [{k: v for k, v in h.items() if k != "time"} for h in json.load(f)]
    assert int(ref["step"]) == 8 and len(ref_hist) == 2
    for key, ckpt in ckpts.items():
        got = _read_npz(os.path.join(ckpt, "latest.npz"))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{key} {k}")
        with open(os.path.join(ckpt, "history.json")) as f:
            assert [{k: v for k, v in h.items() if k != "time"}
                    for h in json.load(f)] == ref_hist, key


@pytest.mark.parametrize("app", ["vae", "unet"])
def test_cli_epoch_scan_on_a_cpu_mesh(tmp_path, app):
    """--spatial 2 on cpu,cpu (one device: the programs run, eagerly here)
    with --epoch-scan equals --resident's per-step loop bitwise."""
    if app == "vae":
        data = _write_dataset(tmp_path / "data")
        argv = (["--data", data, "--nrot", "0", "--epochs", "2", "--resident",
                 "--spatial", "2"] + VAE_CLI[2:] + ["--device", "cpu,cpu"])
        main = tvae_app.main
    else:
        data = str(tmp_path / "data")
        tvox_app.main(["--synthetic", "10", "--kinds", "perovskite,rocksalt", "--nrot",
                       "0", "--d", "8", "--out", data, "--device", "cpu"])
        argv = ["--data", data, "--nrot", "0", "--epochs", "2", "--resident",
                "--spatial", "2", "--batch-size", "4", "--num-classes", "60",
                "--device", "cpu,cpu"]
        main = tunet_app.main
    hists = [main(argv + ["--ckpt", str(tmp_path / f"ck{scan}")]
                  + (["--epoch-scan"] if scan else [])) for scan in (0, 1)]
    for a, b in zip(*hists):
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}
    a = _read_npz(str(tmp_path / "ck0" / "latest.npz"))
    b = _read_npz(str(tmp_path / "ck1" / "latest.npz"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# Two ranks: each trains the tiny VAE and U-Net on its rows of a resident
# split with epoch_scan and without, and saves both histories and states.
RANK_PROGRAM = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from icsg3d_torch import config as tcfg
from icsg3d_torch.parallel import distributed
from icsg3d_torch.train import unet as tunet, vae as tvae

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
group = distributed.initialize("file://" + spec["store"], 2, rank, backend="gloo",
                               timeout=60)
with np.load(spec["data"]) as f:
    d = {k: f[k] for k in f.files}
vae_data = {k: d[k] for k in ("density", "abc", "cond")}
unet_data = {k: d[k] for k in ("density", "abc", "labels")}
out, arrays = {}, {}
for scan in (False, True):
    cfg = tcfg.VAEConfig(grid=tcfg.GridSpec(d=8), filters=(4, 8), latent_dim=8,
                         dtype="float32")
    state = tvae.create_vae_state(cfg, 1e-3, 0, "cpu", group=group)
    _, hist = tvae.train_vae(state.model, state, None, None, 2, seed=5,
                             resident_data=(vae_data, vae_data), batch_size=4,
                             shuffle_seed=3, epoch_scan=scan)
    out[f"vae{int(scan)}"] = [{k: v for k, v in h.items() if k != "time"} for h in hist]
    arrays.update({f"vae{int(scan)}/{k}": v for k, v in state.arrays().items()})
    ucfg = tcfg.UNetConfig(num_classes=12, enc_filters=((4, 8), (8, 8), (8, 16)),
                           bottom_filters=(16, 16), dec_filters=((16, 8), (8, 8), (8, 8)),
                           dtype="float32")
    state = tunet.create_unet_state(ucfg, 1e-3, 0, "cpu", group=group)
    _, hist = tunet.train_unet(state.model, state, None, None, 2,
                               resident_data=(unet_data, unet_data), batch_size=4,
                               shuffle_seed=3, epoch_scan=scan)
    out[f"unet{int(scan)}"] = [{k: v for k, v in h.items() if k != "time"} for h in hist]
    arrays.update({f"unet{int(scan)}/{k}": v for k, v in state.arrays().items()})
with open(f"{spec['dir']}/rank{rank}.json", "w") as f:
    json.dump(out, f)
np.savez(f"{spec['dir']}/rank{rank}.npz", **arrays)
distributed.shutdown()
"""


def test_process_group_keeps_the_per_step_loop(tmp_path):
    """With a gloo group on the CPU epoch_scan runs the epoch program
    (eagerly): no rank prints a refusal line, and each trains exactly as
    the per-step resident loop, histories and state bitwise."""
    vae = _vae_split()
    unet = tunet.prepare_unet_batch(_raw_batch(n=N, seed=4), NC, device_coords=True)
    np.savez(tmp_path / "data.npz", density=vae["density"], abc=vae["abc"],
             cond=vae["cond"], labels=unet["labels"])
    spec = json.dumps({"store": str(tmp_path / "store"), "dir": str(tmp_path),
                       "data": str(tmp_path / "data.npz")})
    outs = run_ranks(RANK_PROGRAM, [spec], 2, REPO)
    for r, (stdout, _) in enumerate(outs):
        assert not [ln for ln in stdout.splitlines() if ln.startswith("--epoch-scan")], \
            stdout
        with open(tmp_path / f"rank{r}.json") as f:
            got = json.load(f)
        states = _read_npz(tmp_path / f"rank{r}.npz")
        for model in ("vae", "unet"):
            assert got[f"{model}1"] == got[f"{model}0"], (r, model)
            assert [h["steps"] for h in got[f"{model}0"]] == [STEPS] * EPOCHS
            per_step = {k[len(model) + 2:]: v for k, v in states.items()
                        if k.startswith(f"{model}0/")}
            assert per_step and int(per_step["step"]) == EPOCHS * STEPS
            for k, v in per_step.items():
                np.testing.assert_array_equal(states[f"{model}1/{k}"], v,
                                              err_msg=f"rank {r} {model} {k}")
