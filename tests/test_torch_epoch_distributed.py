"""The resident epoch program (``--epoch-scan``, train/graphs.py) under a
process group, on the CPU: two gloo ranks, each on its block of every
step's global batch, against the port's per-step resident path and the
JAX package's epoch program on a two-device data mesh, in f32 at d = 8.

Two ranks (subprocesses that import no JAX, joined over a ``file://``
store, as tests/test_torch_distributed.py runs them) train from the same
converted variables (icsg3d_torch/weights.py) for two epochs of two steps
of the global batch 4 (8 samples, 2 rows per rank, the split also the
validation split): the VAE without a U-Net, with the DFC U-Net, and with
its cached true-side features, and the U-Net with class weights.  Each
run is made twice, ``epoch_scan`` on and off.  The VAE's noise is JAX's:
the ranks' generator draws are replaced by the global (4, latent) rows
that JAX's ``train_vae`` draws from ``jax.random.key(SEED)`` (one split
per train step and val batch), which also records the shape of every
draw.

- Epoch program against per-step path: every rank's histories, and its
  parameters, BatchNorm buffers, Adam moments and step (``arrays()``),
  bitwise equal; the two paths ask the generator for the same draws (the
  global batch's rows at every step, not the rows of the global batch
  times the world); no ``--epoch-scan`` refusal line; both ranks hold the
  same state.
- Against JAX's ``train_vae(..., epoch_scan=True, mesh=make_mesh(n_data=2))``
  and ``train_unet(...)``: the bounds of tests/test_torch_epoch.py, tighter
  than tests/test_train.py's epoch-scan test: every metric mean rtol 1e-4,
  parameters atol 1e-6, BatchNorm statistics 1e-5, Adam's first moments
  atol 1e-5 rtol 1e-3, second moments rtol 1e-3.  As there, the VAE's
  conv biases that feed a training BatchNorm (true gradient 0, Adam walks
  their rounding noise) are frozen on both sides, and the U-Net trains at
  lr 1e-7.
- ``graphs.epoch_rows``: rank r's block of an epoch's rows is what JAX's
  ``P(None, "data")`` puts on data device r, for W = 2 and 4, and each of
  its rows is the block ``shard_batch`` gives that step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from icsg3d_torch import weights
from icsg3d_torch.parallel import mesh as tmesh
from icsg3d_torch.train import graphs
from icsg3d_torch.train import unet as tunet
from icsg3d_tpu.parallel.mesh import make_mesh, shard_batch
from icsg3d_tpu.train import unet as junet
from icsg3d_tpu.train import vae as jvae
from icsg3d_tpu.train.state import ModelState
from test_torch_distributed import REPO, run_ranks
from test_torch_epoch import (B, EPOCHS, LATENT, N, STEPS, UNET_LR, ZERO_GRADIENT_BIASES,
                              _assert_means, _frozen_adam, _vae_split)
from test_torch_models import UNET_KW
from test_torch_train import LR, VAE_KW, _unet_pair, _vae_pair
from test_torch_unet_train import CLASS_WEIGHTS, NC, _pair, _raw_batch

torch.set_num_threads(1)

WORLD = 2
SEED = 11
SHUFFLE = 3
CASES = ("vae", "vae_dfc", "vae_dfc_cached", "unet")

# One rank: every case with epoch_scan off and on, from the converted
# variables, with JAX's noise in place of the generator's draws.
RANK_PROGRAM = r"""
import contextlib, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from icsg3d_torch import config as tcfg, weights
from icsg3d_torch.models import ConditionalDFCVAE, UNet3D
from icsg3d_torch.parallel import distributed
from icsg3d_torch.train import unet as tunet, vae as tvae
from icsg3d_torch.train.state import TrainState

def tup(v):
    return tuple(tup(x) for x in v) if isinstance(v, list) else v

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
group = distributed.initialize("file://" + spec["store"], spec["world"], rank,
                               backend="gloo", timeout=60)
d = spec["dir"]
with np.load(f"{d}/data.npz") as f:
    data = {k: f[k] for k in f.files}
with np.load(f"{d}/noise.npz") as f:
    jax_noise = f["noise"]
vae_data = {k: data[k] for k in ("density", "abc", "cond")}
unet_data = {k: data[f"unet_{k}"] for k in ("density", "abc", "labels")}

@contextlib.contextmanager
def jax_draws(draws):
    # the generator's draws replaced by JAX's global rows, in order
    real = torch.randn

    def randn(size, *args, generator=None, **kwargs):
        if generator is None:
            return real(size, *args, **kwargs)
        draws.append(list(size))
        if tuple(size) != jax_noise.shape[1:]:  # another draw: the test says so
            return real(size, *args, generator=generator, **kwargs)
        return torch.from_numpy(jax_noise[len(draws) - 1])

    torch.randn = randn
    try:
        yield
    finally:
        torch.randn = real

def loaded(model, name):
    weights.load_flax_variables(model, weights.load_npz(f"{d}/{name}.npz"))
    return model

def run(case, scan, draws):
    if case == "unet":
        model = loaded(UNet3D(tcfg.UNetConfig(**tup(spec["unet_kw"])),
                              torch.Generator().manual_seed(0), group=group), "unet_vars")
        state = TrainState.create(model, spec["unet_lr"], group)
        _, hist = tunet.train_unet(
            model, state, None, None, spec["epochs"],
            class_weights=np.asarray(spec["class_weights"], np.float32),
            resident_data=(unet_data, unet_data), batch_size=spec["batch"],
            shuffle_seed=spec["shuffle"], epoch_scan=scan)
    else:
        cfg = tcfg.VAEConfig(grid=tcfg.GridSpec(d=8), **tup(spec["vae_kw"]))
        model = loaded(ConditionalDFCVAE(cfg, torch.Generator().manual_seed(0),
                                         group=group), "vae_vars")
        for name, p in model.named_parameters():
            p.requires_grad_(name not in spec["frozen"])
        state = TrainState.create(model, spec["lr"], group)
        dfc = None
        if case != "vae":
            dfc = loaded(UNet3D(tcfg.UNetConfig(**tup(spec["dfc_kw"])),
                                torch.Generator().manual_seed(0)).eval(), "dfc_vars")
        with jax_draws(draws):
            _, hist = tvae.train_vae(
                model, state, None, None, spec["epochs"], unet=dfc,
                resident_data=(vae_data, vae_data), batch_size=spec["batch"],
                shuffle_seed=spec["shuffle"],
                cache_true_features=case == "vae_dfc_cached", epoch_scan=scan)
    return state, hist

out, arrays = {}, {}
for case in spec["cases"]:
    for scan in (False, True):
        tag, draws = f"{case}/{int(scan)}", []
        try:  # every rank fails alike, and the next case runs
            state, hist = run(case, scan, draws)
        except Exception as e:
            out[tag] = {"error": repr(e), "draws": draws}
            continue
        out[tag] = {"history": [{k: v for k, v in h.items() if k != "time"}
                                for h in hist], "draws": draws}
        for k, v in state.arrays().items():
            arrays[f"{tag}/{k}"] = v
with open(f"{d}/rank{rank}.json", "w") as f:
    json.dump(out, f)
np.savez(f"{d}/rank{rank}.npz", **arrays)
distributed.shutdown()
"""


def _jax_noise_rows(n):
    """The global (B, latent) noise of JAX's first ``n`` train steps and val
    batches from ``jax.random.key(SEED)``: one split per step."""
    key, rows = jax.random.key(SEED), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.normal(sub, (B, LATENT))))
    return np.stack(rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's runs and what each rank saw."""
    tmp = tmp_path_factory.mktemp("epoch_dp")
    vae_model, vae_vars, _ = _vae_pair(0.0)
    dfc_model, dfc_vars, _ = _unet_pair(UNET_KW, seed=5)
    unet_model, unet_vars, _ = _pair()
    vae = _vae_split()
    unet = tunet.prepare_unet_batch(_raw_batch(n=N, seed=4), NC, device_coords=True)
    np.savez(tmp / "data.npz", **vae, **{f"unet_{k}": v for k, v in unet.items()})
    np.savez(tmp / "noise.npz", noise=_jax_noise_rows(2 * STEPS * EPOCHS))
    for name, variables in (("vae_vars", vae_vars), ("dfc_vars", dfc_vars),
                            ("unet_vars", unet_vars)):
        weights.save_npz(str(tmp / f"{name}.npz"), variables)
    spec = {"store": str(tmp / "store"), "world": WORLD, "dir": str(tmp),
            "cases": list(CASES), "epochs": EPOCHS, "batch": B, "shuffle": SHUFFLE,
            "lr": LR, "unet_lr": UNET_LR, "vae_kw": VAE_KW, "dfc_kw": UNET_KW,
            "unet_kw": UNET_KW, "class_weights": CLASS_WEIGHTS.tolist(),
            "frozen": sorted(ZERO_GRADIENT_BIASES)}
    outs = run_ranks(RANK_PROGRAM, [json.dumps(spec)], WORLD, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            got = json.load(f)
        with np.load(tmp / f"rank{r}.npz") as f:
            arrays = {k: f[k] for k in f.files}
        ranks.append((got, arrays, outs[r][0]))

    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    kw = dict(mesh=mesh, log_fn=lambda *_: None, resident_data=None, batch_size=B,
              shuffle_seed=SHUFFLE, epoch_scan=True)
    jax_runs = {}
    for case in CASES:
        if case == "unet":
            state = ModelState.create(unet_model.apply, unet_vars, optax.adam(UNET_LR))
            state, hist = junet.train_unet(
                unet_model, state, None, None, EPOCHS, class_weights=CLASS_WEIGHTS,
                **dict(kw, resident_data=(unet, unet)))
            jax_runs[case] = (state, state.opt_state[0], hist)
        else:
            tx = _frozen_adam(vae_vars["params"], ZERO_GRADIENT_BIASES)
            state = ModelState.create(vae_model.apply, vae_vars, tx)
            dfc = {} if case == "vae" else dict(unet=dfc_model, unet_variables=dfc_vars)
            state, hist = jvae.train_vae(
                vae_model, state, None, None, EPOCHS, seed=SEED,
                cache_true_features=case == "vae_dfc_cached",
                **dfc, **dict(kw, resident_data=(vae, vae)))
            jax_runs[case] = (state, state.opt_state.inner_states["adam"].inner_state[0],
                              hist)
    return ranks, jax_runs


def _run(rank, case, scan):
    got, arrays, _ = rank
    prefix = f"{case}/{int(scan)}/"
    return got[f"{case}/{int(scan)}"], {k[len(prefix):]: v for k, v in arrays.items()
                                        if k.startswith(prefix)}


@pytest.mark.parametrize("case", CASES)
def test_epoch_scan_under_a_group_equals_the_per_step_path(runs, case):
    """Bitwise (histories, parameters, BatchNorm buffers, Adam's moments
    and step), the same generator draws, no refusal line, and the ranks
    agree."""
    ranks, _ = runs
    for r, rank in enumerate(ranks):
        assert not [ln for ln in rank[2].splitlines() if ln.startswith("--epoch-scan")]
        (h0, a0), (h1, a1) = _run(rank, case, False), _run(rank, case, True)
        assert "error" not in h0 and "error" not in h1, (r, h0.get("error"), h1.get("error"))
        assert h1["history"] == h0["history"], (r, case)
        assert [h["steps"] for h in h1["history"]] == [STEPS] * EPOCHS
        want_draws = [] if case == "unet" else [[B, LATENT]] * (2 * STEPS * EPOCHS)
        assert h0["draws"] == h1["draws"] == want_draws, (r, case)
        assert a0.keys() == a1.keys() and int(a1["step"]) == EPOCHS * STEPS
        for k in a0:
            np.testing.assert_array_equal(a1[k], a0[k], err_msg=f"rank {r} {case} {k}")
    first = _run(ranks[0], case, True)[1]
    for k, v in _run(ranks[1], case, True)[1].items():
        np.testing.assert_array_equal(v, first[k], err_msg=f"ranks differ: {case} {k}")


@pytest.mark.parametrize("case", CASES)
def test_epoch_scan_under_a_group_matches_jax_data_mesh(runs, case):
    """Rank 0's epoch-scan run against JAX's on a two-device data mesh."""
    ranks, jax_runs = runs
    hist, flat = _run(ranks[0], case, True)
    assert "error" not in hist, hist["error"]
    jstate, adam, jhist = jax_runs[case]
    assert len(hist["history"]) == len(jhist) == EPOCHS
    for e, (got, want) in enumerate(zip(hist["history"], jhist)):
        for split in ("train", "val"):
            _assert_means(got[split], jax.tree_util.tree_map(
                lambda v: np.asarray(v, np.float64).tolist(), want[split]),
                f"{case} epoch {e} {split}")
    jflat = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    mu = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": adam.mu}))
    nu = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": adam.nu}))
    frozen = set() if case == "unet" else {weights.flax_key(n) for n in ZERO_GRADIENT_BIASES}
    params = [k for k in jflat if k.startswith("params/")]
    assert params and set(jflat) <= set(flat)
    for key in params:
        np.testing.assert_allclose(flat[key], jflat[key], atol=1e-6, rtol=0, err_msg=key)
        if key in frozen:  # no moments on either side
            continue
        np.testing.assert_allclose(flat[f"opt_state/mu/{key}"], mu[key], atol=1e-5,
                                   rtol=1e-3, err_msg=f"mu {key}")
        np.testing.assert_allclose(flat[f"opt_state/nu/{key}"], nu[key], atol=1e-9,
                                   rtol=1e-3, err_msg=f"nu {key}")
    for key in (k for k in jflat if k.startswith("batch_stats/")):
        np.testing.assert_allclose(flat[key], jflat[key], atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    assert int(flat["step"]) == int(jstate.step) == EPOCHS * STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_epoch_rows_are_jax_data_blocks(world, monkeypatch):
    """Rank r's block of an epoch's (n_steps, B) rows is what JAX's
    ``P(None, "data")`` puts on data device r, and its row i is the block
    ``shard_batch`` puts there at step i (the rank's place in the group
    patched in)."""
    mesh = make_mesh(n_data=world, devices=jax.devices()[:world])
    order = np.random.default_rng(world).permutation(3 * 8 + 5).astype(np.int32)
    perm = order[:3 * 8].reshape(3, 8)
    placed = jax.device_put(perm, NamedSharding(mesh, PartitionSpec(None, "data")))
    blocks = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    assert graphs.epoch_rows(order, 3, 8, "cpu").tolist() == perm.tolist()
    monkeypatch.setattr(tmesh, "group_size", lambda group: world)
    for r in range(world):
        monkeypatch.setattr(tmesh, "group_rank", lambda group, r=r: r)
        mine = graphs.epoch_rows(order, 3, 8, "cpu", group=object())
        assert mine.dtype == torch.int64
        device = mesh.devices[r, 0]
        np.testing.assert_array_equal(mine.numpy(), blocks[device])
        for i, row in enumerate(perm):
            step = {s.device: np.asarray(s.data)
                    for s in shard_batch(row, mesh).addressable_shards}
            np.testing.assert_array_equal(mine[i].numpy(), step[device])
    with pytest.raises(ValueError, match="does not split"):
        graphs.epoch_rows(order, 3, 6 if world == 4 else 5, "cpu", group=object())
