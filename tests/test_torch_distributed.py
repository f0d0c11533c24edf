"""Data parallelism across processes (icsg3d_torch/parallel/distributed.py)
against the JAX package's data mesh axis, on the CPU.

Two gloo ranks, each a subprocess that imports no JAX, join a process
group over a ``file://`` store in the test's tmp_path (so parallel test
workers never share a port) and run one train step of the port's VAE,
U-Net and CGCNN on their halves of one global batch.  Each is held against
JAX's step on ``make_mesh(n_data=2)`` with ``shard_batch``, on the
conftest's virtual CPU devices (the pattern of tests/test_train.py), with
the port's single-process step tolerances (tests/test_torch_train.py):
losses and metrics rtol 1e-4; gradients atol 1e-5, rtol 1e-3; BatchNorm
statistics 1e-5.  The U-Net's ratio metrics (f1, weighted recall) and
per-class CE are checked against JAX's; the CGCNN batch puts its exact
zeros unevenly across the halves, so the global count_nonzero quirks
decide the result.  The two ranks' gradients, parameters after Adam and
BatchNorm statistics are bitwise equal.

Unit tests: ``all_reduce_sum`` and its gradient, ``process_shard`` and
``shard_batch`` against JAX's striding and row blocks, ``initialize()`` a
no-op without a launcher, ``sync_hosts`` at world 1 and 2.  Every
rendezvous and collective has a timeout of 60 s and every join one of its
own.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.models import CGCNN as TorchCGCNN
from icsg3d_torch.parallel import distributed
from icsg3d_torch.train import unet as tunet
from icsg3d_tpu.config import CGCNNConfig, GridSpec, UNetConfig
from icsg3d_tpu.models import UNet3D
from icsg3d_tpu.parallel import distributed as jdistributed
from icsg3d_tpu.parallel.mesh import make_mesh, shard_batch
from icsg3d_tpu.train import cgcnn as jcg
from icsg3d_tpu.train import unet as junet
from icsg3d_tpu.train import vae as jvae
from test_torch_cgcnn import TINY, random_graphs, randomized_variables
from test_torch_models import UNET_KW, randomize
from test_torch_train import KLD_FLOOR, VAE_KW, _batch, _vae_pair
from test_torch_unet_train import CLASS_WEIGHTS, _raw_batch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 2
JOIN_TIMEOUT_S = 180
LR = 1e-3
CGCNN_ATOMS = [6, 5, 2, 1]  # rank 0 holds 11 atoms, rank 1 holds 3

# One rank: joins the group, runs the unit checks and one train step of
# each model on its rows of the global batch, and saves what it saw.
RANK_PROGRAM = r"""
import json, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from icsg3d_torch import config as tcfg, weights
from icsg3d_torch.models import CGCNN, ConditionalDFCVAE, UNet3D
from icsg3d_torch.parallel import distributed
from icsg3d_torch.parallel.mesh import shard_batch
from icsg3d_torch.train import cgcnn as tcg, unet as tunet, vae as tvae
from icsg3d_torch.train.state import TrainState

def tup(v):
    return tuple(tup(x) for x in v) if isinstance(v, list) else v

spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
group = distributed.initialize("file://" + spec["store"], spec["world"], rank,
                               backend="gloo", timeout=60)
out = {}

def inputs(name):
    with np.load(f"{spec['dir']}/{name}.npz") as f:
        return {k: f[k] for k in f.files}

def local(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch(b, group).items()}

def record(name, state, mets):
    for k, v in mets.items():
        out[f"{name}/mets/{k}"] = v.numpy()
    for n, p in state.model.named_parameters():
        out[f"{name}/grad/{weights.flax_key(n)}"] = p.grad.numpy()
        out[f"{name}/param/{weights.flax_key(n)}"] = p.detach().numpy()
    for n, t in state.model.named_buffers():
        out[f"{name}/buffer/{weights.flax_key(n)}"] = t.numpy()

x = (torch.arange(1.0, 4.0) * (rank + 1)).requires_grad_()
y = distributed.all_reduce_sum(x, group)
(y * (rank + 1)).sum().backward()
out["unit/sum"], out["unit/grad"] = y.detach().numpy(), x.grad.numpy()
out["unit/stride"] = np.array(distributed.process_shard(list(range(7))))
rows = shard_batch({"x": np.arange(16).reshape(8, 2), "s": np.float32(5)}, group)
out["unit/rows"], out["unit/scalar"] = rows["x"], rows["s"]
if rank == 1:
    time.sleep(1.0)
t0 = time.perf_counter()
distributed.sync_hosts(group)
out["unit/waited"] = np.float64(time.perf_counter() - t0)

c = spec["vae"]
model = ConditionalDFCVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=c["d"]), **tup(c["kw"])),
                          torch.Generator().manual_seed(0), group=group)
weights.load_flax_variables(model, weights.load_npz(f"{spec['dir']}/vae_vars.npz"))
state = TrainState.create(model, spec["lr"], group)
b = inputs("vae_batch")
eps = torch.from_numpy(shard_batch(b.pop("eps"), group))
record("vae", state, tvae.make_vae_steps(model)[0](state, local(b), eps))

c = spec["unet"]
model = UNet3D(tcfg.UNetConfig(**tup(c["kw"])), torch.Generator().manual_seed(0),
               group=group)
weights.load_flax_variables(model, weights.load_npz(f"{spec['dir']}/unet_vars.npz"))
state = TrainState.create(model, spec["lr"], group)
train_step, _ = tunet.make_unet_steps(model, np.asarray(c["class_weights"], np.float32))
record("unet", state, train_step(state, local(inputs("unet_batch"))))

cfg = tcfg.CGCNNConfig(**spec["cgcnn"])
variables = weights.load_npz(f"{spec['dir']}/cgcnn_vars.npz")
g = local(inputs("cgcnn_batch"))
graph = [g[k] for k in ("atom_fea", "nbr_dist", "nbr_idx", "atom_mask")]
for name, grp in (("pred", group), ("pred_local", None)):
    model = CGCNN(cfg, torch.Generator().manual_seed(0), group=grp)
    weights.load_flax_variables(model, variables)
    with torch.no_grad():
        out[f"cgcnn/{name}"] = model(*graph).numpy()
model = CGCNN(cfg, torch.Generator().manual_seed(0), group=group)
weights.load_flax_variables(model, variables)
state = TrainState.create(model, spec["lr"], group)
record("cgcnn", state, tcg.make_cgcnn_steps(model)[0](state, g))

np.savez(f"{spec['dir']}/rank{rank}.npz", **out)
distributed.shutdown()
"""


def run_ranks(program: str, args, world: int, cwd, timeout=JOIN_TIMEOUT_S):
    """Start ``world`` ranks of ``program`` (``python -c program args
    rank``) and wait for all of them; a rank that fails or outlives
    ``timeout`` fails the test, and no rank is left running."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", program, *args, str(r)],
                              cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
    return outs


def _cgcnn_inputs():
    """TINY CGCNN variables whose exact zeros count (the two count_nonzero
    quirks of tests/test_torch_cgcnn.py), on a batch whose halves hold 11
    and 3 atoms: each rank's own counts would give other statistics."""
    cfg = CGCNNConfig(**TINY)
    model, variables = randomized_variables(cfg, seed=6)
    conv = variables["params"]["CrystalGraphConv_0"]
    conv["Dense_0"]["kernel"][:, 0] = 0.0
    conv["Dense_0"]["bias"][0] = 0.0
    F = cfg.atom_fea_len
    conv["gamma1"][F + 1] = 0.0
    conv["beta1"][F + 1] = -200.0
    g = random_graphs(cfg, CGCNN_ATOMS, seed=7)
    g["target"] = np.random.default_rng(8).standard_normal(len(CGCNN_ATOMS)).astype(
        np.float32)
    return cfg, model, variables, g


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Inputs of the three models, and what each of the two ranks saw."""
    tmp = tmp_path_factory.mktemp("dp")
    vae = _vae_pair(KLD_FLOOR)
    b = _batch()
    b["eps"] = np.array(jax.random.normal(jax.random.key(7), (4, VAE_KW["latent_dim"])))
    np.savez(tmp / "vae_batch.npz", **b)
    weights.save_npz(str(tmp / "vae_vars.npz"), vae[1])

    jmodel = UNet3D(UNetConfig(**UNET_KW))
    uvars = randomize(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 8, 4)), train=False), 3)
    ub = tunet.prepare_unet_batch(_raw_batch(), UNET_KW["num_classes"],
                                  device_coords=True)
    np.savez(tmp / "unet_batch.npz", **ub)
    weights.save_npz(str(tmp / "unet_vars.npz"), uvars)

    ccfg, cmodel, cvars, g = _cgcnn_inputs()
    np.savez(tmp / "cgcnn_batch.npz", **g)
    weights.save_npz(str(tmp / "cgcnn_vars.npz"), cvars)

    spec = {"store": str(tmp / "store"), "world": WORLD, "dir": str(tmp), "lr": LR,
            "vae": {"d": 8, "kw": dict(VAE_KW, kld_floor=KLD_FLOOR)},
            "unet": {"kw": UNET_KW, "class_weights": CLASS_WEIGHTS.tolist()},
            "cgcnn": TINY}
    run_ranks(RANK_PROGRAM, [json.dumps(spec)], WORLD, tmp)
    ranks = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return {"vae": (vae[0], vae[1], b), "unet": (jmodel, uvars, ub),
            "cgcnn": (cmodel, cvars, g), "ranks": ranks}


def _sharded(tree):
    return shard_batch(tree, make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD]))


def _part(rank, name, kind):
    prefix = f"{name}/{kind}/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def _assert_ranks_agree(ranks, name):
    """Every rank applied the same update and holds the same statistics."""
    for kind in ("grad", "param", "buffer", "mets"):
        first = _part(ranks[0], name, kind)
        for other in ranks[1:]:
            got = _part(other, name, kind)
            assert set(got) == set(first)
            for k, v in first.items():
                np.testing.assert_array_equal(got[k], v, err_msg=f"{kind} {k}")


def _assert_grads_and_stats(rank, name, grads, batch_stats):
    flat_g = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": grads}))
    got = _part(rank, name, "grad")
    assert set(got) == set(flat_g)
    for k, g in got.items():
        np.testing.assert_allclose(g, flat_g[k], atol=1e-5, rtol=1e-3, err_msg=k)
    if batch_stats is None:
        return
    flat_bs = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"batch_stats": batch_stats}))
    got = _part(rank, name, "buffer")
    assert set(got) == set(flat_bs)
    for k, v in got.items():
        np.testing.assert_allclose(v, flat_bs[k], atol=1e-5, rtol=1e-5, err_msg=k)


# -- the collectives ------------------------------------------------------------

def test_all_reduce_sum_and_its_gradient(dp):
    """Rank r contributes (r + 1) * [1, 2, 3] and weighs the sum by r + 1:
    every rank sees the sum 3 * [1, 2, 3], and its input's gradient is the
    sum of the ranks' weights, 1 + 2 (the backward all-reduces)."""
    for rank in dp["ranks"]:
        np.testing.assert_array_equal(rank["unit/sum"], [3.0, 6.0, 9.0])
        np.testing.assert_array_equal(rank["unit/grad"], [3.0, 3.0, 3.0])


def test_process_shard_strides_like_jax(dp, monkeypatch):
    items = list(range(7))
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    for r, rank in enumerate(dp["ranks"]):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert rank["unit/stride"].tolist() == jdistributed.process_shard(items)


def test_shard_batch_takes_the_rows_of_jax_data_axis(dp):
    """Rank r's rows are the block JAX's shard_batch puts on data-axis
    device r; a scalar leaf is replicated."""
    x = np.arange(16).reshape(8, 2)
    placed = _sharded({"x": x, "s": np.float32(5)})
    blocks = {s.device: np.asarray(s.data) for s in placed["x"].addressable_shards}
    for r, rank in enumerate(dp["ranks"]):
        np.testing.assert_array_equal(rank["unit/rows"], blocks[jax.devices()[r]])
        assert float(rank["unit/scalar"]) == float(placed["s"]) == 5.0


def test_sync_hosts_waits_for_every_rank(dp):
    """Rank 1 reaches the barrier a second late; rank 0 waits for it."""
    assert dp["ranks"][0]["unit/waited"] > 0.5


def test_initialize_without_a_launcher_is_a_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is None
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.process_shard([1, 2, 3]) == [1, 2, 3]
    distributed.sync_hosts()  # world 1: returns at once


# -- the train steps --------------------------------------------------------------

def test_vae_step_at_two_ranks_matches_jax_data_axis(dp):
    """The KLD floor (per sample) binds for some samples of the batch."""
    jmodel, jvars, b = dp["vae"]
    batch = {k: v for k, v in b.items() if k != "eps"}
    rng = jax.random.key(7)

    def loss_fn(params, batch):
        return jvae._vae_losses(jmodel, None, None, params, jvars["batch_stats"],
                                batch, rng, train=True)

    grads, (jmets, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jvars["params"], _sharded(batch))
    ranks = dp["ranks"]
    _assert_ranks_agree(ranks, "vae")
    mets = _part(ranks[0], "vae", "mets")
    for k in ("loss", "mse", "perceptual", "kld"):
        np.testing.assert_allclose(mets[k], float(jmets[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    _assert_grads_and_stats(ranks[0], "vae", grads, new_bs)


def test_unet_step_at_two_ranks_matches_jax_data_axis(dp):
    """Every metric of the step, f1, weighted recall and the per-class CE
    among them, is the global batch's."""
    jmodel, jvars, b = dp["unet"]

    def loss_fn(params, batch):
        return junet._unet_losses(jmodel, params, jvars["batch_stats"], batch,
                                  jnp.asarray(CLASS_WEIGHTS), train=True)

    grads, (jmets, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jvars["params"], _sharded(b))
    ranks = dp["ranks"]
    _assert_ranks_agree(ranks, "unet")
    mets = _part(ranks[0], "unet", "mets")
    jmets = jax.tree_util.tree_map(np.asarray, jmets)
    assert set(mets) == set(jmets)
    for k, v in jmets.items():
        np.testing.assert_allclose(mets[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(mets["class_count"].sum()) == b["labels"].size
    folded = tunet._fold_per_class_ce(dict(mets))
    np.testing.assert_allclose(
        folded["ce_per_class"],
        jmets["ce_class_sum"] / np.maximum(jmets["class_count"], 1.0), rtol=1e-4,
        atol=1e-6)
    _assert_grads_and_stats(ranks[0], "unet", grads, new_bs)


def test_cgcnn_step_at_two_ranks_matches_jax_data_axis(dp, monkeypatch):
    """Predictions, loss, MAE and gradients of the global batch.  Each
    rank's own statistics would give other predictions, and so would BN
    statistics counted by the mask instead of count_nonzero: both the
    all-reduced counts and the quirks decide the result."""
    jmodel, jvars, g = dp["cgcnn"]
    graph = ("atom_fea", "nbr_dist", "nbr_idx", "atom_mask")
    want = np.asarray(jmodel.apply(jvars, *(jnp.asarray(g[k]) for k in graph)))
    ranks = dp["ranks"]
    got = np.concatenate([rank["cgcnn/pred"] for rank in ranks])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    local = np.concatenate([rank["cgcnn/pred_local"] for rank in ranks])
    assert np.abs(local - want).max() > 1e-3

    from test_torch_cgcnn import _count_by_mask

    port = TorchCGCNN(tcfg.CGCNNConfig(**TINY))
    weights.load_flax_variables(port, jvars)
    monkeypatch.setattr(sys.modules["icsg3d_torch.models.cgcnn"], "_masked_batch_stats",
                        _count_by_mask)
    with torch.no_grad():
        naive = port(*(torch.from_numpy(g[k]) for k in graph)).numpy()
    assert np.abs(naive - want).max() > 1e-3

    def loss_fn(params, batch):
        return jcg._cgcnn_losses(jmodel, params, batch)

    grads, jmets = jax.jit(jax.grad(loss_fn, has_aux=True))(jvars["params"],
                                                             _sharded(g))
    _assert_ranks_agree(ranks, "cgcnn")
    mets = _part(ranks[0], "cgcnn", "mets")
    for k in ("loss", "mae"):
        np.testing.assert_allclose(mets[k], float(jmets[k]), rtol=1e-4, err_msg=k)
    _assert_grads_and_stats(ranks[0], "cgcnn", grads, None)
