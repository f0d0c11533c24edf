"""The depth-sharded conv (``--spatial``) of the PyTorch port against the
JAX package, on the CPU.

JAX runs on the conftest's 8 virtual CPU devices with its Pallas kernels
in interpret mode; the port's meshes repeat the CPU device, and its kernel
wrappers take their plain versions (f32).  Held here: the depth-VALID conv
and its three gradients against ``conv_ndcs_valid``, the halo exchange,
``make_mesh``, ``conv_sharded`` against ``conv_ndcs_sharded`` on a 4x2
mesh, and the VAE on a 2x2 mesh.  The train steps and the CLIs are in
test_torch_spatial_train.py.

Tolerances are those of the JAX package's own sharded tests
(test_lowc_conv.py:395-502).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.kernels import conv3d as k
from icsg3d_torch.kernels import conv3d_dw as kdw
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_torch.ops.conv import conv3d_valid_diff
from icsg3d_torch.parallel import conv_sharded, halo_exchange, make_mesh
from icsg3d_tpu.config import GridSpec, VAEConfig
from icsg3d_tpu.models import ConditionalDFCVAE
from icsg3d_tpu.ops.lowc_conv import conv_ndcs_valid, from_ndcs, to_ndcs
from icsg3d_tpu.parallel.halo import conv_ndcs_sharded
from icsg3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from test_torch_models import randomize

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _cpu_mesh(n_data, n_spatial):
    return make_mesh(n_data, n_spatial, devices=[CPU] * (n_data * n_spatial))


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv_data(B, D, H, W, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, H, W, cin)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, 3, cin, cout))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def _torch_grads(fn, *arrays):
    ts = [_t(a).requires_grad_() for a in arrays]
    y = fn(*ts)
    torch.sin(y).sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


# -- the depth-VALID conv -----------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 5, 7), (4, 4, 8, 16, 4, 6)],
                         ids=["valid-5x7", "valid-4x6"])
def test_valid_conv_and_grads_match_jax(shape):
    """Conv3dValid on a slab whose halo planes hold data (not zeros) against
    ``conv_ndcs_valid``: the forward, and the x, w, b gradients of
    sum(sin(y)); dx covers all D + 2 planes, halos included."""
    B, D, H, W, cin, cout = shape
    xp, w, b = _conv_data(B, D + 2, H, W, cin, cout, seed=3)

    def jloss(x, w, b):
        return jnp.sum(jnp.sin(conv_ndcs_valid(x, w, b, (H, W), True)))

    jy = from_ndcs(conv_ndcs_valid(to_ndcs(jnp.asarray(xp)), jnp.asarray(w),
                                   jnp.asarray(b), (H, W), True), H, W)
    jg = jax.grad(jloss, (0, 1, 2))(to_ndcs(jnp.asarray(xp)), jnp.asarray(w),
                                    jnp.asarray(b))
    jg = (from_ndcs(jg[0], H, W),) + tuple(jg[1:])
    y, grads = _torch_grads(conv3d_valid_diff, xp, w, b)
    assert y.shape == (B, D, H, W, cout)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-4)
    for name, got, want in zip("xwb", grads, jg):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=1e-4,
                                   err_msg=name)


def test_valid_plain_versions_are_the_valid_window():
    """The three plain versions against autograd of F.conv3d's VALID depth
    window, and the full-window dx against the 2-plane zero pad."""
    xp, w, _ = _conv_data(2, 6, 5, 4, 3, 5, seed=8)
    x = _t(xp).requires_grad_()
    wt = _t(w).requires_grad_()
    y = k.conv3d_valid_reference(x, wt, torch.zeros(5))
    g = torch.from_numpy(np.random.default_rng(9).normal(size=y.shape).astype(np.float32))
    (y * g).sum().backward()
    assert y.shape == (2, 4, 5, 4, 5)
    np.testing.assert_allclose(k.conv3d_dx_valid_reference(g, wt.detach()).numpy(),
                               x.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(kdw.conv3d_dw_valid_reference(x.detach(), g).numpy(),
                               wt.grad.numpy(), atol=1e-4, rtol=1e-5)


# -- mesh and halo exchange ---------------------------------------------------

def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "spatial": 2}
    assert mesh.axis_names == ("data", "spatial")
    assert mesh.devices.shape == (4, 2) and all(d == CPU for d in mesh.devices.flat)
    assert make_mesh(devices=[CPU] * 8).devices.size == 8  # n_data=-1: all of them
    assert make_mesh(n_spatial=2, devices=[CPU] * 5).shape == {"data": 2, "spatial": 2}
    with pytest.raises(ValueError, match="needs 128 devices, have 8"):
        make_mesh(n_data=64, n_spatial=2, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(n_spatial=2, devices=[CPU])
    with pytest.raises(ValueError, match="n_spatial"):
        make_mesh(n_spatial=0, devices=[CPU])
    # the default devices are the visible cards: no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


def test_halo_exchange_values():
    """4 spatial shards of a length-8 depth axis (test_parallel.py:58-75)."""
    x = torch.arange(8.0).reshape(1, 8, 1, 1, 1)
    slabs = list(x.chunk(4, dim=1))
    out = halo_exchange(slabs)
    got = torch.cat(out, dim=1)[0, :, 0, 0, 0].tolist()
    assert got == [0, 0, 1, 2, 1, 2, 3, 4, 3, 4, 5, 6, 5, 6, 7, 0]
    # each cell gets its own storage, even where cells share a device
    storages = {t.untyped_storage().data_ptr() for t in out + [x]}
    assert len(storages) == len(out) + 1
    with pytest.raises(ValueError, match="halo 3 exceeds"):
        halo_exchange(slabs, halo=3)


# -- the sharded conv ---------------------------------------------------------

def test_conv_sharded_matches_jax_on_4x2_mesh():
    """conv_sharded against conv_ndcs_sharded on a 4x2 mesh: values atol
    1e-4, gradients atol 2e-3 / rtol 1e-4 (test_lowc_conv.py:395-438)."""
    B, D, H, W, cin, cout = 4, 8, 8, 16, 4, 6
    x, w, b = _conv_data(B, D, H, W, cin, cout, seed=4)
    jmesh = j_make_mesh(4, 2)

    def jfwd(x, w, b):
        return conv_ndcs_sharded(x, w, b, (H, W), jmesh, interpret=True)

    jx = to_ndcs(jnp.asarray(x))
    jy = from_ndcs(jfwd(jx, jnp.asarray(w), jnp.asarray(b)), H, W)
    jg = jax.grad(lambda *a: jnp.sum(jnp.sin(jfwd(*a))), (0, 1, 2))(
        jx, jnp.asarray(w), jnp.asarray(b))
    jg = (from_ndcs(jg[0], H, W),) + tuple(jg[1:])
    mesh = _cpu_mesh(4, 2)
    y, grads = _torch_grads(lambda *a: conv_sharded(*a, mesh), x, w, b)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-4)
    for name, got, want in zip("xwb", grads, jg):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=1e-4,
                                   err_msg=name)


def test_conv_sharded_runs_the_valid_conv_once_per_cell(monkeypatch):
    """One VALID forward per mesh cell, and in the backward one full-window
    dx and one VALID dW per cell; the SAME conv never runs.  Counted at the
    plain versions' shared helpers, by depth pad (0 = VALID, 1 = SAME)."""
    calls = []

    def counted(mod, tag):
        fn = mod._reference

        def wrap(*a):
            calls.append((tag, a[-1]))
            return fn(*a)
        monkeypatch.setattr(mod, "_reference", wrap)

    counted(k, "conv")
    counted(kdw, "dw")
    x, w, b = _conv_data(4, 8, 4, 4, 3, 5, seed=5)
    ts = [_t(a).requires_grad_() for a in (x, w, b)]
    y = conv_sharded(*ts, _cpu_mesh(2, 2))
    assert calls == [("conv", 0)] * 4
    calls.clear()
    y.sum().backward()
    # the full-window dx's plain version is a VALID conv of the padded g
    assert sorted(calls) == [("conv", 0)] * 4 + [("dw", 0)] * 4
    assert all(t.grad is not None for t in ts)
    with pytest.raises(ValueError, match="does not split"):
        conv_sharded(_t(x)[:, :7], _t(w), _t(b), _cpu_mesh(2, 2))


# -- the sharded models -------------------------------------------------------

def _vae_models(cfg_kw, jmesh, tmesh, seed, x, cond):
    cfg = VAEConfig(layout="ndcs", dtype="float32", **cfg_kw)
    jmodel = ConditionalDFCVAE(cfg, spatial_mesh=jmesh)
    variables = randomize(lambda: jmodel.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(cond), jax.random.key(1)), seed)
    tkw = dict(cfg_kw, grid=tcfg.GridSpec(d=cfg_kw["grid"].d))
    port = TorchVAE(tcfg.VAEConfig(dtype="float32", **tkw),
                    torch.Generator().manual_seed(0), spatial_mesh=tmesh)
    weights.load_flax_variables(port, variables)
    return jmodel, variables, port


def _vae_input(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d, d, d, 4)).astype(np.float32)
    cond = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, cond


def test_vae_on_2x2_mesh_matches_jax():
    """The VAE at d=16 (filters 8, 16, 32: the encoder's last conv at depth
    2) on a 2x2 mesh.  Eval outputs against JAX's ConditionalDFCVAE(layout=
    "ndcs", spatial_mesh=make_mesh(2, 2, devices[:4])) at 1e-5; parameter
    gradients of a training-mode loss at 1e-4 against JAX's single-program
    ndcs model, which the sharded one is meant to equal
    (test_lowc_conv.py:441-502).  On this input JAX's sharded model returns
    twice the single-program weight gradients of encoder convs 0-2 (its
    test's default widths hide it within atol 1e-4); the port's sharded
    gradients equal the single-program ones."""
    x, cond = _vae_input(2, 16, seed=7)
    cfg_kw = dict(grid=GridSpec(d=16), filters=(8, 16, 32), latent_dim=32)
    jmodel, v, port = _vae_models(cfg_kw, j_make_mesh(2, 2, devices=jax.devices()[:4]),
                                  _cpu_mesh(2, 2), 11, x, cond)
    single = ConditionalDFCVAE(VAEConfig(layout="ndcs", dtype="float32", **cfg_kw))
    rng = jax.random.key(0)
    eps = np.array(jax.random.normal(rng, (2, 32)))
    jout = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), jnp.asarray(cond), rng,
                                         train=False))(v)
    with torch.no_grad():
        tout = port.eval()(_t(x), _t(cond), _t(eps))
    for name, a, b in zip(("recon", "z_mean", "z_log_var", "z"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5,
                                   err_msg=name)

    def jloss(params):
        (recon, z_mean, _, _), _ = single.apply(
            {**v, "params": params}, jnp.asarray(x), jnp.asarray(cond), rng,
            train=True, mutable=["batch_stats"])
        return jnp.mean((recon - x) ** 2) + jnp.mean(z_mean ** 2)

    flat_g = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": jax.jit(jax.grad(jloss))(v["params"])}))
    recon, z_mean, _, _ = port.train()(_t(x), _t(cond), _t(eps), train=True)
    (torch.mean((recon - _t(x)) ** 2) + torch.mean(z_mean ** 2)).backward()
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_g[weights.flax_key(name)],
                                   atol=1e-4, rtol=1e-4, err_msg=name)
