"""The port's training ops against the JAX package, on the CPU in f32.

- The differentiable conv (``ops/conv.conv3d_same_diff``): its (dx, dW, db)
  against ``jax.vjp`` of ``icsg3d_tpu.ops.lowc_conv.conv_ndcs`` in Pallas
  interpret mode, which runs K1 as dx and K2 themselves; the plain dW
  against K2 alone (``conv3d_lowc_ndcs_dw`` + ``unpack_weight_grad``).
  Tolerance atol = rtol = 1e-4: the same f32 products, summed in another
  order.
- Max-pool gradients on tied maxima against ``jax.vjp`` of the Flax pool:
  exact.
- Training BatchNorm (block output, updated running statistics) against
  Flax ``nn.BatchNorm(use_running_average=False)``: 1e-5.
- Every loss against ``icsg3d_tpu.ops.losses``: rtol 1e-6.
- Coordinate grids from lattice lengths against ``coordinate_grid``: 1e-6.

On the CPU the conv's three passes run their kernels' plain versions; the
kernels themselves are checked on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from icsg3d_torch import config as tcfg
from icsg3d_torch.kernels import conv3d_dw as kdw
from icsg3d_torch.models import layers as tlayers
from icsg3d_torch.ops import losses as tlosses
from icsg3d_torch.ops.conv import conv3d_same_diff
from icsg3d_torch.ops.grid import coordinate_grids
from icsg3d_tpu.config import GridSpec
from icsg3d_tpu.models import layers as jlayers
from icsg3d_tpu.ops import losses as jlosses
from icsg3d_tpu.ops.lowc_conv import (
    conv3d_lowc_ndcs_dw,
    conv_ndcs,
    from_ndcs,
    to_ndcs,
    unpack_weight_grad,
)
from icsg3d_tpu.ops.voxelize import coordinate_grid

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
# (Cin, Cout); 14 = the VAE encoder's input, 16 -> 4 the VAE's f32 output head
SHAPES = [(4, 8), (14, 16), (16, 4)]
D = 8


def _conv_data(cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, D, D, D, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((2, D, D, D, cout)).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_conv_grads_match_pallas_vjp(cin, cout):
    x, w, b, g = _conv_data(cin, cout, seed=10)

    def f(x, w, b):
        return from_ndcs(conv_ndcs(to_ndcs(x), w, b, (D, D), True), D, D)

    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    refs = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = conv3d_same_diff(xt, wt, bt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    for name, got, ref in zip(("dx", "dW", "db"), (xt.grad, wt.grad, bt.grad), refs):
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name, **TOL)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_plain_dw_matches_k2_pallas(cin, cout):
    x, _, _, g = _conv_data(cin, cout, seed=11)
    dwt = conv3d_lowc_ndcs_dw(to_ndcs(jnp.asarray(x)), to_ndcs(jnp.asarray(g)),
                              W=D, interpret=True)
    ref = unpack_weight_grad(dwt, cin, cout)
    got = kdw.conv3d_dw_reference(torch.from_numpy(x), torch.from_numpy(g))
    assert kdw.launches == 0  # the plain version counts nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_conv_skips_dx_for_data_inputs_and_dw_for_frozen_weights():
    x, w, b, g = _conv_data(4, 8, seed=12)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    conv3d_same_diff(xt, wt, bt).backward(torch.from_numpy(g))
    assert xt.grad is None and wt.grad is not None
    xt = torch.from_numpy(x).requires_grad_()
    conv3d_same_diff(xt, torch.from_numpy(w), torch.from_numpy(b)).backward(
        torch.from_numpy(g))
    assert xt.grad is not None


def test_max_pool_gradient_on_ties_matches_flax():
    rng = np.random.default_rng(13)
    # values in {0, 1, 2}: most 2x2x2 windows hold tied maxima
    x = rng.integers(0, 3, (2, 4, 6, 4, 3)).astype(np.float32)
    g = rng.standard_normal((2, 2, 3, 2, 3)).astype(np.float32)
    y_ref, vjp = jax.vjp(jlayers.max_pool_3d, jnp.asarray(x))
    (gx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = tlayers.max_pool_3d(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_ref))
    # one element per window takes the whole gradient
    assert int((xt.grad != 0).sum()) == g.size


def _flax_bn(x, scale, bias, mean, var):
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                      dtype=jnp.float32, param_dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    y, new = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    return np.asarray(y), new["batch_stats"]


def _port_bn(c, scale, bias, mean, var):
    bn = tlayers.BatchNorm(c)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    return bn


@pytest.mark.parametrize("shape", [(4, 4, 4, 4, 6), (2, 6)])
def test_train_batchnorm_matches_flax(shape):
    """(2, 6) is a batch of 2 per channel: the biased variance (Flax's,
    used for the running variance too) is half the unbiased one."""
    rng = np.random.default_rng(14)
    c = shape[-1]
    x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias, mean = (0.1 * rng.standard_normal((2, c))).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    y_ref, stats = _flax_bn(x, scale, bias, mean, var)
    bn = _port_bn(c, scale, bias, mean, var)
    y = bn.train_forward(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-5, rtol=1e-5)
    for name, got in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(got.numpy(), np.asarray(stats[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    if len(shape) == 2:
        xs = x.reshape(-1, c)
        biased, unbiased = xs.var(0), xs.var(0, ddof=1)
        np.testing.assert_allclose(
            bn.running_var.numpy(), 0.99 * var + 0.01 * biased, rtol=1e-5)
        assert np.all(np.abs(0.01 * (unbiased - biased)) > 1e-4)


def test_train_conv_block_matches_flax_block():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((4, D, D, D, 5)).astype(np.float32)
    block = jlayers.ConvBlock(6, order="bn_act",
                              act=lambda h: nn.leaky_relu(h, negative_slope=0.3),
                              dtype=jnp.float32)
    init = block.init(jax.random.key(0), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.array, init["params"])
    params["BatchNorm_0"]["scale"] = (1 + 0.2 * rng.standard_normal(6)).astype(np.float32)
    params["BatchNorm_0"]["bias"] = (0.1 * rng.standard_normal(6)).astype(np.float32)
    stats = {"mean": (0.1 * rng.standard_normal(6)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    y_ref, new = block.apply({"params": params, "batch_stats": {"BatchNorm_0": stats}},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
    conv = tlayers.Conv3d(5, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(params["Conv_0"]["kernel"]))
        conv.bias.copy_(torch.from_numpy(params["Conv_0"]["bias"]))
    bn = _port_bn(6, params["BatchNorm_0"]["scale"], params["BatchNorm_0"]["bias"],
                  stats["mean"], stats["var"])
    y = tlayers.conv_block(torch.from_numpy(x), conv, bn, order="bn_act",
                           act="leaky", train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)
    got_stats = (bn.running_mean.numpy(), bn.running_var.numpy())
    for name, got in zip(("mean", "var"), got_stats):
        np.testing.assert_allclose(got, np.asarray(new["batch_stats"]["BatchNorm_0"][name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def _loss_data():
    rng = np.random.default_rng(16)
    logits = rng.standard_normal((2, 3, 3, 3, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 3, 3, 3))
    onehot = np.eye(5, dtype=np.float32)[labels]
    weights = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    sig = (4 * rng.standard_normal((2, 3, 3, 3, 1))).astype(np.float32)
    occ = rng.integers(0, 2, sig.shape).astype(np.float32)
    a, b = rng.standard_normal((2, 2, 7)).astype(np.float32)
    feats = [rng.standard_normal((2, 4, 4, 4, c)).astype(np.float32) for c in (3, 5)]
    feats2 = [f + 0.3 * rng.standard_normal(f.shape).astype(np.float32) for f in feats]
    return dict(logits=logits, labels=labels, onehot=onehot, weights=weights,
                sig=sig, occ=occ, a=a, b=b, feats=feats, feats2=feats2)


LOSS_CASES = {
    "weighted_categorical_crossentropy": lambda d: (d["logits"], d["onehot"], d["weights"]),
    "weighted_categorical_crossentropy_from_labels":
        lambda d: (d["logits"], d["labels"], d["weights"]),
    "binary_crossentropy_from_logits": lambda d: (d["sig"], d["occ"]),
    "mse_flat": lambda d: (d["a"], d["b"]),
    "kld_gaussian": lambda d: (d["a"], 0.5 * d["b"]),
    "perceptual_feature_loss": lambda d: (d["feats"], d["feats2"], (1.0, 0.5)),
    "mse_loss": lambda d: (d["a"], d["b"]),
    "mae": lambda d: (d["a"], d["b"]),
}


def _to_torch(a):
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        return [torch.from_numpy(v) for v in a]
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    args = LOSS_CASES[name](_loss_data())
    ref = getattr(jlosses, name)(*[
        [jnp.asarray(v) for v in a] if isinstance(a, list) else
        (jnp.asarray(a) if isinstance(a, np.ndarray) else a) for a in args
    ])
    got = getattr(tlosses, name)(*[_to_torch(a) for a in args])
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_losses_raise_like_jax():
    d = _loss_data()
    with pytest.raises(ValueError, match="feature taps"):
        tlosses.perceptual_feature_loss(_to_torch(d["feats"]),
                                        _to_torch(d["feats2"][:1]), (1.0, 1.0))
    with pytest.raises(ValueError, match="entries for 5 classes"):
        tlosses.weighted_categorical_crossentropy_from_labels(
            torch.from_numpy(d["logits"]), torch.from_numpy(d["labels"]),
            torch.ones(4))


def test_coordinate_grids_match_jax():
    rng = np.random.default_rng(17)
    abc = rng.uniform(3.0, 9.0, (3, 3)).astype(np.float32)
    grid = GridSpec(d=D)
    ref = jax.vmap(lambda a: coordinate_grid(a, grid))(jnp.asarray(abc))
    got = coordinate_grids(torch.from_numpy(abc), tcfg.GridSpec(d=D))
    assert got.shape == (3, D, D, D, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
