"""The port's 3x3x3 conv (icsg3d_torch/ops/conv.py) against the JAX
package's Pallas conv kernels run in interpret mode, in f32.

- epilogue "bias" vs K1 forward, ``icsg3d_tpu.ops.lowc_conv.conv3d_lowc``;
- epilogue "affine_relu" vs K3, ``icsg3d_tpu.ops.pallas_conv.
  conv3d_bn_relu_pallas`` (its shift absorbs the port's bias);
- "affine_leaky" and "relu_affine" vs ``lax.conv_general_dilated`` and the
  JAX epilogue.

Tolerance atol = rtol = 1e-4: both sides sum the same f32 products, in
different orders.  On the CPU the port runs the kernel's plain version;
the kernel itself is checked on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch.kernels import conv3d as k
from icsg3d_torch.ops.conv import conv3d_same, fold_batchnorm
from icsg3d_tpu.ops.lowc_conv import conv3d_lowc
from icsg3d_tpu.ops.pallas_conv import conv3d_bn_relu_pallas

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(4, 8), (14, 16)]  # (Cin, Cout); 14 = the VAE encoder's input


def _inputs(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 8, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32
    )
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(cout)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b, scale, shift


def _port(x, w, b, scale=None, shift=None, epilogue="bias"):
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = conv3d_same(t(x), t(w), t(b), scale=t(scale), shift=t(shift),
                      epilogue=epilogue)
    return out.numpy()


def _lax_conv(x, w, b):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return y + jnp.asarray(b)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_bias_matches_lowc_pallas(cin, cout):
    x, w, b, _, _ = _inputs(cin, cout)
    ref = conv3d_lowc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      interpret=True)
    np.testing.assert_allclose(_port(x, w, b), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_affine_relu_matches_k3_pallas(cin, cout):
    x, w, b, scale, shift = _inputs(cin, cout, seed=1)
    # K3 has no bias: relu(scale*(acc + b) + shift) = relu(scale*acc + shift')
    ref = conv3d_bn_relu_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(shift + scale * b), interpret=True,
    )
    got = _port(x, w, b, scale, shift, "affine_relu")
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("cin,cout", SHAPES)
@pytest.mark.parametrize("epilogue", ["affine_leaky", "relu_affine"])
def test_other_epilogues_match_lax(cin, cout, epilogue):
    x, w, b, scale, shift = _inputs(cin, cout, seed=2)
    y = _lax_conv(x, w, b)
    if epilogue == "affine_leaky":
        ref = jax.nn.leaky_relu(y * scale + shift, negative_slope=0.3)
    else:
        ref = jax.nn.relu(y) * scale + shift
    got = _port(x, w, b, scale, shift, epilogue)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_fold_batchnorm_matches_flax_formula():
    rng = np.random.default_rng(3)
    g, be, m = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    scale, shift = fold_batchnorm(*(torch.from_numpy(a) for a in (g, be, m, v)), 1e-3)
    flax_bn = (x - m) * (g / np.sqrt(v + 1e-3)) + be
    np.testing.assert_allclose(x * scale.numpy() + shift.numpy(), flax_bn,
                               atol=1e-5, rtol=1e-5)


def test_cpu_path_runs_plain_version_and_counts_nothing():
    k.reset_launches()
    x, w, b, scale, shift = _inputs(4, 8)
    _port(x, w, b, scale, shift, "relu_affine")
    assert k.launches == 0
    assert sum(k.launches_by_epilogue.values()) == 0


def test_wrapper_refuses_cpu_tensors_and_unknown_epilogues():
    x = torch.zeros(1, 4, 4, 4, 4)
    w = torch.zeros(3, 3, 3, 4, 8)
    b = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k.conv3d_same_cuda(x, w, b)
    with pytest.raises(ValueError, match="unknown epilogue"):
        conv3d_same(x, w, b, epilogue="gelu")
