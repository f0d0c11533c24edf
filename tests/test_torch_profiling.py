"""The port's profiling utilities (utils/profiling.py), on the CPU.

- The analytic FLOP counts of the VAE and U-Net forwards and of one train
  step each (make_vae_steps with and without the perceptual U-Net,
  make_unet_steps) against ``torch.utils.flop_counter.FlopCounterMode``
  over the plain path, where every conv is an aten conv or matmul: within
  1% (they agree exactly at these shapes).  On the card the conv kernels
  launch through ctypes and FlopCounterMode sees none of them.
- The analytic forward counts against the JAX package's
  ``flops_of_jitted`` (XLA's cost analysis) of the same models, less the
  zero-padding taps that XLA does not count: within 3%, the elementwise
  ops that only XLA counts.
- ``StepTimer.tick()`` returns JAX's keys, None through the warm-up.
- ``trace`` writes a non-empty Chrome trace; ``fetch_time`` and
  ``generation_rate`` time a chained step.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from icsg3d_torch import config as tcfg
from icsg3d_torch.apps.generate import fused_generate_fn
from icsg3d_torch.models import ConditionalDFCVAE, UNet3D
from icsg3d_torch.train import unet as tunet
from icsg3d_torch.train import vae as tvae
from icsg3d_torch.utils import profiling as prof
from icsg3d_tpu.utils import profiling as jprof
from test_torch_models import UNET_KW

torch.set_num_threads(1)

D, B = 8, 2
VAE_CFGS = {
    "f4_8": dict(filters=(4, 8), latent_dim=8),
    "f4_8_8_rep4": dict(filters=(4, 8, 8), latent_dim=16, cond_repeat=4),
}


def _vae_cfg(name):
    return tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), dtype="float32", **VAE_CFGS[name])


def _inputs(latent, seed=0):
    g = torch.Generator().manual_seed(seed)
    cond = torch.zeros(B, 10)
    cond[:, 3] = 1.0
    return (torch.randn((B, D, D, D, 4), generator=g), cond,
            torch.randn((B, latent), generator=g))


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _close(analytic, counted):
    assert counted > 0
    assert abs(analytic - counted) <= 1e-2 * counted, (analytic, counted)


@pytest.mark.parametrize("name", sorted(VAE_CFGS))
def test_vae_forward_flops(name):
    cfg = _vae_cfg(name)
    vae = ConditionalDFCVAE(cfg, torch.Generator().manual_seed(0)).eval()
    x, cond, eps = _inputs(cfg.latent_dim)
    with torch.inference_mode():
        counted = _counted(lambda: vae(x, cond, eps))
    _close(prof.vae_forward_flops(cfg, B), counted)


def test_unet_forward_flops():
    cfg = tcfg.UNetConfig(**UNET_KW)
    unet = UNet3D(cfg, torch.Generator().manual_seed(0)).eval()
    x, _, _ = _inputs(8)
    with torch.inference_mode():
        counted = _counted(lambda: unet(x))
    _close(prof.unet_forward_flops(cfg, D, B), counted)


@pytest.mark.parametrize("dfc", [True, False], ids=["dfc", "no_unet"])
@pytest.mark.parametrize("name", sorted(VAE_CFGS))
def test_vae_train_step_flops(name, dfc):
    cfg = _vae_cfg(name)
    ucfg = tcfg.UNetConfig(**UNET_KW)
    unet = UNet3D(ucfg, torch.Generator().manual_seed(1)) if dfc else None
    state = tvae.create_vae_state(cfg, 1e-3, 0, "cpu")
    train_step, _ = tvae.make_vae_steps(state.model, unet)
    x, cond, eps = _inputs(cfg.latent_dim)
    counted = _counted(lambda: train_step(state, {"x": x, "cond": cond}, eps))
    _close(prof.vae_train_step_flops(cfg, ucfg if dfc else None, B), counted)


def test_unet_train_step_flops():
    cfg = tcfg.UNetConfig(**UNET_KW)
    state = tunet.create_unet_state(cfg, 1e-3, 0, "cpu")
    train_step, _ = tunet.make_unet_steps(state.model)
    x, _, _ = _inputs(8)
    labels = torch.randint(0, cfg.num_classes, (B, D, D, D),
                           generator=torch.Generator().manual_seed(2)).to(torch.uint8)
    counted = _counted(lambda: train_step(state, {"x": x, "labels": labels}))
    _close(prof.unet_train_step_flops(cfg, D, B), counted)


def _padding_flops(convs, batch):
    """The products of SAME 3x3x3 convs whose tap lands in the zero
    padding: of the 3 * edge taps along an axis, 3 * edge - 2 land inside."""
    return sum(prof.conv_flops(ci, co, e, batch)
               - 2 * ci * co * batch * (3 * e - 2) ** 3 for ci, co, e in convs)


@pytest.mark.parametrize("model", ["vae:f4_8", "vae:f4_8_8_rep4", "unet"])
def test_forward_flops_against_jax_cost_analysis(model):
    """The analytic forward counts against ``flops_of_jitted`` (XLA's cost
    analysis) of the JAX package's models at the same config.  XLA counts
    only the conv taps that land inside the grid, and counts the
    elementwise ops (BatchNorm, activations, the reparameterization) as
    well; the analytic count takes all 27 taps, as the kernels compute
    them, and only the convs, heads and dense layers.  So, less its
    padding taps, the analytic count must lie at or under XLA's, by at
    most 3% of it (1.0-2.1% at these configs)."""
    import jax
    import jax.numpy as jnp

    from icsg3d_tpu import config as jcfg
    from icsg3d_tpu.models import ConditionalDFCVAE as JaxVAE
    from icsg3d_tpu.models import UNet3D as JaxUNet

    x = jnp.asarray(np.random.default_rng(0).standard_normal((B, D, D, D, 4)),
                    jnp.float32)
    if model == "unet":
        net = JaxUNet(jcfg.UNetConfig(**UNET_KW))
        variables = net.init(jax.random.key(0), x)
        xla = jprof.flops_of_jitted(
            jax.jit(lambda v, x: net.apply(v, x, train=False)), variables, x)
        cfg = tcfg.UNetConfig(**UNET_KW)
        analytic = (prof.unet_forward_flops(cfg, D, B)
                    - _padding_flops(prof.unet_convs(cfg, D), B))
    else:
        name = model.split(":")[1]
        net = JaxVAE(jcfg.VAEConfig(grid=jcfg.GridSpec(d=D), dtype="float32",
                                    **VAE_CFGS[name]))
        cond = jnp.asarray(_inputs(8)[1].numpy())
        variables = net.init(jax.random.key(0), x, cond, jax.random.key(1))
        xla = jprof.flops_of_jitted(
            jax.jit(lambda v, x, c: net.apply(v, x, c, jax.random.key(1),
                                              train=False)), variables, x, cond)
        cfg = _vae_cfg(name)
        analytic = (prof.vae_forward_flops(cfg, B)
                    - _padding_flops(prof.vae_layers(cfg)[0], B))
    assert xla > 0
    assert 0 <= xla - analytic <= 3e-2 * xla, (analytic, xla)


def test_production_step_counts():
    """The production step counts chip_smoke's MFU uses: the VAE step at
    batch 20 (the 95-class U-Net cut at conv 9) and the U-Net step at
    batch 10, from the 3x3x3 conv shapes alone plus the heads and dense
    layers."""
    vcfg, ucfg = tcfg.VAEConfig(), tcfg.UNetConfig()
    convs, dense = prof.vae_layers(vcfg)
    assert [c[:2] for c in convs] == [(14, 16), (16, 32), (32, 64), (64, 128),
                                      (128, 4), (4, 128), (128, 64), (64, 32),
                                      (32, 16), (16, 4)]
    assert [c[2] for c in convs] == [32, 16, 8, 4, 2, 4, 8, 16, 32, 32]
    assert dense == [(32, 256), (256, 256), (256, 256), (266, 256)]
    assert prof.unet_convs(ucfg, 32)[8] == (768, 512, 8)
    assert prof.vae_train_step_flops(vcfg, ucfg, 20) == 1339280732160
    assert prof.unet_train_step_flops(ucfg, 32, 10) == 3779403448320


@pytest.mark.parametrize("flops", [0.0, 1e9])
def test_step_timer_ticks_like_jax(flops):
    mine = prof.StepTimer(items_per_step=4, flops_per_step=flops, warmup=2)
    ref = jprof.StepTimer(items_per_step=4, flops_per_step=flops, warmup=2)
    assert mine.n_devices == 1 and mine.peak_flops == 989.4e12
    for _ in range(2):
        assert mine.tick() is None and ref.tick() is None
    got, want = mine.tick(), ref.tick()
    assert set(got) == set(want)
    assert got["step"] == want["step"] == 3
    assert got["items_per_sec"] == pytest.approx(4 * 1000.0 / got["step_ms"])


def test_step_timer_counts_distinct_mesh_devices():
    from icsg3d_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_spatial=2, devices=[torch.device("cpu")] * 4)
    assert prof.StepTimer(1, mesh=mesh).n_devices == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_fetch_time_and_generation_rate():
    dt = prof.fetch_time(lambda x: x * 1.0001, torch.ones(8), iters=3,
                         overhead_correct=True)
    assert np.isfinite(dt)
    vcfg = _vae_cfg("f4_8")
    ucfg = tcfg.UNetConfig(**UNET_KW)
    step = fused_generate_fn(ConditionalDFCVAE(vcfg).eval(), UNet3D(ucfg).eval(),
                             tcfg.PipelineConfig(grid=tcfg.GridSpec(d=D)))
    _, cond, z = _inputs(8)
    rate = prof.generation_rate(step, z, cond, iters=2)
    assert set(rate) == {"batch_ms", "samples_per_sec", "iters"}
    assert rate["iters"] == 2 and rate["samples_per_sec"] > 0
