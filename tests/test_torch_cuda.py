"""The hand-written conv kernels on the card against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports no JAX (the machine with the card has none), so it runs there
without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bounds: max |kernel - reference| / max |reference| <= 1e-2 for a bf16
output (bf16 rounding of the output), <= 1e-4 for an f32 output (f32
sums in another order), <= 1e-3 for the weight gradient (f32 out, but
sums of 10^3-10^6 bf16 products taken in another order).  The references
run F.conv3d and matmuls with TF32 off.
"""

import pytest
import torch

from icsg3d_torch.kernels import conv3d as k
from icsg3d_torch.kernels import conv3d_dw as kdw

torch.set_num_threads(1)

CARD_CASES = [
    # (B, D, H, W, Cin, Cout, in dtype, out dtype, epilogue)
    (2, 8, 8, 8, 14, 16, torch.bfloat16, torch.bfloat16, "affine_leaky"),
    (1, 4, 6, 5, 4, 4, torch.bfloat16, torch.bfloat16, "bias"),
    (2, 8, 8, 8, 64, 72, torch.bfloat16, torch.bfloat16, "relu_affine"),
    (2, 8, 8, 8, 16, 4, torch.float32, torch.float32, "affine_relu"),
    (1, 4, 4, 4, 33, 130, torch.bfloat16, torch.float32, "affine_relu"),
    (2, 8, 8, 8, 24, 20, torch.float32, torch.float32, "affine_leaky"),
    (1, 5, 7, 6, 3, 9, torch.float32, torch.bfloat16, "relu_affine"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_reference_on_card(cuda_device, case):
    B, D, H, W, cin, cout, dt, odt, epi = case
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(B, D, H, W, cin, generator=g).to(cuda_device, dt)
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cin) ** 0.5).to(
        cuda_device, dt
    )
    b, scale, shift = (torch.randn(cout, generator=g).to(cuda_device) for _ in range(3))
    n0 = k.launches
    got = k.conv3d_same_cuda(x, w, b, scale, shift, epi, odt)
    torch.cuda.synchronize()
    assert k.launches == n0 + 1
    ref = k.conv3d_same_reference(x, w, b, scale, shift, epi, odt)
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert got.dtype == odt and got.shape == ref.shape
    assert float(err) <= (1e-2 if odt == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_kernel_wrapper_checks_on_card(cuda_device):
    x = torch.zeros(1, 4, 4, 4, 4, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    b = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        k.conv3d_same_cuda(x, w.float(), b)
    with pytest.raises(ValueError, match="contiguous"):
        k.conv3d_same_cuda(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="scale"):
        k.conv3d_same_cuda(x, w, b, epilogue="affine_relu")


@pytest.mark.cuda
def test_conv3d_same_on_card_matches_cpu_plain_version(cuda_device):
    """The ops-level entry point: f32 parameters cast to the bf16 compute
    dtype, the kernel on the card, the plain version on the CPU."""
    from icsg3d_torch.ops.conv import conv3d_same

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 8, 32, generator=g).bfloat16()
    w = torch.randn(3, 3, 3, 32, 48, generator=g) / (27 * 32) ** 0.5
    b, scale, shift = (torch.randn(48, generator=g) for _ in range(3))
    kw = dict(scale=scale, shift=shift, epilogue="relu_affine")
    cpu = conv3d_same(x, w, b, **kw)
    card = conv3d_same(x.to(cuda_device), w.to(cuda_device), b.to(cuda_device),
                       scale=scale.to(cuda_device), shift=shift.to(cuda_device),
                       epilogue="relu_affine").cpu()
    err = (card.float() - cpu.float()).abs().max() / cpu.float().abs().max()
    assert float(err) <= 1e-2


@pytest.mark.cuda
def test_extraction_on_card_equals_cpu(cuda_device):
    """The binary extraction (rolls, sorts, cummin, matmuls on int32 and
    0/1 data) gives the same atoms on the card as on the CPU."""
    import numpy as np

    from icsg3d_torch.ops.extract import extract_atoms

    rng = np.random.default_rng(0)
    d = 16
    grid = np.mgrid[:d, :d, :d].astype(np.float32)
    density = np.zeros((3, d, d, d), np.float32)
    for i in range(3):
        for c in rng.uniform(3, d - 3, (4, 3)):
            density[i] += np.exp(-((grid - c[:, None, None, None]) ** 2).sum(0) / 3.0)
    mask = (density > 0.3).astype(np.int32)
    species = np.where(mask > 0, rng.integers(1, 95, density.shape), 0).astype(np.int32)
    cpu = extract_atoms(torch.from_numpy(species), torch.from_numpy(mask), max_atoms=16)
    card = extract_atoms(torch.from_numpy(species).to(cuda_device),
                         torch.from_numpy(mask).to(cuda_device), max_atoms=16)
    assert int(cpu[2].sum()) > 0
    for c, k_ in zip(cpu, card):
        assert torch.allclose(c.double(), k_.cpu().double(), atol=1e-5)


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


DX_CASES = [
    # (B, D, H, W, Cin, Cout, dtype): dx maps g (.., Cout) to (.., Cin)
    (2, 8, 8, 8, 4, 32, torch.bfloat16),     # U-Net conv1: dx out 4 channels
    (1, 4, 4, 4, 128, 4, torch.bfloat16),    # g of 4 channels: padded to 8
    (2, 4, 6, 5, 64, 72, torch.bfloat16),
    (2, 8, 8, 8, 16, 4, torch.float32),      # the f32 output head
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DX_CASES)
def test_dx_kernel_matches_reference_on_card(cuda_device, case):
    B, D, H, W, cin, cout, dt = case
    g = torch.Generator(device="cpu").manual_seed(2)
    gy = torch.randn(B, D, H, W, cout, generator=g).to(cuda_device, dt)
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cout) ** 0.5).to(
        cuda_device, dt
    )
    n0, f0 = k.launches_dx, k.launches
    got = k.conv3d_dx_cuda(gy, w)
    torch.cuda.synchronize()
    assert (k.launches_dx, k.launches) == (n0 + 1, f0)
    ref = k.conv3d_dx_reference(gy, w)
    assert got.shape == (B, D, H, W, cin) and got.dtype == dt
    assert _rel_err(got, ref) <= (1e-2 if dt == torch.bfloat16 else 1e-4)


DW_CASES = [
    # (B, D, H, W, Cin, Cout, dtype); bf16 runs the wgmma kernel
    (2, 8, 8, 8, 16, 32, torch.bfloat16),    # Cin on wgmma's N (swapped roles)
    (2, 8, 8, 8, 14, 16, torch.bfloat16),    # Cin 14: channels padded to 16
    (1, 4, 4, 4, 4, 128, torch.bfloat16),    # Cin 4 on N = 8, two M tiles of Cout
    (2, 2, 2, 2, 128, 4, torch.bfloat16),    # Cout 4 on N = 8, edge 2
    (2, 4, 4, 4, 64, 64, torch.bfloat16),    # edge 4
    (2, 5, 7, 6, 24, 40, torch.bfloat16),    # ragged tiles, W != H
    (1, 32, 32, 32, 192, 128, torch.bfloat16),  # U-Net conv13 at B = 1
    (1, 16, 16, 16, 384, 256, torch.bfloat16),  # U-Net conv11
    (1, 8, 8, 8, 768, 512, torch.bfloat16),  # U-Net conv9: one split, dW direct
    (2, 8, 8, 8, 16, 4, torch.float32),      # the f32 output head
    (1, 6, 5, 4, 24, 20, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES)
def test_dw_kernel_matches_reference_on_card(cuda_device, case):
    B, D, H, W, cin, cout, dt = case
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(B, D, H, W, cin, generator=g).to(cuda_device, dt)
    gy = torch.randn(B, D, H, W, cout, generator=g).to(cuda_device, dt)
    n0 = kdw.launches
    got = kdw.conv3d_dw_cuda(x, gy)
    torch.cuda.synchronize()
    assert kdw.launches == n0 + 1
    ref = kdw.conv3d_dw_reference(x, gy)
    assert got.shape == (3, 3, 3, cin, cout) and got.dtype == torch.float32
    assert _rel_err(got, ref) <= 1e-3
    again = kdw.conv3d_dw_cuda(x, gy)
    assert torch.equal(got, again)  # split-K reduction in a fixed order


EPI_MODES = [(e, m) for e in ("bias", "affine_leaky", "relu_affine", "affine_relu")
             for m in ("same", "valid")]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(14, 16), (192, 136)], ids=["narrow", "wide"])
@pytest.mark.parametrize("epi,mode", EPI_MODES, ids=[f"{e}-{m}" for e, m in EPI_MODES])
def test_bf16_kernel_epilogues_and_depth_modes_on_card(cuda_device, epi, mode, cin, cout):
    """Every epilogue in both forward depth modes, narrow (Cin 14: channels
    padded, kc 16) and wide (3 chunks of 64, two N tiles), bf16 and f32
    output, against the plain version; a second launch gives equal bits."""
    g = torch.Generator(device="cpu").manual_seed(9)
    D = 6 if mode == "same" else 8
    x = torch.randn(2, D, 9, 11, cin, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cin) ** 0.5).to(
        cuda_device, torch.bfloat16)
    b, scale, shift = (torch.randn(cout, generator=g).to(cuda_device) for _ in range(3))
    run = k.conv3d_same_cuda if mode == "same" else k.conv3d_valid_cuda
    ref_fn = k.conv3d_same_reference if mode == "same" else k.conv3d_valid_reference
    for odt in (torch.bfloat16, torch.float32):
        args = (x, w, b, scale, shift, epi, odt)
        got = run(*args)
        torch.cuda.synchronize()
        ref = ref_fn(*args)
        assert got.dtype == odt and got.shape == ref.shape == (2, 6, 9, 11, cout)
        assert _rel_err(got, ref) <= (1e-2 if odt == torch.bfloat16 else 1e-4)
        assert torch.equal(got, run(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 32), (192, 128)], ids=["narrow", "wide"])
@pytest.mark.parametrize("mode", ["same", "full"])
def test_bf16_dx_kernel_depth_modes_on_card(cuda_device, mode, cin, cout):
    """The input gradient in both depth windows, to a narrow (4) and a wide
    (192: a 128 and a 64 N tile) Cin, against the plain version; a second
    launch gives equal bits."""
    g = torch.Generator(device="cpu").manual_seed(10)
    gy = torch.randn(2, 6, 7, 10, cout, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cout) ** 0.5).to(
        cuda_device, torch.bfloat16)
    run = k.conv3d_dx_cuda if mode == "same" else k.conv3d_dx_valid_cuda
    ref_fn = k.conv3d_dx_reference if mode == "same" else k.conv3d_dx_valid_reference
    got = run(gy, w)
    torch.cuda.synchronize()
    ref = ref_fn(gy, w)
    assert got.shape == ref.shape == (2, 6 if mode == "same" else 8, 7, 10, cin)
    assert _rel_err(got, ref) <= 1e-2
    assert torch.equal(got, run(gy, w))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 300])
def test_bf16_kernel_wide_rows_on_card(cuda_device, W):
    """A row of 128 (one segment, pitch 129) and of 300 (column segments):
    forward and dx against the plain versions."""
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(1, 3, 4, W, 64, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(3, 3, 3, 64, 64, generator=g) / (27 * 64) ** 0.5).to(
        cuda_device, torch.bfloat16)
    b = torch.randn(64, generator=g).to(cuda_device)
    assert k.plan(1, 3, 4, W, 64, 64, 0, False).nseg == (1 if W == 128 else 2)
    got = k.conv3d_same_cuda(x, w, b)
    torch.cuda.synchronize()
    assert _rel_err(got, k.conv3d_same_reference(x, w, b)) <= 1e-2
    assert _rel_err(k.conv3d_dx_cuda(x, w), k.conv3d_dx_reference(x, w)) <= 1e-2


@pytest.mark.cuda
def test_dw_kernel_wide_row_on_card(cuda_device):
    """K2 at W = 128, 128 -> 128: a row too wide for one launch's window,
    split into column segments summed in order; equal bits again."""
    g = torch.Generator(device="cpu").manual_seed(12)
    x = torch.randn(1, 4, 8, 128, 128, generator=g).to(cuda_device, torch.bfloat16)
    gy = torch.randn(1, 4, 8, 128, 128, generator=g).to(cuda_device, torch.bfloat16)
    assert kdw.plan(1, 4, 8, 128, 128, 128, 0).segments > 1
    got = kdw.conv3d_dw_cuda(x, gy)
    torch.cuda.synchronize()
    assert _rel_err(got, kdw.conv3d_dw_reference(x, gy)) <= 1e-3
    assert torch.equal(got, kdw.conv3d_dw_cuda(x, gy))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,dt", [(4, 16, torch.bfloat16),
                                         (16, 4, torch.float32)])
def test_conv_function_grads_on_card(cuda_device, cin, cout, dt):
    """conv3d_same_diff's backward on the card (K1 as dx, K2, the f32 bias
    sum) against the plain versions of the three passes on the same
    operands."""
    from icsg3d_torch.ops.conv import conv3d_same_diff

    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn(2, 8, 8, 8, cin, generator=g).to(cuda_device, dt).requires_grad_()
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cin) ** 0.5).to(
        cuda_device).requires_grad_()
    b = torch.randn(cout, generator=g).to(cuda_device).requires_grad_()
    gy = torch.randn(2, 8, 8, 8, cout, generator=g).to(cuda_device, dt)
    counts = (k.launches, k.launches_dx, kdw.launches)
    y = conv3d_same_diff(x, w, b)
    (y.float() * gy.float()).sum().backward()
    torch.cuda.synchronize()
    assert (k.launches, k.launches_dx, kdw.launches) == tuple(c + 1 for c in counts)
    assert x.grad.dtype == dt and w.grad.dtype == torch.float32
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    assert _rel_err(x.grad, k.conv3d_dx_reference(gy, w.detach().to(dt))) <= tol
    assert _rel_err(w.grad, kdw.conv3d_dw_reference(x.detach(), gy)) <= 1e-3
    assert _rel_err(b.grad, gy.float().sum(dim=(0, 1, 2, 3))) <= 1e-5


@pytest.mark.cuda
def test_dw_wrapper_checks_on_card(cuda_device):
    x = torch.zeros(1, 4, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        kdw.conv3d_dw_cuda(x, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        kdw.conv3d_dw_cuda(x.transpose(1, 2), x)
    with pytest.raises(ValueError, match="want x"):
        kdw.conv3d_dw_cuda(x, x[:, :2])


def _voxel_batch(n, seed, site_pad=64, kinds=("perovskite", "rocksalt")):
    """n synthetic structures padded to ``site_pad`` sites, as the dataset
    build feeds the voxelizer: (sites, z, sigma, mask, abc) float32."""
    import numpy as np

    from icsg3d_torch.data.synthetic import random_structures
    from icsg3d_torch.ops.voxelize import pad_sites

    rows = []
    for s in random_structures(n, seed=seed, kinds=kinds):
        N, z, r = s.site_arrays()
        cart = N * np.asarray(s.lattice.abc, np.float64)
        rows.append((*pad_sites(cart, z, r, site_pad),
                     np.array(s.lattice.abc, np.float32)))
    return [torch.from_numpy(np.stack([r[i] for r in rows])) for i in range(5)]


# (inputs, d, site_pad, label_frac): n synthetic structures, the crafted
# square-root-tie and labelling-radius batch of test_torch_vox_plan.py, or
# the repo's real CIFs (those within 40 sites, as the build keeps them)
VOX_CASES = [
    (3, 16, 64, 1.0), (256, 32, 64, 1.0), (4, 5, 64, 1.0), (4, 33, 64, 1.0),
    (8, 64, 64, 1.0), (4, 16, 1024, 1.0), (6, 16, 64, 0.0), (6, 16, 64, 1.5),
    ("crafted", 8, 6, 1.0), ("crafted", 33, 6, 1.5), ("real", 32, 40, 1.0),
    ("real", 33, 40, 1.5),
]


def _vox_case_args(inputs, site_pad):
    if inputs == "crafted":
        from test_torch_vox_plan import crafted_batch

        return [torch.from_numpy(a) for a in crafted_batch()]
    if inputs == "real":
        from test_torch_vox_plan import _pack, _real_cifs

        return [torch.from_numpy(a) for a in _pack(_real_cifs(), site_pad)]
    return _voxel_batch(inputs, seed=inputs, site_pad=site_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,site_pad,label_frac", VOX_CASES,
                         ids=[f"{c[0]}-d{c[1]}-S{c[2]}-lf{c[3]}" for c in VOX_CASES])
def test_voxelize_kernel_matches_reference_on_card(cuda_device, n, d, site_pad, label_frac):
    """K4 against its plain version on the same operands: species
    identical, density within rtol 2e-4 / atol 1e-6 (sums over sites in
    another order, exp as ex2.approx); a second launch gives the same
    bits."""
    from icsg3d_torch.kernels import voxelize as kv

    args = [t.to(cuda_device) for t in _vox_case_args(n, site_pad)]
    B = args[0].shape[0]
    n0 = kv.launches
    dens, spec = kv.voxelize_cuda(*args, d, 0.25, label_frac)
    torch.cuda.synchronize()
    assert kv.launches == n0 + 1
    ref_d, ref_s = kv.voxelize_reference(*args, d, 0.25, label_frac)
    assert dens.shape == spec.shape == (B, d, d, d)
    assert torch.equal(spec, ref_s)
    assert torch.allclose(dens, ref_d, rtol=2e-4, atol=1e-6)
    assert int((spec > 0).sum()) > 0 or label_frac == 0.0
    again = kv.voxelize_cuda(*args, d, 0.25, label_frac)
    assert torch.equal(dens, again[0]) and torch.equal(spec, again[1])


@pytest.mark.cuda
def test_voxelize_wrapper_checks_on_card(cuda_device):
    from icsg3d_torch.kernels import voxelize as kv

    args = [t.to(cuda_device) for t in _voxel_batch(2, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        kv.voxelize_cuda(*[t.cpu() for t in args], 8, 0.25)
    with pytest.raises(ValueError, match="float32"):
        kv.voxelize_cuda(args[0].double(), *args[1:], 8, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        kv.voxelize_cuda(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                         *args[1:], 8, 0.25)
    big = [t.to(cuda_device) for t in _voxel_batch(1, seed=0,
                                                    site_pad=kv.MAX_SITES + 1)]
    with pytest.raises(ValueError, match="sites"):
        kv.voxelize_cuda(*big, 8, 0.25)


@pytest.mark.cuda
def test_unet_train_step_on_card_matches_cpu(cuda_device):
    """One U-Net train step's loss and gradients in float32 (the FMA
    kernels on the card: K1 forward, K1 as dx, K2, through the Function)
    against the CPU's plain versions: 14 forward, 13 dx and 14 dW
    launches, every gradient within 2e-3 of its max."""
    import numpy as np

    from icsg3d_torch.config import UNetConfig
    from icsg3d_torch.train.unet import _unet_losses, create_unet_state

    cfg = UNetConfig(num_classes=12, enc_filters=((4, 8), (8, 8), (8, 16)),
                     bottom_filters=(16, 16), dec_filters=((16, 8), (8, 8), (8, 8)),
                     dtype="float32")
    rng = np.random.default_rng(6)
    batch = {"density": rng.random((2, 8, 8, 8), np.float32),
             "abc": rng.uniform(3, 6, (2, 3)).astype(np.float32),
             "labels": rng.integers(0, 12, (2, 8, 8, 8)).astype(np.uint8)}
    out = {}
    for dev in ("cpu", "cuda"):
        model = create_unet_state(cfg, 1e-3, 0, dev).model
        b = {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}
        counts = (k.launches, k.launches_dx, kdw.launches)
        loss, _ = _unet_losses(model, b, torch.linspace(0, 2, 12, device=dev), True)
        loss.backward()
        torch.cuda.synchronize()
        launched = (k.launches - counts[0], k.launches_dx - counts[1],
                    kdw.launches - counts[2])
        assert launched == ((14, 13, 14) if dev == "cuda" else (0, 0, 0))
        out[dev] = (float(loss.detach()), {n: p.grad.detach().cpu()
                                  for n, p in model.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for n, g in out["cpu"][1].items():
        err = float((out["cuda"][1][n] - g).abs().max())
        assert err <= 2e-3 * max(float(g.abs().max()), 1e-6), n


# -- the depth-VALID modes (K1 VALID, its full-window dx, K2 VALID) ------------

VALID_CASES = [
    # (B, D out, H, W, Cin, Cout, in dtype, out dtype, epilogue): x has D + 2
    (2, 4, 8, 8, 14, 16, torch.bfloat16, torch.bfloat16, "affine_leaky"),
    (2, 1, 2, 2, 128, 4, torch.bfloat16, torch.bfloat16, "bias"),  # enc Conv_4 slab
    (1, 4, 8, 8, 64, 72, torch.bfloat16, torch.bfloat16, "relu_affine"),
    (2, 8, 8, 8, 16, 4, torch.float32, torch.float32, "affine_relu"),  # f32 head
    (1, 2, 4, 4, 33, 130, torch.bfloat16, torch.float32, "affine_relu"),
    (2, 3, 8, 8, 24, 20, torch.float32, torch.float32, "affine_leaky"),
    (1, 5, 7, 6, 4, 9, torch.float32, torch.bfloat16, "bias"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", VALID_CASES)
def test_valid_kernel_matches_reference_on_card(cuda_device, case):
    B, D, H, W, cin, cout, dt, odt, epi = case
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(B, D + 2, H, W, cin, generator=g).to(cuda_device, dt)
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cin) ** 0.5).to(
        cuda_device, dt)
    b, scale, shift = (torch.randn(cout, generator=g).to(cuda_device) for _ in range(3))
    n0, s0 = k.launches_valid, k.launches
    got = k.conv3d_valid_cuda(x, w, b, scale, shift, epi, odt)
    torch.cuda.synchronize()
    assert (k.launches_valid, k.launches) == (n0 + 1, s0)
    ref = k.conv3d_valid_reference(x, w, b, scale, shift, epi, odt)
    assert got.dtype == odt and got.shape == ref.shape == (B, D, H, W, cout)
    assert _rel_err(got, ref) <= (1e-2 if odt == torch.bfloat16 else 1e-4)


DX_VALID_CASES = [
    # (B, D of g, H, W, Cin, Cout, dtype): dx has D + 2 planes of Cin
    (2, 4, 8, 8, 4, 32, torch.bfloat16),
    (2, 1, 2, 2, 128, 4, torch.bfloat16),   # g of 4 channels, one plane
    (1, 3, 6, 5, 64, 72, torch.bfloat16),
    (2, 8, 8, 8, 16, 4, torch.float32),     # the f32 output head
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DX_VALID_CASES)
def test_dx_valid_kernel_matches_reference_on_card(cuda_device, case):
    B, D, H, W, cin, cout, dt = case
    g = torch.Generator(device="cpu").manual_seed(6)
    gy = torch.randn(B, D, H, W, cout, generator=g).to(cuda_device, dt)
    w = (torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * cout) ** 0.5).to(
        cuda_device, dt)
    n0, d0 = k.launches_dx_valid, k.launches_dx
    got = k.conv3d_dx_valid_cuda(gy, w)
    torch.cuda.synchronize()
    assert (k.launches_dx_valid, k.launches_dx) == (n0 + 1, d0)
    ref = k.conv3d_dx_valid_reference(gy, w)
    assert got.shape == (B, D + 2, H, W, cin) and got.dtype == dt
    assert _rel_err(got, ref) <= (1e-2 if dt == torch.bfloat16 else 1e-4)


DW_VALID_CASES = [
    # (B, D of g, H, W, Cin, Cout, dtype): x has D + 2 planes
    (2, 4, 8, 8, 16, 32, torch.bfloat16),   # Cin on wgmma's N
    (2, 4, 8, 8, 14, 16, torch.bfloat16),   # Cin 14: channels padded to 16
    (1, 2, 4, 4, 4, 128, torch.bfloat16),   # Cin 4
    (2, 1, 2, 2, 128, 4, torch.bfloat16),   # Cout 4, one plane per slab
    (2, 2, 4, 4, 64, 64, torch.bfloat16),   # edge 4
    (2, 3, 7, 6, 24, 40, torch.bfloat16),   # ragged tiles
    (1, 16, 32, 32, 192, 128, torch.bfloat16),  # conv13 slab at B = 1
    (1, 8, 16, 16, 384, 256, torch.bfloat16),   # conv11 slab
    (1, 4, 8, 8, 768, 512, torch.bfloat16),     # conv9 slab
    (2, 8, 8, 8, 16, 4, torch.float32),     # the f32 output head
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_VALID_CASES)
def test_dw_valid_kernel_matches_reference_on_card(cuda_device, case):
    B, D, H, W, cin, cout, dt = case
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(B, D + 2, H, W, cin, generator=g).to(cuda_device, dt)
    gy = torch.randn(B, D, H, W, cout, generator=g).to(cuda_device, dt)
    n0, s0 = kdw.launches_valid, kdw.launches
    got = kdw.conv3d_dw_valid_cuda(x, gy)
    torch.cuda.synchronize()
    assert (kdw.launches_valid, kdw.launches) == (n0 + 1, s0)
    ref = kdw.conv3d_dw_valid_reference(x, gy)
    assert got.shape == (3, 3, 3, cin, cout) and _rel_err(got, ref) <= 1e-3
    assert torch.equal(got, kdw.conv3d_dw_valid_cuda(x, gy))  # deterministic


@pytest.mark.cuda
def test_valid_wrappers_check_on_card(cuda_device):
    x = torch.zeros(1, 2, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 8, 8, device=cuda_device, dtype=torch.bfloat16)
    b = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="no output plane"):
        k.conv3d_valid_cuda(x, w, b)
    with pytest.raises(ValueError, match="want x"):
        kdw.conv3d_dw_valid_cuda(x, x)  # x must have 2 planes more than g
    with pytest.raises(ValueError, match="CUDA"):
        kdw.conv3d_dw_valid_cuda(x.cpu(), x.cpu()[:, :0])


def _sharded_vs_same(mesh, device, batch):
    """conv_sharded over ``mesh`` against the SAME Function on ``device``:
    values and the three gradients, and one VALID forward, dx and dW
    launch per cell."""
    from icsg3d_torch.ops.conv import conv3d_same_diff
    from icsg3d_torch.parallel import conv_sharded

    n = mesh.devices.size
    g = torch.Generator(device="cpu").manual_seed(8)
    x0 = torch.randn(batch, 8, 8, 8, 32, generator=g).to(device, torch.bfloat16)
    w0 = torch.randn(3, 3, 3, 32, 16, generator=g).to(device) / (27 * 32) ** 0.5
    b0 = torch.randn(16, generator=g).to(device)
    gy = torch.randn(batch, 8, 8, 8, 16, generator=g).to(device, torch.bfloat16)
    out = []
    for sharded in (True, False):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        counts = (k.launches_valid, k.launches_dx_valid, kdw.launches_valid)
        y = conv_sharded(x, w, b, mesh) if sharded else conv3d_same_diff(x, w, b)
        (y.float() * gy.float()).sum().backward()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        got = (k.launches_valid - counts[0], k.launches_dx_valid - counts[1],
               kdw.launches_valid - counts[2])
        assert got == ((n, n, n) if sharded else (0, 0, 0))
        out.append((y, x.grad, w.grad, b.grad))
    for name, a, ref in zip(("y", "dx", "dw", "db"), *out):
        assert a.device == ref.device, name
        assert _rel_err(a, ref) <= (1e-2 if a.dtype == torch.bfloat16 else 1e-3), name


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_sharded_conv_on_card_matches_same_conv(cuda_device, mesh_shape):
    """A mesh of the one card (cells share it)."""
    from icsg3d_torch.parallel import make_mesh

    n = mesh_shape[0] * mesh_shape[1]
    _sharded_vs_same(make_mesh(*mesh_shape, devices=[cuda_device] * n), cuda_device, 4)


@pytest.mark.cuda
def test_sharded_conv_across_cards_matches_same_conv(cuda_device):
    """make_mesh's default mesh over every visible card (n/2 x 2): slabs
    and halos cross cards, the result comes back to card 0."""
    from icsg3d_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    mesh = make_mesh(n_spatial=2)
    assert len({d.index for d in mesh.devices.flat}) == mesh.devices.size
    _sharded_vs_same(mesh, torch.device("cuda", 0), 2 * mesh.shape["data"])


# -- the f32 kernels (the VAE's f32 output head and any f32 conv) -------------

F32_GRIDS = [
    # (B, D, H, W): the head at production (32^3, batch 20) and ragged rows
    (20, 32, 32, 32),
    (2, 5, 3, 1),
    (2, 4, 5, 33),
    (1, 3, 2, 130),
]
# (grid, Cin, Cout): the head (16 -> 4) at every grid, the general f32
# shapes 14 -> 16 and 32 -> 64 at the ragged ones
F32_CASES = ([(g, 16, 4) for g in F32_GRIDS]
             + [(g, ci, co) for g in F32_GRIDS[1:] for ci, co in ((14, 16), (32, 64))])
F32_IDS = [f"{ci}to{co}-b{b}d{d}h{h}w{w}" for (b, d, h, w), ci, co in F32_CASES]
EPILOGUES = ("bias", "affine_leaky", "relu_affine", "affine_relu")


def _f32_operands(seed, B, D, H, W, cin, cout, depth_extra=0, cotangent=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(B, D + depth_extra, H, W, cout if cotangent else cin, generator=g)
    w = torch.randn(3, 3, 3, cin, cout, generator=g) / (27 * (cout if cotangent else cin)) ** 0.5
    return a.cuda(), w.cuda(), g


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("case", F32_CASES, ids=F32_IDS)
def test_f32_forward_kernel_on_card(cuda_device, case, mode):
    """The f32 window kernel's forward, SAME and depth-VALID, every epilogue,
    f32 and bf16 out, against the plain version (1e-4 / 1e-2 of max|ref|);
    a second launch gives the same bits."""
    (B, D, H, W), cin, cout = case
    x, w, g = _f32_operands(20, B, D, H, W, cin, cout, 2 if mode == "valid" else 0)
    b, scale, shift = (torch.randn(cout, generator=g).cuda() for _ in range(3))
    run = k.conv3d_same_cuda if mode == "same" else k.conv3d_valid_cuda
    ref_fn = k.conv3d_same_reference if mode == "same" else k.conv3d_valid_reference
    assert k.describe(tuple(x.shape), cout, torch.float32, mode)["path"] == "fma+window"
    for epi in EPILOGUES:
        for odt in (torch.float32, torch.bfloat16):
            args = (x, w, b, scale, shift, epi, odt)
            got = run(*args)
            torch.cuda.synchronize()
            ref = ref_fn(*args)
            assert got.dtype == odt and got.shape == ref.shape == (B, D, H, W, cout)
            assert _rel_err(got, ref) <= (1e-4 if odt == torch.float32 else 1e-2), (epi, odt)
            assert torch.equal(got, run(*args)), (epi, odt)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["same", "full"])
@pytest.mark.parametrize("case", F32_CASES, ids=F32_IDS)
def test_f32_dx_kernel_on_card(cuda_device, case, mode):
    """The f32 input gradient, SAME and the full depth window, f32 and bf16
    out, read from w's flipped taps: within 1e-4 / 1e-2 of max|ref|, the
    same bits again."""
    (B, D, H, W), cin, cout = case
    gy, w, _ = _f32_operands(21, B, D, H, W, cin, cout, cotangent=True)
    run = k.conv3d_dx_cuda if mode == "same" else k.conv3d_dx_valid_cuda
    ref_fn = k.conv3d_dx_reference if mode == "same" else k.conv3d_dx_valid_reference
    for odt in (torch.float32, torch.bfloat16):
        got = run(gy, w, odt)
        torch.cuda.synchronize()
        ref = ref_fn(gy, w, odt)
        assert got.shape == ref.shape == (B, D + (2 if mode == "full" else 0), H, W, cin)
        assert got.dtype == odt
        assert _rel_err(got, ref) <= (1e-4 if odt == torch.float32 else 1e-2), odt
        assert torch.equal(got, run(gy, w, odt))


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1], ids=["same", "valid"])
@pytest.mark.parametrize("case", F32_CASES, ids=F32_IDS)
def test_f32_dw_kernel_on_card(cuda_device, case, off):
    """The f32 sliding-window weight gradient, SAME and depth-VALID: within
    1e-3 of max|ref|, and the split sum in a fixed order gives the same
    bits again."""
    (B, D, H, W), cin, cout = case
    x, _, g = _f32_operands(22, B, D, H, W, cin, cout, 2 * off)
    gy = torch.randn(B, D, H, W, cout, generator=g).cuda()
    run = kdw.conv3d_dw_valid_cuda if off else kdw.conv3d_dw_cuda
    ref_fn = kdw.conv3d_dw_valid_reference if off else kdw.conv3d_dw_reference
    assert kdw.describe(tuple(x.shape), tuple(gy.shape), torch.float32, off)["path"] == \
        "fma+slide"
    got = run(x, gy)
    torch.cuda.synchronize()
    ref = ref_fn(x, gy)
    assert got.shape == (3, 3, 3, cin, cout) and _rel_err(got, ref) <= 1e-3
    assert torch.equal(got, run(x, gy))


@pytest.mark.cuda
def test_f32_dw_kernel_wide_row_on_card(cuda_device):
    """The f32 weight gradient at W = 1000: a row too wide for one launch's
    window, split into column segments summed in order; equal bits again."""
    g = torch.Generator(device="cpu").manual_seed(23)
    x = torch.randn(1, 2, 3, 1000, 16, generator=g).to(cuda_device)
    gy = torch.randn(1, 2, 3, 1000, 4, generator=g).to(cuda_device)
    assert kdw.fma_plan(1, 2, 3, 1000, 16, 4, 0).segments > 1
    got = kdw.conv3d_dw_cuda(x, gy)
    torch.cuda.synchronize()
    assert _rel_err(got, kdw.conv3d_dw_reference(x, gy)) <= 1e-3
    assert torch.equal(got, kdw.conv3d_dw_cuda(x, gy))


# -- CGCNN and evaluate (no hand-written kernel in CGCNN: f32 matmuls) --------

def _cgcnn_batch(n=32, seed=24):
    import numpy as np

    from icsg3d_torch.data.graphs import GraphSpec, featurize_batch
    from icsg3d_torch.data.synthetic import random_structures, synthetic_target

    structures = random_structures(n, seed=seed, kinds=("perovskite", "rocksalt"))
    graphs = featurize_batch(structures, GraphSpec())
    graphs["target"] = np.asarray([synthetic_target(s) for s in structures],
                                  np.float32)
    return graphs


@pytest.mark.cuda
def test_cgcnn_forward_on_card_matches_cpu(cuda_device):
    """The full-width CGCNN forward at batch 32 on featurized structures:
    f32 on the card (TF32 off) against the CPU, within 1e-5 of max|pred|
    (f32 sums in another order)."""
    from icsg3d_torch.config import CGCNNConfig
    from icsg3d_torch.train.cgcnn import cgcnn_forward, create_cgcnn_state

    assert not torch.backends.cuda.matmul.allow_tf32
    graphs = _cgcnn_batch()
    out = {}
    for dev in ("cpu", "cuda"):
        model = create_cgcnn_state(CGCNNConfig(), 1e-3, 0, dev).model.eval()
        with torch.no_grad():
            out[dev] = cgcnn_forward(model, {key: torch.from_numpy(v).to(dev)
                                             for key, v in graphs.items()}).cpu()
    assert out["cuda"].dtype == torch.float32 and out["cuda"].shape == (32,)
    scale = max(float(out["cpu"].abs().max()), 1.0)
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cgcnn_train_step_on_card_matches_cpu(cuda_device):
    """One CGCNN train step at batch 32, the card against the CPU from the
    same weights: loss within 1e-5 relative, every gradient within 1e-4
    of its max, then the Adam update within 1e-5 of each parameter's
    max."""
    from icsg3d_torch.config import CGCNNConfig
    from icsg3d_torch.train.cgcnn import create_cgcnn_state, make_cgcnn_steps

    graphs = _cgcnn_batch(seed=25)
    out = {}
    for dev in ("cpu", "cuda"):
        state = create_cgcnn_state(CGCNNConfig(), 1e-3, 0, dev)
        train_step, _ = make_cgcnn_steps(state.model)
        mets = train_step(state, {key: torch.from_numpy(v).to(dev)
                                  for key, v in graphs.items()})
        out[dev] = (float(mets["loss"]),
                    {n: (p.grad.detach().cpu(), p.detach().cpu())
                     for n, p in state.model.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for n, (g, p) in out["cpu"][1].items():
        gc, pc = out["cuda"][1][n]
        assert float((gc - g).abs().max()) <= 1e-4 * max(float(g.abs().max()), 1e-12), n
        assert float((pc - p).abs().max()) <= 1e-5 * max(float(p.abs().max()), 1.0), n


@pytest.mark.cuda
def test_evaluate_batch_on_card_matches_cpu(cuda_device, tmp_path):
    """One evaluate batch (d = 8, VAE filters 4, 8, the full-width U-Net,
    seeded) on the card and on the CPU with the same noise: the same
    samples evaluated, lattices within 1e-2 relative (bf16 on the card),
    and per batch one K1 ``bias`` launch (the encoder's last conv) and
    2 x 2 + 1 + 14 folded ones."""
    import numpy as np

    from icsg3d_torch.apps import common
    from icsg3d_torch.apps.evaluate import evaluate_reconstructions
    from icsg3d_torch.config import (GridSpec, PipelineConfig, UNetConfig,
                                     VAEConfig, VoxelizerConfig)
    from icsg3d_torch.data.binning import bin_and_encode
    from icsg3d_torch.data.synthetic import build_dataset

    grid = GridSpec(d=8)
    ds = build_dataset(str(tmp_path / "data"), n=4, cfg=VoxelizerConfig(grid=grid),
                       kinds=("perovskite", "rocksalt"), device="cpu")
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    out = {}
    for dev in ("cpu", "cuda"):
        dt = common.compute_dtype(torch.device(dev))
        vae = common.load_vae(VAEConfig(grid=grid, filters=(4, 8), latent_dim=8,
                                        dtype=dt), None, device=dev)
        unet = common.load_unet(UNetConfig(dtype=dt), None, device=dev)
        before = dict(k.launches_by_epilogue)
        out[dev] = evaluate_reconstructions(vae, unet, ds, ds.ids, conds,
                                            batch_size=4, pipe=PipelineConfig(grid=grid))
        torch.cuda.synchronize()
        after = k.launches_by_epilogue
        launched = {e: after[e] - before[e] for e in after}
        if dev == "cuda":
            assert launched["bias"] == 1
            assert sum(launched[e] for e in ("affine_leaky", "relu_affine",
                                              "affine_relu")) == 2 * 2 + 1 + 14
    assert out["cuda"]["n_evaluated"] == out["cpu"]["n_evaluated"] == 4
    lc, lg = (np.asarray(out[d]["lattice_pred"]) for d in ("cpu", "cuda"))
    assert float(np.max(np.abs(lg - lc) / np.abs(lc))) <= 1e-2


def _extract_operands(d: int, n: int, device, skip=()):
    """E1 and E2 operands at d^3 on ``device``: n decoded-like blob masks,
    their cores, the erosion split's seeds, and the adversarial grids of
    test_torch_extract_plan (at d^3) but those named in ``skip``."""
    import numpy as np

    from icsg3d_torch.ops import extract as ex
    from test_torch_extract_plan import adversarial, bfs_operands, blob_masks

    fg = torch.from_numpy(blob_masks(n, (d, d, d), d)).to(device)
    cc_ops = {"foreground": fg.to(torch.int32),
              "cores": ex.erode6(fg).to(torch.int32)}
    bfs_ops = {"split": bfs_operands(cc_ops["foreground"])}
    for name, (grid, seeds) in adversarial(d).items():
        if name in skip:
            continue
        cc_ops[name] = torch.from_numpy(np.ascontiguousarray(grid[None])).to(device)
        if seeds is not None:
            seeds = torch.from_numpy(seeds[None]).to(device)
        bfs_ops[name] = bfs_operands(cc_ops[name], seeds)
    return cc_ops, bfs_ops


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,cluster", [(32, 4, 1), (32, 4, 4), (32, 4, 16), (64, 2, None)],
                         ids=["32-c1", "32-c4", "32-c16", "64-plan"])
def test_extract_kernels_match_plain_on_card(cuda_device, d, n, cluster):
    """E1 and E2 bitwise their plain versions on the same operands, and
    E2's largest per-sample round count the plain version's; one launch
    each.  At 32^3 the cluster size is forced to 1, 4 and 16 CTAs per
    sample; at 64^3 it is the plan's, with the state in shared memory."""
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.ops import extract as ex

    # the snake at 32^3 only: at 64^3 its ~67,000 plain rounds take minutes
    cc_ops, bfs_ops = _extract_operands(d, n, cuda_device,
                                        skip=("snake",) if d == 64 else ())
    def size(grid):  # the non-cubic grid's 9 planes take only a cluster of one
        return cluster if cluster and grid.shape[1] % cluster == 0 else None

    for name, sp in cc_ops.items():
        p = kext.launch_plan("cc", sp, size(sp))
        assert size(sp) in (None, p.cluster) and p.path == "shared"
        n0 = kext.launches_cc
        got, rounds = kext.connected_components_cuda(sp, cluster=size(sp))
        torch.cuda.synchronize()
        assert kext.launches_cc == n0 + 1
        want, want_rounds = ex.connected_components_reference(sp, return_rounds=True)
        assert torch.equal(got, want), (name, p)
        assert 1 <= int(rounds.min()) and int(rounds.max()) <= want_rounds, (name, p)
    for name, ops in bfs_ops.items():
        seeds, cc, fg, sl = ops
        p = kext.launch_plan("bfs", cc, size(cc))
        assert size(cc) in (None, p.cluster) and p.path == "shared"
        n0 = kext.launches_bfs
        got, rounds = kext.nearest_seed_labels_cuda(seeds, cc, fg, sl, cluster=size(cc))
        torch.cuda.synchronize()
        assert kext.launches_bfs == n0 + 1
        want, want_rounds = ex.nearest_seed_labels_reference(seeds, cc, fg, sl,
                                                             return_rounds=True)
        assert torch.equal(got, want), (name, p)
        assert int(rounds.min()) >= 1 and int(rounds.max()) == want_rounds, (name, p)


@pytest.mark.cuda
def test_extract_kernel_wrappers_check_on_card(cuda_device):
    from icsg3d_torch.kernels import extract as kext

    sp = torch.zeros(1, 4, 4, 4, dtype=torch.int32, device=cuda_device)
    b = sp > 0
    with pytest.raises(ValueError, match="int32"):
        kext.connected_components_cuda(sp.float())
    with pytest.raises(ValueError, match="contiguous"):
        kext.connected_components_cuda(sp.transpose(1, 2))
    with pytest.raises(ValueError, match="grid"):
        kext.connected_components_cuda(sp[0])
    with pytest.raises(ValueError, match="fg must be"):
        kext.nearest_seed_labels_cuda(b, sp, b[:, :2])
    with pytest.raises(ValueError, match="seed_labels"):
        kext.nearest_seed_labels_cuda(b, sp, b, sp.long())


@pytest.mark.cuda
def test_extract_atoms_makes_no_host_sync_on_card(cuda_device):
    """The card's extraction (E1 twice, E2 once, torch ops) never waits for
    the device: it runs under sync-debug mode "error", and it returns to
    the host while a long kernel queued before it is still running."""
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.ops.extract import extract_atoms
    from test_torch_extract_plan import blob_masks

    mask = torch.from_numpy(blob_masks(20, (32, 32, 32), 1)).to(cuda_device)
    g = torch.Generator(device="cpu").manual_seed(0)
    spec = torch.randint(1, 95, mask.shape, generator=g, dtype=torch.int32)
    spec = torch.where(mask, spec.to(cuda_device), 0)
    binary = mask.to(torch.int32)
    cpu = extract_atoms(spec.cpu(), binary.cpu())
    extract_atoms(spec, binary)  # builds and loads the kernels
    torch.cuda.synchronize()
    n_cc, n_bfs = kext.launches_cc, kext.launches_bfs
    done = torch.cuda.Event()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at H100 clocks
        out = extract_atoms(spec, binary)
        done.record()
        still_running = not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert still_running
    assert (kext.launches_cc - n_cc, kext.launches_bfs - n_bfs) == (2, 1)
    assert int(cpu[2].sum()) > 0
    for c, got in zip(cpu, out):
        assert torch.allclose(c.double(), got.cpu().double(), atol=1e-5)


# -- the resident epoch as replays of captured steps (train/graphs.py) --------

EPOCH_N, EPOCH_B, EPOCH_D = 12, 4, 16  # 3 train steps and 2 val batches per epoch
TINY_UNET = dict(num_classes=12, enc_filters=((8, 16), (16, 16), (16, 32)),
                 bottom_filters=(32, 32), dec_filters=((32, 16), (16, 16), (16, 16)))


def _epoch_split(n, seed):
    """n smooth densities at EPOCH_D with lattice lengths, one-hot
    conditions and species labels (a resident split of the trainers)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = np.mgrid[:EPOCH_D, :EPOCH_D, :EPOCH_D].astype(np.float32)
    density = np.stack([
        np.exp(-((g - rng.uniform(3, EPOCH_D - 3, 3)[:, None, None, None]) ** 2).sum(0)
               / 6.0) for _ in range(n)]).astype(np.float32)
    labels = np.where(density > 0.3, rng.integers(1, 12, density.shape), 0)
    return {"density": density,
            "abc": rng.uniform(3.0, 7.0, (n, 3)).astype(np.float32),
            "cond": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)],
            "labels": labels.astype(np.uint8)}


def _epoch_models(case, device, group=None):
    """(make state, train function, its kwargs) of one epoch-path case,
    seeded; ``group`` trains it data-parallel."""
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.models import UNet3D
    from icsg3d_torch.parallel.mesh import make_mesh
    from icsg3d_torch.train import unet as tunet
    from icsg3d_torch.train import vae as tvae

    train = _epoch_split(EPOCH_N, 1)
    val = _epoch_split(8, 2)
    if case == "unet":
        fields = ("density", "abc", "labels")
        cfg = UNetConfig(**TINY_UNET)
        return (lambda: tunet.create_unet_state(cfg, 1e-3, 0, device, group=group),
                tunet.train_unet,
                dict(log_fn=lambda *_: None, class_weights=[0.0] + [1.0] * 11,
                     resident_data=tuple({k: s[k] for k in fields} for s in (train, val))))
    fields = ("density", "abc", "cond")
    mesh = make_mesh(1, 2, devices=[device, device]) if case == "vae_spatial" else None
    cfg = VAEConfig(grid=GridSpec(d=EPOCH_D), filters=(8, 16), latent_dim=8)
    unet = UNet3D(UNetConfig(**TINY_UNET), torch.Generator().manual_seed(3)).to(device)
    return (lambda: tvae.create_vae_state(cfg, 5e-4, 0, device, spatial_mesh=mesh,
                                          group=group),
            tvae.train_vae,
            dict(unet=unet, seed=5, remat_perceptual=case == "vae_remat",
                 cache_true_features=case == "vae_cached",
                 resident_data=tuple({k: s[k] for k in fields} for s in (train, val))))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vae", "vae_cached", "vae_remat", "vae_spatial", "unet"])
def test_epoch_capture_matches_per_step_on_card(cuda_device, case):
    """Two epochs of ``epoch_scan`` (a captured train and eval step,
    replayed) against the per-step resident loop from the same seed:
    parameters, BatchNorm buffers, Adam's moments and step, and every
    metric bitwise equal, except the U-Net's per-class CE sums, which
    ``index_add_`` accumulates with float atomics in no fixed order (1e-5
    relative).  The kernels the card ran on the captured path (eager
    launches, plus each capture's recorded launches times its replays) are
    the per-step path's."""
    import numpy as np

    from icsg3d_torch.train import graphs

    make_state, train, kw = _epoch_models(case, cuda_device)
    runs = []
    for scan in (False, True):
        state = make_state()
        graphs.reset_captures()
        k.reset_launches()
        kdw.reset_launches()
        _, hist = train(state.model, state, None, None, 2, batch_size=EPOCH_B,
                        shuffle_seed=3, epoch_scan=scan, **kw)
        torch.cuda.synchronize()
        counts = graphs.launch_counts()
        for c in graphs.captures:
            for key, n in c.launches.items():
                counts[key] += n * (c.replays - 1)
        runs.append((hist, state.arrays(), counts, list(graphs.captures)))
    (h0, a0, c0, _), (h1, a1, c1, caps) = runs
    assert [c.name.split("_")[1] for c in caps] == ["train", "eval"]
    assert [c.replays for c in caps] == [2 * 3 - 1, 2 * 2 - 1]  # one warm-up step each
    assert c1 == c0 and c0["conv3d"] > 0
    assert a0.keys() == a1.keys()
    for key in a0:
        np.testing.assert_array_equal(a0[key], a1[key], err_msg=key)
    for e0, e1 in zip(h0, h1):
        for split in ("train", "val"):
            for key, v in e0[split].items():
                if key == "ce_per_class":
                    np.testing.assert_allclose(e1[split][key], v, rtol=1e-5, err_msg=key)
                else:
                    assert e1[split][key] == v, (split, key)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["vae", "unet"])
def test_captured_epoch_makes_no_host_sync_on_card(cuda_device, model):
    """After the epoch that captures, an epoch's replays (with the noise
    draws and the buffers' device copies) run under sync-debug mode
    "error" and return while a long kernel queued before them still runs;
    the one fetch afterwards holds every step's finite metrics."""
    from icsg3d_torch.train import graphs
    from icsg3d_torch.train import unet as tunet
    from icsg3d_torch.train import vae as tvae

    make_state, _, kw = _epoch_models(model, cuda_device)
    state = make_state()
    data = {k: torch.from_numpy(v).to(cuda_device) for k, v in kw["resident_data"][0].items()}
    if model == "unet":
        train_epoch, _ = tunet.make_unet_epoch_fns(state.model)
    else:
        train_epoch, _ = tvae.make_vae_epoch_fns(state.model, kw["unet"])
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def noise():
        if model == "unet":
            return None
        return torch.stack([torch.randn((EPOCH_B, 8), generator=gen, device=cuda_device)
                            for _ in range(EPOCH_N // EPOCH_B)])

    def rows(epoch):
        import numpy as np

        perm = np.random.default_rng((3, epoch)).permutation(EPOCH_N)
        return torch.from_numpy(perm.reshape(-1, EPOCH_B)).to(cuda_device)

    train_epoch(state, data, rows(0), noise())  # warm-up step, capture, replays
    torch.cuda.synchronize()
    assert train_epoch.graph is not None
    replays = train_epoch.capture.replays
    perm = rows(1)  # the epoch's one upload
    done = torch.cuda.Event()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at H100 clocks
        buf = train_epoch(state, data, perm, noise())
        done.record()
        still_running = not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fetched = buf.cpu()  # the epoch's one fetch
    assert still_running
    assert train_epoch.capture.replays == replays + EPOCH_N // EPOCH_B
    assert state.step == 2 * EPOCH_N // EPOCH_B
    assert fetched.shape[0] == EPOCH_N // EPOCH_B and bool(torch.isfinite(fetched).all())
    assert graphs.capture_refusal(state) is None


@pytest.fixture
def nccl_world_1(cuda_device, tmp_path):
    """A one-rank NCCL process group over a file store in tmp_path."""
    from icsg3d_torch.parallel import distributed

    torch.cuda.set_device(0)
    group = distributed.initialize("file://" + str(tmp_path / "store"), 1, 0,
                                   backend="nccl", timeout=120)
    yield group
    distributed.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["vae", "unet"])
def test_epoch_capture_under_an_nccl_group_on_card(nccl_world_1, model):
    """Under a one-rank NCCL group (its all-reduces inside the captured
    steps) two epochs of ``epoch_scan`` equal the per-step resident loop
    bitwise (the U-Net's per-class CE sums, ``index_add_`` atomics, within
    1e-5 relative) with the same kernel launches; then one more epoch's
    replays make no host sync (sync-debug mode "error") and return while a
    long kernel queued before them still runs."""
    import numpy as np

    from icsg3d_torch.train import graphs
    from icsg3d_torch.train import unet as tunet
    from icsg3d_torch.train import vae as tvae

    device = torch.device("cuda", 0)
    make_state, train, kw = _epoch_models(model, device, nccl_world_1)
    runs = []
    for scan in (False, True):
        state = make_state()
        assert graphs.capture_refusal(state) is None
        graphs.reset_captures()
        k.reset_launches()
        kdw.reset_launches()
        _, hist = train(state.model, state, None, None, 2, batch_size=EPOCH_B,
                        shuffle_seed=3, epoch_scan=scan, **kw)
        torch.cuda.synchronize()
        counts = graphs.launch_counts()
        for c in graphs.captures:
            for key, n in c.launches.items():
                counts[key] += n * (c.replays - 1)
        runs.append((hist, state.arrays(), counts, list(graphs.captures)))
    (h0, a0, c0, _), (h1, a1, c1, caps) = runs
    assert [c.replays for c in caps] == [2 * 3 - 1, 2 * 2 - 1]
    assert c1 == c0 and c0["conv3d"] > 0
    for key in a0:
        np.testing.assert_array_equal(a0[key], a1[key], err_msg=key)
    for e0, e1 in zip(h0, h1):
        for split in ("train", "val"):
            for key, v in e0[split].items():
                if key == "ce_per_class":
                    np.testing.assert_allclose(e1[split][key], v, rtol=1e-5, err_msg=key)
                else:
                    assert e1[split][key] == v, (split, key)

    data = {name: torch.from_numpy(v).to(device)
            for name, v in kw["resident_data"][0].items()}
    if model == "unet":
        train_epoch, _ = tunet.make_unet_epoch_fns(state.model)
    else:
        train_epoch, _ = tvae.make_vae_epoch_fns(state.model, kw["unet"])
    gen = torch.Generator(device=device).manual_seed(0)

    def noise():
        return None if model == "unet" else torch.stack([
            torch.randn((EPOCH_B, 8), generator=gen, device=device)
            for _ in range(EPOCH_N // EPOCH_B)])

    rows = torch.from_numpy(np.random.default_rng(4).permutation(EPOCH_N).reshape(
        -1, EPOCH_B)).to(device)
    train_epoch(state, data, rows, noise())  # warm-up step, capture, replays
    torch.cuda.synchronize()
    replays = train_epoch.capture.replays
    rows = torch.from_numpy(np.random.default_rng(5).permutation(EPOCH_N).reshape(
        -1, EPOCH_B)).to(device)
    done = torch.cuda.Event()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at H100 clocks
        buf = train_epoch(state, data, rows, noise())
        done.record()
        still_running = not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fetched = buf.cpu()
    assert still_running
    assert train_epoch.capture.replays == replays + EPOCH_N // EPOCH_B
    assert bool(torch.isfinite(fetched).all())


@pytest.mark.cuda
def test_load_arrays_puts_adam_step_on_the_parameters_device(cuda_device):
    """Adam is capturable on the card; a state restored by ``load_arrays``
    keeps its step count on the parameters' device and takes the next
    update exactly as the state it was saved from."""
    import numpy as np

    from icsg3d_torch.train import vae as tvae

    make_state, _, kw = _epoch_models("vae", cuda_device)
    split = {k: torch.from_numpy(v[:EPOCH_B]).to(cuda_device)
             for k, v in kw["resident_data"][0].items()}
    eps = torch.randn((EPOCH_B, 8), generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    state = make_state()
    assert state.optimizer.param_groups[0]["capturable"]
    step, _ = tvae.make_vae_steps(state.model, kw["unet"])
    step(state, split, eps)
    restored = make_state()
    restored.load_arrays(state.arrays())
    for p in restored.model.parameters():
        st = restored.optimizer.state[p]
        assert st["step"].device == p.device and float(st["step"]) == 1.0
    step(state, split, eps)
    step(restored, split, eps)
    torch.cuda.synchronize()
    a, b = state.arrays(), restored.arrays()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
