"""The hand-written conv kernel on the card against its plain version.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports no JAX (the machine with the card has none), so it runs there
without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bounds: max |kernel - reference| / max |reference| <= 1e-2 for a bf16
output (bf16 rounding of the output), <= 1e-4 for an f32 output (f32
sums in another order).  The reference runs F.conv3d with TF32 off.
"""

import pytest
import torch

from icsg3d_torch.kernels import conv3d as k

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
