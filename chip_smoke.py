#!/usr/bin/env python3
"""Smoke test of the PyTorch port (icsg3d_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. Device: the card's name and ``nvidia-smi`` name and power limit; CUDA
   must be available.
2. Build: compile icsg3d_torch/csrc/conv3d.cu for sm_90a (nvcc, ctypes).
3. Kernel vs plain: every 3x3x3 conv shape of the generation path at
   batch 20, with its path epilogue, against ``conv3d_same_reference``
   (F.conv3d in f32 on the same bf16 operands, TF32 off).  Bound on
   max|err| / max|ref|: 1e-2 for bf16 outputs, 1e-4 for the f32 output.
   Times are CUDA-event medians of 10 runs, for the kernel, the plain
   version, and cuDNN in bf16 for scale.
4. Main path: ``icsg3d_torch.apps.generate.main`` on a synthetic 32^3
   GridDataset with seeded full-width weights (.npz), 40 samples at batch
   20, once with ``--fused`` and once on the host watershed path.  Checks
   40 records, finite lattices, and that the conv kernel was launched
   exactly once per 3x3x3 conv of the path.
5. GPU vs CPU: the fused step for one batch of 2 on the card and on the
   CPU (plain versions), same weights and latents.  Lattices agree to
   1e-2 relative; extracted atoms agree wherever the masks agree, and the
   card's extraction of the CPU's own masks equals the CPU's exactly.

It imports nothing of JAX.  The last two stdout lines are the kernels
JSON object and then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 20
NSAMPLES = 40
D = 32
SEED = 0
DEVICE = "cuda"

# Every 3x3x3 conv of the generation path at production width:
# (model, Cin, Cout, grid edge, epilogue, input dtype, output dtype)
CONV_SHAPES = [
    ("vae.encoder", 14, 16, 32, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 16, 32, 16, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 32, 64, 8, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 64, 128, 4, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 128, 4, 2, "bias", "bf16", "bf16"),
    ("vae.decoder", 4, 128, 4, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 128, 64, 8, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 64, 32, 16, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 32, 16, 32, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 16, 4, 32, "affine_relu", "f32", "f32"),
    ("unet", 4, 32, 32, "relu_affine", "bf16", "bf16"),
    ("unet", 32, 64, 32, "relu_affine", "bf16", "bf16"),
    ("unet", 64, 64, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 64, 128, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 128, 128, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 128, 256, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 256, 512, 4, "relu_affine", "bf16", "bf16"),
    ("unet", 512, 512, 4, "relu_affine", "bf16", "bf16"),
    ("unet", 768, 512, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 512, 256, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 384, 256, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 256, 128, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 192, 128, 32, "relu_affine", "bf16", "bf16"),
    ("unet", 128, 128, 32, "relu_affine", "bf16", "bf16"),
]

# The TPU kernels the one CUDA kernel replaces, by epilogue family.
KERNEL_ENTRIES = [
    ("conv3d_same[bias]", ("bias",), "icsg3d_tpu/ops/lowc_conv.py:110"),
    ("conv3d_same[folded_bn]", ("affine_leaky", "relu_affine", "affine_relu"),
     "icsg3d_tpu/ops/pallas_conv.py:39"),
]

# 3x3x3 convs per generation run: the encoder once (4 blocks + Conv_4),
# then per batch the decoder (4 blocks + output head) and the U-Net (14).
ENCODER_CONVS, DECODER_CONVS, UNET_CONVS = 5, 5, 14


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}; count {torch.cuda.device_count()}")
    print(card)
    return name, card


def phase_build():
    from icsg3d_torch.kernels import conv3d as k

    t0 = time.perf_counter()
    path = k.build()
    k.load()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")


def phase_kernels(card: str):
    import torch
    import torch.nn.functional as F

    from icsg3d_torch.kernels import conv3d as k

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    print(f"[kernels] batch {BATCH}, card: {card}")
    print("  model        Cin->Cout @edge  epilogue      out   max_abs_err  "
          "rel_err   kernel_ms  plain_ms  cudnn_bf16_ms")
    for model, cin, cout, edge, epi, idt, odt in CONV_SHAPES:
        x = torch.randn(BATCH, edge, edge, edge, cin, device="cuda",
                        generator=gen).to(dt[idt])
        w = (torch.randn(3, 3, 3, cin, cout, device="cuda", generator=gen)
             / (27 * cin) ** 0.5).to(dt[idt])
        b, scale, shift = (
            0.1 * torch.randn(cout, device="cuda", generator=gen) for _ in range(3)
        )
        scale = scale + 1.0
        args = (x, w, b, scale, shift, epi, dt[odt])
        got = k.conv3d_same_cuda(*args)
        torch.cuda.synchronize()
        ref = k.conv3d_same_reference(*args)
        abs_err = float((got.float() - ref.float()).abs().max())
        rel_err = abs_err / max(float(ref.float().abs().max()), 1e-30)
        bound = 1e-2 if odt == "bf16" else 1e-4
        check(got.shape == ref.shape and got.dtype == dt[odt],
              f"{model} {cin}->{cout}@{edge}: shape/dtype {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{model} {cin}->{cout}@{edge}: non-finite output")
        check(rel_err <= bound, f"{model} {cin}->{cout}@{edge} {epi}: "
              f"rel err {rel_err:.3e} > {bound:g}")
        ms = cuda_median_ms(lambda: k.conv3d_same_cuda(*args))
        plain_ms = cuda_median_ms(lambda: k.conv3d_same_reference(*args))
        xc = x.permute(0, 4, 1, 2, 3)  # channels_last_3d view, no copy
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)

        def cudnn():
            y = F.conv3d(xc, wc, padding=1).permute(0, 2, 3, 4, 1)
            return k.apply_epilogue(y.float() + b, epi, scale, shift).to(dt[odt])

        cudnn_ms = cuda_median_ms(cudnn)
        print(f"  {model:12s} {cin:4d}->{cout:<4d}@{edge:<3d} {epi:13s} {odt:4s} "
              f"{abs_err:11.3e} {rel_err:9.2e} {ms:10.4f} {plain_ms:9.4f} "
              f"{cudnn_ms:10.4f}")
        rows.append(dict(model=model, cin=cin, cout=cout, edge=edge, epilogue=epi,
                         abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         cudnn_ms=cudnn_ms))
    print(f"  total over the shapes: kernel {sum(r['ms'] for r in rows):.3f} ms, "
          f"plain {sum(r['plain_ms'] for r in rows):.3f} ms, cuDNN bf16 "
          f"{sum(r['cudnn_ms'] for r in rows):.3f} ms")
    del x, w, got, ref
    torch.cuda.empty_cache()
    return rows


def write_dataset(path: str):
    """A few Gaussian-blob densities at 32^3 with their coordinate grids."""
    import numpy as np

    from icsg3d_torch.data.store import GridDataset

    rng = np.random.default_rng(SEED)
    n, eps = 4, 0.25
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    density = np.zeros((n, D, D, D), np.float32)
    coords = np.zeros((n, D, D, D, 3), np.float32)
    for i in range(n):
        for c in rng.uniform(6, D - 6, (int(rng.integers(2, 6)), 3)):
            density[i] += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / 4.5)
        abc = rng.uniform(3.5, 7.0, 3).astype(np.float32)
        dv = abc * (1 + 2 * eps) / D
        coords[i] = np.moveaxis(g, 0, -1) * dv - eps * abc + dv / 2
    return GridDataset.write(path, [f"syn-{i}" for i in range(n)], {
        "density": density, "coords": coords,
        "target": rng.standard_normal(n).astype(np.float32),
    })


def seeded_models(device):
    """Full-width models from a seed.  The occupancy head is then rescaled
    so that ~30% of voxels of a decoded batch pass the 0.8 threshold:
    with random weights the logits sit in a narrow band and the mask
    would be all-or-nothing, leaving the extraction no work."""
    import numpy as np
    import torch

    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.models import ConditionalDFCVAE, UNet3D

    gen = torch.Generator().manual_seed(SEED)
    vae = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D)), gen).to(device).eval()
    unet = UNet3D(UNetConfig(), gen).to(device).eval()
    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((BATCH, 256)).astype(np.float32))
    cond = torch.zeros(BATCH, 10)
    cond[:, 3] = 1.0
    with torch.inference_mode():
        _, sig = unet(vae.decode(z.to(device), cond.to(device)))
        logits = sig.double().flatten()
        q = float(torch.quantile(logits, 0.7))
        a = 6.0 / float(logits.std())
    with torch.no_grad():  # logit -> a * (logit - q) + logit(0.8)
        head = unet.head_sig
        head.kernel.mul_(a)
        head.bias.copy_(a * (head.bias - q) + float(np.log(4.0)))
    return vae, unet


def phase_main_path(tmp: str, card: str):
    import numpy as np
    import torch

    from icsg3d_torch.apps import generate
    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.weights import save_npz, to_flax_variables

    write_dataset(os.path.join(tmp, "data"))
    vae, unet = seeded_models(DEVICE)
    save_npz(os.path.join(tmp, "vae.npz"), to_flax_variables(vae))
    save_npz(os.path.join(tmp, "unet.npz"), to_flax_variables(unet))
    n_batches = -(-NSAMPLES // BATCH)
    want = ENCODER_CONVS + n_batches * (DECODER_CONVS + UNET_CONVS)
    results = {}
    for fused in (True, False):
        label = "fused" if fused else "host"
        out = os.path.join(tmp, f"out-{label}")
        argv = ["--data", os.path.join(tmp, "data"), "--base", "syn-1",
                "--vae-ckpt", os.path.join(tmp, "vae.npz"),
                "--unet-ckpt", os.path.join(tmp, "unet.npz"),
                "--nsamples", str(NSAMPLES), "--batch-size", str(BATCH),
                "--device", DEVICE, "--output", out] + (["--fused"] if fused else [])
        sync()
        k.reset_launches()
        t0 = time.perf_counter()
        generate.main(argv)
        sync()
        secs = time.perf_counter() - t0
        launches = k.launches
        by_epi = dict(k.launches_by_epilogue)
        with open(os.path.join(out, "results.json")) as f:
            rows = json.load(f)
        check(len(rows) == NSAMPLES, f"{label}: {len(rows)} records, want {NSAMPLES}")
        lat = np.asarray([r["lattice"] for r in rows], np.float64)
        check(lat.shape == (NSAMPLES, 3) and bool(np.isfinite(lat).all()),
              f"{label}: lattice values not finite or misshapen")
        check(launches == want, f"{label}: conv kernel launched {launches} times, "
              f"the path runs {want} 3x3x3 convs")
        n_atoms = sum(len(r.get("atoms", [])) for r in rows)
        n_valid = sum(bool(r.get("valid")) for r in rows)
        n_err = sum("error" in r for r in rows)
        print(f"[main:{label}] {NSAMPLES} samples in {secs:.3f} s = "
              f"{NSAMPLES / secs:.2f} samples/s ({card}); conv launches "
              f"{launches} = {want} expected {by_epi}; atoms {n_atoms}, "
              f"valid {n_valid}, per-sample errors {n_err}")
        results[label] = dict(seconds=secs, launches=launches, by_epilogue=by_epi)
    return vae, unet, results


def phase_breakdown(vae, unet, card: str):
    """Device time of one fused batch of 20, by stage (CUDA events)."""
    import numpy as np
    import torch

    from icsg3d_torch.apps.generate import _decode_segment
    from icsg3d_torch.config import GridSpec, PipelineConfig
    from icsg3d_torch.ops.extract import extract_atoms

    pipe = PipelineConfig(grid=GridSpec(d=D))
    rng = np.random.default_rng(SEED + 2)
    z = torch.from_numpy(rng.standard_normal((BATCH, 256)).astype(np.float32)).cuda()
    cond = torch.zeros(BATCH, 10, device="cuda")
    cond[:, 3] = 1.0
    with torch.inference_mode():
        dec_ms = cuda_median_ms(lambda: vae.decode(z, cond), runs=5, warmup=1)
        M = vae.decode(z, cond)
        unet_ms = cuda_median_ms(lambda: unet(M), runs=5, warmup=1)
        _, _, _, labels, binary = _decode_segment(vae, unet, pipe, z, cond)
        spec = torch.where(binary > 0, labels, 0)
        ext_ms = cuda_median_ms(
            lambda: extract_atoms(spec, binary, max_atoms=64, vote_classes=95),
            runs=3, warmup=1)
    print(f"[breakdown] fused batch of {BATCH} ({card}): decode {dec_ms:.3f} ms, "
          f"U-Net {unet_ms:.3f} ms, extraction {ext_ms:.3f} ms "
          f"(foreground {float(binary.float().mean()):.3f})")


def phase_cpu_parity(vae, unet):
    import numpy as np
    import torch

    from icsg3d_torch.apps.generate import _decode_segment
    from icsg3d_torch.config import GridSpec, PipelineConfig
    from icsg3d_torch.ops.extract import extract_atoms

    pipe = PipelineConfig(grid=GridSpec(d=D))
    rng = np.random.default_rng(SEED + 3)
    z = rng.standard_normal((2, 256)).astype(np.float32)
    cond = np.zeros((2, 10), np.float32)
    cond[:, 3] = 1.0
    out, grids = {}, {}
    t0 = time.perf_counter()
    for dev, (v, u) in ((DEVICE, (vae, unet)),
                        ("cpu", (copy.deepcopy(vae).cpu(), copy.deepcopy(unet).cpu()))):
        with torch.inference_mode():
            zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(cond).to(dev)
            M, lattice, dv, labels, binary = _decode_segment(v, u, pipe, zt, ct)
            spec = torch.where(binary > 0, labels, 0)
            atoms, mu, valid = extract_atoms(spec, binary, max_atoms=64,
                                             vote_classes=95)
        grids[dev] = (spec, binary)
        out[dev] = {n: t.cpu().numpy() for n, t in dict(
            lattice=lattice, labels=labels, binary=binary, atoms=atoms, mu=mu,
            valid=valid).items()}
    g, c = out[DEVICE], out["cpu"]
    lat_rel = float(np.max(np.abs(g["lattice"] - c["lattice"]) / np.abs(c["lattice"])))
    check(lat_rel <= 1e-2, f"GPU vs CPU lattice rel err {lat_rel:.3e} > 1e-2")
    mask_agree = 0
    for i in range(2):
        if np.array_equal(g["binary"][i], c["binary"][i]):
            mask_agree += 1
            check(np.array_equal(g["valid"][i], c["valid"][i])
                  and np.allclose(g["mu"][i], c["mu"][i], atol=1e-5),
                  f"sample {i}: masks agree, extracted atoms differ")
    # the extraction itself on identical masks: the CPU's grids on the card
    with torch.inference_mode():
        same = extract_atoms(*(t.to(DEVICE) for t in grids["cpu"]),
                             max_atoms=64, vote_classes=95)
    for name, a, b in zip(("atoms", "mu", "valid"), same,
                          (c["atoms"], c["mu"], c["valid"])):
        ok = (np.allclose(a.cpu().numpy(), b, atol=1e-5) if name == "mu"
              else np.array_equal(a.cpu().numpy(), b))
        check(ok, f"extraction of the same masks differs on {DEVICE}: {name}")
    mismatch = [int((g["binary"][i] != c["binary"][i]).sum()) for i in range(2)]
    print(f"[gpu-vs-cpu] batch 2 in {time.perf_counter() - t0:.1f} s: lattice max "
          f"rel err {lat_rel:.2e}; masks agree on {mask_agree}/2 samples (voxels "
          f"differing {mismatch} of {D ** 3}); extraction of identical masks: "
          f"{int(c['valid'].sum())} atoms, equal on {DEVICE} and cpu; valid atoms "
          f"from own masks gpu {int(g['valid'].sum())} cpu {int(c['valid'].sum())}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs one NVIDIA GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "icsg3d_torch")):
        fail(f"no icsg3d_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, repo)
    torch.manual_seed(SEED)

    name, card = phase_device()
    phase_build()
    rows = phase_kernels(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        vae, unet, runs = phase_main_path(tmp, card)
    phase_breakdown(vae, unet, card)
    phase_cpu_parity(vae, unet)

    kernels = []
    for entry, epis, replaces in KERNEL_ENTRIES:
        mine = [r for r in rows if r["epilogue"] in epis]
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": "icsg3d_torch/csrc/conv3d.cu",
            "replaces": replaces,
            "launches": sum(runs["fused"]["by_epilogue"][e] for e in epis),
            "max_abs_err": max(r["abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
        })
        check(kernels[-1]["launches"] > 0, f"{entry} was not launched by the path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
