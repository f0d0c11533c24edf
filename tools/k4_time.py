#!/usr/bin/env python3
"""Device time of the voxelizer kernel K4 built from one or more
``voxelize.cu`` sources, compared in turns on one card.

    python3 tools/k4_time.py [SOURCE.cu ...]

Run from the root of a checkout on a machine with an NVIDIA GPU (default
source: the repo's ``icsg3d_torch/csrc/voxelize.cu``; give an earlier
version's file beside it to compare).  A source whose C entry
``voxelize`` takes a workspace (this version) is called with one; one
without (the first K4 kernel) is called as it was.  Inputs are
``chip_smoke.py``'s: the chunk of 256 synthetic structures and the repo's
real CIFs at 32^3.  For each input and source it checks the species
against the plain version (identical) and the density (rtol 2e-4 / atol
1e-6), then, with outputs allocated once and the C entry called directly
(no Python wrapper in the timed region), takes the CUDA-event median of
20 calls and the profiled device time of the K4 kernels per call (over 5
calls), each source in turns: A, B, ..., ..., B, A.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(REPO, "icsg3d_torch", "csrc", "voxelize.cu")


def _entry(source: str):
    """(library, takes a workspace) for a K4 source."""
    from pathlib import Path

    from icsg3d_torch.kernels._nvcc import build_library

    stem = "libk4time_" + os.path.splitext(os.path.basename(source))[0]
    lib = ctypes.CDLL(str(build_library(Path(source), stem)))
    with open(source) as f:
        new = "void* workspace" in f.read()
    ptrs, ints = (8, 4) if new else (7, 3)
    lib.voxelize.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                             + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    lib.voxelize.restype = ctypes.c_int
    return lib, new


def _caller(lib, new: bool, args, d: int):
    import torch

    from icsg3d_torch.kernels import voxelize as kv

    B, S = args[0].shape[:2]
    density = torch.empty((B, d, d, d), device="cuda")
    species = torch.empty_like(density)
    work = torch.empty(kv.workspace_words(B, S, d), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args]
    tail = (0.25, 1.5, 1.0, kv.INV_TWO_PI_POW, stream)

    def call():
        if new:
            err = lib.voxelize(*ptrs, work.data_ptr(), density.data_ptr(),
                               species.data_ptr(), B, S, d, kv.tile(d)[1], *tail)
        else:
            err = lib.voxelize(*ptrs, density.data_ptr(), species.data_ptr(), B, S, d,
                               *tail)
        if err != 0:
            raise RuntimeError(f"K4 launch failed: CUDA error {err}")
        return density, species
    return call


def _event_ms(fn, runs: int = 20) -> float:
    import torch

    for _ in range(3):
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


def _device_ms(fn, calls: int = 5) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and "voxelize" in e.name) / calls / 1e3


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from icsg3d_torch.data.synthetic import random_structures
    from icsg3d_torch.kernels import voxelize as kv

    if not torch.cuda.is_available():
        sys.exit("k4_time needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    sources = [os.path.abspath(s) for s in sys.argv[1:]] or [DEFAULT]
    libs = [_entry(s) for s in sources]
    d = chip_smoke.D
    inputs = [
        ("chunk", random_structures(chip_smoke.VOX_CHUNK, seed=chip_smoke.SEED + 6,
                                    kinds=("perovskite", "rocksalt"))),
        ("real CIFs", chip_smoke.real_cif_structures()),
    ]
    print(f"[k4-time] {card}; {d}^3, site_pad {chip_smoke.SITE_PAD}")
    for label, structures in inputs:
        args = [torch.from_numpy(a).cuda() for a in chip_smoke._pack(structures)]
        ref_d, ref_s = kv.voxelize_reference(*args, d, 0.25, 1.0)
        calls = [_caller(lib, new, args, d) for lib, new in libs]
        for src, call in zip(sources, calls):
            dens, spec = call()
            torch.cuda.synchronize()
            ok = bool(torch.equal(spec, ref_s)) and bool(
                torch.allclose(dens, ref_d, rtol=2e-4, atol=1e-6))
            if not ok:
                sys.exit(f"{label}: {os.path.relpath(src, REPO)} disagrees with the "
                         "plain version")
        order = list(range(len(sources)))
        results = {k: [] for k in order}
        for k in order + order[::-1]:
            results[k].append((_event_ms(calls[k]), _device_ms(calls[k])))
        for k in order:
            ev = ", ".join(f"{e:.4f}" for e, _ in results[k])
            dv = ", ".join(f"{v:.4f}" for _, v in results[k])
            print(f"  {label}: {os.path.relpath(sources[k], REPO)}: event ms {ev}; "
                  f"device ms {dv} (species equal, density within rtol 2e-4)")


if __name__ == "__main__":
    main()
