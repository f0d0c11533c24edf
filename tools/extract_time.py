#!/usr/bin/env python3
"""Device time of the extraction kernels E1 (connected components) and E2
(the nearest-seed BFS) built from one or more ``extract.cu`` sources,
compared in turns on one card.

    python3 tools/extract_time.py [SOURCE.cu ...]

Run from the root of a checkout on a machine with an NVIDIA GPU (default
source: the repo's ``icsg3d_torch/csrc/extract.cu``; give an earlier
version's file beside it to compare, e.g. one written from git with
``git show <commit>:icsg3d_torch/csrc/extract.cu > _checkout/old.cu``).
A source whose C entries take a launch plan (this version: a cluster of
CTAs per sample) is called with ``kernels/extract.launch_plan``'s; one
without (one block per sample) is called as it was.

Inputs: the masks the fused generation extracts from, decoded and
segmented by ``chip_smoke.py``'s seeded full-width models in chunks of
20 (its ``[extract-kernels]`` batch of 128): 32^3 at batch 1, 20 and 128,
and its first 4 masks doubled along each axis to 64^3.  On each: E1 on
the foreground and on its erosion cores, E2 on the erosion split's
seeds.  For each source it checks the labels against the plain version
(bitwise) and E2's largest per-sample rounds (equal), then, with outputs
allocated once and the C entry called directly (no Python wrapper in the
timed region), takes the CUDA-event median of 20 calls, the sources in
turns: A, B, ..., ..., B, A.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(REPO, "icsg3d_torch", "csrc", "extract.cu")


def _entry(source: str):
    """(library, takes a plan) for an extraction source."""
    from pathlib import Path

    from icsg3d_torch.kernels._nvcc import build_library

    stem = "libextime_" + os.path.splitext(os.path.basename(source))[0]
    lib = ctypes.CDLL(str(build_library(Path(source), stem)))
    with open(source) as f:
        planned = "extract_max_active_clusters" in f.read()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    extra = (3, 4) if planned else (0, 0)
    lib.extract_cc.argtypes = [vp] * 4 + [ci] * (4 + extra[0]) + [vp]
    lib.extract_bfs.argtypes = [vp] * 8 + [ci] * (4 + extra[1]) + [vp]
    lib.extract_cc.restype = lib.extract_bfs.restype = ci
    return lib, planned


def _caller(lib, planned: bool, kind: str, ops):
    """A call of one source's C entry on fixed operands and outputs."""
    import torch

    from icsg3d_torch.kernels import extract as kext

    grid = ops[0] if kind == "cc" else ops[1]
    n, d0, d1, d2 = grid.shape
    dev = grid.device
    labels = torch.empty(grid.shape, dtype=torch.int32, device=dev)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    bits = torch.empty(grid.shape, dtype=torch.uint8, device=dev)
    dist = torch.empty(n * d0 * d1 * d2 + 4 * n * 16 * d1 * d2, dtype=torch.int32,
                       device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    p = kext.launch_plan(kind, grid) if planned else None
    plan = (p.cluster, int(p.path == "shared"), p.smem_bytes_per_cta) if planned else ()

    def call():
        if kind == "cc":
            err = lib.extract_cc(grid.data_ptr(), labels.data_ptr(), bits.data_ptr(),
                                 rounds.data_ptr(), n, d0, d1, d2, *plan, stream)
        else:
            seeds, cc, fg, sl = ops
            err = lib.extract_bfs(
                seeds.data_ptr(), cc.data_ptr(), fg.data_ptr(),
                None if sl is None else sl.data_ptr(), labels.data_ptr(),
                dist.data_ptr(), bits.data_ptr(), rounds.data_ptr(), n, d0, d1, d2,
                *plan, *((p.dist_bytes,) if planned else ()), stream)
        if err != 0:
            raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
        return labels, rounds
    return call, (f"C={p.cluster} {p.path}" if planned else "one block per sample")


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


def _inputs():
    """(label, foreground) sets: 32^3 at batch 1, 20, 128; 4 x 64^3."""
    import numpy as np
    import torch

    import chip_smoke
    from icsg3d_torch.apps.generate import _decode_segment
    from icsg3d_torch.config import GridSpec, PipelineConfig

    vae, unet = chip_smoke.seeded_models("cuda")
    pipe = PipelineConfig(grid=GridSpec(d=chip_smoke.D))
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    b = chip_smoke.BATCH
    chunks = []
    with torch.inference_mode():
        for _ in range(-(-chip_smoke.EXTRACT_BATCH // b)):
            z = torch.from_numpy(rng.standard_normal((b, 256)).astype(np.float32))
            cond = torch.zeros(b, 10)
            cond[:, 3] = 1.0
            chunks.append(_decode_segment(vae, unet, pipe, z.cuda(), cond.cuda())[4])
    fg = (torch.cat(chunks)[:chip_smoke.EXTRACT_BATCH] > 0).contiguous()
    fg64 = fg[:4]
    for dim in (1, 2, 3):
        fg64 = fg64.repeat_interleave(2, dim=dim)
    d = chip_smoke.D
    return [(f"batch 1 x {d}^3", fg[:1].contiguous()),
            (f"batch {b} x {d}^3", fg[:b].contiguous()),
            (f"batch {len(fg)} x {d}^3", fg), (f"4 x {2 * d}^3", fg64.contiguous())]


def main() -> None:
    sys.path.insert(0, REPO)
    import torch

    from icsg3d_torch.ops import extract as ex

    if not torch.cuda.is_available():
        sys.exit("extract_time needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    sources = [os.path.abspath(s) for s in sys.argv[1:]] or [DEFAULT]
    libs = [_entry(s) for s in sources]
    print(f"[extract-time] {card}")
    for label, fg in _inputs():
        fgi = fg.to(torch.int32)
        core_i = ex.erode6(fg).to(torch.int32)
        lab = ex.connected_components_reference(fgi)
        cores = ex.connected_components_reference(core_i)
        seed, seed_labels = ex.erosion_split_seeds(lab, cores, fg)
        cases = [("E1 foreground", "cc", (fgi,)), ("E1 cores", "cc", (core_i,)),
                 ("E2 split seeds", "bfs", (seed, lab, fg, seed_labels))]
        for what, kind, ops in cases:
            if kind == "cc":
                want, want_rounds = ex.connected_components_reference(
                    ops[0], return_rounds=True)
            else:
                want, want_rounds = ex.nearest_seed_labels_reference(
                    *ops, return_rounds=True)
            calls, notes = [], []
            for src, (lib, planned) in zip(sources, libs):
                call, note = _caller(lib, planned, kind, ops)
                got, rounds = call()
                torch.cuda.synchronize()
                r_max = int(rounds.max())
                if not torch.equal(got, want) or int(rounds.min()) < 1 or (
                        kind == "bfs" and r_max != want_rounds):
                    sys.exit(f"{label} {what}: {os.path.relpath(src, REPO)} disagrees with "
                             f"the plain version")
                calls.append(call)
                notes.append(f"{note}, rounds {r_max}")
            order = list(range(len(sources)))
            times = {k: [] for k in order}
            for k in order + order[::-1]:
                times[k].append(_event_ms(calls[k]))
            for k in order:
                ms = ", ".join(f"{t:.4f}" for t in times[k])
                print(f"  {label} {what}: {os.path.relpath(sources[k], REPO)} "
                      f"({notes[k]}; plain rounds {want_rounds}): event ms {ms}; "
                      f"bitwise equal", flush=True)


if __name__ == "__main__":
    main()
