#!/usr/bin/env python3
"""Registers, spills and SASS instructions per site-voxel pair of the
voxelizer kernel K4 (``icsg3d_torch/csrc/voxelize.cu``), for sm_90a.

    python3 tools/k4_sass.py [SOURCE.cu ...]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no GPU.  For each
source (default: the repo's ``voxelize.cu``) it compiles a cubin with
``-Xptxas -v`` and prints what ptxas says of each kernel, then
disassembles the main kernel (the function whose name holds
``voxelize_kernel``) and finds its loops (backward branches).  Every
site-voxel pair takes exactly one exponential (``MUFU.EX2``), so a loop's
static instruction count over its ``MUFU.EX2`` count is the instructions
issued per pair on the loop's path.  The loops with exponentials are the
site loops: the loop over the valid sites (which the compiler may unroll,
leaving a remainder loop), and in the redesigned kernel also a
density-only loop over invalid sites that carry a weight.  The site loop
reported is the one that also compares (``FSETP``/``FSET``: the
labelling test) with the most exponentials, the unrolled body where most
pairs run.  The script prints every loop with exponentials, and the site
loop's mix of instructions.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(REPO, "icsg3d_torch", "csrc", "voxelize.cu")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
TARGET = re.compile(r"BRA\s+(?:`?\(?\.?(L_x_\d+)\)?`?|0x([0-9a-f]+))")


def tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(found):
        sys.exit(f"{name} not found: this script needs the CUDA toolkit")
    return found


def functions(sass: str) -> dict:
    """Function name -> list of (address, instruction text, labels there)."""
    out, cur, labels = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        lm = re.match(r"\s*\.(L_x_\d+):", line)
        if lm:
            labels.append(lm.group(1))
            continue
        m = INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip(), labels))
            labels = []
    return out


def loops(insns):
    """(first index, last index) of every backward branch's range."""
    where = {a: i for i, (a, _, _) in enumerate(insns)}
    label_at = {lab: i for i, (_, _, labs) in enumerate(insns) for lab in labs}
    found = []
    for i, (_, text, _) in enumerate(insns):
        m = TARGET.search(text)
        if not m:
            continue
        j = label_at.get(m.group(1)) if m.group(1) else where.get(int(m.group(2), 16))
        if j is not None and j <= i:
            found.append((j, i))
    return found


def opcode(text: str) -> str:
    text = re.sub(r"^@!?U?P[T0-9]+\s+", "", text)
    return text.split()[0]


def report(source: str) -> None:
    with tempfile.TemporaryDirectory(prefix="k4_sass_") as tmp:
        cubin = os.path.join(tmp, "k4.cubin")
        cmd = [tool("nvcc"), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-o", cubin, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
        print(f"== {os.path.relpath(source, REPO)}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line
                                         or "spill" in line):
                print("  " + line.strip())
            elif "spill" in line:
                print("  " + line.strip())
        sass = subprocess.run([tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    fns = {n: v for n, v in functions(sass).items()
           if "voxelize_kernel" in n and "sites" not in n}
    if len(fns) != 1:
        sys.exit(f"expected one main kernel, found {sorted(fns)}")
    name, insns = next(iter(fns.items()))
    print(f"  {name}: {len(insns)} instructions")
    best = None
    for j, i in loops(insns):
        body = [opcode(t) for _, t, _ in insns[j:i + 1]]
        ex2 = sum(op.startswith("MUFU.EX2") for op in body)
        if not ex2:
            continue
        print(f"  loop 0x{insns[j][0]:04x}-0x{insns[i][0]:04x}: {len(body)} "
              f"instructions, {ex2} exponentials = {len(body) / ex2:.2f} per pair")
        labels = any(op.startswith(("FSETP", "FSET.")) for op in body)
        if labels and (best is None or ex2 > best[2]):
            best = (j, i, ex2, body)
    if best is None:
        sys.exit(f"{name}: no loop with MUFU.EX2 and a comparison found")
    j, i, ex2, body = best
    mix = collections.Counter(op.split(".")[0] for op in body)
    print(f"  site loop 0x{insns[j][0]:04x}-0x{insns[i][0]:04x}: {len(body) / ex2:.2f} "
          f"instructions per site-voxel pair; mix: "
          + ", ".join(f"{op} {n}" for op, n in mix.most_common()))


def main() -> None:
    for source in sys.argv[1:] or [DEFAULT]:
        report(os.path.abspath(source))


if __name__ == "__main__":
    main()
