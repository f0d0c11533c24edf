"""Build a kernel source into a shared library with nvcc (plain C interface,
loaded with ctypes).  Nothing is built when a module is imported: each
kernel module's ``load`` calls ``build_library`` at first use."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def build_tag(source: Path, flags=()) -> str:
    """The hash a build is named by: the source, every header beside it in
    ``csrc/`` (a source may include any of them), and the nvcc flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")) + sorted(source.parent.glob("*.h")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(BASE_FLAGS + tuple(flags)).encode())
    return h.hexdigest()[:16]


def build_library(source: Path, stem: str, flags=(), verbose: bool = False) -> Path:
    """Compile ``source`` for sm_90a into ``_build/<stem>_<hash>.so``.

    The name carries ``build_tag``, so an edited source or header, or other
    flags, is never served by a stale build.  ``flags`` are added to the
    nvcc command; ``verbose`` prints what nvcc wrote (for ``-Xptxas -v``).
    Returns the library path.
    """
    lib = BUILD_DIR / f"{stem}_{build_tag(source, flags)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *BASE_FLAGS, *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
    os.replace(tmp, lib)
    return lib
