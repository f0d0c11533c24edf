"""Build a kernel source into a shared library with nvcc (plain C interface,
loaded with ctypes).  Nothing is built when a module is imported: each
kernel module's ``load`` calls ``build_library`` at first use."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` for sm_90a into ``_build/<stem>_<hash>.so``.

    The name carries a hash of the source, so an edited source is never
    served by a stale build.  Returns the library path.
    """
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib
