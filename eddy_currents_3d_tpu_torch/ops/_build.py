"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, loaded with ``ctypes``.  The library goes into ``_build/`` inside
the package (listed in ``.gitignore``) under a name that carries a hash of
the source and the flags, so an edited source is rebuilt and a stale build
is never loaded.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Hopper only: sm_90a keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.is_file():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
            "kernels of eddy_currents_3d_tpu_torch are built from source at "
            "first use and need the CUDA toolkit")
    return path


def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists.

    Returns (library path, compiler log, seconds spent compiling; 0.0 when
    the build was already there)."""
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, "", 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode} on {src}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds


def load_library(name: str) -> ctypes.CDLL:
    path, _, _ = build_library(name)
    return ctypes.CDLL(str(path))
