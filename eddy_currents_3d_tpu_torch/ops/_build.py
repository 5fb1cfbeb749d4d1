"""Build the package's native sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``; the sources share device code
through the headers ``csrc/*.cuh``.  Each ``csrc/<name>.cpp`` is host code
(the ILU(0) factorization, ``ops/native.py``; the VTK encoder,
``io/native.py``) and compiles the same way with ``g++ -pthread``.  The
library goes into ``_build/`` inside the package (listed in
``.gitignore``) under a name that carries a hash of the source, the headers
and the flags, so an edited source or header is rebuilt and a stale build
is never loaded.  A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "HOST_FLAGS", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Hopper only: sm_90a keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


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


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found on PATH: the host sources of "
            "eddy_currents_3d_tpu_torch are built from source at first use")
    return path


def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++)
    unless an up-to-date build exists.

    Returns (library path, compiler log, seconds spent compiling; 0.0 when
    the build was already there)."""
    src = CSRC_DIR / f"{name}.cu"
    host = not src.exists()
    if host:
        src = CSRC_DIR / f"{name}.cpp"
    flags = HOST_FLAGS if host else NVCC_FLAGS
    key = hashlib.sha256(src.read_bytes())
    if not host:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            key.update(header.read_bytes())
    key.update(" ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, "", 0.0
    compiler = _gxx() if host else _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed with code "
                           f"{proc.returncode} on {src}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds


def load_library(name: str) -> ctypes.CDLL:
    path, _, _ = build_library(name)
    return ctypes.CDLL(str(path))
