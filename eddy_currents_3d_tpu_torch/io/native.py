"""ctypes bindings to the port's native VTK encoder (``csrc/ecio.cpp``).

The counterpart of ``eddy_currents_3d_tpu/io/native.py``, with the same
functions.  The library is the port's own build (``ops/_build.py``: g++
into ``_build/`` at first use).  Unlike the JAX package, a missing ``g++``,
a failed build or a failed write raises instead of returning False: the
numpy writers (``io/vtk.py``) are the plain version that tests hold this
one against, chosen only by ``EC3D_NATIVE_IO=0``, never as a fallback.
The encoder's threads run with the interpreter lock released (ctypes), so
writer threads overlap.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import load_library

__all__ = ["enabled", "get_lib", "write_field_native", "write_src_native"]

_lib = None
_lock = threading.Lock()   # one build, whichever writer thread asks first

_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def enabled() -> bool:
    """True unless ``EC3D_NATIVE_IO=0``, the JAX package's switch to the
    numpy writers."""
    return os.environ.get("EC3D_NATIVE_IO", "1") != "0"


def get_lib() -> ctypes.CDLL:
    """The encoder library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load_library("ecio")
            lib.ec3d_write_field.restype = ctypes.c_int
            lib.ec3d_write_field.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                _f64p, _f64p, ctypes.c_void_p, ctypes.c_double,
            ]
            lib.ec3d_write_src.restype = ctypes.c_int
            lib.ec3d_write_src.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                _i64p, _i64p, _f64p, _i32p, ctypes.c_int64,
            ]
            _lib = lib
    return _lib


def _check(rc: int, path: str) -> None:
    if rc != 0:
        raise OSError(f"native VTK encoder could not open {path!r} for "
                      "writing")


def write_field_native(path, delta, A, carry, cond_mask, eddy_scale) -> None:
    """field_N.vtk from A and the carry, (3, nz, ny, nx) each, and the
    (nz, ny, nx) conductor mask or None; the bytes of ``io/vtk.py``
    ``write_field``."""
    lib = get_lib()
    A = np.ascontiguousarray(A, np.float64)
    carry = np.ascontiguousarray(carry, np.float64)
    if A.ndim != 4 or A.shape[0] != 3 or carry.shape != A.shape:
        raise ValueError(f"A and carry must be (3, nz, ny, nx) alike, got "
                         f"{A.shape} and {carry.shape}")
    nz, ny, nx = A.shape[1:]
    cond = None
    if cond_mask is not None:
        cond = np.ascontiguousarray(cond_mask, np.uint8)
        if cond.shape != A.shape[1:]:
            raise ValueError(f"cond_mask must be {A.shape[1:]}, got "
                             f"{cond.shape}")
    _check(lib.ec3d_write_field(
        path.encode(), nx, ny, nz,
        float(delta[0]), float(delta[1]), float(delta[2]),
        A.ctypes.data_as(_f64p), carry.ctypes.data_as(_f64p),
        None if cond is None else cond.ctypes.data_as(ctypes.c_void_p),
        float(eddy_scale)), path)


def write_src_native(path, delta, shape_xyz, cells_per_fun, values,
                     dirs) -> None:
    """src_N.vtk of the source voxels (0-based flat cells per function);
    the bytes of ``io/vtk.py`` ``write_src``."""
    lib = get_lib()
    nx, ny, _ = shape_xyz
    cells = np.ascontiguousarray(
        np.concatenate([np.asarray(c, np.int64) for c in cells_per_fun])
        if cells_per_fun else np.zeros(0, np.int64))
    counts = np.asarray([len(c) for c in cells_per_fun], np.int64)
    vals = np.asarray(values, np.float64)
    dmap = np.asarray([{"X": 0, "Y": 1, "Z": 2}[d] for d in dirs], np.int32)
    if not len(vals) == len(dmap) == len(counts):
        raise ValueError("one value and one direction per source function")
    _check(lib.ec3d_write_src(
        path.encode(), nx, ny,
        float(delta[0]), float(delta[1]), float(delta[2]),
        cells.ctypes.data_as(_i64p), counts.ctypes.data_as(_i64p),
        vals.ctypes.data_as(_f64p), dmap.ctypes.data_as(_i32p),
        len(cells_per_fun)), path)
