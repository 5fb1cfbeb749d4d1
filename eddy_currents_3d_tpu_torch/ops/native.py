"""ctypes bindings to the port's host ILU(0) engine (``csrc/ilu0_host.cpp``).

The counterpart of ``eddy_currents_3d_tpu/ops/native.py``, with the same
function signatures.  The library is the port's own build (``ops/_build.py``:
g++ into ``_build/`` at first use).  Unlike the JAX package, a missing
``g++`` or a failed build raises instead of returning None: the numpy
factorization (``solvers/ilu0.py`` ``_ilu0_numpy``) is the plain version
that tests hold this one against, not a fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ._build import load_library

__all__ = ["get_lib", "ilu0_native", "ilu0_solve_native"]

_lib = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


def get_lib() -> ctypes.CDLL:
    """The host library, built at first use."""
    global _lib
    if _lib is None:
        lib = load_library("ilu0_host")
        lib.ec3d_ilu0.restype = ctypes.c_int64
        lib.ec3d_ilu0.argtypes = [ctypes.c_int64, _i64p, _i32p, _f64p]
        lib.ec3d_ilu0_solve.restype = ctypes.c_int64
        lib.ec3d_ilu0_solve.argtypes = [ctypes.c_int64, _i64p, _i32p, _f64p,
                                        _f64p]
        _lib = lib
    return _lib


def ilu0_native(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """ILU(0) of (indptr, cols, vals); returns the factored values (L and U
    packed in the input pattern).  Raises on a zero or missing pivot and on
    unsorted columns."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.array(vals, np.float64, copy=True, order="C")
    rc = lib.ec3d_ilu0(
        indptr.shape[0] - 1,
        indptr.ctypes.data_as(_i64p), cols.ctypes.data_as(_i32p),
        out.ctypes.data_as(_f64p),
    )
    if rc > 0:
        raise ZeroDivisionError(f"ILU(0): zero or missing pivot in row {rc - 1}")
    if rc < 0:
        raise ValueError(f"ILU(0): unsorted columns in row {-rc - 1}")
    return out


def ilu0_solve_native(indptr, cols, fvals, b) -> np.ndarray:
    """Exact sequential L/U solve on packed ILU(0) factors; returns x.
    Raises on a zero pivot."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    fvals = np.ascontiguousarray(fvals, np.float64)
    x = np.array(b, np.float64, copy=True, order="C")
    rc = lib.ec3d_ilu0_solve(
        indptr.shape[0] - 1,
        indptr.ctypes.data_as(_i64p), cols.ctypes.data_as(_i32p),
        fvals.ctypes.data_as(_f64p), x.ctypes.data_as(_f64p),
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILU(0) solve: zero pivot in row {rc - 1}")
    return x
