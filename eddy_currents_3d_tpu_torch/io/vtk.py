"""Legacy binary VTK writers, byte-compatible with the reference output.

The PyTorch package's copy of the numpy writers of
``eddy_currents_3d_tpu/io/vtk.py``; the bytes are identical to that
package's numpy path for the same data.  ``write_outputs`` goes through the
native encoder (``io/native.py``) unless ``EC3D_NATIVE_IO=0``; these numpy
writers are its plain version.

``write_field`` mirrors ``writeVtk_field`` (utilites.f90:171-293): a
big-endian STRUCTURED_GRID file with float32 POINTS and the vector fields
``Field_A``, ``Vector_field_eddy`` (= -1/mu0 * carry on conducting cells,
scale constant utilites.f90:239), ``Vector_field_SOURCE`` (carry on
non-conducting cells) and ``Vector_field_B`` (= curl A by clamped central
differences, utilites.f90:276-290).

``write_src`` mirrors ``writeVtk_src`` (utilites.f90:3-168): an
UNSTRUCTURED_GRID of one hexahedron (cell type 11) per source voxel with
the per-function source vector as float64 CELL_DATA.

Number fields reproduce Fortran's ``trim(adjustl())`` of fixed-width
edits, so outputs are byte-identical to the reference for the same data.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import native

__all__ = ["write_field", "write_src", "write_outputs", "read_vtk_vectors"]

# -1/mu0, as hard-coded in the reference (utilites.f90:239)
EDDY_SCALE = -0.07957747154594766788444e7


def _trim(s: str) -> str:
    return s.strip()


def _i8(n: int) -> str:
    return f"{n:8d}"


def _cshift(f: np.ndarray, axis: int, d: int) -> np.ndarray:
    """Shift with edge clamping (the curl writer maps out-of-grid neighbors
    to the cell itself, utilites.f90:282-284). axis: 0=x,1=y,2=z."""
    ax = {0: -1, 1: -2, 2: -3}[axis] % f.ndim
    idx = np.clip(np.arange(f.shape[ax]) + d, 0, f.shape[ax] - 1)
    return np.take(f, idx, axis=ax)


def curl(A: np.ndarray, delta) -> np.ndarray:
    """B = curl A with clamped central differences; A is (3,nz,ny,nx)."""
    dx, dy, dz = [float(v) for v in delta]
    ax, ay, az = A[0], A[1], A[2]
    d = lambda f, axis, h: 0.5 * (_cshift(f, axis, +1) - _cshift(f, axis, -1)) / h
    bx = d(az, 1, dy) - d(ay, 2, dz)
    by = d(ax, 2, dz) - d(az, 0, dx)
    bz = d(ay, 0, dx) - d(ax, 1, dy)
    return np.stack([bx, by, bz])


def _vec_block(V: np.ndarray) -> bytes:
    """(3,nz,ny,nx) -> interleaved (x,y,z) float32 big-endian triples in
    grid order."""
    return np.ascontiguousarray(np.moveaxis(V, 0, -1), ">f4").tobytes()


def write_field(
    path: str,
    delta,
    A: np.ndarray,          # (3,nz,ny,nx)
    carry: np.ndarray,      # (3,nz,ny,nx) — the Jaf field
    cond_mask,              # (nz,ny,nx) bool, or None when no conductors
) -> None:
    nz, ny, nx = A.shape[1:]
    n = nx * ny * nz
    dx, dy, dz = [float(v) for v in delta]
    nl = b"\n"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0" + nl + b"out data result" + nl + b"BINARY" + nl)
        dims = _trim(f"{_i8(nx)} {_i8(ny)} {_i8(nz)}")
        f.write(b"DATASET STRUCTURED_GRID" + nl + b"DIMENSIONS " + dims.encode() + nl)
        f.write(b"POINTS " + _trim(_i8(n)).encode() + b" float" + nl)
        zc, yc, xc = np.meshgrid(
            np.arange(nz) * dz, np.arange(ny) * dy, np.arange(nx) * dx, indexing="ij"
        )
        pts = np.stack([xc, yc, zc], axis=-1)
        f.write(np.ascontiguousarray(pts, ">f4").tobytes() + nl)
        f.write(b"POINT_DATA " + _trim(_i8(n)).encode() + nl)

        f.write(b"VECTORS Field_A float" + nl)
        f.write(_vec_block(A) + nl)

        has_cond = cond_mask is not None and bool(np.any(cond_mask))
        if has_cond:
            cm = np.asarray(cond_mask, bool)[None]
            f.write(b"VECTORS Vector_field_eddy float" + nl)
            f.write(_vec_block(np.where(cm, EDDY_SCALE * carry, 0.0)) + nl)
            f.write(b"VECTORS Vector_field_SOURCE float" + nl)
            f.write(_vec_block(np.where(cm, 0.0, carry)) + nl)
        else:
            f.write(b"VECTORS Vector_field_SOURCE float" + nl)
            f.write(_vec_block(carry) + nl)

        f.write(b"VECTORS Vector_field_B float" + nl)
        f.write(_vec_block(curl(A, delta)) + nl)


def write_src(
    path: str,
    delta,
    shape_xyz,
    cells_per_fun: list[np.ndarray],   # 0-based flat grid cells, per function
    values_per_fun: list[float],
    directions: list[str],             # 'X'|'Y'|'Z' per function
) -> None:
    nx, ny, _ = shape_xyz
    dx, dy, dz = [float(v) for v in delta]
    numcells = sum(len(c) for c in cells_per_fun)
    nl = b"\n"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0" + nl + b"out data result" + nl + b"BINARY" + nl)
        f.write(b"DATASET UNSTRUCTURED_GRID" + nl)
        f.write(b"POINTS " + _trim(_i8(numcells * 8)).encode() + b" double" + nl)
        corner = np.array(
            [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
             [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], float
        )
        for cells in cells_per_fun:
            cells = np.asarray(cells, np.int64)
            i = cells % nx
            j = (cells // nx) % ny
            k = cells // (nx * ny)
            base = np.stack([i * dx, j * dy, k * dz], axis=-1)  # (m,3)
            pts = base[:, None, :] + corner[None] * np.array([dx, dy, dz])
            f.write(np.ascontiguousarray(pts, ">f8").tobytes())
        f.write(nl)

        f.write(
            b"CELLS " + _trim(_i8(numcells)).encode() + b" "
            + _trim(_i8(9 * numcells)).encode() + nl
        )
        rec = np.empty((numcells, 9), np.int64)
        rec[:, 0] = 8
        rec[:, 1:] = 8 * np.arange(numcells)[:, None] + np.arange(8)[None]
        f.write(np.ascontiguousarray(rec, ">i4").tobytes() + nl)

        f.write(b"CELL_TYPES " + _trim(_i8(numcells)).encode() + nl)
        f.write(np.full(numcells, 11, ">i4").tobytes() + nl)

        f.write(b"CELL_DATA " + _trim(_i8(numcells)).encode() + nl)
        f.write(b"VECTORS Vector_field_SRC double" + nl)
        for cells, val, dirn in zip(cells_per_fun, values_per_fun, directions):
            v = np.zeros((len(cells), 3))
            v[:, {"X": 0, "Y": 1, "Z": 2}[dirn]] = float(val)
            f.write(np.ascontiguousarray(v, ">f8").tobytes())
        f.write(nl)


def _host(x) -> np.ndarray:
    """A host array of ``x``; a bfloat16 tensor widened to float32 on its
    device first (exact; numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def write_outputs(sim, state, info, npoint: int, output_dir: str) -> None:
    """Write field_<n>.vtk + src_<n>.vtk for one output point.

    Through the native encoder (``io/native.py``, ``csrc/ecio.cpp``:
    byte-identical, threaded curl, byteswap and interleave), or through
    the numpy writers above when ``EC3D_NATIVE_IO=0``, the JAX package's
    switch (its ``io/vtk.py`` ``write_outputs``).  ``state.A``/
    ``state.carry`` and ``info.src_cells`` may be numpy arrays or tensors
    on any device; the conductor mask is the model's host copy."""
    os.makedirs(output_dir, exist_ok=True)
    model = sim.model
    A = _host(state.A).astype(np.float64)
    carry = _host(state.carry).astype(np.float64)
    cond = model.cond_mask if model.n_cond else None
    field_path = os.path.join(output_dir, f"field_{npoint}.vtk")
    src_path = os.path.join(output_dir, f"src_{npoint}.vtk")
    cells = [_host(c) for c in info.src_cells]
    values = [float(v) for v in info.src_values]
    dirs = [fn.direction for fn in model.functions]
    if native.enabled():
        native.write_field_native(field_path, model.delta, A, carry, cond,
                                  EDDY_SCALE)
        native.write_src_native(src_path, model.delta, model.shape_xyz,
                                cells, values, dirs)
    else:
        write_field(field_path, model.delta, A, carry, cond)
        write_src(src_path, model.delta, model.shape_xyz, cells, values,
                  dirs)


def read_vtk_vectors(path: str) -> dict:
    """Minimal reader for the files written above (and by the reference):
    returns {'dims': (nx,ny,nz), '<field name>': (n,3) float64 array}."""
    out: dict = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def line():
        nonlocal pos
        end = data.index(b"\n", pos)
        s = data[pos:end]
        pos = end + 1
        return s

    assert line().startswith(b"# vtk")
    line()
    assert line() == b"BINARY"
    ds = line().split()
    n = None
    if ds[1] == b"STRUCTURED_GRID":
        dims = line().split()[1:]
        out["dims"] = tuple(int(d) for d in dims)
        hdr = line().split()
        n = int(hdr[1])
        pos += n * 3 * 4  # skip float32 points
        pos += 1
        assert line().split()[0] == b"POINT_DATA"
    else:
        hdr = line().split()  # POINTS np double
        npts = int(hdr[1])
        out["n_points"] = npts
        pts = np.frombuffer(data, ">f8", npts * 3, pos).reshape(npts, 3)
        out["points"] = pts.astype(np.float64)
        pos += npts * 3 * 8 + 1
        hdr = line().split()  # CELLS n 9n
        ncells = int(hdr[1])
        pos += ncells * 9 * 4 + 1
        line()  # CELL_TYPES
        pos += ncells * 4 + 1
        hdr = line().split()  # CELL_DATA n
        n = int(hdr[1])
    while pos < len(data):
        hdr = line().split()
        if not hdr:
            continue
        assert hdr[0] == b"VECTORS", hdr
        name = hdr[1].decode()
        dt, w = (">f4", 4) if hdr[2] == b"float" else (">f8", 8)
        arr = np.frombuffer(data, dt, n * 3, pos).reshape(n, 3)
        out[name] = arr.astype(np.float64)
        pos += n * 3 * w + 1
    return out
