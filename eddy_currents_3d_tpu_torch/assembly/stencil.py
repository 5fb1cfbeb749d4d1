"""Block stencil (DIA) operator as torch ops — the flat-roll reference.

The PyTorch counterpart of ``eddy_currents_3d_tpu/assembly/stencil.py``.
The global matrix over unknowns ``[Ax | Ay | Az | U]`` (EC3D.f90:465-1049)
is stored as dense per-offset coefficient fields over the voxel grid and
applied as a sum of shifted multiply-adds on flat vectors.  This operator
streams every assembled coefficient, so it is the slow path; it is the
f64 operator and the independent oracle that the case-coded operator
(``ops/coded.py``) and its CUDA kernel are tested against.

Blocks (see assemble.py for how they are filled):

* ``ka``  (7, nz, ny, nx)  — the A-row stencil, *shared* by Ax/Ay/Az.
  Offset order: [0, -x, +x, -y, +y, -z, +z].
* ``gu``  (3, 5, *box*)    — grad-U coupling into the A_c row; offsets
  [-2, -1, 0, +1, +2] along axis c.
* ``ku``  (7, *box*)       — U-row Laplacian on U.
* ``da``  (3, 3, *box*)    — U-row div(dA/dt) coupling into A_c; offsets
  [-1, 0, +1] along axis c.

The U-coupled blocks are stored over the conductor bounding box expanded
by the 2-cell stencil halo; ``box`` is None when there are no conductors.
U is dense on the grid but only conducting cells carry unknowns; every
coefficient touching a non-conducting U cell is zero, so those entries
stay zero through the solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["State", "StencilOperator", "shift", "OFFSETS7"]

# array dims for (..., z, y, x)
_AXIS = {0: -1, 1: -2, 2: -3}  # physical axis (x,y,z) -> tensor dim


def shift(f: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """Neighbor gather: ``out[c] = f[c + d * unit(axis)]``, zero beyond the
    grid.  ``axis`` is the physical axis (0=x, 1=y, 2=z)."""
    if d == 0:
        return f
    dim = _AXIS[axis] % f.dim()
    n = f.shape[dim]
    out = torch.zeros_like(f)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, 0, n - d).copy_(f.narrow(dim, d, n - d))
    else:
        out.narrow(dim, -d, n + d).copy_(f.narrow(dim, 0, n + d))
    return out


# canonical 7-point offset list used by ka/ku: index -> (axis, d)
OFFSETS7 = ((None, 0), (0, -1), (0, +1), (1, -1), (1, +1), (2, -1), (2, +1))


@dataclass(frozen=True)
class State:
    """The unknown vector as grid fields: A (3, nz, ny, nx) and U (nz, ny, nx)."""

    A: torch.Tensor
    U: torch.Tensor


def _boxslice(box):
    z0, z1, y0, y1, x0, x1 = box
    return (slice(z0, z1), slice(y0, y1), slice(x0, x1))


@dataclass(frozen=True)
class StencilOperator:
    ka: torch.Tensor   # (7, nz, ny, nx)
    gu: torch.Tensor   # (3, 5, bz, by, bx) — conductor box (halo included)
    ku: torch.Tensor   # (7, bz, by, bx)
    da: torch.Tensor   # (3, 3, bz, by, bx)
    # (z0, z1, y0, y1, x0, x1) of the conductor box within the grid;
    # None when the model has no conducting cells
    box: Optional[tuple] = None

    @property
    def shape_zyx(self):
        return tuple(self.ka.shape[1:])

    @property
    def dtype(self):
        return self.ka.dtype

    def apply(self, x: State) -> State:
        """y = A @ x (the full coupled operator).

        Flat-roll formulation: every stencil offset that crosses a grid (or
        conductor-box) face has a zero coefficient on the cells where the
        flattened roll wraps, so shifts are plain ``torch.roll`` on flat
        vectors."""
        nz, ny, nx = self.shape_zyx
        N = nz * ny * nx
        strides = (1, nx, nx * ny)

        A2 = x.A.reshape(3, N)
        ka = self.ka.reshape(7, N)
        yA = ka[0] * A2
        for o, (axis, d) in enumerate(OFFSETS7):
            if o == 0:
                continue
            yA = yA + ka[o] * torch.roll(A2, -d * strides[axis], dims=1)
        yA = yA.reshape(x.A.shape)

        if self.box is None:
            return State(yA, torch.zeros_like(x.U))

        sl = _boxslice(self.box)
        bz, by, bx = self.ku.shape[1:]
        B = bz * by * bx
        bstr = (1, bx, bx * by)
        Ub = x.U[sl].reshape(B)
        gu = self.gu.reshape(3, 5, B)
        ku = self.ku.reshape(7, B)

        # grad-U coupling into the A rows (conductor box only)
        gu_terms = []
        for c in range(3):
            t = gu[c, 2] * Ub
            for k, d in ((0, -2), (1, -1), (3, +1), (4, +2)):
                t = t + gu[c, k] * torch.roll(Ub, -d * bstr[c])
            gu_terms.append(t.reshape(bz, by, bx))
        yA[(slice(None),) + sl] += torch.stack(gu_terms)

        # U rows: Laplacian on U + div coupling into A (box only)
        yUb = ku[0] * Ub
        for o, (axis, d) in enumerate(OFFSETS7):
            if o == 0:
                continue
            yUb = yUb + ku[o] * torch.roll(Ub, -d * bstr[axis])
        yUb = yUb + self._div_box(x.A)
        yU = torch.zeros_like(x.U)
        yU[sl] = yUb.reshape(bz, by, bx)
        return State(yA, yU)

    def _div_box(self, A: torch.Tensor) -> torch.Tensor:
        """Flat box vector of the div-coupling contraction (same flat-roll
        argument as apply: da is zero within 1 cell of the box faces)."""
        sl = _boxslice(self.box)
        bz, by, bx = self.ku.shape[1:]
        B = bz * by * bx
        bstr = (1, bx, bx * by)
        Ab = A[(slice(None),) + sl].reshape(3, B)
        da = self.da.reshape(3, 3, B)
        yUb = torch.zeros(B, dtype=A.dtype, device=A.device)
        for c in range(3):
            yUb = yUb + da[c, 1] * Ab[c]
            yUb = yUb + da[c, 0] * torch.roll(Ab[c], bstr[c])
            yUb = yUb + da[c, 2] * torch.roll(Ab[c], -bstr[c])
        return yUb

    def apply_div(self, A: torch.Tensor) -> torch.Tensor:
        """Only the U-row -> A-column coupling (the per-step RHS term: the
        reference moves these terms times the old solution to the right hand
        side, EC3D.f90:385-392)."""
        full = torch.zeros(A.shape[1:], dtype=A.dtype, device=A.device)
        if self.box is None:
            return full
        bz, by, bx = self.ku.shape[1:]
        full[_boxslice(self.box)] = self._div_box(A).reshape(bz, by, bx)
        return full

    def diagonal(self) -> State:
        """Operator diagonal as a State (for Jacobi preconditioning).
        Non-conducting U rows have no unknown; report 1 there."""
        dA = self.ka[0][None].expand((3,) + tuple(self.ka.shape[1:])).clone()
        dU = torch.ones(self.ka.shape[1:], dtype=self.ka.dtype,
                        device=self.ka.device)
        if self.box is not None:
            ku0 = self.ku[0]
            dU[_boxslice(self.box)] = torch.where(
                ku0 == 0, torch.ones_like(ku0), ku0)
        return State(dA, dU)

    def astype(self, dtype: torch.dtype) -> "StencilOperator":
        """The operator with its coefficients rounded to ``dtype``.  A
        bfloat16 operator applied to float32 fields promotes each product
        to float32, as jnp does, so the state keeps its dtype."""
        return StencilOperator(self.ka.to(dtype), self.gu.to(dtype),
                               self.ku.to(dtype), self.da.to(dtype), self.box)
