"""The field-kernel tier: the operator applied from streamed coefficients.

The PyTorch counterpart of ``eddy_currents_3d_tpu/ops/pallas_stencil.py``.
The operator reads the assembled coefficient fields (``ka`` over the grid;
``gu``/``ku``/``da`` over the conductor box, see ``assembly/stencil.py``)
in float32 or bfloat16 and applies them to float32 or bfloat16 (or, on
the CPU, float64) fields.  It serves every run the case-coded operator does
not: bfloat16 state, ``precond="mg"``, bfloat16 coefficients
(``coeff_dtype``), ``use_coded=False``, and models the coded encoder
refuses.

At bfloat16 state both functions upcast coefficients and state to float32,
sum in float32 in the JAX kernels' order, and round once to bfloat16 at the
store.  The JAX kernels round every operation in bfloat16 instead, and add
the grad-U terms into yA after rounding them to bfloat16
(``pallas_stencil.py:365-368``): ``bf16(bf16(gout) + yA)`` where this tier
gives ``bf16(gout + yA)``, at most one bfloat16 ulp apart.

Two functions make up one apply, each with a plain torch version here and
a hand-written CUDA kernel (``csrc/field_stencil.cu``, wrappers in
``ops/field_cuda.py``):

* ``field_a``: ``y[l] = sum_o ka[o] * shift_o(A[l])`` over the 7 offsets
  ``[0, -x, +x, -y, +y, -z, +z]``, for every leading field ``l`` (the three
  A components here, the V-cycle's fields in ``solvers/multigrid.py``);
* ``field_u``: over the conductor box, the grad-U coupling added into the
  A rows, and the U rows (Laplacian on U plus the div(dA/dt) coupling).

Neighbours beyond the grid, or beyond the box for ``field_u``, read as
zero.  That is exact because of the assembly invariant
(``assembly/stencil.py``): every coefficient that reaches across a grid
face, or within 2 cells of a box face, is zero.

Unlike the TPU tier there is no padded layout: the operator works on the
model's own (3, nz, ny, nx) A and full-shape (nz, ny, nx) U, so
``pad_state``/``unpad_state`` are identities, kept so that the simulation
treats this tier and the coded one alike.  As in the JAX package the
operator has no ``apply_div``: the step's right-hand side goes through the
assembled operator's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..assembly.stencil import OFFSETS7, State, _boxslice, shift

__all__ = ["FieldStencilOperator", "field_a_reference", "field_u_reference"]

# grad-U offsets: coefficient index k -> shift along axis c, in the order
# the JAX kernel sums them (centre, -1, +1, -2, +2)
_GU_ORDER = ((2, 0), (1, -1), (3, +1), (0, -2), (4, +2))


def _upcast(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 state in float32 (exact); any other dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def field_a_reference(ka: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain version of ``field_a``: ``ka`` (7, nz, ny, nx) applied to every
    leading field of ``A`` (..., nz, ny, nx); a bfloat16 ``ka`` promotes to
    the float32 or float64 sum, a bfloat16 ``A`` is summed in float32 and
    the result rounded once to bfloat16."""
    out = A.dtype
    A = _upcast(A)
    y = ka[0] * A
    for o in range(1, 7):
        axis, d = OFFSETS7[o]
        y = y + ka[o] * shift(A, axis, d)
    return y.to(out)


def field_u_reference(gu, ku, da, box, A: torch.Tensor, U: torch.Tensor):
    """Plain version of ``field_u`` on the conductor ``box``: returns
    ``(gout, uout)``, the grad-U terms of the A rows (3, bz, by, bx) and
    the U rows (bz, by, bx).  At bfloat16 state ``uout`` is rounded once to
    bfloat16 and ``gout`` stays the float32 sum, to be added into the
    bfloat16 yA with one rounding (``yA[box] += gout``)."""
    out = U.dtype
    sl = _boxslice(box)
    Ub = _upcast(U[sl])
    Ab = _upcast(A[(slice(None),) + sl])
    gout = []
    for c in range(3):
        g = None
        for k, d in _GU_ORDER:
            t = gu[c, k] * shift(Ub, c, d)
            g = t if g is None else g + t
        gout.append(g)
    uout = ku[0] * Ub
    for o in range(1, 7):
        axis, d = OFFSETS7[o]
        uout = uout + ku[o] * shift(Ub, axis, d)
    for c in range(3):
        uout = (uout + da[c, 1] * Ab[c] + da[c, 0] * shift(Ab[c], c, -1)
                + da[c, 2] * shift(Ab[c], c, +1))
    return torch.stack(gout), uout.to(out)


@dataclass(frozen=True)
class FieldStencilOperator:
    """The operator over streamed coefficient fields (float32 or
    bfloat16), applied to fields of the state's dtype; on CUDA tensors its
    ``apply`` runs the two field kernels."""

    ka: torch.Tensor                # (7, nz, ny, nx)
    gu: torch.Tensor                # (3, 5, bz, by, bx)
    ku: torch.Tensor                # (7, bz, by, bx)
    da: torch.Tensor                # (3, 3, bz, by, bx)
    shape_zyx: tuple
    box: Optional[tuple] = None     # (z0, z1, y0, y1, x0, x1) or None

    @property
    def dtype(self) -> torch.dtype:
        return self.ka.dtype

    def pad_state(self, x: State) -> State:
        return x

    def unpad_state(self, x: State) -> State:
        return x

    def apply(self, x: State) -> State:
        """y = A @ x: ``field_a`` on the three A components, then, on the
        conductor box, ``field_u`` (which adds into yA)."""
        from .field_cuda import field_a, field_u
        yA = field_a(self.ka, x.A)
        if self.box is None:
            return State(yA, torch.zeros_like(x.U))
        return State(yA, field_u(self, x.A, x.U, yA))

    @staticmethod
    def without_box(ka: torch.Tensor, shape_zyx) -> "FieldStencilOperator":
        """The operator of a model with no conducting cell: ``ka`` alone,
        empty box fields."""
        empty = lambda *lead: torch.zeros(lead + (0, 0, 0), dtype=ka.dtype,
                                          device=ka.device)
        return FieldStencilOperator(ka, empty(3, 5), empty(7), empty(3, 3),
                                    tuple(shape_zyx), None)

    @staticmethod
    def from_assembled(system) -> "FieldStencilOperator":
        """The operator of an assembled system, in the dtype of
        ``system.op``'s coefficients.  Each field is converted from the
        float64 host copy (``system.np_ka``, ...), as the JAX package's
        ``pallas_stencil.from_assembled`` converts it.  To bfloat16 torch,
        jnp and ml_dtypes all round through float32, so these fields equal
        ``system.op.astype(torch.bfloat16)``'s bit for bit (tested against
        the JAX operator's in tests/test_torch_field.py)."""
        op = system.op
        dev, dtype = op.ka.device, op.ka.dtype
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
        shape = tuple(int(n) for n in op.shape_zyx)
        if op.box is None:
            return FieldStencilOperator.without_box(to(system.np_ka), shape)
        window = lambda a: a[(Ellipsis,) + _boxslice(op.box)]
        return FieldStencilOperator(
            to(system.np_ka), to(window(system.np_gu)),
            to(window(system.np_ku)), to(window(system.np_da)), shape,
            tuple(int(b) for b in op.box))
