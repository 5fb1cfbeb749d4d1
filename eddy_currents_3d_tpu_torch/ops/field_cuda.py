"""Wrappers of the field tier's hand-written CUDA kernels.

The kernels (``csrc/field_stencil.cu``) replace the TPU kernels
``_a_kernel`` and ``_u_kernel`` (``eddy_currents_3d_tpu/ops/pallas_stencil.py:136``,
``:206``), each with its single-tile twin.  Both take float32 fields (the
state) with float32 or bfloat16 coefficients, or bfloat16 fields with
bfloat16 coefficients, sum in float32 and round once to the state's dtype,
and are bound by device-memory bytes (see the source note).

* :data:`field_a` applies a 7-point coefficient field ``ka`` to every
  leading field of ``A``: the operator's three A components, and every
  level of the multigrid V-cycle (``solvers/multigrid.py``).
* :data:`field_u` runs the conductor box's U coupling: it adds the grad-U
  terms into ``yA`` in place (after ``field_a`` on the same stream) and
  returns yU, zero off the box.

A CPU tensor goes to the plain torch version (:func:`~.field.field_a_reference`,
:func:`~.field.field_u_reference`); a CUDA tensor launches the kernel or
raises: a bfloat16 tensor launches the bfloat16-state instantiation, never
an upcast around the float32 one.  Each wrapper's ``launches`` counts its
kernels' launches, and only those; ``bf16_state.launches`` counts the
bfloat16-state launches among them.
"""

from __future__ import annotations

import ctypes

import torch

from ..assembly.stencil import _boxslice
from .coded_cuda import CudaKernel, check_tensors, cuda_only, ptr
from .field import field_a_reference, field_u_reference

__all__ = ["field_a", "field_u"]

_DTYPES = (torch.float32, torch.bfloat16)


def _is_bf16(name, t):
    """1 for a bfloat16 tensor, 0 for a float32 one; raises otherwise."""
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16 on CUDA, "
                         f"got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def _flags(coef_name, coef, state_name, state):
    """(coef_bf16, state_bf16) of a kernel's coefficient and state tensors;
    bfloat16 state takes bfloat16 coefficients only."""
    coef_bf16, state_bf16 = _is_bf16(coef_name, coef), _is_bf16(state_name,
                                                                  state)
    if state_bf16 and not coef_bf16:
        raise ValueError(f"bfloat16 {state_name} needs bfloat16 {coef_name} "
                         f"on CUDA, got {coef.dtype}")
    return coef_bf16, state_bf16


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class _Count:
    """A launch count of its own: ``launches``."""

    def __init__(self):
        self.launches = 0


class _FieldKernel(CudaKernel):
    source = "field_stencil"

    def __init__(self):
        super().__init__()
        self.bf16_state = _Count()

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.field_a_launch.argtypes = [vp, ci, ci, vp, vp] + [ci] * 4 + [vp]
        lib.field_a_launch.restype = ci
        lib.field_u_launch.argtypes = ([vp] * 3 + [ci] * 2 + [vp] * 4
                                       + [ci] * 9 + [vp])
        lib.field_u_launch.restype = ci

    def _counted(self, err, state_bf16):
        self._raise_on(err)
        self.bf16_state.launches += state_bf16


class _FieldA(_FieldKernel):
    def __call__(self, ka: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        """``y[l] = sum_o ka[o] * shift_o(A[l])`` for ``ka`` (7, nz, ny, nx)
        and ``A`` (L, nz, ny, nx) or (nz, ny, nx)."""
        if A.device.type == "cpu":
            return field_a_reference(ka, A)
        cuda_only("field_a", A)
        nz, ny, nx = ka.shape[1:]
        if A.dim() not in (3, 4) or tuple(A.shape[-3:]) != (nz, ny, nx):
            raise ValueError(f"A must have shape (L, {nz}, {ny}, {nx}) or "
                             f"({nz}, {ny}, {nx}), got {tuple(A.shape)}")
        coef_bf16, state_bf16 = _flags("ka", ka, "A", A)
        dev = A.device
        check_tensors(dev, [("ka", ka, (7, nz, ny, nx), ka.dtype),
                            ("A", A, A.shape, A.dtype)])
        lib, _ = self._ready(dev)
        L = A.shape[0] if A.dim() == 4 else 1
        y = torch.empty_like(A)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.field_a_launch(ptr(ka), coef_bf16, state_bf16, ptr(A),
                                     ptr(y), L, nx, ny, nz, stream)
        self._counted(err, state_bf16)
        return y


class _FieldU(_FieldKernel):
    def __call__(self, op, A: torch.Tensor, U: torch.Tensor,
                 yA: torch.Tensor) -> torch.Tensor:
        """Add ``op``'s grad-U terms into the conductor box of ``yA`` (in
        place) and return yU (nz, ny, nx), zero off the box.  ``yA`` must
        not share memory with ``A`` or ``U``."""
        if op.box is None:
            raise ValueError("field_u needs a conductor box")
        if _shares_memory(yA, A) or _shares_memory(yA, U):
            raise ValueError("yA must not share memory with A or U")
        sl = _boxslice(op.box)
        if A.device.type == "cpu":
            gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, A, U)
            yA[(slice(None),) + sl] += gout
            yU = torch.zeros_like(U)
            yU[sl] = uout
            return yU
        cuda_only("field_u", A)
        nz, ny, nx = op.shape_zyx
        z0, z1, y0, y1, x0, x1 = op.box
        box = (z1 - z0, y1 - y0, x1 - x0)
        coef_bf16, state_bf16 = _flags("gu", op.gu, "A", A)
        dev = A.device
        cd, sd = op.gu.dtype, A.dtype
        check_tensors(dev, [("gu", op.gu, (3, 5) + box, cd),
                            ("ku", op.ku, (7,) + box, cd),
                            ("da", op.da, (3, 3) + box, cd),
                            ("A", A, (3, nz, ny, nx), sd),
                            ("U", U, (nz, ny, nx), sd),
                            ("yA", yA, (3, nz, ny, nx), sd)])
        lib, _ = self._ready(dev)
        yU = torch.zeros_like(U)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.field_u_launch(
                ptr(op.gu), ptr(op.ku), ptr(op.da), coef_bf16, state_bf16,
                ptr(A), ptr(U), ptr(yA), ptr(yU), nx, ny, nz, z0, y0, x0,
                *box, stream)
        self._counted(err, state_bf16)
        return yU


field_a = _FieldA()
field_u = _FieldU()
