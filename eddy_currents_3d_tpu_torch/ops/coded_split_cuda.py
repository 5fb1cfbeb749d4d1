"""Wrappers of the split route's hand-written CUDA kernels.

The kernels (``csrc/coded_split.cu``) replace the TPU kernels
``_stencil_kernel_yt`` and ``_slab_kernel_yt``
(``eddy_currents_3d_tpu/ops/pallas_coded.py:602``, ``:658``), which the
coded operator runs on 256x256-class planes with the solver's U held
z-compact: only the conductor's planes ``op.cond_z = (zb0, zb1)``.

* :data:`coded_stencil` fills every plane of yA outside the slab with the
  constant+face A stencil (A in, yA out, nothing else), and with ``wA``
  also returns dot(yA, wA) and dot(yA, yA) over those planes.
* :data:`coded_slab` runs the whole coded matvec on the slab's planes: it
  writes them into the same yA, in place, and returns the compact yU (with
  ``w``, also the dots over the slab).  Without ``U_c`` it is
  ``apply_div``'s contraction (U = 0) and returns the compact yU alone.

Both are bound by device-memory bytes (see the source note).  A CPU tensor
goes to the plain torch version (:func:`~.coded.coded_stencil_reference`,
:func:`~.coded.coded_slab_reference`); a CUDA tensor launches the kernel
or raises.  Each wrapper's ``launches`` counts its kernel's launches, and
only those.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..assembly.stencil import State
from .coded import coded_slab_reference, coded_stencil_reference
from .coded_cuda import CudaKernel, check_tensors, cuda_only, ptr

__all__ = ["coded_stencil", "coded_slab"]

_APPLY, _DOTS, _DIV = 0, 1, 2


def _slab(op):
    """(zb0, zb1) of ``op``, checked against its grid."""
    nz, ny, nx = op.shape_zyx
    zb0, zb1 = op.cond_z
    if not 0 <= zb0 < zb1 <= nz:
        raise ValueError(f"conductor planes {op.cond_z} do not fit the "
                         f"grid's {nz}")
    if 3 * nz * ny * nx >= 2 ** 31:
        raise ValueError(f"grid {op.shape_zyx} too large for the kernel")
    return zb0, zb1


class _SplitKernel(CudaKernel):
    source = "coded_split"
    consts_len = "coded_split_consts_len"

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        lib.coded_stencil_launch.argtypes = [vp] * 4 + [ci] * 6 + [fp, vp]
        lib.coded_stencil_launch.restype = ci
        lib.coded_slab_launch.argtypes = [vp] * 10 + [ci] * 7 + [fp, vp]
        lib.coded_slab_launch.restype = ci
        lib.coded_split_num_blocks.argtypes = [ci, ci, ci]
        lib.coded_split_num_blocks.restype = ctypes.c_longlong

    @staticmethod
    def _partials(lib, nx, ny, nplanes, dev):
        return torch.empty((lib.coded_split_num_blocks(nx, ny, nplanes), 2),
                           dtype=torch.float32, device=dev)


class _CodedStencil(_SplitKernel):
    def __call__(self, op, A: torch.Tensor, wA: Optional[torch.Tensor] = None):
        """yA (full shape; only the planes outside the slab are written on
        CUDA), or ``(yA, dot(yA, wA), dot(yA, yA))`` over those planes."""
        if A.device.type == "cpu":
            return coded_stencil_reference(A, op.consts, op.cond_z, wA)
        cuda_only("coded_stencil", A)
        zb0, zb1 = _slab(op)
        nz, ny, nx = op.shape_zyx
        dev = A.device
        f32 = torch.float32
        checks = [("A", A, (3, nz, ny, nx), f32)]
        if wA is not None:
            checks.append(("wA", wA, (3, nz, ny, nx), f32))
        check_tensors(dev, checks)
        lib, kc = self._ready(dev, op.consts)
        yA = torch.empty_like(A)
        nplanes = nz - (zb1 - zb0)
        if nplanes == 0:
            # the slab covers the grid: the stencil kernel owns no plane
            zero = torch.zeros((), dtype=f32, device=dev)
            return yA if wA is None else (yA, zero, zero.clone())
        parts = (self._partials(lib, nx, ny, nplanes, dev)
                 if wA is not None else None)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.coded_stencil_launch(
                ptr(A), ptr(wA), ptr(yA), ptr(parts), nx, ny, nz, zb0,
                zb1 - zb0, int(wA is not None), kc, stream)
        self._raise_on(err)
        if wA is None:
            return yA
        return yA, parts[:, 0].sum(), parts[:, 1].sum()


class _CodedSlab(_SplitKernel):
    def __call__(self, op, A: torch.Tensor, U_c: Optional[torch.Tensor] = None,
                 yA: Optional[torch.Tensor] = None, w: Optional[State] = None):
        """With ``U_c`` (the compact U): write the slab's planes of ``yA``
        in place and return the compact yU, or ``(yU_c, dot(y, w),
        dot(y, y))`` over the slab when ``w`` is given (``w.A`` full-grid,
        ``w.U`` compact).  Without: ``apply_div`` (U = 0), returns the
        compact yU."""
        if U_c is None and (yA is not None or w is not None):
            raise ValueError("apply_div takes A alone")
        if U_c is not None and yA is None:
            raise ValueError("apply needs the yA whose slab planes it fills")
        if A.device.type == "cpu":
            out = coded_slab_reference(A, U_c, op.code, op.cf, op.conv,
                                       op.consts, op.inertia_on_faces,
                                       op.cond_z, w)
            if U_c is None:
                return out
            zb0, zb1 = op.cond_z
            yA[:, zb0:zb1] = out[0]
            return out[1] if w is None else out[1:]
        cuda_only("coded_slab", A)
        return self._launch(op, A, U_c, yA, w)

    def _launch(self, op, A, U_c, yA, w):
        zb0, zb1 = _slab(op)
        nzc = zb1 - zb0
        nz, ny, nx = op.shape_zyx
        mode = _DIV if U_c is None else (_APPLY if w is None else _DOTS)
        dev = A.device
        f32 = torch.float32
        checks = [("A", A, (3, nz, ny, nx), f32),
                  ("code", op.code, (nz, ny, nx), torch.int32),
                  ("cf", op.cf, (nz, ny, nx), f32)]
        if U_c is not None:
            checks += [("U_c", U_c, (nzc, ny, nx), f32),
                       ("yA", yA, (3, nz, ny, nx), f32)]
        if op.conv is not None:
            checks.append(("conv", op.conv, (3, nz, ny, nx), f32))
        if w is not None:
            checks += [("w.A", w.A, (3, nz, ny, nx), f32),
                       ("w.U", w.U, (nzc, ny, nx), f32)]
        check_tensors(dev, checks)
        lib, kc = self._ready(dev, op.consts)
        yU = torch.empty((nzc, ny, nx), dtype=f32, device=dev)
        parts = (self._partials(lib, nx, ny, nzc, dev) if mode == _DOTS
                 else None)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.coded_slab_launch(
                ptr(A), ptr(U_c), ptr(op.code), ptr(op.cf), ptr(op.conv),
                ptr(w.A if w is not None else None),
                ptr(w.U if w is not None else None),
                ptr(yA), ptr(yU), ptr(parts),
                nx, ny, nz, zb0, nzc, mode, int(op.inertia_on_faces), kc,
                stream)
        self._raise_on(err)
        if mode != _DOTS:
            return yU
        return yU, parts[:, 0].sum(), parts[:, 1].sum()


coded_stencil = _CodedStencil()
coded_slab = _CodedSlab()
