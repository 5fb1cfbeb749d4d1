"""Wrapper of the hand-written CUDA coded-matvec kernel.

The kernel (``csrc/coded_matvec.cu``) replaces the TPU kernel
``_fused_kernel_chunk`` and its decode ``_u_body``
(``eddy_currents_3d_tpu/ops/pallas_coded.py:405``, ``:1051``).  It is bound
by device-memory bytes: about 40 B per cell without convection or dots
(A, U, code and cf read once, yA and yU written once; neighbours come from
cache).  One thread per cell on (x, y) tiles with one z plane per block
keeps a warp's neighbour reads on shared cache lines, and cells that do
not conduct skip the decode and its U, cf and conv reads.  See the source
note for the rest of the design.

:data:`coded_matvec` serves the coded operator's three entry points on the
whole-plane route.  A CPU tensor goes to
:func:`~.coded.coded_apply_reference`, the plain torch version; a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel
launches, and only those.  :class:`CudaKernel`, :func:`check_tensors` and
:func:`cuda_only` are what this wrapper shares with the split route's
(``ops/coded_split_cuda.py``) and the field tier's (``ops/field_cuda.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from ..assembly.stencil import State
from ._build import load_library
from .coded import coded_apply_reference

__all__ = ["coded_matvec", "CudaKernel", "check_tensors", "cuda_only"]

_APPLY, _DOTS, _DIV = 0, 1, 2


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes; None for a missing operand."""
    return None if t is None else t.data_ptr()


@lru_cache(maxsize=16)
def pack_consts(consts) -> ctypes.Array:
    """The kernel's ``Consts`` struct: each constant formed in float64 and
    rounded once to float32, in the struct's field order."""
    s, ds, dt, delta, BND = consts
    vals = (list(s)
            + [BND[a][0] * s[a] for a in range(3)]
            + [BND[a][1] * s[a] for a in range(3)]
            + list(ds)
            + [2.0 / dt, 2.0 * (s[0] + s[1] + s[2])]
            + [2.0 / (dt * delta[a]) for a in range(3)]
            + [0.5 / (dt * delta[a]) for a in range(3)])
    return (ctypes.c_float * len(vals))(*vals)


def cuda_only(name, t):
    """Raise unless ``t`` lies on a CUDA device (the wrappers send CPU
    tensors to the plain versions before they call this)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")


def check_tensors(dev, checks):
    """Raise unless each ``(name, tensor, shape, dtype)`` of ``checks`` is
    a contiguous tensor of that shape and dtype on ``dev``."""
    for name, t, shape, dtype in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, A on {dev}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class CudaKernel:
    """What the wrappers of the hand-written kernels share: the library of
    ``csrc/<source>.cu``, built at first use; a check, once per device,
    that the card is Hopper and (for the coded kernels) that the library's
    ``Consts`` layout is :func:`pack_consts`'s; and ``launches``, the count
    of kernel launches."""

    source = ""         # csrc/<source>.cu
    consts_len = None   # the library's function giving len(Consts), if any

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._checked = set()     # devices whose arch was checked

    def _bind(self, lib):
        """Declare the argument and result types of ``lib``'s functions."""
        raise NotImplementedError

    def _library(self):
        if self._lib is None:
            lib = load_library(self.source)
            if self.consts_len:
                getattr(lib, self.consts_len).restype = ctypes.c_int
            self._bind(lib)
            self._lib = lib
        return self._lib

    def _ready(self, dev, consts=None):
        """(library, packed constants or None) for a launch on ``dev``."""
        lib = self._library()
        kc = pack_consts(consts) if consts is not None else None
        if dev not in self._checked:
            cap = torch.cuda.get_device_capability(dev)
            if cap != (9, 0):
                raise RuntimeError(
                    f"the {self.source} kernels are built for sm_90a (Hopper); "
                    f"{torch.cuda.get_device_name(dev)} is sm_{cap[0]}{cap[1]}")
            if kc is not None and len(kc) != getattr(lib, self.consts_len)():
                raise RuntimeError(f"csrc/{self.source}.cu Consts layout "
                                   "differs from pack_consts")
            self._checked.add(dev)
        return lib, kc

    def _raise_on(self, err):
        if err != 0:
            raise RuntimeError(f"{self.source} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1


class _CodedMatvec(CudaKernel):
    source = "coded_matvec"
    consts_len = "coded_matvec_consts_len"

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.coded_matvec_launch.argtypes = [vp] * 10 + [ci] * 5 + [
            ctypes.POINTER(ctypes.c_float), vp]
        lib.coded_matvec_launch.restype = ci
        lib.coded_matvec_num_blocks.argtypes = [ci, ci, ci]
        lib.coded_matvec_num_blocks.restype = ctypes.c_longlong

    def __call__(self, op, A: torch.Tensor, U: Optional[torch.Tensor] = None,
                 w: Optional[State] = None):
        """``U is None``: apply_div (returns yU).  ``w`` given: apply_dots
        (returns yA, yU, dot(y, w), dot(y, y)).  Otherwise apply (returns
        yA, yU)."""
        if U is None and w is not None:
            raise ValueError("apply_dots needs U")
        if A.device.type == "cpu":
            out = coded_apply_reference(A, U, op.code, op.cf, op.conv,
                                        op.consts, op.inertia_on_faces, w)
            return out[1] if U is None else out
        cuda_only("coded_matvec", A)
        return self._launch(op, A, U, w)

    def _launch(self, op, A, U, w):
        nz, ny, nx = op.shape_zyx
        if 3 * nz * ny * nx >= 2 ** 31:
            raise ValueError(f"grid {op.shape_zyx} too large for the kernel")
        mode = _DIV if U is None else (_APPLY if w is None else _DOTS)
        dev = A.device
        f32 = torch.float32
        checks = [("A", A, (3, nz, ny, nx), f32),
                  ("code", op.code, (nz, ny, nx), torch.int32),
                  ("cf", op.cf, (nz, ny, nx), f32)]
        if U is not None:
            checks.append(("U", U, (nz, ny, nx), f32))
        if op.conv is not None:
            checks.append(("conv", op.conv, (3, nz, ny, nx), f32))
        if w is not None:
            checks += [("w.A", w.A, (3, nz, ny, nx), f32),
                       ("w.U", w.U, (nz, ny, nx), f32)]
        check_tensors(dev, checks)
        lib, kc = self._ready(dev, op.consts)
        yA = torch.empty_like(A) if mode != _DIV else None
        yU = torch.empty((nz, ny, nx), dtype=f32, device=dev)
        parts = (torch.empty((lib.coded_matvec_num_blocks(nx, ny, nz), 2),
                             dtype=f32, device=dev)
                 if mode == _DOTS else None)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.coded_matvec_launch(
                ptr(A), ptr(U), ptr(op.code), ptr(op.cf), ptr(op.conv),
                ptr(w.A if w is not None else None),
                ptr(w.U if w is not None else None),
                ptr(yA), ptr(yU), ptr(parts),
                nx, ny, nz, mode, int(op.inertia_on_faces), kc, stream)
        self._raise_on(err)
        if mode == _DIV:
            return yU
        if mode == _APPLY:
            return yA, yU
        return yA, yU, parts[:, 0].sum(), parts[:, 1].sum()


coded_matvec = _CodedMatvec()
