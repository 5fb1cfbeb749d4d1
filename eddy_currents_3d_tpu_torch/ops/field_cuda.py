"""Wrappers of the field tier's hand-written CUDA kernels.

The kernels (``csrc/field_stencil.cu``) replace the TPU kernels
``_a_kernel`` and ``_u_kernel`` (``eddy_currents_3d_tpu/ops/pallas_stencil.py:136``,
``:206``), each with its single-tile twin.  Both take float32 or bfloat16
fields (the state) with float32 or bfloat16 coefficients, sum in float32
and round once to the state's dtype, and are bound by device-memory bytes
(see the source note).

* :data:`field_a` applies a 7-point coefficient field ``ka`` to every
  leading field of ``A``: the operator's three A components, and every
  level of the multigrid V-cycle (``solvers/multigrid.py``).
* :data:`field_u` runs the conductor box's U coupling: it adds the grad-U
  terms into ``yA`` in place (after ``field_a`` on the same stream) and
  returns yU, zero off the box.

A CPU tensor goes to the plain torch version (:func:`~.field.field_a_reference`,
:func:`~.field.field_u_reference`); a CUDA tensor launches a kernel or
raises: a bfloat16 tensor launches a bfloat16-state kernel, never an upcast
around the float32 one.  At bfloat16 state two hand-written kernels compute
the same outputs bit for bit, and :func:`pair_route` picks one from the
shape, the box, the coefficients' dtype and the tensors' alignment:

* ``"paired"``: two cells along x a thread, read and written as 4-byte
  words (a float32 coefficient pair as one 8-byte float2), marching runs of
  planes with the z neighbours in registers (``field_a_pairs``,
  ``field_a_pairs_f32``, ``field_u_pairs``), where the width is even;
* ``"scalar"``: one cell a thread (the bfloat16-state instantiations of
  the one-cell kernels), for every other shape: odd widths such as the
  V-cycle's coarse levels, unaligned views, and ``field_u`` with float32
  coefficients (``coeff_dtype=torch.float32``).

Each wrapper's ``launches`` counts its kernels' launches, and only those;
``bf16_state.launches`` counts the bfloat16-state launches among them,
``paired.launches`` and ``scalar.launches`` each route's, which add up to
``bf16_state.launches``, and ``f32_coef.launches`` those of the
bfloat16-state launches that took float32 coefficients (on either route).
"""

from __future__ import annotations

import ctypes

import torch

from ..assembly.stencil import _boxslice
from ..utils.graph import counted
from .coded_cuda import CudaKernel, check_tensors, cuda_only, ptr
from .field import field_a_reference, field_u_reference

__all__ = ["field_a", "field_u", "pair_route", "aligned4", "pairs_aligned",
           "KERNEL_NAMES"]

_DTYPES = (torch.float32, torch.bfloat16)
_ROUTES = ("paired", "scalar")


def pair_route(shape_zyx, box=None, aligned: bool = True,
               fields: int = 3, coef_bf16: bool = True) -> str:
    """The route of a bfloat16-state launch over a grid of ``shape_zyx``
    (nz, ny, nx) with ``fields`` state fields: ``"paired"`` where every
    tensor is aligned to its pairs (``aligned``: :func:`pairs_aligned` for
    ``field_a``, :func:`aligned4` for ``field_u``), every index fits 32
    bits and pairs of cells along x fill whole words: nx even for
    ``field_a`` (``box`` None, bfloat16 or float32 coefficients), nx and
    the box's width even for ``field_u`` over ``box`` (z0, z1, y0, y1, x0,
    x1), whose paired kernel takes bfloat16 coefficients only
    (``coef_bf16``); ``"scalar"`` otherwise."""
    nz, ny, nx = shape_zyx
    even = nx % 2 == 0 and (box is None or (box[5] - box[4]) % 2 == 0)
    fits = max(fields, 15) * nz * ny * nx < 2 ** 31
    takes = coef_bf16 or box is None
    return "paired" if takes and even and aligned and fits else "scalar"


def aligned4(*tensors) -> bool:
    """Whether every tensor's data starts on a 4-byte boundary.  The
    wrappers ask it of their inputs only: an output they allocate starts a
    block of the caching allocator, and the launch refuses any pointer
    that is not aligned."""
    return all(t.data_ptr() % 4 == 0 for t in tensors)


def pairs_aligned(ka, *state) -> bool:
    """Whether ``field_a``'s paired kernels can read ``ka`` and the
    ``state`` tensors as pairs: ``ka`` from a boundary of two coefficients
    (4 bytes in bfloat16, 8 in float32), the state on 4 bytes."""
    return ka.data_ptr() % (2 * ka.element_size()) == 0 and aligned4(*state)


def _chosen(asked, choice):
    """The route a launch takes: ``choice`` (:func:`pair_route`'s) unless
    the caller ``asked`` for one; the paired route only where it applies."""
    if asked is None:
        return choice
    if asked not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES} or None, got "
                         f"{asked!r}")
    if asked == "paired" and choice != "paired":
        raise ValueError("the paired route needs an even width, tensors "
                         "aligned to their pairs, 32-bit indices and, for "
                         "field_u, bfloat16 coefficients")
    return asked


def _is_bf16(name, t):
    """1 for a bfloat16 tensor, 0 for a float32 one; raises otherwise."""
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16 on CUDA, "
                         f"got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def _flags(coef_name, coef, state_name, state):
    """(coef_bf16, state_bf16) of a kernel's coefficient and state
    tensors, each float32 or bfloat16."""
    return _is_bf16(coef_name, coef), _is_bf16(state_name, state)


def _shares_memory(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class _Count:
    """A launch count of its own: ``launches``."""

    def __init__(self):
        self.launches = 0
        counted(self)


# The kernels of csrc/field_stencil.cu in field_info's numbering, each with
# a piece of its mangled name (to find its ptxas lines in a build log).
KERNEL_NAMES = {
    "field_a_kernel<float, float>": "field_a_kernelIffE",
    "field_a_kernel<bf16, float>": "field_a_kernelI13__nv_bfloat16fE",
    "field_a_kernel<bf16, bf16>": "field_a_kernelI13__nv_bfloat16S",
    "field_u_kernel<float, float>": "field_u_kernelIffE",
    "field_u_kernel<bf16, float>": "field_u_kernelI13__nv_bfloat16fE",
    "field_u_kernel<bf16, bf16>": "field_u_kernelI13__nv_bfloat16S",
    "field_a_pairs<3>": "field_a_pairsILi3E",
    "field_a_pairs<1>": "field_a_pairsILi1E",
    "field_u_pairs<kEven>": "field_u_pairsILi0E",
    "field_u_pairs<kOdd>": "field_u_pairsILi1E",
    "field_a_kernel<float, bf16>": "field_a_kernelIf13__nv_bfloat16E",
    "field_u_kernel<float, bf16>": "field_u_kernelIf13__nv_bfloat16E",
    "field_a_pairs_f32<3>": "field_a_pairs_f32ILi3E",
    "field_a_pairs_f32<1>": "field_a_pairs_f32ILi1E",
}


class _FieldKernel(CudaKernel):
    source = "field_stencil"

    def __init__(self):
        super().__init__()
        self.bf16_state = _Count()
        self.paired = _Count()
        self.scalar = _Count()
        self.f32_coef = _Count()

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.field_a_launch.argtypes = [vp, ci, ci, vp, vp] + [ci] * 4 + [vp]
        lib.field_a_launch.restype = ci
        lib.field_u_launch.argtypes = ([vp] * 3 + [ci] * 2 + [vp] * 4
                                       + [ci] * 9 + [vp])
        lib.field_u_launch.restype = ci
        lib.field_a_pairs_launch.argtypes = [vp, ci, vp, vp] + [ci] * 4 + [vp]
        lib.field_a_pairs_launch.restype = ci
        lib.field_u_pairs_launch.argtypes = [vp] * 7 + [ci] * 9 + [vp]
        lib.field_u_pairs_launch.restype = ci
        lib.field_info.argtypes = [ci, ctypes.POINTER(ctypes.c_int)]
        lib.field_info.restype = ci

    def _counted(self, err, state_bf16, route, coef_bf16):
        self._raise_on(err)
        if state_bf16:
            self.bf16_state.launches += 1
            getattr(self, route).launches += 1
            if not coef_bf16:
                self.f32_coef.launches += 1

    def info(self, kernel: str, dev=None):
        """{registers, resident CTAs per SM, local bytes per thread, threads}
        of ``kernel`` (a key of :data:`KERNEL_NAMES`) at the threads a CTA
        it launches with."""
        lib = self._library()
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev or torch.device("cuda")):
            err = lib.field_info(list(KERNEL_NAMES).index(kernel), out)
        if err != 0:
            raise RuntimeError(f"field_info failed: CUDA error {err}")
        return dict(zip(("registers", "ctas_per_sm", "local_bytes",
                         "threads"), out))


class _FieldA(_FieldKernel):
    def __call__(self, ka: torch.Tensor, A: torch.Tensor,
                 route=None) -> torch.Tensor:
        """``y[l] = sum_o ka[o] * shift_o(A[l])`` for ``ka`` (7, nz, ny, nx)
        and ``A`` (L, nz, ny, nx) or (nz, ny, nx).  ``route`` ("paired" or
        "scalar", bfloat16 state only) overrides :func:`pair_route`."""
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
        if route is not None and not state_bf16:
            raise ValueError("route applies to bfloat16 state only")
        lib, _ = self._ready(dev)
        L = A.shape[0] if A.dim() == 4 else 1
        y = torch.empty_like(A)
        if state_bf16:
            route = _chosen(route, pair_route((nz, ny, nx), None,
                                              pairs_aligned(ka, A), L,
                                              coef_bf16))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if route == "paired":
                err = lib.field_a_pairs_launch(ptr(ka), coef_bf16, ptr(A),
                                               ptr(y), L, nx, ny, nz, stream)
            else:
                err = lib.field_a_launch(ptr(ka), coef_bf16, state_bf16,
                                         ptr(A), ptr(y), L, nx, ny, nz,
                                         stream)
        self._counted(err, state_bf16, route, coef_bf16)
        return y


class _FieldU(_FieldKernel):
    def __call__(self, op, A: torch.Tensor, U: torch.Tensor,
                 yA: torch.Tensor, route=None) -> torch.Tensor:
        """Add ``op``'s grad-U terms into the conductor box of ``yA`` (in
        place) and return yU (nz, ny, nx), zero off the box.  ``yA`` must
        not share memory with ``A`` or ``U``.  ``route`` as for
        ``field_a``."""
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
        if route is not None and not state_bf16:
            raise ValueError("route applies to bfloat16 state only")
        lib, _ = self._ready(dev)
        yU = torch.zeros_like(U)
        if state_bf16:
            route = _chosen(route, pair_route(
                (nz, ny, nx), op.box,
                aligned4(op.gu, op.ku, op.da, A, U, yA),
                coef_bf16=coef_bf16))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if route == "paired":
                err = lib.field_u_pairs_launch(
                    ptr(op.gu), ptr(op.ku), ptr(op.da), ptr(A), ptr(U),
                    ptr(yA), ptr(yU), nx, ny, nz, z0, y0, x0, *box, stream)
            else:
                err = lib.field_u_launch(
                    ptr(op.gu), ptr(op.ku), ptr(op.da), coef_bf16,
                    state_bf16, ptr(A), ptr(U), ptr(yA), ptr(yU), nx, ny, nz,
                    z0, y0, x0, *box, stream)
        self._counted(err, state_bf16, route, coef_bf16)
        return yU


field_a = _FieldA()
field_u = _FieldU()
