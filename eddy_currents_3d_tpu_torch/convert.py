"""Carry state and operators over from the JAX package, as numpy arrays.

These let a run of ``eddy_currents_3d_tpu`` hand its state to this package
(for example to continue a transient on another device, or to start both
packages from the same mid-transient state in a parity test) without this
package importing jax: the caller converts the JAX arrays with
``numpy.asarray`` first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .assembly.stencil import State, StencilOperator
from .ops.coded import CodedStencilOperator
from .ops.field import FieldStencilOperator
from .ops.sparse import BSRMatrix, CSRMatrix, ELLMatrix
from .sim.motion import MotionState
from .sim.simulate import SimState
from .solvers.ilu0 import StencilILU0
from .solvers.multigrid import MGLevel, MGPreconditioner

__all__ = ["state_from_numpy", "coded_from_jax_arrays",
           "field_from_jax_arrays", "mg_from_jax_levels", "csr_from_jax",
           "ell_from_jax", "bsr_from_jax", "stencil_ilu0_from_jax"]


def _tensor(arr, device) -> torch.Tensor:
    """A numpy array (float32, float64 or ml_dtypes' bfloat16, as JAX hands
    bfloat16 over) as a tensor of the same dtype on ``device``; a copy."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def state_from_numpy(A, U, carry, prev_A=None, prev_U=None,
                     motion_distance=None, motion_movestop=None,
                     motion_comp=None, *, dtype: torch.dtype,
                     device) -> SimState:
    """A JAX ``SimState`` given as numpy arrays -> this package's
    :class:`SimState` on ``device``, its fields in ``dtype`` (a bfloat16
    JAX state carries over bit for bit at ``dtype=torch.bfloat16``).

    ``prev_A``/``prev_U`` are the extrapolated warm start's history (both
    or neither); the motion arrays default to the initial motion state of
    zero functions and are kept on the host in float64."""
    def dev(x):
        return _tensor(x, device).to(dtype)

    if (prev_A is None) != (prev_U is None):
        raise ValueError("give both prev_A and prev_U, or neither")
    prev = State(dev(prev_A), dev(prev_U)) if prev_A is not None else None
    if motion_distance is None:
        motion_distance = np.zeros((0, 3))
        motion_comp = np.zeros((0, 3))
        motion_movestop = np.ones(3)
    motion = MotionState(
        distance=np.array(motion_distance, np.float64),
        movestop=np.array(motion_movestop, np.int32),
        comp=np.array(motion_comp, np.float64),
    )
    return SimState(A=dev(A), U=dev(U), carry=dev(carry), motion=motion,
                    prev=prev)


def coded_from_jax_arrays(code_p, cf_p, conv_p, shape_zyx, *, consts,
                          cond_z, compact_u: bool,
                          inertia_on_faces: bool = False,
                          device) -> CodedStencilOperator:
    """Crop the lane/sublane padding off a JAX ``CodedStencilOperator``'s
    arrays (``code_p``, ``cf_p``, ``conv_p``, which has shape (3, 0, 0, 0)
    without convection) and return this package's operator.  ``cond_z``
    and ``compact_u`` are the JAX operator's: with them the port takes the
    same route and solves in the same space (z-compact U or full)."""
    nz, ny, nx = (int(n) for n in shape_zyx)

    def crop(arr, dtype):
        arr = np.array(np.asarray(arr)[..., :nz, :ny, :nx])
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    conv: Optional[torch.Tensor] = None
    if np.asarray(conv_p).size:
        conv = crop(conv_p, torch.float32)
    return CodedStencilOperator(
        code=crop(code_p, torch.int32),
        cf=crop(cf_p, torch.float32),
        conv=conv,
        shape_zyx=(nz, ny, nx),
        consts=consts,
        inertia_on_faces=bool(inertia_on_faces),
        cond_z=tuple(int(z) for z in cond_z),
        compact_u=bool(compact_u),
    )


def field_from_jax_arrays(ka_p, gu_p, ku_p, da_p, shape_zyx, box_jax,
                          box_system, device) -> FieldStencilOperator:
    """Crop the lane/sublane padding off a JAX ``PallasStencilOperator``'s
    arrays and return this package's operator, in the same dtype (float32
    or bfloat16).  ``box_jax`` is the JAX operator's ``box``, whose (y, x)
    origin may have been shifted back to keep the padded window inside the
    padded grid; ``box_system`` is the assembled system's box (None: no
    conductor).  The JAX arrays carry ``y0 - y0n`` and ``x0 - x0n`` extra
    zero rows and columns on the low side, which are cut off here."""
    nz, ny, nx = (int(n) for n in shape_zyx)
    ka = _tensor(np.asarray(ka_p)[:, :nz, :ny, :nx], device)
    if box_system is None:
        return FieldStencilOperator.without_box(ka, (nz, ny, nx))
    z0, z1, y0, y1, x0, x1 = (int(b) for b in box_system)
    _, _, y0n, _, x0n, _ = (int(b) for b in box_jax)
    ly, lx = y0 - y0n, x0 - x0n
    win = lambda a: _tensor(
        np.asarray(a)[..., :, ly:ly + y1 - y0, lx:lx + x1 - x0], device)
    return FieldStencilOperator(ka, win(gu_p), win(ku_p), win(da_p),
                                (nz, ny, nx), (z0, z1, y0, y1, x0, x1))


def mg_from_jax_levels(levels, inv_du, pre: int, post: int,
                       coarse_sweeps: int, device) -> MGPreconditioner:
    """This package's V-cycle from a JAX ``MGPreconditioner``: ``levels``
    is its levels' ``(ka, inv_d)`` arrays, fine to coarse, and ``inv_du``
    its U-row scaling, all as numpy arrays; the sweep counts are its own."""
    lv = []
    for ka, inv_d in levels:
        shape = tuple(int(s) for s in np.shape(ka)[1:])
        lv.append(MGLevel(ka=_tensor(ka, device), inv_d=_tensor(inv_d, device),
                          shape=shape,
                          pshape=tuple(s + (s % 2) for s in shape)))
    return MGPreconditioner(levels=tuple(lv), inv_du=_tensor(inv_du, device),
                            pre=int(pre), post=int(post),
                            coarse_sweeps=int(coarse_sweeps))


# The sparse containers and ILU(0) factors below take the JAX objects
# themselves and read each array with ``numpy.asarray``, which needs no jax.

def _shape(shape) -> tuple:
    return tuple(int(n) for n in shape)


def csr_from_jax(a, device) -> CSRMatrix:
    """A JAX ``CSRMatrix`` as this package's, on ``device``."""
    return CSRMatrix(indptr=_tensor(np.asarray(a.indptr), device),
                     cols=_tensor(np.asarray(a.cols), device),
                     vals=_tensor(np.asarray(a.vals), device),
                     shape=_shape(a.shape))


def ell_from_jax(a, device) -> ELLMatrix:
    """A JAX ``ELLMatrix`` as this package's, on ``device``."""
    return ELLMatrix(cols=_tensor(np.asarray(a.cols), device),
                     vals=_tensor(np.asarray(a.vals), device),
                     shape=_shape(a.shape))


def bsr_from_jax(a, device) -> BSRMatrix:
    """A JAX ``BSRMatrix`` as this package's, on ``device``."""
    return BSRMatrix(block_cols=_tensor(np.asarray(a.block_cols), device),
                     blocks=_tensor(np.asarray(a.blocks), device),
                     shape=_shape(a.shape))


def stencil_ilu0_from_jax(st, shape_zyx, box_system, device) -> StencilILU0:
    """A JAX ``StencilILU0`` as this package's, on ``device``.  Its padded
    form (``padded=True``: ``PallasStencilOperator`` factors) is cropped
    through :func:`field_from_jax_arrays` into field-tier factors;
    otherwise the flat-roll factors carry over as they are.
    ``box_system`` is the assembled system's box (None: no conductor)."""
    nz, ny, nx = _shape(shape_zyx)
    if st.padded:
        op = lambda o: field_from_jax_arrays(
            np.asarray(o.ka_p), np.asarray(o.gu_p), np.asarray(o.ku_p),
            np.asarray(o.da_p), (nz, ny, nx), o.box, box_system, device)
        crop = lambda a: _tensor(np.asarray(a)[:nz, :ny, :nx], device)
    else:
        op = lambda o: StencilOperator(
            *(_tensor(np.asarray(getattr(o, f)), device)
              for f in ("ka", "gu", "ku", "da")),
            box=None if o.box is None else _shape(o.box))
        crop = lambda a: _tensor(np.asarray(a), device)
    return StencilILU0(L_op=op(st.L_op), U_op=op(st.U_op), d_A=crop(st.d_A),
                       d_U=crop(st.d_U), inv_dA=crop(st.inv_dA),
                       inv_dU=crop(st.inv_dU), padded=bool(st.padded))
