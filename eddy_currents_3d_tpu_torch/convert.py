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

from .assembly.stencil import State
from .ops.coded import CodedStencilOperator
from .sim.motion import MotionState
from .sim.simulate import SimState

__all__ = ["state_from_numpy", "coded_from_jax_arrays"]


def state_from_numpy(A, U, carry, prev_A=None, prev_U=None,
                     motion_distance=None, motion_movestop=None,
                     motion_comp=None, *, dtype: torch.dtype,
                     device) -> SimState:
    """A JAX ``SimState`` given as numpy arrays -> this package's
    :class:`SimState` on ``device``.

    ``prev_A``/``prev_U`` are the extrapolated warm start's history (both
    or neither); the motion arrays default to the initial motion state of
    zero functions and are kept on the host in float64."""
    def dev(x):
        # copy: arrays handed over from JAX are read-only views
        return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)

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
                          inertia_on_faces: bool = False,
                          device) -> CodedStencilOperator:
    """Crop the lane/sublane padding off a JAX ``CodedStencilOperator``'s
    arrays (``code_p``, ``cf_p``, ``conv_p``, which has shape (3, 0, 0, 0)
    without convection) and return this package's operator."""
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
    )
