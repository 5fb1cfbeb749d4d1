"""Moving-source subsystem, on the host in float64.

The PyTorch package's counterpart of ``eddy_currents_3d_tpu/sim/motion.py``.
Motion is a handful of scalars per source function and a clamp per source
voxel, so it stays on the host in numpy; only the resulting flat cell
indices go to the device for the source scatter.  Semantics (EC3D.f90:
156-230, 1052-1114):

* per-function accumulated ``Distance(3)`` (fractions of a cell) and the
  *global* 3-vector ``movestop`` latch shared by every function;
* constant-velocity axes accumulate ``movestop(1) * shift`` — the reference
  multiplies by the X-axis latch regardless of axis (EC3D.f90:1055), kept
  for parity — while function-driven axes accumulate ``V(t)*dt/delta``
  ignoring the latch (EC3D.f90:1058);
* integer displacement ``length = nint(Distance)``;
* each source voxel is displaced by ``length`` and clamped per-axis to
  ``[2, sd-2]`` (1-based); a clamp drops the axis latch to 0, and any
  in-range voxel re-arms it (EC3D.f90:1068-1111).

The accumulation is Kahan-compensated exactly as in the JAX package, so at
float64 both give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

__all__ = ["MotionState", "motion_init", "FunctionMotion", "advance_function"]


class MotionState(NamedTuple):
    distance: np.ndarray    # (numfun, 3) float64 accumulated displacement
    movestop: np.ndarray    # (3,) int32 global latch (EC3D.f90:238)
    comp: np.ndarray        # (numfun, 3) Kahan compensation for `distance`


def motion_init(numfun: int) -> MotionState:
    return MotionState(
        distance=np.zeros((numfun, 3), np.float64),
        movestop=np.ones((3,), np.int32),
        comp=np.zeros((numfun, 3), np.float64),
    )


def _anint(x):
    # Fortran NINT: round half away from zero.
    return np.trunc(x + np.where(x >= 0, 0.5, -0.5)).astype(np.int32)


@dataclass(frozen=True)
class FunctionMotion:
    """Static motion description of one source function."""

    index: int                      # position in model.functions
    ijk0: np.ndarray                # (numnod, 3) 0-based original (i,j,k)
    const_shift: np.ndarray         # (3,) shift per step for constant-velocity axes
    vmech_index: tuple[int, int, int]   # 1-based into the Vmech value vector
    shape_xyz: tuple[int, int, int]


def advance_function(
    fm: FunctionMotion,
    distance_row: np.ndarray,       # (3,)
    comp_row: np.ndarray,           # (3,) Kahan compensation
    movestop: np.ndarray,           # (3,) int32
    vmech_vals: np.ndarray,         # (numMech,) velocities at this step
    dt: float,
    delta: np.ndarray,
):
    """One function's motion for one step.

    Returns (new_distance_row, new_comp_row, new_movestop, new_flat_cells)
    where new_flat_cells are 0-based flat grid indices (int32) of the
    displaced voxels.
    """
    dtype = np.asarray(distance_row).dtype
    parts, comps = [], []
    for a in range(3):
        vi = fm.vmech_index[a]
        d_a = distance_row[a]
        c_a = comp_row[a]
        if vi == 0:
            # constant velocity, gated by the X latch (reference quirk).
            # While latched off, Distance += 0*shift freezes the accumulator
            # bit-exactly, so the Kahan update is skipped entirely.
            if not movestop[0] > 0:
                parts.append(d_a)
                comps.append(c_a)
                continue
            term = dtype.type(fm.const_shift[a])
        else:
            # function-driven axes accumulate every step (latch ignored,
            # EC3D.f90:1057-1059)
            term = dtype.type(vmech_vals[vi - 1] * (dt / float(delta[a])))
        y = term - c_a
        t = d_a + y
        parts.append(t)
        comps.append((t - d_a) - y)
    new_dist = np.array(parts, dtype)
    new_comp = np.array(comps, dtype)
    length = _anint(new_dist)

    # --- new_m (EC3D.f90:1064-1114), vectorized over voxels ---
    sd = np.asarray(fm.shape_xyz)
    lo = 1                           # 0-based lower clamp (= 2 in 1-based)
    new_ms = []
    pos = []
    for a in range(3):
        hi = int(sd[a]) - 3          # 0-based upper clamp (= sd-2 in 1-based)
        raw = fm.ijk0[:, a].astype(np.int32) + length[a]
        clamped = (raw > hi) | (raw < lo)
        newv = np.clip(raw, lo, hi)
        # re-arm condition uses the in-range value (EC3D.f90:1072)
        rearm = (~clamped) & ((newv < hi) | (newv > lo))
        nonid = clamped | rearm
        # value written by the last non-no-op voxel (0 on clamp, 1 on rearm)
        hits = np.nonzero(nonid)[0]
        if hits.size:
            new_ms.append(0 if clamped[hits[-1]] else 1)
        else:
            new_ms.append(int(movestop[a]))
        pos.append(newv)
    new_movestop = np.array(new_ms, np.int32)
    nx, ny = int(sd[0]), int(sd[1])
    flat = (pos[0] + nx * pos[1] + nx * ny * pos[2]).astype(np.int32)
    return new_dist, new_comp, new_movestop, flat
