"""The reference's own reading of a cell: the case as data, not as text.

The program reads the cell's ``.vxc`` text through its front end (the
material DSL, the source and motion functions).  The reference takes the
same case as the data the text was written from: the :class:`Case` that
the configuration's case module (``cases/<case>.py``
``reference_case``) builds from the configuration and the traffic.  Its
source and motion functions are evaluated here in plain Python, so that a
fault in the program's parse shows as a system, a source or a motion that
differs from this one.

The definitions follow the reference program: mu0 and pi as EC3D.f90 and
vxc2data.f90 give them, a material's inertial coefficient ``C = mu0
sigma``, source values scaled by mu0 (EC3D.f90:254), the boundary
multiplier -0.95 on every face where the input names none (the default of
vxc2data.f90), and the step times of EC3D.f90's loop (137-143, 436-455).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["MU0", "PI", "BND_DEFAULT", "Case", "Source", "schedule"]

MU0 = 0.12566370964050292e-5          # EC3D.f90:254, vxc2data.f90:402
PI = 3.1415926535897932384626433832795
BND_DEFAULT = -0.95


def schedule(stop: float, dt: float) -> list[float]:
    """The step times of the reference's loop: T from 0 in steps of dt,
    summed as the loop sums them, while T < stop."""
    T, times = 0.0, []
    while True:
        times.append(T)
        T = T + dt
        if not T < stop:
            return times


@dataclass
class Source:
    """One source function: the current along ``axis`` (0, 1, 2) in the
    voxels ``cells`` (flat, grid order) of one material, ``sign a
    cos(omega t + ph + offset)``: ``ph`` the run's phase (the ``PH``
    argument), ``offset`` the function's own phase in radians (a
    three-phase winding's 120 degrees)."""

    axis: int
    cells: np.ndarray
    sign: int
    amp: float
    omega: float
    offset: float = 0.0

    def value(self, t: float, phase: float) -> float:
        """``sign a cos(omega t + ph + offset)``, scaled by mu0."""
        return (self.sign * self.amp
                * math.cos(self.omega * t + phase + self.offset) * MU0)


@dataclass
class Case:
    shape_xyz: tuple            # (nx, ny, nz)
    delta: np.ndarray           # (3,) cell size
    geo: np.ndarray             # (nz, ny, nx) material ids, 0 = air
    C: np.ndarray               # C of each material id (0 for air)
    dt: float
    times: list                 # step times
    tol: float
    bnd: np.ndarray             # (3, 2) boundary multipliers
    sources: list               # [Source], in the program's function order
    velocity: object            # t -> (vx, vy, vz) in m/s (None: the
                                # axis does not move) of every source,
                                # or None
