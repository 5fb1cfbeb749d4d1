"""The reference's own reading of a cell: the case as data, not as text.

The program reads the cell's ``.vxc`` text through its front end (the
material DSL, the source and motion functions).  The reference takes the
same case from the data the text was written from (``cases/vxc_text.py``
``layout``, the configuration and the traffic) and evaluates the
functions here in plain Python, so that a fault in the program's parse
shows as a system, a source or a motion that differs from this one.

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

from ..cases.vxc_text import layout

__all__ = ["MU0", "PI", "Case", "read_case", "schedule"]

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
    voxels ``cells`` (flat, grid order) of one material."""

    axis: int
    cells: np.ndarray
    sign: int
    amp: float
    omega: float

    def value(self, t: float, phase: float) -> float:
        """``sign a cos(2 pi f t + ph)``, scaled by mu0."""
        return self.sign * self.amp * math.cos(self.omega * t + phase) * MU0


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
                                # axis does not move), or None


def read_case(config: dict, traffic: dict) -> Case:
    """The case of a configuration and a traffic file, as the reference
    program would build it from the same ``.vxc``."""
    geo, materials = layout(config, traffic)
    nx, ny, nz = (int(v) for v in config["grid_xyz"])
    h = float(config["cell_m"])
    dt = float(traffic["dt_s"])
    stop = float(repr(traffic["steps"] * dt))     # as the text writes it
    C = np.zeros(len(materials) + 1)
    sources = []
    coil = traffic["coil"]
    amp = coil["current_A"] / (4 * h * 2 * h)
    omega = 2 * PI * coil["freq_hz"]
    flat = geo.reshape(-1)
    for ident, m in enumerate(materials, start=1):
        if "sigma" in m:
            C[ident] = MU0 * m["sigma"]
        else:
            sources.append(Source(
                axis="xyz".index(m["axis"]),
                cells=np.flatnonzero(flat == ident).astype(np.int64),
                sign=m["sign"], amp=amp, omega=omega))
    velocity = None
    motion = traffic.get("motion")
    if motion:
        w = 2 * PI * motion["freq_hz"]
        ax = h * (nx - motion["inset_cells"]) / 2
        ay = -h * (ny - motion["inset_cells"]) / 2

        def velocity(t):
            return (ax * w * math.sin(w * t), ay * w * math.cos(w * t), None)
    return Case(shape_xyz=(nx, ny, nz), delta=np.full(3, h), geo=geo, C=C,
                dt=dt, times=schedule(stop, dt), tol=float(config["tol"]),
                bnd=np.full((3, 2), BND_DEFAULT), sources=sources,
                velocity=velocity)
