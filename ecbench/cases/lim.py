"""The linear induction machine: a three-phase primary of twelve windings
that slides back and forth along x over a conducting secondary bar.

The upstream's ``LIM.vxc`` (README.md:235) has twelve y-directed source
functions, each registered with the same reciprocating velocity function
``Vsx``.  Its geometry is not in the repository, so this is the port's
stand-in, ``testing/cases.py`` ``case_lim``, at the configuration's grid:
a bar ``bar["z"]`` thick, ``margin_y`` cells in from the y sides and
``margin_x`` from the x ends, and one one-cell-wide winding at each of
``windings["x"]``, its current along y.  The windings take the phases of
``WINDINGS`` in turn (a+, b+, c+, a-, b-, c-, then again), so that the
primary's field travels along x.  Every winding's current is ``sign a
cosd(360 f t + o + ph 180/pi)``, ``o`` its own phase in degrees and ``ph``
the run's phase (``vxc.set_phase``); the drive is ``Vx = v impl2(sind(360
f t + o))``, forward while the sine is not negative and back while it is.

:func:`layout` gives the voxels as data; the program gets them as ``.vxc``
text (:func:`vxc_text`), the reference as the data itself
(:func:`reference_case`), with its source and velocity functions written
in plain Python.
"""

from __future__ import annotations

import math

import numpy as np

from ecbench.reference.case import (BND_DEFAULT, MU0, PI, Case, Source,
                                    schedule)
from ecbench.vxc import make_vxc_text

__all__ = ["layout", "vxc_text", "reference_case"]

# a winding's phase: its current function, the sign of its current, its
# phase in degrees
WINDINGS = (("Iap", 1, 0), ("Ibp", 1, 120), ("Icp", 1, -120),
            ("Iam", -1, 0), ("Ibm", -1, 120), ("Icm", -1, -120))


def _phase(k: int):
    """The phase of winding ``k``: ``WINDINGS`` in turn along x."""
    return WINDINGS[k % len(WINDINGS)]


def layout(config: dict) -> np.ndarray:
    """The voxel grid (nz, ny, nx): 0 air, 1 the bar, 2 + k winding k."""
    nx, ny, nz = config["grid_xyz"]
    geo = np.zeros((nz, ny, nx), np.int64)
    bar = config["bar"]
    my, mx = bar["margin_y"], bar["margin_x"]
    geo[bar["z"][0]:bar["z"][1], my:ny - my, mx:nx - mx] = 1
    w = config["windings"]
    wy = w["margin_y"]
    for k, x in enumerate(w["x"]):
        geo[w["z"][0]:w["z"][1], wy:ny - wy, x] = 2 + k
    return geo


def vxc_text(config: dict, traffic: dict, phase: float) -> str:
    """The ``.vxc`` text of :func:`layout`'s machine: the bar's
    conductivity, one ``SRCy`` source a winding, each with ``Vsx=Vx``, the
    transient and the solver; ``phase`` in radians."""
    geo = layout(config)
    dt, steps = traffic["dt_s"], traffic["steps"]
    m = traffic["motion"]
    amp = f"{traffic['current_A']}/(1*dx*2*dz)"
    names = [f"plast D=1 C='mu0*{config['sigma_S_per_m']!r}'"]
    for k in range(len(config["windings"]["x"])):
        # winding k's material: its phase's name (ap, ..., cm) and which of
        # the phase's windings along x it is (1, 2, ...)
        fun = _phase(k)[0]
        names.append(f"{fun[1:].lower()}{k // len(WINDINGS) + 1} D=1 "
                     f"SRCy={fun} Vsx=Vx")
    names += [
        f"param tran stop={steps * dt} step={dt} jump={traffic['jump_s']}",
        f"p2 solver tol={config['tol']} itmax={config['itmax']} dir=out",
    ]
    for k, (fun, sign, deg) in enumerate(WINDINGS, start=1):
        names.append(f"f{k} func {fun}={'-' if sign < 0 else ''}"
                     f"a*cosd(360*f*t+o+ph*r) a='{amp}' "
                     f"f={traffic['freq_hz']} t=t o={deg} ph={phase:.12f} "
                     "r='180/pi'")
    names.append(f"f{len(WINDINGS) + 1} func Vx=a*impl2(sind(360*f*t+o)) "
                 f"a={m['speed_m_per_s']!r} f={m['freq_hz']!r} t=t "
                 f"o={m['offset_deg']!r}")
    return make_vxc_text(config["grid_xyz"], config["cell_m"], names, geo)


def reference_case(config: dict, traffic: dict) -> Case:
    """The machine as the reference program would build it from the same
    ``.vxc``."""
    nx, ny, nz = (int(v) for v in config["grid_xyz"])
    h = float(config["cell_m"])
    dt = float(traffic["dt_s"])
    geo = layout(config)
    flat = geo.reshape(-1)
    n = len(config["windings"]["x"])
    C = np.zeros(n + 2)
    C[1] = MU0 * config["sigma_S_per_m"]
    amp = traffic["current_A"] / (1 * h * 2 * h)
    omega = 2 * PI * traffic["freq_hz"]
    sources = [Source(axis=1,
                      cells=np.flatnonzero(flat == 2 + k).astype(np.int64),
                      sign=_phase(k)[1], amp=amp, omega=omega,
                      offset=_phase(k)[2] * PI / 180)
               for k in range(n)]
    m = traffic["motion"]
    v = m["speed_m_per_s"]
    w = 2 * PI * m["freq_hz"]
    o = m["offset_deg"] * PI / 180

    def velocity(t):
        return (v * (1.0 if math.sin(w * t + o) >= 0 else -1.0), None, None)
    stop = float(repr(traffic["steps"] * dt))     # as the text writes it
    return Case(shape_xyz=(nx, ny, nz), delta=np.full(3, h), geo=geo, C=C,
                dt=dt, times=schedule(stop, dt), tol=float(config["tol"]),
                bnd=np.full((3, 2), BND_DEFAULT), sources=sources,
                velocity=velocity)
