"""The benchmark's default case, a coil over a plate: the voxel layout both
sides take, the ``.vxc`` text the program reads and the case data the
float64 reference builds its system from.

One builder that reproduces the port's ``testing/cases.py``
``case_static`` and ``case_moving`` from a configuration (grid, cell
size, plate, conductivity, solver) and a traffic file (steps, dt, the coil
ring, its current and its motion).  :func:`layout` gives the voxels and
materials as data; the program gets them as ``.vxc`` text
(:func:`vxc_text`), the reference as the data itself
(:func:`reference_case`), so that it parses nothing the program parses.

A configuration names its case module with ``"case"``; one without that
key takes this one (``cellspec.load_case``).  Every case module exports
``vxc_text(config, traffic, phase)`` and ``reference_case(config,
traffic)``.
"""

from __future__ import annotations

import math

import numpy as np

from ecbench.reference.case import (BND_DEFAULT, MU0, PI, Case, Source,
                                    schedule)
from ecbench.vxc import make_vxc_text

__all__ = ["layout", "vxc_text", "reference_case"]


# the coil's four segments: material name, current axis, sign of its current
SEGMENTS = (("axp", "x", 1), ("axm", "x", -1), ("ayp", "y", 1),
            ("aym", "y", -1))


def layout(config: dict, traffic: dict):
    """(geo, materials) of a rectangular four-segment coil over a
    conducting plate: the voxel grid (nz, ny, nx; 0 = air, k = material k)
    and the materials in palette order, each a dict with ``name`` and
    either ``sigma`` (S/m) or the source's ``axis`` and ``sign``."""
    nx, ny, nz = config["grid_xyz"]
    geo = np.zeros((nz, ny, nx), np.int64)
    pz0, pz1 = config["plate"]["z"]
    pm = config["plate"]["margin_xy"]
    geo[pz0:pz1, pm:ny - pm, pm:nx - pm] = 1
    coil = traffic["coil"]
    cm = coil["margin_xy"]
    x0, x1, y0, y1 = cm, nx - 1 - cm, cm, ny - 1 - cm
    z0, z1 = coil["z"]
    geo[z0:z1, y0, x0 + 1:x1] = 2          # +x current, near side
    geo[z0:z1, y1, x0 + 1:x1] = 3          # -x current, far side
    geo[z0:z1, y0 + 1:y1, x1] = 4          # +y current
    geo[z0:z1, y0 + 1:y1, x0] = 5          # -y current
    materials = [{"name": "plast", "sigma": config["sigma_S_per_m"]}] + [
        {"name": n, "axis": a, "sign": sg} for n, a, sg in SEGMENTS]
    return geo, materials


def vxc_text(config: dict, traffic: dict, phase: float) -> str:
    """The ``.vxc`` text of :func:`layout`'s case: the config's grid, plate
    and solver, the traffic's coil, current, motion and transient.  Each
    segment's source is ``a cos(2 pi f t + ph)`` with ``a`` the coil's
    current over ``4 dx 2 dz`` and ``ph`` = ``phase`` radians; a moving coil
    runs on an ellipse ``inset_cells`` inside the grid's sides at the
    motion's frequency, its velocity ``Vmx``, ``Vmy`` functions of t."""
    nx, ny, nz = config["grid_xyz"]
    geo, materials = layout(config, traffic)
    coil, motion = traffic["coil"], traffic["motion"]
    move = " Vsx=Vmx Vsy=Vmy" if motion else ""
    dt, steps = traffic["dt_s"], traffic["steps"]
    amp = f"{coil['current_A']}/(4*dx*2*dz)"
    freq = coil["freq_hz"]
    ph = f"{phase:.12f}"
    fun = {1: "Fp", -1: "Fm"}
    names = [f"plast D=1 C='mu0*{materials[0]['sigma']!r}'"] + [
        f"{m['name']} D=1 SRC{m['axis']}={fun[m['sign']]}{move}"
        for m in materials[1:]]
    names += [
        f"param tran stop={steps * dt} step={dt} jump={traffic['jump_s']}",
        f"p2 solver tol={config['tol']} itmax={config['itmax']} dir=out",
        f"f1 func Fp=a*cos(p2*f*t+ph) a='{amp}' p2='2*pi' f={freq} t=t ph={ph}",
        f"f2 func Fm=-a*cos(p2*f*t+ph) a='{amp}' p2='2*pi' f={freq} t=t ph={ph}",
    ]
    if motion:
        f, k = motion["freq_hz"], motion["inset_cells"]
        names += [
            f"m1 func Vmx=a*p2*f*sin(p2*f*t) a='dX*(Nx-{k})/2' p2='2*pi' f={f} t=t",
            f"m2 func Vmy=a*p2*f*cos(p2*f*t) a='-dY*(Ny-{k})/2' p2='2*pi' f={f} t=t",
        ]
    return make_vxc_text((nx, ny, nz), config["cell_m"], names, geo)


def reference_case(config: dict, traffic: dict) -> Case:
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
