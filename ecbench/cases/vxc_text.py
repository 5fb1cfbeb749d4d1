"""The benchmark's cases: the voxel layout both sides take, and the VoxCad
``.vxc`` text the program reads.

A frozen copy of the port's ``.vxc`` writer (``testing/cases.py``
``make_vxc_text``, its layer encoding done with one table lookup) and one
builder that reproduces that module's ``case_static`` and ``case_moving``
from a configuration (grid, cell size, plate, conductivity, solver) and a
traffic file (steps, dt, the coil ring, its current and its motion).
:func:`layout` gives the voxels and materials as data; the program gets
them as ``.vxc`` text (:func:`coil_over_plate`), the reference
(``reference/case.py``) as the data itself, so that it parses nothing the
program parses.

The coil currents' 50 Hz cosine takes a phase ``ph``.  Every run takes
the same ``PHASES`` phases 2 pi j / PHASES, one a transient
(:func:`set_phase` between transients), in an order drawn from its seed
(:func:`phases`): every seed does the same work in another order.  One
phase a run made the moving coil's iterations a step differ by 30% from
seed to seed; a set of phases shifted by an offset drawn from the seed
still moved them by up to 1.2% at 32 phases and 3.8% at 8.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_vxc_text", "layout", "coil_over_plate", "PHASES", "phases",
           "set_phase"]

PHASES = 32

# 1-based material id = position in this string (the port's models/vxc.py)
LETTERS = r"123456789:;<=>?@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\]^_`abcdefghijklmnopqrstuvwxyz"
_CHARS = np.frombuffer(("0" + LETTERS).encode("latin-1"), np.uint8)

_HEADER = """<?xml version="1.0" encoding="ISO-8859-1"?>
<VXC Version="0.94">
  <Lattice>
    <Lattice_Dim>{dim}</Lattice_Dim>
    <X_Dim_Adj>1</X_Dim_Adj>
    <Y_Dim_Adj>1</Y_Dim_Adj>
    <Z_Dim_Adj>1</Z_Dim_Adj>
  </Lattice>
  <Palette>
{palette}
  </Palette>
  <Structure Compression="ASCII_READABLE">
    <X_Voxels>{nx}</X_Voxels>
    <Y_Voxels>{ny}</Y_Voxels>
    <Z_Voxels>{nz}</Z_Voxels>
    <Data>
{layers}
    </Data>
  </Structure>
</VXC>
"""

_MATERIAL = """    <Material ID="{ident}">
      <MatType>0</MatType>
      <Name>{name}</Name>
    </Material>"""


def make_vxc_text(shape_xyz, delta0: float, names: list[str],
                  geo: np.ndarray) -> str:
    """A palette and a voxel grid ``geo`` (nz, ny, nx; 0 = air, k =
    material k) as a ``.vxc`` document with an ASCII structure."""
    nx, ny, nz = shape_xyz
    chars = _CHARS[np.asarray(geo, np.int64).reshape(nz, ny * nx)]
    layers = "\n".join(
        f"      <Layer><![CDATA[{row.tobytes().decode('latin-1')}]]></Layer>"
        for row in chars)
    palette = "\n".join(
        _MATERIAL.format(ident=i + 1, name=nm) for i, nm in enumerate(names))
    return _HEADER.format(dim=repr(delta0), palette=palette, nx=nx, ny=ny,
                          nz=nz, layers=layers)


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


def coil_over_plate(config: dict, traffic: dict, phase: float) -> str:
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


def phases(rng) -> list[float]:
    """The ``PHASES`` phases 2 pi j / PHASES, each once, in bit-reversed
    order, so that every first 2^m of them are evenly spaced, rotated by an
    offset and taken forwards or backwards as ``rng`` draws; each as the
    text of a ``.vxc`` gives it."""
    bits = PHASES.bit_length() - 1
    rev = [int(f"{k:0{bits}b}"[::-1], 2) for k in range(PHASES)]
    j0 = int(rng.integers(PHASES))
    sign = 1 if rng.integers(2) else -1
    return [float(f"{2.0 * np.pi * ((j0 + sign * r) % PHASES) / PHASES:.12f}")
            for r in rev]


def set_phase(model, phase: float) -> None:
    """Give each source function of a parsed ``model`` (the program's or the
    reference's) the phase ``phase``: its ``PH`` argument, as a ``.vxc``
    written with that phase gives it."""
    for fn in model.functions:
        fn.arg_values = tuple(phase if n == "PH" else v
                              for n, v in zip(fn.arg_names, fn.arg_values))
