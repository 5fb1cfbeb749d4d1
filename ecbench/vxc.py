"""The VoxCad ``.vxc`` text every case writes, and the phase ``PH`` its
source functions take.

A frozen copy of the port's ``.vxc`` writer (``testing/cases.py``
``make_vxc_text``, its layer encoding done with one table lookup), shared
by the case modules (``cases/<case>.py``), which build their own palette,
voxels and functions.

The source currents take a phase ``ph``, the ``PH`` argument of each
source function.  Every run takes the same ``PHASES`` phases
2 pi j / PHASES, one a transient (:func:`set_phase` between transients),
in an order drawn from its seed (:func:`phases`): every seed does the same
work in another order.  One phase a run made the moving coil's iterations
a step differ by 30% from seed to seed; a set of phases shifted by an
offset drawn from the seed still moved them by up to 1.2% at 32 phases and
3.8% at 8.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_vxc_text", "PHASES", "phases", "set_phase"]

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
