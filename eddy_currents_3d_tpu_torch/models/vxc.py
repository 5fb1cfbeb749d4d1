"""VoxCad ``.vxc`` input reader: XML + zlib voxel data + palette DSL.

A from-scratch re-implementation of the behavior of the reference's
``vxc2data.f90`` (two-pass line scanner + Python zlib subprocess): here a
single in-process pass with a real XML parser, no temp files, no subprocess
(the reference shells out to ``uncompress_zlib.py``, vxc2data.f90:275).

Palette DSL grammar (README.md:131-174, vxc2data.f90:127-221, 420-600): each
material ``<Name>`` holds space/`=`-separated words, uppercased.  Keywords:

* ``<name> D=<v> [C=<v>] [VEX|VEY|VEZ=<v>] [SRCX|SRCY|SRCZ=<fn>
  [VSX|VSY|VSZ=<fn|value>]...]`` — a material domain.
* ``TRAN STOP=<t> STEP=<dt> [JUMP=<dtt>]`` — transient config.
* ``SOLVER [TOL=][ITMAX=][SOLV=][DIR=][BOUND=]`` — solver config.
* ``BOUNDARY BXM|BXP|BYM|BYP|BZM|BZP|ALL=<v>`` — boundary coefficients.
* ``FUNC <name>=<expr> <arg>=<val> ...`` — function definition.

Values accept SPICE prefixes (``100m``) or quoted constant expressions over
PI, E, MU0, E0, DT, DX, DY, DZ, TIME, NX, NY, NZ (vxc2data.f90:397-411).

Known reference quirks handled differently (documented divergences):

* ``SRCZ`` is implemented (the reference mis-tags it 'D' and silently drops
  Z-directed sources, vxc2data.f90:489,694-698 vs :744-747).
* ``FUNC`` definitions may appear before or after the domain that uses them
  (the reference only resolves backward references).
* Voxel counts are not capped at 3 digits (vxc2data.f90:233 reads '(i3)').
"""

from __future__ import annotations

import base64
import zlib
from typing import Optional
from xml.etree import ElementTree

import numpy as np

from .expr import compile_expression
from .model import (
    DomainSpec,
    Model,
    MotionFunction,
    SolverConfig,
    SourceFunction,
    TranConfig,
    build_model,
    builtin_constants,
)
from ..utils.numeric import spice_to_float

__all__ = ["read_vxc", "VxcError"]

# Voxel character table: 1-based material id = position in this string
# (vxc2data.f90:71, uncompress_zlib.py:10).
LETTERS = r"123456789:;<=>?@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\]^_`abcdefghijklmnopqrstuvwxyz"


class VxcError(ValueError):
    pass


def _words(name_text: str) -> list[str]:
    """'=' acts as a separator; whole line uppercased (vxc2data.f90:430-440)."""
    return name_text.replace("=", " ").replace("\t", " ").upper().split()


def _make_evaluator(constants: dict[str, float]):
    def evaluate(word: str) -> float:
        if word[:1] in ("'", '"', "`"):
            expr = compile_expression(word[1:-1] if word[-1:] == word[:1] else word[1:])
            return float(expr(constants))
        return spice_to_float(word)

    return evaluate


def _decode_layers(structure: ElementTree.Element, sdx: int, sdy: int, sdz: int) -> np.ndarray:
    compression = structure.get("Compression", "ASCII_READABLE")
    layers = structure.findall("./Data/Layer")
    if len(layers) != sdz:
        raise VxcError(f"expected {sdz} <Layer> entries, found {len(layers)}")
    per_layer = sdx * sdy
    out = np.zeros(sdz * per_layer, np.int64)
    lut = np.zeros(256, np.int64)
    for idx, ch in enumerate(LETTERS):
        lut[ord(ch)] = idx + 1
    for j, layer in enumerate(layers):
        text = (layer.text or "").strip()
        if compression == "ZLIB":
            raw = zlib.decompress(base64.b64decode(text))
            vals = np.frombuffer(raw, np.uint8).astype(np.int64)
        else:
            vals = lut[np.frombuffer(text.encode("latin-1"), np.uint8)]
        if vals.size != per_layer:
            raise VxcError(
                f"layer {j}: {vals.size} voxels, expected {per_layer}"
            )
        out[j * per_layer : (j + 1) * per_layer] = vals
    return out


def read_vxc(path: str) -> Model:
    """Read a ``.vxc`` file into a finalized :class:`Model`."""
    tree = ElementTree.parse(path)
    root = tree.getroot()

    # --- lattice spacing (vxc2data.f90:94-121) ---
    lattice = root.find("./Lattice")
    if lattice is None:
        raise VxcError("no <Lattice> element")
    delta0 = spice_to_float(lattice.findtext("Lattice_Dim", "0"))
    delta = np.array(
        [
            spice_to_float(lattice.findtext("X_Dim_Adj", "1")) * delta0,
            spice_to_float(lattice.findtext("Y_Dim_Adj", "1")) * delta0,
            spice_to_float(lattice.findtext("Z_Dim_Adj", "1")) * delta0,
        ]
    )

    # --- voxel structure ---
    structure = root.find("./Structure")
    if structure is None:
        raise VxcError("no <Structure> element")
    sdx = int(structure.findtext("X_Voxels", "0"))
    sdy = int(structure.findtext("Y_Voxels", "0"))
    sdz = int(structure.findtext("Z_Voxels", "0"))
    if min(sdx, sdy, sdz) <= 0:
        raise VxcError(f"bad voxel dims ({sdx},{sdy},{sdz})")
    v = _decode_layers(structure, sdx, sdy, sdz)
    nsub = int(v.max(initial=0))

    materials = root.findall("./Palette/Material")
    names = [(m.findtext("Name") or "") for m in materials]

    # --- first sweep: TRAN and SOLVER lines (plain numeric values only,
    # vxc2data.f90:181-220) so the constants table can be built ---
    tran = TranConfig()
    solver = SolverConfig()
    for text in names:
        w = _words(text)
        for i in range(1, len(w)):
            if w[i] == "TRAN":
                for j in range(i + 1, len(w) - 1, 2):
                    if "STOP" in w[j]:
                        tran.stop = spice_to_float(w[j + 1])
                    elif "STEP" in w[j]:
                        tran.step = spice_to_float(w[j + 1])
                    elif "JUMP" in w[j]:
                        tran.jump = spice_to_float(w[j + 1])
            elif w[i] == "SOLVER":
                for j in range(i + 1, len(w) - 1):
                    if "TOL" in w[j]:
                        solver.tolerance = spice_to_float(w[j + 1])
                    elif "ITMAX" in w[j]:
                        solver.itmax = int(round(spice_to_float(w[j + 1])))
                    elif "SOLV" in w[j]:
                        solver.solv = w[j + 1][:3]
                    elif "DIR" in w[j]:
                        solver.files = w[j + 1]
                    elif "BOUND" in w[j]:
                        solver.bound = w[j + 1][:6]

    constants = builtin_constants(tran.step, delta, tran.stop, (sdx, sdy, sdz))
    evaluate = _make_evaluator(constants)

    # --- second sweep: domains + sources in document order ---
    domains: list[DomainSpec] = []
    functions: list[SourceFunction] = []
    vmech: list[MotionFunction] = []
    fun_names: list[str] = []    # parallel to functions
    vmech_names: list[str] = []  # parallel to vmech
    deferred_func: list[list[str]] = []
    deferred_bound: list[list[str]] = []

    def register_source(kp: int, w: list[str], j: int, axis: str) -> None:
        """calcVmech equivalent (vxc2data.f90:836-891): one SRC word at
        index j creates a source function; the following up-to-6 words are
        scanned for VSX/VSY/VSZ motion specs."""
        fn = SourceFunction(
            name=w[j + 1],
            direction=axis,
            domain=kp,
            expression=None,  # filled when the FUNC line is processed
            arg_names=(),
            arg_values=(),
        )
        move = [0, 0, 0]
        num_vm = [0, 0, 0]
        vel_vm = [0.0, 0.0, 0.0]
        for n in range(1, 7):
            if j + 1 + n + 1 >= len(w):
                break
            key = w[j + 1 + n]
            val = w[j + 1 + n + 1]
            for ax, tag in enumerate(("VSX", "VSY", "VSZ")):
                if tag in key:
                    move[ax] = 1
                    if val[:1].isalpha():
                        vmech.append(
                            MotionFunction(
                                name=val, expression=None, arg_names=(),
                                arg_values=(), domain=kp,
                                axis={0: "X", 1: "Y", 2: "Z"}[ax],
                            )
                        )
                        vmech_names.append(val)
                        num_vm[ax] = len(vmech)  # 1-based
                    else:
                        vel_vm[ax] = evaluate(val)
        fn.move = tuple(move)
        fn.vmech_index = tuple(num_vm)
        fn.vmech_const = tuple(vel_vm)
        functions.append(fn)
        fun_names.append(fn.name)

    environ: Optional[DomainSpec] = None
    for kp, text in enumerate(names, start=1):
        w = _words(text)
        if any("ENVIRON" in word for word in w[1:]):
            # ENVIRON (vxc2data.f90:571-593): D/C/VEX/VEY/VEZ for the
            # environment — applied to the *last* air domain (the reference
            # writes valPHYS(nsub_glob, :)).  Divergence from the reference:
            # its per-word scan would also mis-register the line's D word as
            # material parameters of palette id kp; here the line is
            # consumed as ENVIRON only (see PARITY.md).
            environ = DomainSpec(ident=0, name=w[0], typ="R")
            for j in range(1, len(w) - 1):
                if w[j][:1] == "D" and w[j] != "DIR":
                    environ.D = evaluate(w[j + 1])
                elif w[j][:1] == "C":
                    environ.C = evaluate(w[j + 1])
                    if environ.C != 0.0:
                        environ.typ = environ.typ + "C"
                elif "VEX" in w[j]:
                    environ.Ve = (evaluate(w[j + 1]), environ.Ve[1], environ.Ve[2])
                elif "VEY" in w[j]:
                    environ.Ve = (environ.Ve[0], evaluate(w[j + 1]), environ.Ve[2])
                elif "VEZ" in w[j]:
                    environ.Ve = (environ.Ve[0], environ.Ve[1], evaluate(w[j + 1]))
            continue
        for i in range(1, len(w)):
            if w[i][:1] == "D" and kp <= nsub and w[i] != "DIR" and i + 1 < len(w):
                dom = DomainSpec(ident=kp, name=w[0], typ="R", D=evaluate(w[i + 1]))
                for j in range(i + 2, len(w) - 1):
                    if w[j][:1] == "C":
                        dom.C = evaluate(w[j + 1])
                        if dom.C != 0.0:
                            dom.typ = dom.typ + "C"
                    elif "VEX" in w[j]:
                        dom.Ve = (evaluate(w[j + 1]), dom.Ve[1], dom.Ve[2])
                    elif "VEY" in w[j]:
                        dom.Ve = (dom.Ve[0], evaluate(w[j + 1]), dom.Ve[2])
                    elif "VEZ" in w[j]:
                        dom.Ve = (dom.Ve[0], dom.Ve[1], evaluate(w[j + 1]))
                domains.append(dom)
                if i + 2 < len(w) and "SRC" in w[i + 2]:
                    for j in range(i + 2, len(w) - 1):
                        if "SRCX" in w[j]:
                            register_source(kp, w, j, "X")
                        elif "SRCY" in w[j]:
                            register_source(kp, w, j, "Y")
                        elif "SRCZ" in w[j]:
                            # divergence: reference drops Z sources
                            register_source(kp, w, j, "Z")
            elif "FUNC" in w[i]:
                deferred_func.append(w[i:])
            elif "BOUNDARY" in w[i]:
                deferred_bound.append(w[i:])

    # --- FUNC lines (vxc2data.f90:497-548): fill every function/motion
    # entry whose registered name matches ---
    for w in deferred_func:
        if len(w) < 3:
            raise VxcError(f"malformed FUNC line: {' '.join(w)}")
        fname, eqn = w[1], w[2]
        arg_names: list[str] = []
        arg_values: list[float] = []
        j = 3
        while j + 1 < len(w):
            arg_names.append(w[j][:8])
            arg_values.append(evaluate(w[j + 1]))
            j += 2
        expr = compile_expression(eqn, arg_names)
        found = False
        for idx, name in enumerate(fun_names):
            if name == fname:
                functions[idx].expression = expr
                functions[idx].arg_names = tuple(arg_names)
                functions[idx].arg_values = tuple(arg_values)
                found = True
        for idx, name in enumerate(vmech_names):
            if name == fname:
                vmech[idx].expression = expr
                vmech[idx].arg_names = tuple(arg_names)
                vmech[idx].arg_values = tuple(arg_values)
                found = True
        if not found:
            # a FUNC no domain references: ignored (reference behavior)
            pass

    for fn in functions:
        if fn.expression is None:
            raise VxcError(f"source function {fn.name!r} has no FUNC definition")
    for vm in vmech:
        if vm.expression is None:
            raise VxcError(f"motion function {vm.name!r} has no FUNC definition")

    # --- BOUNDARY lines (vxc2data.f90:549-570) ---
    for w in deferred_bound:
        for j in range(1, len(w) - 1, 2):
            key = w[j][:3]
            val = evaluate(w[j + 1])
            table = {
                "BXM": (0, 0), "BXP": (0, 1), "BYM": (1, 0),
                "BYP": (1, 1), "BZM": (2, 0), "BZP": (2, 1),
            }
            if key == "ALL":
                solver.BND[:, :] = val
            elif key in table:
                solver.BND[table[key]] = val
            else:
                raise VxcError(f"unrecognized BOUNDARY keyword {w[j]!r}")

    return build_model(
        shape_xyz=(sdx, sdy, sdz),
        delta=delta,
        geo_xyz_flat=v,
        domains=domains,
        functions=functions,
        vmech=vmech,
        solver=solver,
        tran=tran,
        nsub=nsub,
        environ=environ,
    )
