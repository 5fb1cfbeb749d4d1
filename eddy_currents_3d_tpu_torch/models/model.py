"""Model: the device-independent description of a simulation case.

The PyTorch package's copy of ``eddy_currents_3d_tpu/models/model.py``:
the equivalent of the reference's global model state (``m_vxc2data.f90``
module + the outputs of ``vxc2data``): voxel geometry, per-domain material
coefficients, source/motion functions, and solver/transient configuration.
It is deliberately a *host-side* object (numpy + compiled expressions); the
device-side operator is built from it by ``assembly.assemble``.

Array convention
----------------
All 3-D grids are C-ordered ``(nz, ny, nx)`` — x fastest — so that
``arr.ravel()[n]`` corresponds to the reference's 1-based cell number
``nn = n + 1`` with ``nn = i + sdx*(j-1) + sdx*sdy*(k-1)``
(EC3D.f90:506-524).  x is the contiguous axis of every device tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .expr import Expression

__all__ = [
    "MU0",
    "DomainSpec",
    "SourceFunction",
    "MotionFunction",
    "SolverConfig",
    "TranConfig",
    "Model",
    "build_model",
]

# The reference's mu0 constant, bit-for-bit (EC3D.f90:254, vxc2data.f90:402).
MU0 = 0.12566370964050292e-5

_CONST_NAMES = ("PI", "E", "MU0", "E0", "DT", "DX", "DY", "DZ", "TIME", "NX", "NY", "NZ")


def builtin_constants(dt: float, delta, time: float, shape_xyz) -> dict[str, float]:
    """The constant environment available to quoted expressions in the input
    DSL (vxc2data.f90:397-411)."""
    return {
        "PI": 3.1415926535897932384626433832795,
        "E": 0.27182818284590451e1,
        "MU0": MU0,
        "E0": 0.88541878176203908e-11,
        "DT": dt,
        "DX": float(delta[0]),
        "DY": float(delta[1]),
        "DZ": float(delta[2]),
        "TIME": time,
        "NX": float(shape_xyz[0]),
        "NY": float(shape_xyz[1]),
        "NZ": float(shape_xyz[2]),
    }


@dataclass
class DomainSpec:
    """Material domain parameters (valPHYS row, m_vxc2data.f90:47-52)."""

    ident: int                 # 1-based material/domain id (palette order)
    name: str = ""
    typ: str = ""              # 'R', 'RC', ... (typPHYS)
    D: float = 0.0             # diffusion coefficient
    C: float = 0.0             # inertial coefficient (mu0 * sigma)
    Ve: tuple[float, float, float] = (0.0, 0.0, 0.0)  # conductor velocity

    @property
    def conducting(self) -> bool:
        return self.C != 0.0


@dataclass
class MotionFunction:
    """A coil-velocity function (Vmech entry, m_vxc2data.f90:17)."""

    name: str
    expression: Expression
    arg_names: tuple[str, ...]
    arg_values: tuple[float, ...]
    domain: int = 0
    axis: str = ""             # 'X', 'Y' or 'Z' (the reference mis-tags VSZ
                               # as 'D', vxc2data.f90:871 — fixed here; the
                               # tag is informational, motion is driven by
                               # SourceFunction.vmech_index)

    def __call__(self, t):
        env = dict(zip(self.arg_names, self.arg_values))
        for k in self.arg_names:
            if k.strip().upper() == "T":
                env[k] = t
        return self.expression(env)


@dataclass
class SourceFunction:
    """A coil source-current function plus its motion spec
    (tFun + tfun_nod, m_vxc2data.f90:9-30)."""

    name: str
    direction: str             # 'X', 'Y' or 'Z'
    domain: int                # material id whose voxels carry this source
    expression: Expression
    arg_names: tuple[str, ...]
    arg_values: tuple[float, ...]
    # motion: per axis either a constant velocity or a MotionFunction index
    move: tuple[int, int, int] = (0, 0, 0)        # "axis is mobile" flags
    vmech_index: tuple[int, int, int] = (0, 0, 0)  # 1-based into Model.vmech, 0 = const
    vmech_const: tuple[float, float, float] = (0.0, 0.0, 0.0)
    cells: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # ^ 0-based flat cell indices (grid order) of the source voxels

    def __call__(self, t):
        """Source value at time t — already scaled by mu0 (EC3D.f90:254)."""
        env = dict(zip(self.arg_names, self.arg_values))
        for k in self.arg_names:
            if k.strip().upper() == "T":
                env[k] = t
        return self.expression(env) * MU0


@dataclass
class SolverConfig:
    """SOLVER line + defaults (vxc2data.f90:74, 199-219)."""

    solv: str = "BCG"
    tolerance: float = 1e-3
    itmax: int = 10000
    bound: str = "DDDDDD"      # per-face N/D/A string (x-,x+,y-,y+,z-,z+)
    # BND(axis, side): boundary-stencil multiplier; [axis][0]=minus side,
    # [axis][1]=plus side (EC3D.f90:528-643). Default -0.95.
    BND: np.ndarray = field(default_factory=lambda: np.full((3, 2), -0.95))
    files: str = "out"


@dataclass
class TranConfig:
    """TRAN line (vxc2data.f90:181-197)."""

    stop: float = 0.0          # Time
    step: float = 0.0          # dt
    jump: float = 0.0          # dtt; 0 => output every step (Makefile:12 quirk)


@dataclass
class Model:
    shape_xyz: tuple[int, int, int]          # (sdx, sdy, sdz)
    delta: np.ndarray                        # grid spacing (3,)
    geo: np.ndarray                          # (nz, ny, nx) int16 domain ids
    domains: list[DomainSpec]                # palette order; index = ident-1
    functions: list[SourceFunction]
    vmech: list[MotionFunction]
    solver: SolverConfig
    tran: TranConfig
    nsub: int = 0                            # physical domains (max voxel id)
    nsub_air: int = 0                        # synthetic AIR domains

    # -- derived (filled by finalize) --
    cond_mask: Optional[np.ndarray] = None   # (nz,ny,nx) bool
    cond_number: Optional[np.ndarray] = None # (nz,ny,nx) int64; 0 = none, else
                                             # 1-based local U number m (the
                                             # reference stores 3N+m,
                                             # vxc2data.f90:633)
    n_cond: int = 0

    @property
    def shape_zyx(self) -> tuple[int, int, int]:
        sdx, sdy, sdz = self.shape_xyz
        return (sdz, sdy, sdx)

    @property
    def n_cells(self) -> int:
        sdx, sdy, sdz = self.shape_xyz
        return sdx * sdy * sdz

    @property
    def conducting_domains(self) -> list[DomainSpec]:
        """PHYS_C order: ascending material id (vxc2data.f90:443-465)."""
        return [d for d in self.domains if d.conducting]

    def domain_field(self, column: str) -> np.ndarray:
        """Per-cell material coefficient field, float64 (nz,ny,nx).

        ``column`` is one of D, C, VEX, VEY, VEZ (valPHYS columns 1..5).
        """
        table = np.zeros(len(self.domains) + 1)
        for d in self.domains:
            if column == "D":
                table[d.ident] = d.D
            elif column == "C":
                table[d.ident] = d.C
            elif column == "VEX":
                table[d.ident] = d.Ve[0]
            elif column == "VEY":
                table[d.ident] = d.Ve[1]
            elif column == "VEZ":
                table[d.ident] = d.Ve[2]
            else:
                raise ValueError(column)
        return table[self.geo]

    def finalize(self) -> "Model":
        """Apply geometry post-processing and derive conducting-cell data.

        Mirrors vxc2data.f90:609-651: (a) with an Absorption/Neumann face and
        the BCG solver, conducting cells on the outer grid boundary are
        reassigned to the last air domain; (b) conducting cells are numbered
        1..n_cond in PHYS_C-domain order, cells in grid order within each
        domain; (c) per-function source-cell lists are collected in grid
        order (vxc2data.f90:656-752).
        """
        nz, ny, nx = self.shape_zyx
        geo = self.geo
        cond_ids = [d.ident for d in self.conducting_domains]

        if cond_ids and self.solver.solv == "BCG" and (
            "A" in self.solver.bound or "N" in self.solver.bound
        ):
            border = np.zeros(self.shape_zyx, bool)
            border[0, :, :] = border[-1, :, :] = True
            border[:, 0, :] = border[:, -1, :] = True
            border[:, :, 0] = border[:, :, -1] = True
            nsub_glob = self.nsub + self.nsub_air
            for ident in cond_ids:
                geo = np.where(border & (geo == ident), nsub_glob, geo)
            self.geo = geo

        self.cond_mask = np.isin(geo, cond_ids) if cond_ids else np.zeros(self.shape_zyx, bool)
        self.cond_number = np.zeros(self.shape_zyx, np.int64)
        m = 0
        for ident in cond_ids:
            sel = (geo == ident).ravel()
            count = int(sel.sum())
            numbers = np.zeros(geo.size, np.int64)
            numbers[sel] = np.arange(m + 1, m + count + 1)
            self.cond_number += numbers.reshape(self.shape_zyx)
            m += count
        self.n_cond = m

        flat_geo = geo.ravel()
        for fn in self.functions:
            fn.cells = np.nonzero(flat_geo == fn.domain)[0].astype(np.int64)
        return self


def build_model(
    *,
    shape_xyz,
    delta,
    geo_xyz_flat: np.ndarray,
    domains: list[DomainSpec],
    functions: list[SourceFunction],
    vmech: list[MotionFunction],
    solver: SolverConfig,
    tran: TranConfig,
    nsub: Optional[int] = None,
    environ: Optional[DomainSpec] = None,
) -> Model:
    """Assemble a Model from raw parts and assign synthetic AIR domains.

    ``geo_xyz_flat`` is the flat voxel array in reference order (x fastest).
    Cells with id 0 are chunked into AIR domains of at most 500,000 cells
    each, appended after the physical domains (vxc2data.f90:324-336), which
    all get D=1 (vxc2data.f90:367-373).

    ``environ`` (an ENVIRON palette line) overrides D/C/Ve of the *last*
    domain — the reference writes valPHYS(nsub_glob, :)
    (vxc2data.f90:571-593), so with one air chunk (grids < 500k air cells)
    it makes the whole environment e.g. conducting.
    """
    sdx, sdy, sdz = shape_xyz
    v = np.asarray(geo_xyz_flat, dtype=np.int64).copy()
    if v.size != sdx * sdy * sdz:
        raise ValueError(f"voxel array has {v.size} cells, expected {sdx*sdy*sdz}")
    if nsub is None:
        nsub = int(v.max(initial=0))

    # air chunking: walk cells in order, new domain every 500k air cells
    air_positions = np.nonzero(v == 0)[0]
    n_air_cells = air_positions.size
    if n_air_cells:
        chunk = np.arange(n_air_cells) // 500_000
        v[air_positions] = nsub + 1 + chunk
        nsub_air = int(chunk[-1]) + 1
    else:
        nsub_air = 0
    nsub_glob = nsub + nsub_air

    by_id = {d.ident: d for d in domains}
    full: list[DomainSpec] = []
    for ident in range(1, nsub_glob + 1):
        if ident in by_id:
            full.append(by_id[ident])
        elif ident > nsub:
            full.append(DomainSpec(ident=ident, name="AIR", typ="R", D=1.0))
        else:
            full.append(DomainSpec(ident=ident))

    if environ is not None and full:
        last = full[-1]
        last.D, last.C, last.Ve = environ.D, environ.C, environ.Ve
        last.typ = environ.typ

    geo = v.reshape(sdz, sdy, sdx)  # C-order: z slowest, x fastest
    model = Model(
        shape_xyz=(sdx, sdy, sdz),
        delta=np.asarray(delta, float),
        geo=geo,
        domains=full,
        functions=functions,
        vmech=vmech,
        solver=solver,
        tran=tran,
        nsub=nsub,
        nsub_air=nsub_air,
    )
    return model.finalize()
