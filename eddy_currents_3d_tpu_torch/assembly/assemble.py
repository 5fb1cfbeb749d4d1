"""Vectorized voxel-grid -> stencil-operator assembly.

The PyTorch package's counterpart of
``eddy_currents_3d_tpu/assembly/assemble.py``: the host fields are the same
numpy arithmetic; only the device tensors are made with torch on the
caller's device.

Reproduces the row semantics of the reference's ``gen_sparse_matrix``
(EC3D.f90:465-1049) — the 7-point A-block with open-boundary BND
multipliers, convection and 2C/dt terms on conducting cells, the grad-U
coupling with one-sided (-3,+4,-1) conductor-surface stencils, and the
27-way U-row case ladder — but as mask algebra over dense coefficient
fields instead of a triple-nested scalar loop with linked lists.

The 27-way boundary ladder for A rows collapses to a closed form: on a
minus face the +neighbor coefficient is ``BND(axis,plus)*s`` and the minus
neighbor is absent; mirrored on a plus face; diagonal accumulates ``s`` per
face-adjacent axis and ``2s`` otherwise (verified row-for-row against the
ladder in tests).  The U-row ladder (8 corners / 12 edges / 6 faces /
interior, EC3D.f90:766-922) is kept as an explicit prioritized case table —
including the reference's sign quirk in the (x-,y+,z+) corner
(EC3D.f90:803-806), so that assembled matrices match the reference exactly.

Configurations on which the reference would address out of bounds or STOP
(conductors thinner than 3 cells, conducting cells whose one-sided stencil
leaves the conductor) raise :class:`AssemblyError` here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .stencil import StencilOperator
from ..models.model import Model
from ..utils.device import resolve_device

__all__ = ["AssembledSystem", "AssemblyError", "assemble_operator", "to_csr"]


class AssemblyError(ValueError):
    pass


def _nshift(f: np.ndarray, axis: int, d: int, fill=0):
    """numpy version of stencil.shift: value of neighbor at +d along
    physical axis (0=x,1=y,2=z), `fill` beyond the grid."""
    if d == 0:
        return f.copy()
    ax = {0: 2, 1: 1, 2: 0}[axis]
    out = np.full_like(f, fill)
    n = f.shape[ax]
    if abs(d) >= n:
        return out
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if d > 0:
        src[ax] = slice(d, None)
        dst[ax] = slice(None, n - d)
    else:
        src[ax] = slice(None, d)
        dst[ax] = slice(-d, None)
    out[tuple(dst)] = f[tuple(src)]
    return out


@dataclass
class AssembledSystem:
    """Device-ready operator + masks + per-cell inertial coefficient."""

    op: StencilOperator
    cond_mask: torch.Tensor       # (nz,ny,nx) bool
    inert: torch.Tensor           # (nz,ny,nx) 2C/dt on conducting cells
    bnd_a: torch.Tensor           # (3,nz,ny,nx) bool: cel_bndX/Y/Z rows
    bnd_u: torch.Tensor           # (3,nz,ny,nx) bool: cel_bndUx/y/z rows
    gershgorin: float             # max absolute row sum (spectral bound)
    # host copies for the coded encoder's proof / inspection
    np_ka: np.ndarray
    np_gu: np.ndarray
    np_ku: np.ndarray
    np_da: np.ndarray

    @property
    def shape_zyx(self):
        return self.np_ka.shape[1:]

    @property
    def device(self) -> torch.device:
        return self.cond_mask.device

    @property
    def bnd_u_any(self):
        return torch.any(self.bnd_u, dim=0)

    def matrix_stats(self) -> dict:
        """Exact assembled-matrix statistics, matching the reference's
        post-assembly prints (EC3D.f90:965-971: per-block nnz and one-sided
        boundary-row counts; :1046-1047: total nnz + density, which the
        reference computes against the *grid* cell count, not the unknown
        count — reproduced as-is); the JAX package's ``matrix_stats``, from
        the host copies (the boundary rows read back once)."""
        ka = int(np.count_nonzero(self.np_ka))      # shared by the 3 A blocks
        gu = [int(np.count_nonzero(self.np_gu[c])) for c in range(3)]
        nz_u = (int(np.count_nonzero(self.np_ku))
                + int(np.count_nonzero(self.np_da)))
        nz_xyz = [ka + g for g in gu]
        total = sum(nz_xyz) + nz_u
        n_cells = int(np.prod(self.shape_zyx))
        bnd = self.bnd_a.reshape(3, -1).sum(1).tolist()
        return {
            "nnz_x": nz_xyz[0], "nnz_y": nz_xyz[1], "nnz_z": nz_xyz[2],
            "nnz_u": nz_u, "nnz": total,
            "bnd_x": bnd[0], "bnd_y": bnd[1], "bnd_z": bnd[2],
            "density_pct": 100.0 * total / n_cells / n_cells,
        }


# offset index bookkeeping for the 7-point arrays: [0, -x, +x, -y, +y, -z, +z]
_MOFF = {0: 1, 1: 3, 2: 5}  # axis -> index of the minus-neighbor slot
_POFF = {0: 2, 1: 4, 2: 6}


def _raise_bad(sel: np.ndarray, why: str):
    idx = np.argwhere(sel)
    z, y, x = idx[0]
    raise AssemblyError(
        f"{why} at {int(sel.sum())} cell(s), first (x,y,z)="
        f"({x + 1},{y + 1},{z + 1}) [1-based]; the reference aborts or reads "
        f"out of bounds on this geometry (conductors must be >=3 cells thick "
        f"and off the grid boundary)"
    )


def assemble_operator(model: Model, dtype: torch.dtype, device=None,
                      inertia_on_faces: bool = False) -> AssembledSystem:
    """Build the stencil operator; its tensors are ``dtype`` on ``device``
    (None: the current CUDA device, and a ``RuntimeError`` without one).

    ``inertia_on_faces`` is a beyond-reference extension: the reference adds
    the conducting 2C/dt inertia only on grid-interior cells
    (EC3D.f90:656-663), so conducting cells on the outer faces behave as
    vacuum.  With True, face conductors get the inertial term too (their
    boundary A-row is otherwise unchanged; convection and grad-U coupling
    stay interior-only).  Combined with BOUNDARY ALL=-1 (exact discrete
    Neumann) this makes full-cross-section slabs exactly 1-D — used by the
    analytic skin-depth validation (tests/test_physics_skin_depth.py).
    Default False = reference-exact."""
    device = resolve_device(device)
    nz, ny, nx = model.shape_zyx
    shape = (nz, ny, nx)
    dx, dy, dz = [float(d) for d in model.delta]
    s = np.array([1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2])
    ds = np.array([0.5 / dx, 0.5 / dy, 0.5 / dz])
    dt = float(model.tran.step)
    if dt <= 0:
        raise AssemblyError("tran.step (dt) must be positive before assembly")
    BND = np.asarray(model.solver.BND, float)

    cond = model.cond_mask
    if cond is None:
        raise AssemblyError("model not finalized")
    Cf = model.domain_field("C")
    Ve = [model.domain_field("VEX"), model.domain_field("VEY"), model.domain_field("VEZ")]

    # face masks per physical axis
    at_m = [np.zeros(shape, bool) for _ in range(3)]
    at_p = [np.zeros(shape, bool) for _ in range(3)]
    at_m[0][:, :, 0] = True;  at_p[0][:, :, -1] = True
    at_m[1][:, 0, :] = True;  at_p[1][:, -1, :] = True
    at_m[2][0, :, :] = True;  at_p[2][-1, :, :] = True
    on_face = at_m[0] | at_p[0] | at_m[1] | at_p[1] | at_m[2] | at_p[2]
    interior = ~on_face

    # ------------------------------------------------------------------
    # A-block rows (closed form of the 27-case boundary ladder,
    # EC3D.f90:528-654)
    # ------------------------------------------------------------------
    ka = np.zeros((7,) + shape)
    diag = np.zeros(shape)
    for a in range(3):
        ka[_MOFF[a]] = np.where(at_m[a], 0.0, np.where(at_p[a], BND[a, 0] * s[a], -s[a]))
        ka[_POFF[a]] = np.where(at_p[a], 0.0, np.where(at_m[a], BND[a, 1] * s[a], -s[a]))
        diag += np.where(at_m[a] | at_p[a], s[a], 2.0 * s[a])
    ka[0] = diag

    # conducting extras, interior cells only (EC3D.f90:656-663)
    intc = cond & interior
    for a in range(3):
        conv = Ve[a] / (2.0 * model.delta[a])
        ka[_MOFF[a]] = np.where(intc, ka[_MOFF[a]] - conv, ka[_MOFF[a]])
        ka[_POFF[a]] = np.where(intc, ka[_POFF[a]] + conv, ka[_POFF[a]])
    inert = np.where(cond, 2.0 * Cf / dt, 0.0)
    inert_sel = cond if inertia_on_faces else intc
    ka[0] = np.where(inert_sel, ka[0] + inert, ka[0])

    # neighbor-conducting flags (out-of-grid counts as non-conducting)
    cnd_m = [_nshift(cond, a, -1).astype(bool) for a in range(3)]
    cnd_p = [_nshift(cond, a, +1).astype(bool) for a in range(3)]
    cnd_m2 = [_nshift(cond, a, -2).astype(bool) for a in range(3)]
    cnd_p2 = [_nshift(cond, a, +2).astype(bool) for a in range(3)]

    # ------------------------------------------------------------------
    # grad-U coupling in the A rows (EC3D.f90:667-710)
    # ------------------------------------------------------------------
    gu = np.zeros((3, 5) + shape)
    bnd_a = np.zeros((3,) + shape, bool)
    for c in range(3):
        one_m = intc & ~cnd_p[c]                 # +neighbor missing: backward
        one_p = intc & cnd_p[c] & ~cnd_m[c]      # -neighbor missing: forward
        central = intc & cnd_p[c] & cnd_m[c]
        bad = one_m & ~(cnd_m[c] & cnd_m2[c])
        if bad.any():
            _raise_bad(bad, f"one-sided grad-U stencil (axis {'xyz'[c]}) leaves the conductor")
        bad = one_p & ~cnd_p2[c]
        if bad.any():
            _raise_bad(bad, f"one-sided grad-U stencil (axis {'xyz'[c]}) leaves the conductor")
        g = Cf * ds[c]
        gu[c, 2] = np.where(one_m, -3.0 * g, np.where(one_p, 3.0 * g, 0.0))
        gu[c, 1] = np.where(one_m, 4.0 * g, np.where(central, g, 0.0))
        gu[c, 0] = np.where(one_m, -g, 0.0)
        gu[c, 3] = np.where(one_p, -4.0 * g, np.where(central, -g, 0.0))
        gu[c, 4] = np.where(one_p, g, 0.0)
        bnd_a[c] = one_m | one_p

    # ------------------------------------------------------------------
    # U rows: prioritized case ladder (EC3D.f90:766-922)
    # ------------------------------------------------------------------
    miss = {  # miss[(axis, side)] : that neighbor is NOT conducting
        (0, "m"): cond & ~cnd_m[0], (0, "p"): cond & ~cnd_p[0],
        (1, "m"): cond & ~cnd_m[1], (1, "p"): cond & ~cnd_p[1],
        (2, "m"): cond & ~cnd_m[2], (2, "p"): cond & ~cnd_p[2],
    }

    def corner(xs, ys, zs, du):
        cmask = miss[(0, xs)] & miss[(1, ys)] & miss[(2, zs)]
        ku_spec = {0: "p" if xs == "m" else "m",
                   1: "p" if ys == "m" else "m",
                   2: "p" if zs == "m" else "m"}
        return (cmask, ku_spec, dict(zip(range(3), du)), (0, 1, 2))

    def edge(free, m1, m2):
        (a1, s1), (a2, s2) = m1, m2
        cmask = miss[(a1, s1)] & miss[(a2, s2)]
        ku_spec = {free: "both",
                   a1: "p" if s1 == "m" else "m",
                   a2: "p" if s2 == "m" else "m"}
        du = {a1: +1 if s1 == "p" else -1, a2: +1 if s2 == "p" else -1}
        return (cmask, ku_spec, du, (a1, a2))

    def face(a, side):
        others = [b for b in range(3) if b != a]
        cmask = miss[(a, side)]
        for b in others:
            cmask = cmask & ~miss[(b, "m")] & ~miss[(b, "p")]
        ku_spec = {a: "p" if side == "m" else "m", others[0]: "both", others[1]: "both"}
        du = {a: +1 if side == "p" else -1}
        return (cmask, ku_spec, du, (a,))

    cases = [
        # 8 corners (EC3D.f90:773-812); du holds the sign of the 2/(dt*delta)
        # same-cell A coupling per axis
        corner("m", "m", "m", (-1, -1, -1)),
        corner("p", "m", "m", (+1, -1, -1)),
        corner("m", "p", "m", (-1, +1, -1)),
        corner("p", "p", "m", (+1, +1, -1)),
        corner("m", "m", "p", (-1, -1, +1)),
        corner("p", "m", "p", (+1, -1, +1)),
        # reference sign quirk: this corner reuses (+x,-y) signs
        # (EC3D.f90:803-806) — kept for exact parity
        corner("m", "p", "p", (+1, -1, +1)),
        corner("p", "p", "p", (+1, +1, +1)),
        # 12 edges (EC3D.f90:815-878)
        edge(0, (1, "p"), (2, "m")),
        edge(0, (1, "m"), (2, "m")),
        edge(0, (1, "p"), (2, "p")),
        edge(0, (1, "m"), (2, "p")),
        edge(1, (0, "p"), (2, "m")),
        edge(1, (0, "m"), (2, "m")),
        edge(1, (0, "p"), (2, "p")),
        edge(1, (0, "m"), (2, "p")),
        edge(2, (0, "m"), (1, "m")),
        edge(2, (0, "p"), (1, "m")),
        edge(2, (0, "m"), (1, "p")),
        edge(2, (0, "p"), (1, "p")),
        # 6 faces (EC3D.f90:881-916)
        face(0, "m"), face(0, "p"), face(1, "p"), face(1, "m"),
        face(2, "p"), face(2, "m"),
    ]

    ncase = len(cases)
    case_id = np.where(cond, ncase, -1)  # ncase = interior 13-pt row
    for idx in range(ncase - 1, -1, -1):
        case_id = np.where(cases[idx][0], idx, case_id)

    ku = np.zeros((7,) + shape)
    da = np.zeros((3, 3) + shape)
    bnd_u = np.zeros((3,) + shape, bool)
    sdiag = 2.0 * s.sum()

    for idx, (_, ku_spec, du, bnd_axes) in enumerate(cases):
        sel = case_id == idx
        if not sel.any():
            continue
        ku[0] = np.where(sel, sdiag, ku[0])
        for a, spec in ku_spec.items():
            if spec == "both":
                bad = sel & ~(cnd_m[a] & cnd_p[a])
                if bad.any():
                    _raise_bad(bad, f"U-row references a non-conducting neighbor (axis {'xyz'[a]})")
                ku[_MOFF[a]] = np.where(sel, -s[a], ku[_MOFF[a]])
                ku[_POFF[a]] = np.where(sel, -s[a], ku[_POFF[a]])
            elif spec == "p":
                bad = sel & ~cnd_p[a]
                if bad.any():
                    _raise_bad(bad, f"U-row references a non-conducting neighbor (axis {'xyz'[a]})")
                ku[_POFF[a]] = np.where(sel, -2.0 * s[a], ku[_POFF[a]])
            else:  # "m"
                bad = sel & ~cnd_m[a]
                if bad.any():
                    _raise_bad(bad, f"U-row references a non-conducting neighbor (axis {'xyz'[a]})")
                ku[_MOFF[a]] = np.where(sel, -2.0 * s[a], ku[_MOFF[a]])
        for a, sign in du.items():
            da[a, 1] = np.where(sel, sign * 2.0 / (dt * model.delta[a]), da[a, 1])
        for a in bnd_axes:
            bnd_u[a] |= sel

    # interior 13-point U row (EC3D.f90:917-921)
    sel = case_id == ncase
    if sel.any():
        bad = sel & ~(cnd_m[0] & cnd_p[0] & cnd_m[1] & cnd_p[1] & cnd_m[2] & cnd_p[2])
        if bad.any():
            _raise_bad(bad, "interior U-row with a non-conducting neighbor")
        ku[0] = np.where(sel, sdiag, ku[0])
        for a in range(3):
            ku[_MOFF[a]] = np.where(sel, -s[a], ku[_MOFF[a]])
            ku[_POFF[a]] = np.where(sel, -s[a], ku[_POFF[a]])
            half = 0.5 / (dt * model.delta[a])
            da[a, 0] = np.where(sel, +half, da[a, 0])
            da[a, 2] = np.where(sel, -half, da[a, 2])

    # conductor bounding box + stencil halo: the U-coupled coefficient
    # streams are zero outside it, so only this window ships to the device
    if cond.any():
        zz, yy, xx = np.nonzero(cond)
        box = (
            max(int(zz.min()) - 2, 0), min(int(zz.max()) + 3, nz),
            max(int(yy.min()) - 2, 0), min(int(yy.max()) + 3, ny),
            max(int(xx.min()) - 2, 0), min(int(xx.max()) + 3, nx),
        )
        bsl = (slice(box[0], box[1]), slice(box[2], box[3]), slice(box[4], box[5]))
        gu_d = gu[(slice(None), slice(None)) + bsl]
        ku_d = ku[(slice(None),) + bsl]
        da_d = da[(slice(None), slice(None)) + bsl]
    else:
        box = None
        gu_d = np.zeros((3, 5, 0, 0, 0))
        ku_d = np.zeros((7, 0, 0, 0))
        da_d = np.zeros((3, 3, 0, 0, 0))

    def dev(arr, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=dt)

    op = StencilOperator(ka=dev(ka), gu=dev(gu_d), ku=dev(ku_d), da=dev(da_d),
                         box=box)
    # Gershgorin bound on |lambda|: max absolute row sum over A and U rows
    # (for the dominant 7-point block this is ~4*(sx+sy+sz), tight)
    row_a = np.abs(ka).sum(0) + np.abs(gu).sum(1).max(0)
    row_u = np.abs(ku).sum(0) + np.abs(da).sum(axis=(0, 1))
    gersh = float(max(row_a.max(), row_u.max()))
    return AssembledSystem(
        op=op,
        cond_mask=dev(cond, torch.bool),
        inert=dev(inert),
        bnd_a=dev(bnd_a, torch.bool),
        bnd_u=dev(bnd_u, torch.bool),
        gershgorin=gersh,
        np_ka=ka, np_gu=gu, np_ku=ku, np_da=da,
    )


def to_csr(system: AssembledSystem, model: Model):
    """Export the operator as a scipy CSR matrix in the reference's global
    numbering [Ax | Ay | Az | U] (EC3D.f90:503, 973-986), from the float64
    host copies: the general sparse tier's matrix (``ops/sparse.py``) and
    ILU(0)'s (``solvers/ilu0.py``).  Host numpy/scipy only."""
    from scipy import sparse

    from .stencil import OFFSETS7

    nz, ny, nx = system.shape_zyx
    N = nx * ny * nz
    ncond = model.n_cond
    ntot = 3 * N + ncond
    condno = model.cond_number.ravel()          # 1-based local U number
    u_col_of_cell = 3 * N + condno - 1          # valid where condno > 0

    flat = np.arange(N)
    stride = {0: 1, 1: nx, 2: nx * ny}

    rows, cols, vals = [], [], []

    def add(r, c, v, keep):
        rows.append(r[keep]); cols.append(c[keep]); vals.append(v[keep])

    for o, (axis, d) in enumerate(OFFSETS7):
        coef = system.np_ka[o].ravel()
        tgt = flat if d == 0 else flat + d * stride[axis]
        keep = coef != 0.0
        for c in range(3):
            add(c * N + flat, c * N + tgt, coef, keep)
        ucoef = system.np_ku[o].ravel()
        keep = ucoef != 0.0
        add(3 * N + condno - 1,
            u_col_of_cell[np.clip(tgt, 0, N - 1)] if d != 0 else u_col_of_cell,
            ucoef, keep)

    for c in range(3):
        for k, d in enumerate((-2, -1, 0, +1, +2)):
            coef = system.np_gu[c, k].ravel()
            keep = coef != 0.0
            tgt = flat + d * stride[c]
            add(c * N + flat, u_col_of_cell[np.clip(tgt, 0, N - 1)], coef, keep)
        for k, d in enumerate((-1, 0, +1)):
            coef = system.np_da[c, k].ravel()
            keep = coef != 0.0
            tgt = flat + d * stride[c]
            add(3 * N + condno - 1, c * N + np.clip(tgt, 0, N - 1), coef, keep)

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return sparse.coo_matrix((vals, (rows, cols)), shape=(ntot, ntot)).tocsr()
