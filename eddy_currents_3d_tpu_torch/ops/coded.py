"""Case-coded operator: compute coefficients, don't stream them.

The PyTorch counterpart of ``eddy_currents_3d_tpu/ops/pallas_coded.py``.
The assembled coefficients carry almost no information:

* the A-row stencil (EC3D.f90:528-663) is a *constant* 7-point stencil
  everywhere except (a) grid faces, where the closed-form BND multipliers
  apply — a pure function of the cell's face membership — and (b)
  conducting interior cells, which add the 2C/dt inertial diagonal and the
  ±C·Ve/(2Δ) convection pair;
* every U-coupling coefficient (the 27-way ladder, EC3D.f90:667-922) is a
  case-dependent constant — a function of the six "is this neighbor
  conducting" bits — times at most the cell's conductivity C.

So the coded operator holds ONE int32 code field and ONE C field (plus the
convection fields when a conductor moves) and computes every coefficient
from static constants.  The matvec takes one of two routes, the JAX
package's (:func:`split_route`):

* whole-plane: one hand-written kernel (``ops/coded_cuda.py``,
  ``csrc/coded_matvec.cu``) over the full grid and a full-shape U;
* split, on 256x256-class planes: a stencil kernel on the air planes and a
  conductor-slab kernel (``ops/coded_split_cuda.py``,
  ``csrc/coded_split.cu``), with the solver's U held z-compact: only the
  conductor's planes ``[zb0, zb1)`` (``pad_state``/``unpad_state``).

On a CPU tensor each kernel's wrapper runs its plain torch version
(:func:`coded_apply_reference`, :func:`coded_stencil_reference`,
:func:`coded_slab_reference`), one copy of the same arithmetic.

Correctness: the encoder *proves* itself against the assembly — it
reconstructs all four coefficient field sets from the code in f64 with the
same expression forms as assembly/assemble.py and requires bit-exact
equality with ``system.np_*`` (including the reference's (x-,y+,z+) corner
sign quirk, EC3D.f90:803-806); any model it cannot represent raises
:class:`CodedUnsupported`.

The port works on the unpadded grid: neighbors beyond the grid read as
zero.  The solver space is the full (3, nz, ny, nx) A and either the full
(nz, ny, nx) U or, on the split route, its conductor planes
(zb1 - zb0, ny, nx).  Compact U is exact because U is zero off the
conductor in every solver vector (tests/test_torch_split.py shows it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..assembly.assemble import _MOFF, _POFF, _nshift
from ..assembly.stencil import State, shift

__all__ = ["CodedStencilOperator", "from_assembled_coded",
           "CodedUnsupported", "split_route", "coded_apply_reference",
           "coded_stencil_reference", "coded_slab_reference"]

# code bits (1 = that neighbor is NOT conducting / out of grid)
_B_XM, _B_XP, _B_YM, _B_YP, _B_ZM, _B_ZP = 0, 1, 2, 3, 4, 5
_B_COND, _B_INTC = 6, 7


class CodedUnsupported(ValueError):
    """The model's assembled coefficients are not reproducible from the
    case code, or the operator cannot be coded (no conductors, a dtype
    other than float32)."""


# ---------------------------------------------------------------------------
# host-side encode + proof
# ---------------------------------------------------------------------------

def _nb(cond, axis, d):
    """Neighbor-conducting mask, False beyond the grid (assemble._nshift)."""
    return _nshift(cond, axis, d).astype(bool)


def _encode(model) -> np.ndarray:
    cond = model.cond_mask
    nz, ny, nx = model.shape_zyx
    code = np.zeros((nz, ny, nx), np.int32)
    for a, (bm, bp) in enumerate(((_B_XM, _B_XP), (_B_YM, _B_YP), (_B_ZM, _B_ZP))):
        code |= (~_nb(cond, a, -1)).astype(np.int32) << bm
        code |= (~_nb(cond, a, +1)).astype(np.int32) << bp
    on_face = np.zeros((nz, ny, nx), bool)
    on_face[:, :, 0] = on_face[:, :, -1] = True
    on_face[:, 0, :] = on_face[:, -1, :] = True
    on_face[0, :, :] = on_face[-1, :, :] = True
    code |= cond.astype(np.int32) << _B_COND
    code |= (cond & ~on_face).astype(np.int32) << _B_INTC
    # bits only matter on conducting cells (the decode multiplies by them)
    return np.where(cond, code, 0).astype(np.int32)


def _reconstruct(code: np.ndarray, Cf: np.ndarray, model, s, ds, dt):
    """f64 reconstruction of (gu, ku, da), mirroring assemble_operator's
    expression forms exactly."""
    shape = code.shape
    bit = lambda k: ((code >> k) & 1).astype(bool)
    mm = [bit(_B_XM), bit(_B_YM), bit(_B_ZM)]
    mp = [bit(_B_XP), bit(_B_YP), bit(_B_ZP)]
    cond = bit(_B_COND)
    intc = bit(_B_INTC)

    gu = np.zeros((3, 5) + shape)
    for c in range(3):
        one_m = intc & mp[c]
        one_p = intc & ~mp[c] & mm[c]
        central = intc & ~mp[c] & ~mm[c]
        g = Cf * ds[c]
        gu[c, 2] = np.where(one_m, -3.0 * g, np.where(one_p, 3.0 * g, 0.0))
        gu[c, 1] = np.where(one_m, 4.0 * g, np.where(central, g, 0.0))
        gu[c, 0] = np.where(one_m, -g, 0.0)
        gu[c, 3] = np.where(one_p, -4.0 * g, np.where(central, -g, 0.0))
        gu[c, 4] = np.where(one_p, g, 0.0)

    ku = np.zeros((7,) + shape)
    ku[0] = np.where(cond, 2.0 * s.sum(), 0.0)
    for a in range(3):
        ku[_MOFF[a]] = np.where(
            cond, np.where(mp[a], -2.0 * s[a], np.where(mm[a], 0.0, -s[a])), 0.0)
        ku[_POFF[a]] = np.where(
            cond, np.where(mm[a], -2.0 * s[a], np.where(mp[a], 0.0, -s[a])), 0.0)

    da = np.zeros((3, 3) + shape)
    any_missing = (mm[0] | mp[0] | mm[1] | mp[1] | mm[2] | mp[2])
    interior13 = cond & ~any_missing
    quirk = cond & mm[0] & mp[1] & mp[2]     # EC3D.f90:803-806 sign quirk
    for a in range(3):
        big = 2.0 / (dt * model.delta[a])
        half = 0.5 / (dt * model.delta[a])
        sign = np.where(mp[a], 1.0, np.where(mm[a], -1.0, 0.0))
        if a == 0:
            sign = np.where(quirk, 1.0, sign)
        elif a == 1:
            sign = np.where(quirk, -1.0, sign)
        da[a, 1] = np.where(cond & (mm[a] | mp[a]), sign * big, 0.0)
        da[a, 0] = np.where(interior13, half, 0.0)
        da[a, 2] = np.where(interior13, -half, 0.0)
    return gu, ku, da


def _closed_ka(model, s) -> np.ndarray:
    """The constant+face closed form of the A stencil (no conducting
    extras) — assemble_operator's base stencil verbatim."""
    nz, ny, nx = model.shape_zyx
    shape = (nz, ny, nx)
    BND = np.asarray(model.solver.BND, float)
    at_m = [np.zeros(shape, bool) for _ in range(3)]
    at_p = [np.zeros(shape, bool) for _ in range(3)]
    at_m[0][:, :, 0] = True;  at_p[0][:, :, -1] = True
    at_m[1][:, 0, :] = True;  at_p[1][:, -1, :] = True
    at_m[2][0, :, :] = True;  at_p[2][-1, :, :] = True
    ka = np.zeros((7,) + shape)
    diag = np.zeros(shape)
    for a in range(3):
        ka[_MOFF[a]] = np.where(at_m[a], 0.0, np.where(at_p[a], BND[a, 0] * s[a], -s[a]))
        ka[_POFF[a]] = np.where(at_p[a], 0.0, np.where(at_m[a], BND[a, 1] * s[a], -s[a]))
        diag += np.where(at_m[a] | at_p[a], s[a], 2.0 * s[a])
    ka[0] = diag
    return ka


def from_assembled_coded(system, model, device,
                         inertia_on_faces: bool = False,
                         compact_u: bool = True) -> "CodedStencilOperator":
    """Encode + prove + place on ``device``.  Raises
    :class:`CodedUnsupported` when the assembled fields are not exactly
    reproducible from the code.  ``compact_u=False`` keeps the whole-plane
    route and a full-shape U on every grid."""
    dtype = system.op.dtype
    if dtype != torch.float32:
        raise CodedUnsupported(f"the coded operator is float32 only, got {dtype}")
    dx, dy, dz = [float(d) for d in model.delta]
    s = np.array([1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2])
    ds = np.array([0.5 / dx, 0.5 / dy, 0.5 / dz])
    dt = float(model.tran.step)
    Cf = model.domain_field("C")

    code = _encode(model)
    gu, ku, da = _reconstruct(code, Cf, model, s, ds, dt)

    # ---- proof: reconstruction must be bit-exact vs the assembly ----
    if not (np.array_equal(gu, system.np_gu) and
            np.array_equal(ku, system.np_ku) and
            np.array_equal(da, system.np_da)):
        raise CodedUnsupported("U-coupling fields not reproducible from code")
    # full A-stencil reconstruction with assembly's exact expression forms:
    # constant+face base, then convection on intc, then the inertial diagonal
    bitm = lambda k: ((code >> k) & 1).astype(bool)
    intc = bitm(_B_INTC)
    cond = bitm(_B_COND)
    inert_sel = cond if inertia_on_faces else intc
    recon = _closed_ka(model, s)
    Ve = [model.domain_field("VEX"), model.domain_field("VEY"),
          model.domain_field("VEZ")]
    conv = np.zeros((3,) + code.shape)
    for a in range(3):
        conv_a = Ve[a] / (2.0 * model.delta[a])
        recon[_MOFF[a]] = np.where(intc, recon[_MOFF[a]] - conv_a,
                                   recon[_MOFF[a]])
        recon[_POFF[a]] = np.where(intc, recon[_POFF[a]] + conv_a,
                                   recon[_POFF[a]])
        conv[a] = np.where(intc, conv_a, 0.0)
    inert = np.where(model.cond_mask, 2.0 * Cf / dt, 0.0)
    recon[0] = np.where(inert_sel, recon[0] + inert, recon[0])
    if not np.array_equal(recon, np.asarray(system.np_ka, np.float64)):
        raise CodedUnsupported("A-stencil fields not reproducible from code")
    has_conv = bool(np.any(conv))

    if system.op.box is None:
        raise CodedUnsupported("no conducting cells; the coded operator "
                               "needs a conductor")
    zz = np.nonzero(model.cond_mask)[0]
    cond_z = (int(zz.min()), int(zz.max()) + 1)

    def dev(arr, dt_):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                              dtype=dt_)

    return CodedStencilOperator(
        code=dev(code, torch.int32),
        cf=dev(Cf, dtype),
        conv=dev(conv, dtype) if has_conv else None,
        shape_zyx=tuple(int(n) for n in model.shape_zyx),
        consts=(tuple(float(v) for v in s), tuple(float(v) for v in ds),
                dt, (dx, dy, dz),
                tuple(tuple(float(v) for v in row)
                      for row in np.asarray(model.solver.BND))),
        inertia_on_faces=bool(inertia_on_faces),
        cond_z=cond_z,
        compact_u=bool(compact_u),
    )


# ---------------------------------------------------------------------------
# the route: whole-plane kernel, or the split pair over z-compact U
# ---------------------------------------------------------------------------

# The JAX package's whole-(y, x)-plane gate (ops/pallas_coded.py:324, tested
# at :368).  Past it the JAX coded operator runs its split stencil + slab
# kernels over a z-compact U; the port takes the same route for the same
# model, so both packages solve in the same space.  The (8, 128) padding of
# split_route exists only for this gate: the port's arrays are unpadded.
# Tests shrink the budget to force the split route on small grids.
_WHOLE_PLANE_BUDGET = 4_500_000


def split_route(shape_zyx, has_conv: bool) -> bool:
    """True where the JAX package's ``_yt_plan`` is not None: the padded
    planes' footprint passes the whole-plane budget."""
    _, ny, nx = shape_zyx
    nyp = -(-ny // 8) * 8
    nxp = -(-nx // 128) * 128
    return (19 + 3 * int(has_conv)) * nyp * nxp * 4 > _WHOLE_PLANE_BUDGET


# ---------------------------------------------------------------------------
# the plain torch versions of the kernels
# ---------------------------------------------------------------------------
#
# Expression forms and evaluation order follow _fused_kernel_chunk /
# _stencil_plane and _u_body in the JAX package: every constant is formed in
# float64 on the host and rounded once to the working dtype, then combined
# in that dtype.  Neighbors beyond the grid read as zero.  The three public
# versions share one copy of the arithmetic, evaluated on a window of z
# planes [z0, z1).

def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _a_window(A, z0, z1):
    """Planes [z0, z1) of A and their neighbor views ``{(axis, d): ...}``
    for d = -1, +1, zero beyond the grid."""
    nz = A.shape[1]
    plane = lambda: A.new_zeros((3, 1) + tuple(A.shape[2:]))
    parts = (([plane()] if z0 == 0 else [])
             + [A[:, max(z0 - 1, 0):min(z1 + 1, nz)]]
             + ([plane()] if z1 == nz else []))
    Aw = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
    a0 = Aw[:, 1:-1]
    nb = {(a, d): shift(a0, a, d) for a in (0, 1) for d in (-1, 1)}
    nb[(2, -1)], nb[(2, 1)] = Aw[:, :-2], Aw[:, 2:]
    return a0, nb


def _stencil(a0, nb, consts, z0, nz):
    """The constant+face 7-point A stencil on planes [z0, z0 + n) of an
    nz-plane grid (``_stencil_plane``)."""
    s, ds, dt, delta, BND = consts
    c = lambda v: _const(v, a0)
    zero = c(0.0)
    where = torch.where
    n, ny, nx = a0.shape[1:]
    idx = lambda k, lo=0: torch.arange(lo, lo + k, device=a0.device)
    zi = idx(n, z0).view(n, 1, 1)
    faces = (((idx(nx) == 0).view(1, 1, nx), (idx(nx) == nx - 1).view(1, 1, nx)),
             ((idx(ny) == 0).view(1, ny, 1), (idx(ny) == ny - 1).view(1, ny, 1)),
             (zi == 0, zi == nz - 1))
    for a, (fm, fp) in enumerate(faces):
        if a == 0:
            diag = where(fm | fp, c(s[0]), c(2.0 * s[0]))
        else:
            diag = diag + where(fm | fp, c(s[a]), c(2.0 * s[a]))
    yA = diag * a0
    for a, (fm, fp) in enumerate(faces):
        cm = where(fm, zero, where(fp, c(BND[a][0] * s[a]), c(-s[a])))
        cp = where(fp, zero, where(fm, c(BND[a][1] * s[a]), c(-s[a])))
        yA = yA + cm * nb[(a, -1)] + cp * nb[(a, 1)]
    return yA


def _conductor(a0, nb, U, code, cf, conv, consts, inertia_on_faces):
    """The case decode and U ladder (``_u_body``) on the planes of ``a0``:
    returns (grad-U + inertia + convection to add to the A rows, the U
    row).  ``U``, ``code``, ``cf`` and ``conv`` hold the same planes; U's
    neighbors beyond them read as zero."""
    s, ds, dt, delta, BND = consts
    c = lambda v: _const(v, a0)
    zero = c(0.0)
    where = torch.where
    bit = lambda k: ((code >> k) & 1) == 1
    mm = (bit(_B_XM), bit(_B_YM), bit(_B_ZM))
    mp = (bit(_B_XP), bit(_B_YP), bit(_B_ZP))
    cond = bit(_B_COND)
    intc = bit(_B_INTC)
    un = {(a, d): shift(U, a, d) for a in range(3) for d in (-2, -1, 1, 2)}

    inert_sel = cond if inertia_on_faces else intc
    inert = where(inert_sel, c(2.0 / dt) * cf, zero)
    gout = []
    for comp in range(3):
        one_m = intc & mp[comp]
        one_p = intc & ~mp[comp] & mm[comp]
        central = intc & ~mp[comp] & ~mm[comp]
        g = cf * c(ds[comp])
        gc = (where(one_m, c(-3.0) * g, where(one_p, c(3.0) * g, zero)) * U
              + where(one_m, c(4.0) * g, where(central, g, zero)) * un[(comp, -1)]
              + where(one_m, -g, zero) * un[(comp, -2)]
              + where(one_p, c(-4.0) * g, where(central, -g, zero)) * un[(comp, +1)]
              + where(one_p, g, zero) * un[(comp, +2)])
        gc = gc + inert * a0[comp]
        if conv is not None:
            # convection acts on every component along every axis
            for a in range(3):
                gc = gc + conv[a] * (nb[(a, 1)][comp] - nb[(a, -1)][comp])
        gout.append(gc)

    yU = where(cond, c(2.0 * (s[0] + s[1] + s[2])), zero) * U
    for a in range(3):
        km = where(mp[a], c(-2.0 * s[a]), where(mm[a], zero, c(-s[a])))
        kp = where(mm[a], c(-2.0 * s[a]), where(mp[a], zero, c(-s[a])))
        yU = yU + where(cond, km, zero) * un[(a, -1)]
        yU = yU + where(cond, kp, zero) * un[(a, +1)]

    any_missing = mm[0] | mp[0] | mm[1] | mp[1] | mm[2] | mp[2]
    interior13 = cond & ~any_missing
    quirk = cond & mm[0] & mp[1] & mp[2]   # EC3D.f90:803-806 sign quirk
    for a in range(3):
        big = c(2.0 / (dt * delta[a]))
        half = c(0.5 / (dt * delta[a]))
        sign = where(mp[a], big, where(mm[a], -big, zero))
        if a == 0:
            sign = where(quirk, big, sign)
        elif a == 1:
            sign = where(quirk, -big, sign)
        yU = yU + where(cond & (mm[a] | mp[a]), sign, zero) * a0[a]
        yU = yU + where(interior13, half, zero) * nb[(a, -1)][a]
        yU = yU + where(interior13, -half, zero) * nb[(a, 1)][a]
    return torch.stack(gout), yU


def _coded_planes(A, U, code, cf, conv, consts, inertia_on_faces, z0, z1):
    """(yA, yU) of the whole coded matvec on planes [z0, z1) of the
    full-grid ``A``; ``U`` holds those planes (None: U = 0)."""
    a0, nb = _a_window(A, z0, z1)
    if U is None:
        U = a0.new_zeros(a0.shape[1:])
    g, yU = _conductor(a0, nb, U, code[z0:z1], cf[z0:z1],
                       None if conv is None else conv[:, z0:z1], consts,
                       inertia_on_faces)
    return _stencil(a0, nb, consts, z0, A.shape[1]) + g, yU


def coded_apply_reference(A, U, code, cf, conv, consts, inertia_on_faces,
                          w: Optional[State] = None):
    """Plain torch version of the whole-plane kernel (``coded_matvec``),
    on any device.

    Returns ``(yA, yU)``, or ``(yA, yU, dot(y, w), dot(y, y))`` when ``w``
    is given.  ``U is None`` means U = 0 (the ``apply_div`` contraction)."""
    yA, yU = _coded_planes(A, U, code, cf, conv, consts, inertia_on_faces,
                           0, code.shape[0])
    if w is None:
        return yA, yU
    pw = torch.sum(yA * w.A) + torch.sum(yU * w.U)
    py = torch.sum(yA * yA) + torch.sum(yU * yU)
    return yA, yU, pw, py


def coded_stencil_reference(A, consts, cond_z, wA=None):
    """Plain torch version of the split route's stencil kernel
    (``coded_stencil``): the constant+face A stencil.

    Returns yA on every plane (the kernel writes only the planes outside
    the slab ``cond_z = (zb0, zb1)``), or ``(yA, dot(yA, wA), dot(yA, yA))``
    with both dots over the planes outside the slab only: the slab kernel
    owns the slab's planes."""
    nz = A.shape[1]
    a0, nb = _a_window(A, 0, nz)
    yA = _stencil(a0, nb, consts, 0, nz)
    if wA is None:
        return yA
    zb0, zb1 = cond_z
    own = torch.cat([yA[:, :zb0], yA[:, zb1:]], 1)
    w_own = torch.cat([wA[:, :zb0], wA[:, zb1:]], 1)
    return yA, torch.sum(own * w_own), torch.sum(own * own)


def coded_slab_reference(A, U_c, code, cf, conv, consts, inertia_on_faces,
                         cond_z, w: Optional[State] = None, prior=None):
    """Plain torch version of the split route's slab kernel
    (``coded_slab``): the whole coded matvec on the slab planes
    ``cond_z = (zb0, zb1)`` over the z-compact ``U_c`` (those planes only;
    U beyond them reads as zero).  ``A``, ``code``, ``cf`` and ``conv`` are
    full-grid.

    Returns ``(yA_slab, yU_c)`` with ``yA_slab`` the slab's planes of yA,
    ``(yA_slab, yU_c, dot(y, w), dot(y, y))`` over the slab when ``w`` is
    given (``w.A`` full-grid, ``w.U`` compact), or ``yU_c`` alone when
    ``U_c`` is None (U = 0: the ``apply_div`` contraction).  ``prior``, 2
    floats (the stencil's dots), is added to the dots: prior + slab."""
    zb0, zb1 = cond_z
    yA, yU = _coded_planes(A, U_c, code, cf, conv, consts, inertia_on_faces,
                           zb0, zb1)
    if U_c is None:
        return yU
    if w is None:
        return yA, yU
    pw = torch.sum(yA * w.A[:, zb0:zb1]) + torch.sum(yU * w.U)
    py = torch.sum(yA * yA) + torch.sum(yU * yU)
    if prior is not None:
        pw, py = prior[0] + pw, prior[1] + py
    return yA, yU, pw, py


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CodedStencilOperator:
    """Operator whose coefficients are computed from the case code.

    Same ``apply``/``apply_dots``/``apply_div`` and
    ``pad_state``/``unpad_state`` surface as the JAX operator.  The solver
    space is the unpadded grid, with U z-compact on the split route."""

    code: torch.Tensor              # (nz, ny, nx) int32 case code
    cf: torch.Tensor                # (nz, ny, nx) conductivity C
    conv: Optional[torch.Tensor]    # (3, nz, ny, nx) Ve/(2Δ) on intc, or None
    shape_zyx: tuple
    consts: tuple = ()              # (s, ds, dt, delta, BND)
    inertia_on_faces: bool = False
    cond_z: tuple = (0, 0)          # conductor z-extent [zb0, zb1)
    # z-compact U solver space (and the split kernels) where split_route
    # holds; False keeps the whole-plane route everywhere
    compact_u: bool = False

    @property
    def has_conv(self) -> bool:
        return self.conv is not None

    @property
    def split(self) -> bool:
        """True when the split pair runs over z-compact U."""
        return self.compact_u and split_route(self.shape_zyx, self.has_conv)

    def pad_state(self, x: State) -> State:
        """Full-grid state -> solver space (on the split route, U's
        conductor planes: a view, not a copy)."""
        if not self.split:
            return x
        zb0, zb1 = self.cond_z
        return State(x.A, x.U[zb0:zb1])

    def unpad_state(self, x: State) -> State:
        """Solver space -> full-grid state (U zero off the slab)."""
        if not self.split:
            return x
        zb0, zb1 = self.cond_z
        U = x.U.new_zeros(self.shape_zyx)
        U[zb0:zb1] = x.U
        return State(x.A, U)

    def apply_div(self, A: torch.Tensor) -> torch.Tensor:
        """U-row div(dA/dt) contraction (the per-step RHS term,
        EC3D.f90:385-392): the matvec with U = 0, U output only, full
        shape.  On the split route only the slab kernel runs."""
        if self.split:
            from .coded_split_cuda import coded_slab
            zb0, zb1 = self.cond_z
            yU = A.new_zeros(self.shape_zyx)
            yU[zb0:zb1] = coded_slab(self, A)
            return yU
        from .coded_cuda import coded_matvec
        return coded_matvec(self, A)

    def apply(self, x: State) -> State:
        if self.split:
            from .coded_split_cuda import coded_slab, coded_stencil
            yA = coded_stencil(self, x.A)
            return State(yA, coded_slab(self, x.A, x.U, yA))
        from .coded_cuda import coded_matvec
        return State(*coded_matvec(self, x.A, x.U))

    def apply_dots(self, x: State, w: State):
        """(y, dot(y, w), dot(y, y)) with both reductions fused into the
        matvec.  The partial sums and their total are float32.  On the
        split route the slab kernel adds the stencil kernel's dots to its
        own (stencil + slab), so the pair is two launches and the dots are
        views of one tensor."""
        if self.split:
            from .coded_split_cuda import coded_slab, coded_stencil
            yA, dots = coded_stencil(self, x.A, w.A)
            yU, dots = coded_slab(self, x.A, x.U, yA, w, dots)
            return State(yA, yU), dots[0], dots[1]
        from .coded_cuda import coded_matvec
        yA, yU, pw, py = coded_matvec(self, x.A, x.U, w)
        return State(yA, yU), pw, py
