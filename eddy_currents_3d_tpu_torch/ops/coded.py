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
from static constants.  On a CUDA tensor the matvec is one hand-written
kernel (``ops/coded_cuda.py``, ``csrc/coded_matvec.cu``); on a CPU tensor it
is :func:`coded_apply_reference`, the plain torch version of the same
arithmetic.

Correctness: the encoder *proves* itself against the assembly — it
reconstructs all four coefficient field sets from the code in f64 with the
same expression forms as assembly/assemble.py and requires bit-exact
equality with ``system.np_*`` (including the reference's (x-,y+,z+) corner
sign quirk, EC3D.f90:803-806); any model it cannot represent raises
:class:`CodedUnsupported`.

The port works on the unpadded grid: neighbors beyond the grid read as
zero, and the solver space is the full (3, nz, ny, nx) + (nz, ny, nx) grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..assembly.assemble import _MOFF, _POFF, _nshift
from ..assembly.stencil import State, shift

__all__ = ["CodedStencilOperator", "from_assembled_coded",
           "CodedUnsupported", "coded_apply_reference"]

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
                         inertia_on_faces: bool = False) -> "CodedStencilOperator":
    """Encode + prove + place on ``device``.  Raises
    :class:`CodedUnsupported` when the assembled fields are not exactly
    reproducible from the code."""
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
    )


# ---------------------------------------------------------------------------
# the plain torch version of the kernel
# ---------------------------------------------------------------------------

def coded_apply_reference(A, U, code, cf, conv, consts, inertia_on_faces,
                          w: Optional[State] = None):
    """Plain torch evaluation of the coded matvec on any device.

    Returns ``(yA, yU)``, or ``(yA, yU, dot(y, w), dot(y, y))`` when ``w``
    is given.  ``U is None`` means U = 0 (the ``apply_div`` contraction).
    Expression forms and evaluation order follow ``_fused_kernel_chunk`` and
    ``_u_body`` in the JAX package: every constant is formed in float64 on
    the host and rounded once to the working dtype, then combined in that
    dtype.  Neighbors beyond the grid read as zero."""
    s, ds, dt, delta, BND = consts
    dtype, device = A.dtype, A.device
    nz, ny, nx = code.shape
    if U is None:
        U = torch.zeros((nz, ny, nx), dtype=dtype, device=device)

    def c(v):
        return torch.tensor(v, dtype=dtype, device=device)

    zero = c(0.0)
    where = torch.where
    idx = lambda n: torch.arange(n, device=device)
    faces = (((idx(nx) == 0).view(1, 1, nx), (idx(nx) == nx - 1).view(1, 1, nx)),
             ((idx(ny) == 0).view(1, ny, 1), (idx(ny) == ny - 1).view(1, ny, 1)),
             ((idx(nz) == 0).view(nz, 1, 1), (idx(nz) == nz - 1).view(nz, 1, 1)))

    # ---- constant+face 7-point A stencil (_fused_kernel_chunk) ----
    for a, (fm, fp) in enumerate(faces):
        if a == 0:
            diag = where(fm | fp, c(s[0]), c(2.0 * s[0]))
        else:
            diag = diag + where(fm | fp, c(s[a]), c(2.0 * s[a]))
    yA = diag * A
    for a, (fm, fp) in enumerate(faces):
        cm = where(fm, zero, where(fp, c(BND[a][0] * s[a]), c(-s[a])))
        cp = where(fp, zero, where(fm, c(BND[a][1] * s[a]), c(-s[a])))
        yA = yA + cm * shift(A, a, -1) + cp * shift(A, a, +1)

    # ---- case decode + U ladder (_u_body) ----
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
        gc = gc + inert * A[comp]
        if conv is not None:
            # convection acts on every component along every axis
            for a in range(3):
                gc = gc + conv[a] * (shift(A[comp], a, +1) - shift(A[comp], a, -1))
        gout.append(gc)
    yA = yA + torch.stack(gout)

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
        yU = yU + where(cond & (mm[a] | mp[a]), sign, zero) * A[a]
        yU = yU + where(interior13, half, zero) * shift(A[a], a, -1)
        yU = yU + where(interior13, -half, zero) * shift(A[a], a, +1)

    if w is None:
        return yA, yU
    pw = torch.sum(yA * w.A) + torch.sum(yU * w.U)
    py = torch.sum(yA * yA) + torch.sum(yU * yU)
    return yA, yU, pw, py


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CodedStencilOperator:
    """Operator whose coefficients are computed from the case code.

    Same ``apply``/``apply_dots``/``apply_div`` surface as the JAX
    operator; the solver space is the unpadded grid."""

    code: torch.Tensor              # (nz, ny, nx) int32 case code
    cf: torch.Tensor                # (nz, ny, nx) conductivity C
    conv: Optional[torch.Tensor]    # (3, nz, ny, nx) Ve/(2Δ) on intc, or None
    shape_zyx: tuple
    consts: tuple = ()              # (s, ds, dt, delta, BND)
    inertia_on_faces: bool = False

    @property
    def has_conv(self) -> bool:
        return self.conv is not None

    def apply_div(self, A: torch.Tensor) -> torch.Tensor:
        """U-row div(dA/dt) contraction (the per-step RHS term,
        EC3D.f90:385-392): the matvec with U = 0, U output only."""
        from .coded_cuda import coded_matvec
        return coded_matvec(self, A)

    def apply(self, x: State) -> State:
        from .coded_cuda import coded_matvec
        return State(*coded_matvec(self, x.A, x.U))

    def apply_dots(self, x: State, w: State):
        """(y, dot(y, w), dot(y, y)) with both reductions fused into the
        matvec.  The partial sums and their total are float32."""
        from .coded_cuda import coded_matvec
        yA, yU, pw, py = coded_matvec(self, x.A, x.U, w)
        return State(yA, yU), pw, py
