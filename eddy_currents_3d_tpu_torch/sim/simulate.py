"""Time-domain simulation driver on torch tensors.

The PyTorch counterpart of ``eddy_currents_3d_tpu/sim/simulate.py``.  One
step reproduces the reference's main loop body (EC3D.f90:241-455):
evaluate source / motion-velocity expressions at time T (on the host, in
float64), (re)locate moving source voxels, build the right-hand side
(sources + trapezoidal inertial history + U-row coupling terms of the old
solution), zero the conductor-surface rows, solve with warm-started
restarted BiCGSTAB, then form the post-solve inertial carry
``J = (2C/dt)·A_new - rhs`` that doubles as the eddy-current output field
(EC3D.f90:412-432).

Operator selection follows the JAX package (single device).  float32
runs one of two tiers, on CUDA through hand-written kernels and on the CPU
through their plain torch versions:

* the case-coded operator (``ops/coded.py``), whose solver space is
  z-compact in U on the split route (``pad_state``/``unpad_state`` around
  the solve).  It is taken when ``coeff_dtype`` is None and ``precond`` is
  not ``"mg"``, unless ``use_coded=False``;
* the field tier (``ops/field.py``), which streams the assembled
  coefficients in float32 or bfloat16 (``coeff_dtype``), for every other
  float32 run: ``precond="mg"``, ``coeff_dtype``, ``use_coded=False``, and
  models the coded encoder refuses (``CodedUnsupported``) when
  ``use_coded`` is None.

float64 runs the flat-roll :class:`StencilOperator`, on the CPU only.  The
solve is BiCGSTABwr, unpreconditioned or right-preconditioned with Jacobi,
Chebyshev, Chebyshev on Jacobi, the multigrid V-cycle or ILU(0), as in the
JAX package.  ILU(0) (``solvers/ilu0.py``) factors the exported CSR on the
host once and applies its factors as stencil operators: field-tier
operators (the ``field_a``/``field_u`` kernels on the card) with a float32
tier, flat-roll operators in float64.  Its factors live on the full grid,
so the coded operator keeps a full-shape U under it (``compact_u=False``,
the whole-plane route).  The route choice is not a fallback: both tiers run
hand-written kernels on the card, and a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..assembly.assemble import AssembledSystem, assemble_operator
from ..assembly.stencil import State
from ..models.model import Model
from ..ops.coded import CodedUnsupported, from_assembled_coded
from ..ops.field import FieldStencilOperator
from ..solvers.bicgstab import bicgstab_wr, bicgstab_wr_right
from ..solvers.chebyshev import bicgstab_wr_cheb
from ..solvers.ilu0 import ilu0_stencil_factorize
from ..solvers.multigrid import build_mg
from .motion import FunctionMotion, MotionState, advance_function, motion_init

__all__ = ["Simulation", "SimState", "StepInfo"]


class SimState(NamedTuple):
    A: torch.Tensor       # (3,nz,ny,nx) vector potential (solution)
    U: torch.Tensor       # (nz,ny,nx) scalar potential (solution, dense-masked)
    carry: torch.Tensor   # (3,nz,ny,nx) inertial history / eddy field (Jaf)
    motion: MotionState   # host float64
    # previous-step solution for the extrapolated warm start (None under
    # warm_start="previous", keeping the reference's exact iterate path)
    prev: Optional[State] = None


class StepInfo(NamedTuple):
    iterations: int
    relres: torch.Tensor
    converged: bool
    # flat 0-based cells of each function's (possibly moved) source voxels,
    # in function order, and the source values in the working dtype —
    # consumed by the src VTK writer
    src_cells: tuple
    src_values: tuple
    sync_s: float = 0.0   # host time blocked on the solver's done reads


def _schedule(tran):
    """Step times + output points with the reference's exact bookkeeping
    (EC3D.f90:137-143, 436-455)."""
    T, dt, Time, dtt = 0.0, float(tran.step), float(tran.stop), float(tran.jump)
    nout = int(np.round(dtt / dt)) if dt > 0 else 0
    nprint = nout
    ntime = 0
    steps = []  # (t, output_point_or_None)
    while True:
        out = None
        if ntime >= nprint and ntime != 0:
            nprint = ntime + nout
            out = sum(1 for _, o in steps if o is not None) + 1
        steps.append((T, out))
        ntime += 1
        T = T + dt
        if not (T < Time):
            break
    return steps


class Simulation:
    """End-to-end simulation of a :class:`Model` on ``device``."""

    def __init__(
        self,
        model: Model,
        dtype: torch.dtype = torch.float32,
        *,
        device,
        system: Optional[AssembledSystem] = None,
        precond: Optional[str] = None,
        cheb_order: int = 4,
        cheb_ratio: float = 30.0,
        warm_start: str = "extrapolate",
        use_coded: Optional[bool] = None,
        coeff_dtype: Optional[torch.dtype] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names torch's current CUDA device
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"device must be cpu or cuda, got {self.device}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if self.device.type == "cuda" and dtype != torch.float32:
            raise ValueError(
                f"dtype={dtype} is not ported to CUDA: the CUDA kernels take "
                "float32 state (run float64 with device='cpu')")
        if coeff_dtype not in (None, torch.bfloat16):
            raise ValueError(f"coeff_dtype must be None or torch.bfloat16, "
                             f"got {coeff_dtype}")
        if precond not in (None, "cheb", "jacobi", "cheb_jacobi", "mg",
                           "ilu0"):
            raise ValueError(f"unknown preconditioner {precond!r}")
        if warm_start not in ("extrapolate", "previous"):
            raise ValueError(f"unknown warm_start {warm_start!r}")
        self.model = model
        self.dtype = dtype
        self.warm_start = warm_start
        self.system = (system if system is not None
                       else assemble_operator(model, dtype, self.device))
        if self.system.device != self.device:
            raise ValueError(f"system is on {self.system.device}, "
                             f"simulation on {self.device}")
        if coeff_dtype is not None:
            # mixed precision: coefficient streams in bfloat16, state and
            # accumulation in dtype; the solved operator is A rounded
            # entrywise to bfloat16
            self.system = dataclasses.replace(
                self.system, op=self.system.op.astype(coeff_dtype))
        self.coeff_dtype = coeff_dtype

        # tier choice (JAX simulate.py:230-309, single device): the coded
        # operator where it applies; the field tier for every other float32
        # run.  use_coded=None routes CodedUnsupported to the field tier; an
        # explicit use_coded=True never degrades.
        coded_ok = (dtype == torch.float32 and coeff_dtype is None
                    and precond != "mg")
        if use_coded and not coded_ok:
            why = (f"coeff_dtype={coeff_dtype}" if coeff_dtype is not None
                   else "precond='mg'" if precond == "mg"
                   else f"dtype={dtype}")
            raise ValueError(
                f"use_coded=True is incompatible with {why}; the coded "
                "kernels require float32 state and coefficients")
        self.coded_op = None
        if coded_ok and use_coded is not False:
            try:
                # ilu0's factors live on the full grid, so it keeps a
                # full-shape U (JAX simulate.py:261-265)
                self.coded_op = from_assembled_coded(
                    self.system, model, self.device,
                    compact_u=(precond != "ilu0"))
            except CodedUnsupported:
                if use_coded:
                    raise
        self.field_op = (FieldStencilOperator.from_assembled(self.system)
                         if dtype == torch.float32 and self.coded_op is None
                         else None)
        # the solver-space tier (None: float64's flat-roll operator)
        self._tier = (self.coded_op if self.coded_op is not None
                      else self.field_op)
        self.op = self._tier if self._tier is not None else self.system.op

        self.precond = precond
        self.cheb_order = cheb_order
        self.cheb_ratio = cheb_ratio
        if precond == "cheb_jacobi":
            # Gershgorin bound of the diagonally scaled operator D^-1 A
            # (similar to A D^-1): max row sum of |a_ij| / d_i, from the
            # host copies, as the JAX package computes it
            sysm = self.system
            ka = np.abs(sysm.np_ka).sum(0)
            rs_a = ka[None] + np.abs(sysm.np_gu).sum(1)
            diag_a = np.abs(sysm.np_ka[0])
            ratio_a = np.where(diag_a[None] > 0,
                               rs_a / np.maximum(diag_a[None], 1e-300), 0.0)
            ku0 = np.abs(sysm.np_ku[0])
            rs_u = np.abs(sysm.np_ku).sum(0) + np.abs(sysm.np_da).sum((0, 1))
            ratio_u = np.where(ku0 > 0, rs_u / np.maximum(ku0, 1e-300), 0.0)
            self._scaled_lmax = float(max(ratio_a.max(), ratio_u.max())) * 1.01
        if precond in ("jacobi", "cheb_jacobi"):
            # right-Jacobi: solve (A D^-1) y = b, x = D^-1 y, in the
            # solver space; the residual test stays the original system's
            d = self.system.op.diagonal()
            if self._tier is not None:
                d = self._tier.pad_state(d)
                d = State(torch.where(d.A == 0, 1.0, d.A).to(dtype),
                          torch.where(d.U == 0, 1.0, d.U).to(dtype))
            self._jac = (d, State(1.0 / d.A, 1.0 / d.U))
        if precond == "mg":
            # geometric V-cycle on the shared A-block stencil, built from
            # the unpadded coefficients as the JAX package builds it without
            # Pallas (JAX simulate.py:350-356)
            op = self.system.op
            ku0 = np.zeros(tuple(model.shape_zyx))
            if op.box is not None:
                z0, z1, y0, y1, x0, x1 = op.box
                ku0[z0:z1, y0:y1, x0:x1] = op.ku[0].to(
                    "cpu", torch.float64).numpy()
            self._mg = build_mg(op.ka, ku0=ku0, dtype=dtype,
                                device=self.device)
        if precond == "ilu0":
            # right-ILU(0) in stencil form: host factorization on the CSR
            # export, factors in the state dtype (under coeff_dtype too, as
            # JAX builds them from the float64 host copies), applied as
            # fixed Jacobi sweeps per triangle (JAX simulate.py:324-339)
            self._ilu = ilu0_stencil_factorize(
                self.system, model, dtype=dtype, device=self.device,
                field=self._tier is not None)
            self.ilu_sweeps = 2

        self.steps = _schedule(model.tran)
        nx, ny, nz = model.shape_xyz
        self._N = nx * ny * nz
        self.flag_move = any(any(f.move) for f in model.functions)
        self._bnd_u_any = self.system.bnd_u_any

        # host-side static per-function data
        self._funs = []
        for idx, fn in enumerate(model.functions):
            cells = fn.cells.astype(np.int64)
            ijk0 = np.stack(
                [cells % nx, (cells // nx) % ny, cells // (nx * ny)], axis=1
            ).astype(np.int32)
            const_shift = np.array(
                [
                    fn.vmech_const[a] * model.tran.step / model.delta[a]
                    if (fn.vmech_index[a] == 0 and fn.move[a] != 0)
                    else 0.0
                    for a in range(3)
                ]
            )
            comp = {"X": 0, "Y": 1, "Z": 2}[fn.direction]
            self._funs.append((
                comp,
                fn,
                cells.astype(np.int32),
                torch.from_numpy(cells).to(self.device),
                FunctionMotion(index=idx, ijk0=ijk0, const_shift=const_shift,
                               vmech_index=fn.vmech_index,
                               shape_xyz=model.shape_xyz),
            ))

    # ------------------------------------------------------------------
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def init_state(self) -> SimState:
        nz, ny, nx = self.model.shape_zyx
        return SimState(
            A=self._zeros(3, nz, ny, nx),
            U=self._zeros(nz, ny, nx),
            carry=self._zeros(3, nz, ny, nx),
            motion=motion_init(len(self.model.functions)),
            prev=(State(self._zeros(3, nz, ny, nx), self._zeros(nz, ny, nx))
                  if self.warm_start == "extrapolate" else None),
        )

    def _cast(self, v: float) -> float:
        """A host float64 value rounded to the working dtype."""
        return float(torch.tensor(v, dtype=self.dtype))

    # ------------------------------------------------------------------
    def _step(self, state: SimState, t: float) -> tuple[SimState, StepInfo]:
        model = self.model
        sysm = self.system
        cond = sysm.cond_mask
        inert = sysm.inert
        dt = float(model.tran.step)

        # ---- source scatter (EC3D.f90:275-367), function by function:
        # later functions overwrite earlier ones on shared cells ----
        base = torch.where(cond[None], state.carry, 0.0).reshape(3, self._N)
        motion = state.motion
        src_cells = []
        src_values = []
        if self.flag_move:
            # motion-velocity functions at time t (EC3D.f90:260-271)
            vmech_vals = np.array([vm(t) for vm in model.vmech], np.float64)
            movestop = motion.movestop
            dist_rows, comp_rows = [], []
            for comp, fn, _, _, fm in self._funs:
                drow, crow, movestop, flat = advance_function(
                    fm, motion.distance[fm.index], motion.comp[fm.index],
                    movestop, vmech_vals, dt, model.delta)
                dist_rows.append(drow)
                comp_rows.append(crow)
                val = self._cast(fn(t))
                base[comp, torch.from_numpy(flat.astype(np.int64)).to(
                    self.device)] = val
                src_cells.append(flat)
                src_values.append(val)
            motion = MotionState(distance=np.stack(dist_rows),
                                 movestop=movestop,
                                 comp=np.stack(comp_rows))
        else:
            for comp, fn, cells_np, cells, _ in self._funs:
                val = self._cast(fn(t))
                base[comp, cells] = val
                src_cells.append(cells_np)
                src_values.append(val)

        rhs_A = base.reshape((3,) + tuple(model.shape_zyx)) + inert[None] * state.A
        # the field tier has no apply_div: its RHS term is the assembled
        # operator's, as in the JAX package
        div_op = self.coded_op if self.coded_op is not None else sysm.op
        rhs_U = div_op.apply_div(state.A)
        rhs_A = torch.where(sysm.bnd_a, 0.0, rhs_A)
        rhs_U = torch.where(self._bnd_u_any, 0.0, rhs_U)

        # ---- solve (EC3D.f90:408) ----
        b = State(rhs_A, rhs_U)
        if self.warm_start == "extrapolate":
            # linear prediction from the last two solutions
            x0 = State(2.0 * state.A - state.prev.A,
                       2.0 * state.U - state.prev.U)
        else:
            x0 = State(state.A, state.U)
        tol = torch.tensor(model.solver.tolerance, dtype=self.dtype,
                           device=self.device)
        coded = self.coded_op
        tier = self._tier
        if tier is not None:
            b, x0 = tier.pad_state(b), tier.pad_state(x0)
        apply_fn = self.op.apply
        itmax = model.solver.itmax
        if self.precond == "cheb":
            lmax = sysm.gershgorin * 1.01
            res = bicgstab_wr_cheb(apply_fn, b, x0, tol, itmax,
                                   order=self.cheb_order,
                                   lmin=lmax / self.cheb_ratio, lmax=lmax)
            sol = res.x
        elif self.precond in ("jacobi", "cheb_jacobi"):
            d, inv = self._jac
            mul = lambda a, v: State(a.A * v.A, a.U * v.U)
            scaled = lambda v: apply_fn(mul(inv, v))
            if self.precond == "cheb_jacobi":
                lmax = self._scaled_lmax
                res = bicgstab_wr_cheb(scaled, b, mul(d, x0), tol, itmax,
                                       order=self.cheb_order,
                                       lmin=lmax / self.cheb_ratio, lmax=lmax)
            else:
                # the fused dots of the right-scaled operator A D^-1 v
                mvd = ((lambda v, w: coded.apply_dots(mul(inv, v), w))
                       if coded is not None else None)
                res = bicgstab_wr(scaled, b, mul(d, x0), tol, itmax,
                                  mv_dot=mvd)
            sol = mul(inv, res.x)
        elif self.precond == "mg":
            res = bicgstab_wr_right(apply_fn, self._mg.apply, b, x0, tol,
                                    itmax)
            sol = res.x
        elif self.precond == "ilu0":
            # the factors act on the full grid, which is the solver space
            # here (compact_u=False on the coded route)
            minv = lambda v: self._ilu.apply(v, sweeps=self.ilu_sweeps)
            res = bicgstab_wr_right(apply_fn, minv, b, x0, tol, itmax)
            sol = res.x
        else:
            # only the coded operator fuses the dots (in float32); the
            # field tier and float64's flat-roll operator run them apart
            mvd = coded.apply_dots if coded is not None else None
            res = bicgstab_wr(apply_fn, b, x0, tol, itmax, mv_dot=mvd)
            sol = res.x
        if tier is not None:
            sol = tier.unpad_state(sol)
        A_new, U_new = sol.A, sol.U

        # ---- post-solve inertial carry + surface zeroing (EC3D.f90:412-432)
        carry = torch.where(cond[None], inert[None] * A_new - rhs_A, rhs_A)
        carry = torch.where(sysm.bnd_a, 0.0, carry)
        A_out = torch.where(sysm.bnd_a, 0.0, A_new)

        new_state = SimState(
            A=A_out, U=U_new, carry=carry, motion=motion,
            prev=(State(state.A, state.U)
                  if self.warm_start == "extrapolate" else None),
        )
        info = StepInfo(
            iterations=res.iterations,
            relres=res.relres,
            converged=res.converged,
            src_cells=tuple(src_cells),
            src_values=tuple(src_values),
            sync_s=res.sync_s,
        )
        return new_state, info

    # ------------------------------------------------------------------
    def run(
        self,
        num_steps: Optional[int] = None,
        output_dir: Optional[str] = None,
        initial_state: Optional[SimState] = None,
    ):
        """Run the transient.

        * ``output_dir``: write field_N.vtk / src_N.vtk at the jump cadence,
          synchronously, from one host copy of A and the carry per output.

        Returns (final_state, diagnostics dict with per-step iteration
        counts, the wall / io / solver-sync seconds, and the unconverged
        steps).
        """
        from ..io.vtk import write_outputs

        state = initial_state if initial_state is not None else self.init_state()
        steps = self.steps if num_steps is None else self.steps[:num_steps]
        infos = []
        t0 = _time.perf_counter()
        t_io = 0.0
        for t, out in steps:
            state, info = self._step(state, t)
            infos.append(info)
            if out is not None and output_dir is not None:
                t1 = _time.perf_counter()
                host = torch.stack([state.A, state.carry]).cpu().numpy()
                write_outputs(self, state._replace(A=host[0], carry=host[1]),
                              info, out, output_dir)
                t_io += _time.perf_counter() - t1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - t0

        iters = [i.iterations for i in infos]
        unconverged = [i for i, inf in enumerate(infos) if not inf.converged]
        if unconverged:
            # the reference prints the residual norm on itmax overflow and
            # carries on (solvers.f90:25-27)
            print(f"WARNING: solver hit itmax without converging at "
                  f"{len(unconverged)} step(s), first at step {unconverged[0]}")
        return state, {
            "wall_s": wall,
            "io_s": t_io,
            "sync_s": sum(i.sync_s for i in infos),
            "steps": len(steps),
            "iterations": iters,
            "total_iterations": int(sum(iters)),
            "unconverged_steps": unconverged,
        }
