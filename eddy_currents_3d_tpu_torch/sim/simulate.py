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
runs one of two tiers and bfloat16 the second, on CUDA through
hand-written kernels and on the CPU through their plain torch versions:

* the case-coded operator (``ops/coded.py``), whose solver space is
  z-compact in U on the split route (``pad_state``/``unpad_state`` around
  the solve).  It is taken when ``coeff_dtype`` is None and ``precond`` is
  not ``"mg"``, unless ``use_coded=False``;
* the field tier (``ops/field.py``), which streams the assembled
  coefficients in float32 or bfloat16 (``coeff_dtype``), for every other
  float32 run: ``precond="mg"``, ``coeff_dtype``, ``use_coded=False``, and
  models the coded encoder refuses (``CodedUnsupported``) when
  ``use_coded`` is None; and for every bfloat16-state run, with bfloat16
  coefficients, as the JAX package runs ``dtype=bfloat16`` on its Pallas
  field kernels (the coded tier is float32 only, and ``use_coded=True``
  raises).

float64 runs the flat-roll :class:`StencilOperator` (torch shifts), on the
card as on the CPU, as the JAX package runs its jnp operator at float64;
``use_pallas=False`` (the JAX package's keyword: off, the hand-written
kernels are not used) runs the same flat-roll tier at float32 or bfloat16.
On a mesh (``parallel/mesh.py`` ``make_mesh``: one process per card over
``torch.distributed``, (z, y) blocks) the operator is the sharded tier
(``parallel/shard_op.py``): per slab the coded kernel on z-only meshes
where the coded operator applies, as in the JAX package, and per block the
field kernels otherwise: for ``precond="mg"``, whose V-cycle then runs on
the rank's block (``parallel/shard_mg.py``: distributed levels with
``field_a`` and ghost exchanges, the coarse ones gathered and replicated),
and for ``use_shard_map=False``, the JAX package's GSPMD tier.  Every
field is the rank's block, the dots are all-reduced inside the solve,
``run``/``run_scan`` return the global fields, and checkpoints hold the
global fields (the first rank gathers and writes them; every rank resumes
by cutting its block from the file).
The solve is BiCGSTABwr, unpreconditioned or right-preconditioned with
Jacobi, Chebyshev, Chebyshev on Jacobi, the multigrid V-cycle or ILU(0),
as in the JAX package, its reductions in ``dot_dtype`` (None: the state's
dtype); the coded operator's fused dots serve only ``dot_dtype=None``, as
in JAX; on a mesh the dots are taken apart from the operator and summed
over the ranks.
ILU(0) (``solvers/ilu0.py``) factors the exported CSR on the host once and
applies its factors as stencil operators: field-tier operators (the
``field_a``/``field_u`` kernels on the card) with a float32 or bfloat16
tier, flat-roll operators in float64.  Its factors live on the full grid,
so the coded operator keeps a full-shape U under it (``compact_u=False``,
the whole-plane route).  The route choice is not a fallback: both tiers run
hand-written kernels on the card, and a kernel that fails to build or
launch raises.

Each solve runs as a device program (``solvers/bicgstab.py``
``DeviceLoop``, one per Simulation): on the card one CUDA graph launch
with no host read, its iteration count and convergence flag left on the
device until ``run``/``run_scan`` read every step's once, after the loop,
as the JAX package does.  ``run_scan`` is the JAX package's chunked path
(segments between outputs and checkpoints); checkpoints are its ``.npz``
format (``sim/checkpoint.py``).  VTK outputs go through the overlapped
writer (:class:`_AsyncVtkWriter`): one device-to-host copy per output, the
encoding on writer threads while the loop steps on.

With the tracer on (``utils/trace.py``) a transient keeps spans at the
step's layer boundaries: ``run`` (a transient of ``run`` or ``run_scan``),
``step`` (one ``_step``, with the device clock), inside it ``rhs``
(``_rhs``, and in it ``rhs.motion``, the source functions' relocation, a
device wait, and ``rhs.scatter``, the fill of their cells), ``solve`` (the
device loop's solve, with the device clock) and ``carry`` (the carry and
the surface zeroing); and the counters ``steps``, ``iterations``,
``motion.functions`` (source functions relocated) and ``scatter.cells``
(source cells filled).
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue
import threading
import time as _time
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..assembly.assemble import AssembledSystem, assemble_operator
from ..assembly.stencil import State
from ..io import native, vtk
from ..models.model import Model
from ..ops.coded import CodedUnsupported, from_assembled_coded
from ..ops.field import FieldStencilOperator
from ..parallel.shard_mg import build_shard_mg
from ..parallel.shard_op import ShardedStencilOperator
from ..solvers.bicgstab import DeviceLoop
from ..solvers.chebyshev import chebyshev_preconditioner
from ..solvers.ilu0 import ilu0_stencil_factorize
from ..solvers.multigrid import build_mg
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.graph import WhilePrimer, read_host
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
    # int and bool, or, from a solve that made no host read (the card's
    # one-launch solve), 0-d device tensors (int32, bool), as in JAX
    iterations: object
    relres: torch.Tensor  # on the device
    converged: object
    # flat 0-based cells of each function's (possibly moved) source voxels,
    # in function order, and the source values in the working dtype —
    # consumed by the src VTK writer
    src_cells: tuple
    src_values: tuple
    sync_s: float = 0.0   # host time blocked on the solver's (done, it) reads
    reads: int = 0        # the solve's host reads of (done, it)


# the overlapped writer's pinned snapshots in flight: at most _PIN_BYTES
# (one 256x256x64 float32 output is 101 MB, so 2 there; the JAX package's
# 16-deep queue would pin 1.6 GB) and at most _DEPTH (JAX's depth)
_PIN_BYTES = 256 << 20
_DEPTH = 16
# writer threads: one a core, at least the JAX package's 2 and at most 8
# (8 on the card's 8-core host).  On that host 8 and 4 threads were within
# each other's spread (PERF.md), 8 ahead in two runs of three; 2
# was slower; more than 8 was not measured
_WORKERS = max(2, min(8, os.cpu_count() or 2))


class _AsyncVtkWriter:
    """Overlapped VTK output, the counterpart of the JAX package's
    ``_AsyncVtkWriter`` (``eddy_currents_3d_tpu/sim/simulate.py:55-171``).

    Each output makes one device-to-host copy of A and the carry (stacked;
    bfloat16 widened to float32 on the device first, which is exact) into
    a pinned host buffer, non-blocking, and records an event after it; the
    writer threads wait on the event, then encode and write
    (``io/vtk.py`` ``write_outputs``) while the loop steps on.  The source
    cells and values are host data already (``Simulation._step``), so only
    the fields cross.  The copy runs on the stream that made the snapshot,
    the step's own: the caching allocator hands the snapshot's memory to
    no later kernel before the copy has read it, with no ``record_stream``,
    and the loop's thread makes no synchronizing call.  Buffers are reused
    once written, at most ``_PIN_BYTES`` of them; ``submit`` waits for one
    when all are in flight.  A worker's exception is re-raised at the next
    ``submit`` and at ``close``; a failed write is never dropped."""

    def __init__(self, sim, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        if native.enabled():
            native.get_lib()    # a failed build raises here, before a step
        self._sim = sim
        self._dir = output_dir
        self._cuda = sim.device.type == "cuda"
        self._dtype = (torch.float64 if sim.dtype == torch.float64
                       else torch.float32)
        self._shape = (2, 3) + tuple(sim.model.shape_zyx)
        nbytes = math.prod(self._shape) * self._dtype.itemsize
        self.depth = max(1, min(_DEPTH, _PIN_BYTES // nbytes))
        self._made = 0
        self._free: queue.Queue = queue.Queue()
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._ts = [threading.Thread(target=self._work, daemon=True)
                    for _ in range(_WORKERS)]
        for t in self._ts:
            t.start()

    def _buffer(self) -> torch.Tensor:
        """A free host buffer: a written one, a new one while fewer than
        ``depth`` exist, else the next one a worker frees."""
        try:
            return self._free.get_nowait()
        except queue.Empty:
            if self._made < self.depth:
                self._made += 1
                return torch.empty(self._shape, dtype=self._dtype,
                                   pin_memory=self._cuda)
            return self._free.get()

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            buf, ev, info, npoint = item
            try:
                if self._err is None:
                    if ev is not None:
                        ev.synchronize()
                    host = buf.numpy()
                    vtk.write_outputs(
                        self._sim, SimpleNamespace(A=host[0], carry=host[1]),
                        info, npoint, self._dir)
            except Exception as e:  # re-raised on submit/close
                self._err = e
            finally:
                self._free.put(buf)

    def submit(self, state: "SimState", info: "StepInfo", npoint: int) -> None:
        if self._err is not None:
            raise self._err
        buf = self._buffer()
        snap = torch.stack([state.A, state.carry]).to(self._dtype)
        buf.copy_(snap, non_blocking=self._cuda)
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._sim.device))
        self._q.put((buf, ev, info, npoint))

    def close(self) -> None:
        """Wait for every write; raise the first worker's exception."""
        for _ in self._ts:
            self._q.put(None)
        for t in self._ts:
            t.join()
        if self._err is not None:
            raise self._err


def _fields(state: SimState, f) -> SimState:
    """``state`` with ``f`` applied to each of its fields (not the host
    motion); ``state`` itself where ``f`` is None."""
    if f is None:
        return state
    return state._replace(
        A=f(state.A), U=f(state.U), carry=f(state.carry),
        prev=(State(f(state.prev.A), f(state.prev.U))
              if state.prev is not None else None))


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
    """End-to-end simulation of a :class:`Model` on ``device`` (None: the
    current CUDA device, and a ``RuntimeError`` without one), or, with
    ``mesh`` (:func:`~..parallel.mesh.make_mesh`), on this rank's (z, y)
    block of a mesh, on the mesh's device.

    ``use_pallas`` is the JAX package's keyword for the hand-written
    kernels (None: on at float32 and bfloat16, off at float64): off, the
    operator is the flat-roll tier of torch shifts, on any device.
    ``use_shard_map`` (None: on unless ``precond="mg"``) is the JAX
    package's choice between its explicit mesh tier and its GSPMD tier: off,
    the operator is the per-block field tier, never coded, and ``"mg"``
    (which needs it off) runs the V-cycle on the rank's block
    (``parallel/shard_mg.py``)."""

    def __init__(
        self,
        model: Model,
        dtype: torch.dtype = torch.float32,
        dot_dtype: Optional[torch.dtype] = None,
        *,
        device=None,
        mesh=None,
        system: Optional[AssembledSystem] = None,
        use_pallas: Optional[bool] = None,
        precond: Optional[str] = None,
        cheb_order: int = 4,
        cheb_ratio: float = 30.0,
        use_shard_map: Optional[bool] = None,
        coeff_dtype: Optional[torch.dtype] = None,
        warm_start: str = "extrapolate",
        use_coded: Optional[bool] = None,
    ):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device} but this rank's mesh "
                                 f"device is {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names torch's current CUDA device
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"device must be cpu or cuda, got {self.device}")
        if dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"dtype must be float32, bfloat16 or float64, "
                             f"got {dtype}")
        if dot_dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"dot_dtype must be None, float32 or float64, "
                             f"got {dot_dtype}")
        if coeff_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"coeff_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {coeff_dtype}")
        if precond not in (None, "cheb", "jacobi", "cheb_jacobi", "mg",
                           "ilu0"):
            raise ValueError(f"unknown preconditioner {precond!r}")
        if warm_start not in ("extrapolate", "previous"):
            raise ValueError(f"unknown warm_start {warm_start!r}")
        # the hand-written kernels for 2- and 4-byte dtypes (JAX
        # simulate.py:234-238); they take no float64
        no_pallas = use_pallas is False          # the caller's own choice
        if use_pallas is None:
            use_pallas = dtype.itemsize <= 4
        if use_pallas and dtype == torch.float64:
            raise ValueError("use_pallas=True needs float32 or bfloat16 "
                             "state: the hand-written kernels take no "
                             "float64")
        self.use_pallas = bool(use_pallas)
        if mesh is not None:
            # JAX simulate.py:249-250: the explicit tier unless "mg", whose
            # V-cycle takes the GSPMD tier; here both run on the rank's
            # block, "mg" and use_shard_map=False on the field tier
            if use_shard_map is None:
                use_shard_map = precond != "mg"
            if precond == "mg" and use_shard_map:
                raise ValueError(
                    "precond='mg' with use_shard_map=True: the explicit "
                    "tier's padded solver space cannot host the JAX "
                    "package's V-cycle; leave use_shard_map None or False")
            if precond == "ilu0":
                raise ValueError("precond='ilu0' is single-device only")
        self.mesh = mesh
        self.model = model
        self.dtype = dtype
        self.dot_dtype = dot_dtype
        self.warm_start = warm_start
        if system is None:
            # a mesh reads the host copies and cuts its own slabs: the
            # whole system stays on the CPU
            system = assemble_operator(
                model, dtype, "cpu" if mesh is not None else self.device)
        elif mesh is None and system.device != self.device:
            raise ValueError(f"system is on {system.device}, "
                             f"simulation on {self.device}")
        self.system = system
        if coeff_dtype is not None and coeff_dtype != self.system.op.dtype:
            # mixed precision: coefficient streams in coeff_dtype, state
            # and accumulation in dtype; the solved operator is A rounded
            # entrywise to coeff_dtype (JAX simulate.py:220: a coeff_dtype
            # equal to the system's casts nothing)
            self.system = dataclasses.replace(
                self.system, op=self.system.op.astype(coeff_dtype))
        self.coeff_dtype = coeff_dtype

        # tier choice (JAX simulate.py:230-309): the coded operator where it
        # applies, on one device or per slab of a z-only mesh; the field
        # tier for every other float32 or bfloat16 run, any coeff_dtype
        # included (JAX :252-253), on one device or per (z, y) block of a
        # mesh; the flat-roll operator without the kernels (float64,
        # use_pallas=False).  use_coded=None routes CodedUnsupported to
        # the field tier; an explicit use_coded=True never degrades.
        n_y = mesh.n_y if mesh is not None else 1
        gspmd = mesh is not None and not use_shard_map
        coded_ok = (self.use_pallas and dtype == torch.float32
                    and coeff_dtype is None and precond != "mg"
                    and not gspmd and n_y == 1)
        if use_coded and not coded_ok:
            why = ("use_pallas=False" if no_pallas
                   else f"coeff_dtype={coeff_dtype}" if coeff_dtype is not None
                   else "precond='mg'" if precond == "mg"
                   else "use_shard_map=False" if gspmd
                   else "mesh has a y decomposition" if n_y != 1
                   else f"dtype={dtype}")
            raise ValueError(
                f"use_coded=True is incompatible with {why}; the coded "
                "kernels require float32 state and coefficients (single "
                "device or a z-decomposed mesh)")
        self.coded_op = None
        if coded_ok and use_coded is not False and mesh is None:
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
                         if self.use_pallas and self.coded_op is None
                         and mesh is None else None)
        self.shard_op = None
        if mesh is not None and coded_ok and use_coded is not False:
            try:
                self.shard_op = ShardedStencilOperator(
                    self.system, mesh, dtype, use_pallas=True, model=model,
                    use_coded=True)
            except CodedUnsupported:
                if use_coded:
                    raise
        if mesh is not None and self.shard_op is None:
            self.shard_op = ShardedStencilOperator(
                self.system, mesh, dtype, use_pallas=self.use_pallas,
                coeff_dtype=coeff_dtype)
        # the single-device solver-space tier (None: the flat-roll operator,
        # and the mesh, whose fields are blocks throughout)
        self._tier = (self.coded_op if self.coded_op is not None
                      else self.field_op)
        self.op = next(o for o in (self.shard_op, self._tier, self.system.op)
                       if o is not None)
        # the step's masks, on this Simulation's device: the system's, or
        # on a mesh this rank's blocks
        sysm = self.system
        cut = (self.shard_op.shard if mesh is not None
               else lambda t: t)
        self._cond = cut(sysm.cond_mask).to(self.device)
        self._inert = cut(sysm.inert).to(self.device)
        self._bnd_a = cut(sysm.bnd_a).to(self.device)
        self._bnd_u_any = cut(sysm.bnd_u_any).to(self.device)
        self._shape = tuple(self._cond.shape)    # the step's (z, y, x)

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
            if self.shard_op is not None:
                d = self.shard_op.diagonal_padded()
            else:
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
            if mesh is None:
                self._mg = build_mg(op.ka, ku0=ku0, dtype=dtype,
                                    device=self.device,
                                    kernels=self.use_pallas)
            else:
                # the same hierarchy, its levels on the rank's block
                # (parallel/shard_mg.py)
                self._mg = build_shard_mg(op.ka, self.shard_op, ku0=ku0,
                                          dtype=dtype,
                                          kernels=self.use_pallas)
        if precond == "ilu0":
            # right-ILU(0) in stencil form: host factorization on the CSR
            # export, factors in the state dtype (under coeff_dtype too, as
            # JAX builds them from the float64 host copies), applied as
            # fixed Jacobi sweeps per triangle (JAX simulate.py:324-339)
            self._ilu = ilu0_stencil_factorize(
                self.system, model, dtype=dtype, device=self.device,
                field=self._tier is not None)
            self.ilu_sweeps = 2

        # the solve: one device loop per solver-space shape, made at its
        # first solve; on the card their CUDA graphs share one memory pool
        self._tol = torch.tensor(model.solver.tolerance, dtype=dtype,
                                 device=self.device)
        self._loops = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._primer = None   # utils/graph.py WhilePrimer, at the first run
        self._staged = []   # (event, pinned buffer) of copies in flight

        self.steps = _schedule(model.tran)
        self.n_steps = len(self.steps)
        nx, ny, nz = model.shape_xyz
        self._N = math.prod(self._shape)    # the step's cells
        self.flag_move = any(any(f.move) for f in model.functions)

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
                torch.from_numpy(self._own(cells)).to(self.device),
                FunctionMotion(index=idx, ijk0=ijk0, const_shift=const_shift,
                               vmech_index=fn.vmech_index,
                               shape_xyz=model.shape_xyz),
            ))

    # ------------------------------------------------------------------
    def _own(self, flat: np.ndarray) -> np.ndarray:
        """The step's flat indices of the global flat cells ``flat`` that
        lie in this Simulation's fields: all of them, or on a mesh those of
        this rank's block, in its own numbering."""
        if self.shard_op is None:
            return flat
        return self.shard_op.own(flat)

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

    def shard_state(self, state: SimState) -> SimState:
        """``state`` (global fields) as :meth:`_step` takes it: itself, or
        on a mesh this rank's slabs (no communication)."""
        return _fields(state, self.shard_op and self.shard_op.shard)

    def gather_state(self, state: SimState) -> SimState:
        """The global fields of a :meth:`_step` ``state``: itself, or on a
        mesh every rank's slabs joined, on every rank (all-gathers)."""
        return _fields(state, self.shard_op and self.shard_op.gather)

    def _cast(self, v: float) -> float:
        """A host float64 value rounded to the working dtype."""
        return float(torch.tensor(v, dtype=self.dtype))

    # ------------------------------------------------------------------
    def _solve_form(self) -> dict:
        """The operator, fused dots, preconditioner and right-Jacobi
        scaling of this Simulation's solve, as :class:`DeviceLoop` takes
        them (JAX simulate.py:560-636)."""
        apply_fn = self.op.apply
        coded = self.coded_op
        # the coded operator's fused dots are in its own float32 sums: only
        # for dot_dtype=None (JAX simulate.py:591-594, :627-629); the field
        # tier and float64's flat-roll operator run them apart
        fused = coded is not None and self.dot_dtype is None
        form = {"apply_fn": apply_fn}
        cheb = lambda op, lmax: chebyshev_preconditioner(
            op, self.cheb_order, lmax / self.cheb_ratio, lmax)
        if self.precond in ("jacobi", "cheb_jacobi"):
            # right-Jacobi in the solver space: (A D^-1) y = b, x = D^-1 y
            inv = self._jac[1]
            form["scale"] = self._jac
            if self.precond == "cheb_jacobi":
                form["minv"] = cheb(
                    lambda v: apply_fn(State(inv.A * v.A, inv.U * v.U)),
                    self._scaled_lmax)
            elif fused:
                form["mv_dot"] = coded.apply_dots
        elif self.precond == "cheb":
            form["minv"] = cheb(apply_fn, self.system.gershgorin * 1.01)
        elif self.precond == "mg":
            form["minv"] = self._mg.apply
        elif self.precond == "ilu0":
            # the factors act on the full grid, which is the solver space
            # here (compact_u=False on the coded route)
            ilu, sweeps = self._ilu, self.ilu_sweeps
            form["minv"] = lambda v: ilu.apply(v, sweeps=sweeps)
        elif fused:
            form["mv_dot"] = coded.apply_dots
        return form

    def _loop(self, b: State) -> DeviceLoop:
        """The device loop of this Simulation's solve configuration for
        the solver-space shape of ``b``, made at its first solve."""
        key = (tuple(b.A.shape), tuple(b.U.shape))
        if key not in self._loops:
            self._loops[key] = DeviceLoop(
                itmax=self.model.solver.itmax, dot_dtype=self.dot_dtype,
                pool=self._pool,
                reduce=self.mesh.all_reduce if self.mesh is not None else None,
                # NCCL's collectives between ranks cannot sit in a WHILE body
                batched=self.mesh is not None and self.mesh.size > 1,
                **self._solve_form())
        return self._loops[key]

    def _settle(self):
        """Count the launches of every solve not read yet
        (:meth:`DeviceLoop.settle`)."""
        for loop in self._loops.values():
            loop.settle()

    @staticmethod
    def _read_steps(infos):
        """([iterations], [converged]) of ``infos`` on the host, in one read
        where they are device tensors; the iterations go to the tracer's
        ``iterations`` counter."""
        if not infos or not isinstance(infos[0].iterations, torch.Tensor):
            its = [int(i.iterations) for i in infos]
            conv = [bool(i.converged) for i in infos]
        else:
            its = torch.stack([i.iterations for i in infos])
            conv = torch.stack([i.converged for i in infos]).to(its.dtype)
            its, conv = read_host(torch.stack([its, conv])).tolist()
            conv = [bool(c) for c in conv]
        trace.count("iterations", sum(its))
        return its, conv

    @property
    def captures(self) -> int:
        """CUDA graph captures of the solve programs so far (one per solve
        configuration)."""
        return sum(loop.captures for loop in self._loops.values())

    def _upload(self, flat: np.ndarray) -> torch.Tensor:
        """Host cell indices on the device without a synchronizing copy:
        through pinned memory with ``non_blocking=True``, each pinned
        buffer held until the event after its copy has passed."""
        idx = torch.from_numpy(flat.astype(np.int64))
        if self.device.type != "cuda":
            return idx
        pinned = idx.pin_memory()
        out = pinned.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._staged = [(e, p) for e, p in self._staged if not e.query()]
        self._staged.append((ev, pinned))
        return out

    def step_system(self, state: SimState, t: float) -> tuple[State, State]:
        """``(b, x0)``: the right-hand side and the warm start of the linear
        solve of the step at ``t`` from ``state``, in the step's layout
        (global fields, or on a mesh this rank's slabs).  With
        :meth:`solve` it lets a check hold a step's solution to the true
        residual ``||b - A x|| / ||b||``."""
        return self._rhs(state, t)[:2]

    def solve(self, b: State, x0: State, eager: bool = False,
              read: bool = True):
        """The step's BiCGSTABwr solve of ``A x = b`` from ``x0`` at the
        model's tolerance, with this Simulation's operator, preconditioner
        and device loop (:class:`~..solvers.bicgstab.SolveResult`, ``x`` in
        the step's layout, before the surface zeroing of the step).
        ``eager=True`` runs the per-iteration host loop (the solver's plain
        version); ``read=False``: see :meth:`DeviceLoop.solve`."""
        tier = self._tier
        if tier is not None:
            b, x0 = tier.pad_state(b), tier.pad_state(x0)
        loop = self._loop(b)
        with trace.span("solve", self.device, "interval"):
            res = (loop.reference(b, x0, self._tol) if eager
                   else loop.solve(b, x0, self._tol, read=read))
        if tier is not None:
            res = res._replace(x=tier.unpad_state(res.x))
        return res

    def _rhs(self, state: SimState, t: float):
        """(b, x0, rhs_A, motion, src_cells, src_values) of the step at
        ``t``: the source scatter and the right-hand side (EC3D.f90:275-
        408), and the warm start."""
        model = self.model
        cond = self._cond
        inert = self._inert
        bnd_a = self._bnd_a
        dt = float(model.tran.step)

        # ---- source scatter (EC3D.f90:275-367), function by function:
        # later functions overwrite earlier ones on shared cells ----
        base = torch.where(cond[None], state.carry, 0.0).reshape(3, self._N)
        motion = state.motion
        src_cells = []
        src_values = []
        filled = 0              # source cells filled, for the tracer
        if self.flag_move:
            # motion-velocity functions at time t (EC3D.f90:260-271)
            vmech_vals = np.array([vm(t) for vm in model.vmech], np.float64)
            movestop = motion.movestop
            dist_rows, comp_rows = [], []
            # every function's motion first, host only, under one span; then
            # the scatter in function order
            with trace.span("rhs.motion", self.device, "wait"):
                for *_, fm in self._funs:
                    drow, crow, movestop, flat = advance_function(
                        fm, motion.distance[fm.index], motion.comp[fm.index],
                        movestop, vmech_vals, dt, model.delta)
                    dist_rows.append(drow)
                    comp_rows.append(crow)
                    src_cells.append(flat)
            trace.count("motion.functions", len(src_cells))
            with trace.span("rhs.scatter"):
                for (comp, fn, *_), flat in zip(self._funs, src_cells):
                    val = self._cast(fn(t))
                    own = self._own(flat)
                    base[comp].index_fill_(0, self._upload(own), val)
                    filled += len(own)
                    src_values.append(val)
            motion = MotionState(distance=np.stack(dist_rows),
                                 movestop=movestop,
                                 comp=np.stack(comp_rows))
        else:
            with trace.span("rhs.scatter"):
                for comp, fn, cells_np, cells, _ in self._funs:
                    val = self._cast(fn(t))
                    base[comp].index_fill_(0, cells, val)
                    filled += len(cells)
                    src_cells.append(cells_np)
                    src_values.append(val)
        trace.count("scatter.cells", filled)

        rhs_A = base.reshape((3,) + self._shape) + inert[None] * state.A
        # the field tier has no apply_div: its RHS term is the assembled
        # operator's, as in the JAX package
        div_op = next(o for o in (self.shard_op, self.coded_op,
                                  self.system.op) if o is not None)
        rhs_U = div_op.apply_div(state.A)
        rhs_A = torch.where(bnd_a, 0.0, rhs_A)
        rhs_U = torch.where(self._bnd_u_any, 0.0, rhs_U)

        b = State(rhs_A, rhs_U)
        if self.warm_start == "extrapolate":
            # linear prediction from the last two solutions
            x0 = State(2.0 * state.A - state.prev.A,
                       2.0 * state.U - state.prev.U)
        else:
            x0 = State(state.A, state.U)
        return b, x0, rhs_A, motion, src_cells, src_values

    def _step(self, state: SimState, t: float,
              eager: bool = False) -> tuple[SimState, StepInfo]:
        """One time step.  ``eager=True`` solves with the per-iteration
        host loop (the solver's plain version) instead of the device loop,
        for checks against it.  On a mesh ``state``'s fields are this
        rank's slabs (:meth:`shard_state`), and so are the result's; the
        step exchanges ghost planes with the neighbour slabs and all-reduces
        the solver's dots, and gathers nothing."""
        cond = self._cond
        inert = self._inert
        bnd_a = self._bnd_a
        with trace.span("rhs"):
            b, x0, rhs_A, motion, src_cells, src_values = self._rhs(state, t)

        # ---- solve (EC3D.f90:408) ----
        # the device loop makes no host read: on the card the iterations
        # and convergence flag stay 0-d device tensors until a run reads
        # them all after its loop
        res = self.solve(b, x0, eager=eager, read=False)
        A_new, U_new = res.x.A, res.x.U

        # ---- post-solve inertial carry + surface zeroing (EC3D.f90:412-432)
        with trace.span("carry"):
            carry = torch.where(cond[None], inert[None] * A_new - rhs_A,
                                rhs_A)
            carry = torch.where(bnd_a, 0.0, carry)
            A_out = torch.where(bnd_a, 0.0, A_new)

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
            reads=res.reads,
        )
        return new_state, info

    # ------------------------------------------------------------------
    def _load_resume(self, checkpoint_dir, fingerprint):
        """Shared resume: newest checkpoint -> (state, start_index), with
        warm-start-history normalization to this run's mode."""
        from . import checkpoint as ckpt
        path = ckpt.latest_checkpoint(checkpoint_dir)
        if path is None:
            return None, 0
        state, start, _ = ckpt.load_checkpoint(path, fingerprint, self.dtype,
                                               self.device)
        # a pre-extrapolation checkpoint seeds prev = x (the first resumed
        # step starts from the previous solution, then extrapolation takes
        # over); "previous" mode drops any stored history
        if self.warm_start == "extrapolate" and state.prev is None:
            state = state._replace(prev=State(state.A, state.U))
        if self.warm_start == "previous" and state.prev is not None:
            state = state._replace(prev=None)
        return state, start

    def _start(self, initial_state, checkpoint_dir, resume):
        """(state, start step, fingerprint) of a run: the newest checkpoint
        under ``resume``, else ``initial_state``, else a cold start."""
        from . import checkpoint as ckpt

        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        start = 0
        state = initial_state
        fingerprint = None
        if checkpoint_dir is not None:
            fingerprint = ckpt.model_fingerprint(self.model)
            if resume:
                loaded, start = self._load_resume(checkpoint_dir, fingerprint)
                if loaded is not None:   # no checkpoint yet: keep
                    state = loaded       # initial_state (or cold start)
        if state is None:
            state = self.init_state()
        return state, start, fingerprint

    def _save_checkpoint(self, path, state, step_index, npoint, fingerprint):
        """Write ``state`` (the step's layout) as the checkpoint at
        ``path``.  On a mesh the first rank gathers the global fields and
        writes them, the same file one device writes, and every rank
        leaves once it is written, so that a resume on any rank finds it."""
        from . import checkpoint as ckpt

        sop = self.shard_op
        if sop is not None:
            state = _fields(state, sop.gather_first)
        if sop is None or self.mesh.rank == 0:
            ckpt.save_checkpoint(path, state, step_index, npoint, fingerprint)
        if sop is not None:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group)

    def _run_steps(self, steps, state, start, fingerprint, output_dir=None,
                   on_output=None, progress=False, checkpoint_dir=None,
                   checkpoint_every=0):
        """Steps ``start..len(steps)`` from ``state``, with the outputs
        (through :class:`_AsyncVtkWriter`), ``on_output`` calls, ticker and
        checkpoints of :meth:`run` (JAX simulate.py:939-985).  Returns
        (state, step infos, io seconds: the time the loop stayed blocked on
        outputs and checkpoints, and the writer's drain)."""
        every = checkpoint_every if checkpoint_dir is not None else 0
        infos = []
        t_io = 0.0
        last_ck = None
        if self.device.type == "cuda" and (self.mesh is None
                                           or self.mesh.size == 1):
            # a profiler session loses records of the first WHILE body it
            # sees run: let that be the primer's, not a solve's.  Made at
            # the first run, so that a session never sees its capture.
            if self._primer is None:
                self._primer = WhilePrimer(self.device)
            if torch.autograd.profiler._is_profiler_enabled:
                self._primer.launch()
        tick = max(len(self.steps) // 100, 1)
        mesh = self.shard_op
        state = self.shard_state(state)
        # on a mesh the first rank writes the files
        writer = (_AsyncVtkWriter(self, output_dir)
                  if output_dir is not None
                  and (mesh is None or self.mesh.rank == 0) else None)
        try:
            for idx in range(start, len(steps)):
                t, out = steps[idx]
                with trace.span("step", self.device, "interval", step=idx,
                                counts="steps"):
                    state, info = self._step(state, t)
                infos.append(info)
                if out is not None:
                    t1 = _time.perf_counter()
                    shown = state
                    if mesh is not None and on_output is not None:
                        shown = self.gather_state(state)     # every rank
                    elif mesh is not None and output_dir is not None:
                        # A and the carry on the first rank only
                        A, carry = (mesh.gather_first(state.A),
                                    mesh.gather_first(state.carry))
                        shown = state._replace(A=A, carry=carry)
                    if writer is not None:
                        writer.submit(shown, info, out)
                    if on_output is not None:
                        on_output(out, shown, info)
                    t_io += _time.perf_counter() - t1
                if every and (idx + 1) % every == 0:
                    t1 = _time.perf_counter()
                    self._save_checkpoint(
                        os.path.join(checkpoint_dir, f"ckpt_{idx + 1}.npz"),
                        state, idx + 1, out or 0, fingerprint)
                    last_ck = idx + 1
                    t_io += _time.perf_counter() - t1
                if progress and idx % tick == 0:
                    print(">", end="", flush=True)
        finally:
            if writer is not None:
                t1 = _time.perf_counter()
                writer.close()      # drain the writes in flight
                t_io += _time.perf_counter() - t1
        # final checkpoint only when steps actually ran this call (an
        # empty horizon, or resuming past num_steps, must neither crash on
        # steps[-1] nor write a checkpoint whose step index contradicts
        # the state it contains) and the loop didn't just write the
        # identical ckpt_<len>.npz itself
        if every and start < len(steps) and last_ck != len(steps):
            self._save_checkpoint(
                os.path.join(checkpoint_dir, f"ckpt_{len(steps)}.npz"),
                state, len(steps), steps[-1][1] or 0, fingerprint)
        # on a mesh the global fields, on every rank, once at the end
        return self.gather_state(state), infos, t_io

    def run_scan(self, num_steps: Optional[int] = None,
                 initial_state: Optional[SimState] = None,
                 output_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 resume: bool = False):
        """Run ``num_steps`` timesteps with no host round trip between
        outputs.

        The JAX package's ``run_scan`` is one ``lax.scan`` dispatch, or,
        where the backend has no host callbacks, its chunked path: one scan
        between consecutive outputs and checkpoints.  CUDA has no
        ``io_callback``, so this is the chunked path: a segment is the steps
        between two outputs, also cut at checkpoint boundaries, and inside
        it the host reads nothing (each solve is one graph launch whose
        counts stay on the device; every step's are read once, at the
        end).  With ``output_dir``, field_N.vtk / src_N.vtk are written at
        the jump cadence through the overlapped writer, as in :meth:`run`;
        the files equal :meth:`run`'s.  ``checkpoint_dir`` +
        ``checkpoint_every`` save ckpt_<step>.npz (as :meth:`run`), and
        ``resume=True`` continues from the newest one.

        Returns (final_state, JAX's stacked diagnostics: ``iterations``
        int32, ``relres`` in the solver's dtype, ``converged`` bool, each
        one entry per step run, ``start_step`` and ``io_s``).
        """
        with trace.span("run", transient=True):
            state, start, fingerprint = self._start(initial_state,
                                                    checkpoint_dir, resume)
            steps = self.steps if num_steps is None else self.steps[:num_steps]
            state, infos, t_io = self._run_steps(
                steps, state, start, fingerprint, output_dir,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
            # resuming at/after the last step leaves nothing to run; the
            # empty relres takes the state's dtype, as in JAX
            iters, conv = self._read_steps(infos)
            self._settle()
            rr = (torch.stack([i.relres for i in infos]) if infos
                  else torch.zeros((0,), dtype=self.dtype, device=self.device))
        return state, {"iterations": torch.tensor(iters, dtype=torch.int32),
                       "relres": rr,
                       "converged": torch.tensor(conv, dtype=torch.bool),
                       "start_step": start,
                       "io_s": t_io}

    def run(
        self,
        num_steps: Optional[int] = None,
        output_dir: Optional[str] = None,
        on_output: Optional[Callable] = None,
        progress: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        initial_state: Optional[SimState] = None,
    ):
        """Run the transient.

        * ``output_dir``: write field_N.vtk / src_N.vtk at the jump cadence
          through the overlapped writer (:class:`_AsyncVtkWriter`: one
          device-to-host copy of A and the carry per output, encoded and
          written on writer threads; a writer's error is raised here).
        * ``on_output(npoint, state, info)``: callback at each output point.
        * ``checkpoint_dir`` + ``checkpoint_every``: save ckpt_<step>.npz
          every N steps; ``resume=True`` continues from the newest one
          (validated against a model fingerprint).
        * ``progress``: the reference's 1%% ``>`` ticker (EC3D.f90:446-450).

        Returns (final_state, diagnostics dict with per-step iteration
        counts, the wall / io / solver-sync seconds, the host reads of the
        solves' (done, it), and the unconverged steps).
        """
        with trace.span("run", transient=True):
            state, start, fingerprint = self._start(initial_state,
                                                    checkpoint_dir, resume)
            steps = self.steps if num_steps is None else self.steps[:num_steps]
            t0 = _time.perf_counter()
            state, infos, t_io = self._run_steps(
                steps, state, start, fingerprint, output_dir, on_output,
                progress, checkpoint_dir, checkpoint_every)
            if self.device.type == "cuda":
                # wait for the last step on an event: a wait that
                # set_sync_debug_mode does not flag, so a run with outputs
                # can be held to no synchronizing call; with the tracer on
                # it anchors the run's timing events to the host clock
                done = torch.cuda.Event(enable_timing=trace.ON)
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
                trace.anchor(done)
            wall = _time.perf_counter() - t0

            # the per-step diagnostics, read once after the loop (JAX
            # simulate.py:987-988)
            iters, conv = self._read_steps(infos)
            self._settle()
            unconverged = [start + i for i, c in enumerate(conv) if not c]
            if unconverged:
                # the reference prints the residual norm on itmax overflow
                # and carries on (solvers.f90:25-27)
                print(f"WARNING: solver hit itmax without converging at "
                      f"{len(unconverged)} step(s), first at step "
                      f"{unconverged[0]}")
        return state, {
            "wall_s": wall,
            "io_s": t_io,
            "sync_s": sum(i.sync_s for i in infos),
            "steps": len(steps) - start,
            "start_step": start,
            "iterations": iters,
            "total_iterations": int(sum(iters)),
            "reads": [i.reads for i in infos],
            "unconverged_steps": unconverged,
        }
