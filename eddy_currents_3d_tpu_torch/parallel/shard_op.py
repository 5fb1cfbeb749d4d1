"""The multi-device tier on z slabs: per-shard field kernels with ghost-plane
exchange over torch.distributed.

The PyTorch counterpart of ``eddy_currents_3d_tpu/parallel/shard_op.py``
``ShardedStencilOperator`` (:89) on z-only meshes, field tier.  The grid is
cut into z slabs, one a rank of a :class:`~.mesh.Mesh`; each rank holds its
slab of ``ka`` and of the conductor box's ``gu``, ``ku`` and ``da``, and of
every state field.  One apply is

1. post the exchange of the ghost planes with the neighbour slabs: the
   +-1 planes of A and the +-2 planes of U in the box window (JAX
   ``_halo_a`` :559, :595-596), as ``isend``/``irecv`` pairs
   (``batch_isend_irecv``), one message each way a neighbour;
2. the single-device field kernels on the local slab (``ops/field_cuda.py``:
   the hand-written kernels on the card, their plain versions on the CPU;
   at float64, or with ``use_pallas=False``, the plain versions anywhere,
   as the JAX package runs jnp shifts there): the bulk of the work, which
   needs no ghost;
3. wait for the ghosts and fold them into the slab's face planes.

The kernels guard a neighbour beyond the slab as zero and never clamp
(``csrc/field_stencil.cu``), so step 3 is the pure ghost adds of the JAX
package's jnp backend (:634-649, :692-696, :714-715): a coefficient times
the received plane.  The Pallas backend's clamped-duplicate form
(:620-633, :688-689) would subtract a duplicate plane the kernels never
added.  A rank folds only the ghosts of the neighbours it has: at the
grid's own faces there is nothing to add.

Layout: z is padded to ``n_z * max(2, ceil(nz / n_z))`` planes with inert
planes (zero coefficients, so they stay zero through BiCGSTAB; JAX
:119-125), each rank holding ``NZl = NZp / n_z`` of them.  There is no lane
or sublane padding (TPU layout).  The box's (y, x) window is the assembled
conductor box's; its z window spans the whole padded z (JAX :44-47), so
every slab holds ``NZl`` box planes and the box fields stay per-slab
rectangles.

Every field of a mesh run is the rank's padded slab: the solver's vectors,
:meth:`apply`'s and :meth:`apply_div`'s arguments and results, and the
Jacobi diagonal (:meth:`diagonal_padded`).  :meth:`pad_state` cuts a global
state into this rank's slab (no communication); :meth:`unpad_state` joins
the slabs of every rank into the global state (one all-gather).  The
solver's dots are per-rank partial sums all-reduced inside the solve
(:meth:`~.mesh.Mesh.all_reduce`, ``solvers/bicgstab.py`` ``reduce``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..assembly.stencil import State, shift
from ..ops.field import (FieldStencilOperator, _upcast, field_a_reference,
                         field_u_reference)
from ..ops.field_cuda import field_a, field_u
from .mesh import Mesh

__all__ = ["ShardedStencilOperator"]


class ShardedStencilOperator:
    """The operator on this rank's z slab of a :class:`~.mesh.Mesh`, with
    coefficients in ``coeff_dtype`` (None: ``dtype``) for state in
    ``dtype``.  ``use_pallas`` (None: on for 2- and 4-byte dtypes) selects
    the hand-written field kernels for the local apply; off, and at
    float64, the local apply is their plain torch versions."""

    def __init__(self, system, mesh: Mesh, dtype=torch.float32,
                 use_pallas=None, coeff_dtype=None):
        if use_pallas is None:
            use_pallas = dtype.itemsize <= 4
        if use_pallas and dtype == torch.float64:
            raise ValueError("use_pallas=True needs float32 or bfloat16 "
                             "state: the field kernels take no float64")
        self.mesh = mesh
        self.n_z = mesh.n_z
        self.dtype = dtype
        self.coeff_dtype = coeff_dtype or dtype
        self.use_pallas = bool(use_pallas)
        nz, ny, nx = (int(n) for n in system.shape_zyx)
        self.shape_zyx = (nz, ny, nx)
        # each slab needs >= 2 planes for the +-2 U ghosts to stay
        # nearest-neighbour (JAX :123-125)
        NZl = max(2, -(-nz // self.n_z))
        self.padded_zyx = (self.n_z * NZl, ny, nx)
        self.NZl = NZl
        self.z0 = mesh.index * NZl          # this slab's first padded plane
        self.device = mesh.device
        # this rank's slab of each host float64 field, then in coeff_dtype
        cut = lambda a: self.shard(torch.from_numpy(
            np.asarray(a, np.float64))).to(self.coeff_dtype)
        ka = cut(system.np_ka)
        box = system.op.box
        if box is None:
            self.box = None
            self.local = FieldStencilOperator.without_box(ka, (NZl, ny, nx))
        else:
            _, _, y0, y1, x0, x1 = (int(b) for b in box)
            win = lambda a: cut(a[..., :, y0:y1, x0:x1])
            self.box = (y0, y1, x0, x1)
            self.local = FieldStencilOperator(
                ka, win(system.np_gu), win(system.np_ku), win(system.np_da),
                (NZl, ny, nx), (0, NZl, y0, y1, x0, x1))

    # -- layout ------------------------------------------------------------
    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's padded slab of a global (..., nz, ny, nx) tensor, in
        its own dtype, on the mesh's device."""
        nz = self.shape_zyx[0]
        hi = min(self.z0 + self.NZl, nz)
        out = torch.zeros(t.shape[:-3] + (self.NZl,) + t.shape[-2:],
                          dtype=t.dtype, device=self.device)
        if hi > self.z0:
            out[..., :hi - self.z0, :, :] = t[..., self.z0:hi, :, :]
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global (..., nz, ny, nx) tensor of every rank's slab ``t``
        (..., NZl, ny, nx): one all-gather, on every rank."""
        parts = [torch.empty_like(t) for _ in range(self.n_z)]
        dist.all_gather(parts, t.contiguous(), group=self.mesh.group)
        full = torch.cat(parts, dim=-3)
        return full[..., :self.shape_zyx[0], :, :].contiguous()

    def gather_first(self, t: torch.Tensor):
        """The global tensor of every rank's slab ``t`` on the mesh's
        first rank (one gather to it), None on the others."""
        m = self.mesh
        group = m.group if m.group is not None else dist.group.WORLD
        parts = ([torch.empty_like(t) for _ in range(self.n_z)]
                 if m.index == 0 else None)
        dist.gather(t.contiguous(), parts,
                    dst=dist.get_process_group_ranks(group)[0],
                    group=m.group)
        if parts is None:
            return None
        full = torch.cat(parts, dim=-3)
        return full[..., :self.shape_zyx[0], :, :].contiguous()

    def pad_state(self, x: State) -> State:
        """This rank's padded slab of a global state (no communication)."""
        return State(self.shard(x.A), self.shard(x.U))

    def unpad_state(self, x: State) -> State:
        """The global state of every rank's slab ``x`` (all-gathers)."""
        return State(self.gather(x.A), self.gather(x.U))

    # -- the ghost exchange ------------------------------------------------
    def message(self, x: State, side: str) -> torch.Tensor:
        """What this slab sends to its neighbour on ``side`` ("lo": the slab
        below, "hi": the one above): its A plane and its two U box planes
        nearest that neighbour, flattened into one contiguous tensor."""
        a, u = (0, slice(0, 2)) if side == "lo" else (-1, slice(-2, None))
        parts = [x.A[:, a].reshape(-1)]
        if self.box is not None:
            y0, y1, x0, x1 = self.box
            parts.append(x.U[u, y0:y1, x0:x1].reshape(-1))
        return torch.cat(parts)

    def _exchange(self, make):
        """Start an exchange with the neighbour slabs: to the one on each
        side this slab has, send ``make(side)`` and receive a tensor of its
        shape.  Returns (requests, {side: receive buffer})."""
        m = self.mesh
        ops, recv = [], {}
        for side, peer in (("lo", m.lo), ("hi", m.hi)):
            if peer is None:
                continue
            send = make(side)
            recv[side] = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send, peer, m.group))
            ops.append(dist.P2POp(dist.irecv, recv[side], peer, m.group))
        return (dist.batch_isend_irecv(ops) if ops else []), recv

    # -- the operator ------------------------------------------------------
    def local_apply(self, x: State):
        """(yA, yU): the field kernels on this slab alone, every neighbour
        beyond it taken as zero (the bulk of :meth:`apply`)."""
        op, A, U = self.local, x.A, x.U
        if op.box is None:
            yA = (field_a if self.use_pallas else field_a_reference)(op.ka, A)
            return yA, torch.zeros_like(U)
        if self.use_pallas:
            yA = field_a(op.ka, A)
            return yA, field_u(op, A, U, yA)
        yA = field_a_reference(op.ka, A)
        gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, A, U)
        y0, y1, x0, x1 = self.box
        yA[:, :, y0:y1, x0:x1] += gout
        yU = torch.zeros_like(U)
        yU[:, y0:y1, x0:x1] = uout
        return yA, yU

    def fold(self, yA, yU, ghosts: dict) -> None:
        """Add into this slab's face planes of (yA, yU), in place, the terms
        of the neighbours' ``ghosts`` ({side: that neighbour's
        :meth:`message` to this slab}): pure adds of coefficient times
        ghost plane (JAX :634-649, :692-696)."""
        op, f = self.local, _upcast
        nA = yA[:, 0].numel()
        for side, buf in ghosts.items():
            a = buf[:nA].view(yA.shape[0], *yA.shape[2:])
            # the A stencil's z neighbour across the face
            p, o = (0, 5) if side == "lo" else (-1, 6)
            yA[:, p] += f(op.ka[o, p]) * f(a)
            if self.box is None:
                continue
            y0, y1, x0, x1 = self.box
            gu, ku, da = op.gu, op.ku, op.da
            u = f(buf[nA:].view(2, y1 - y0, x1 - x0))
            az = f(a[2, y0:y1, x0:x1])
            gz = yA[2, :, y0:y1, x0:x1]
            if side == "lo":
                # u: U at the planes z-2, z-1 below the slab
                gz[0] += f(gu[2, 1, 0]) * u[1] + f(gu[2, 0, 0]) * u[0]
                gz[1] += f(gu[2, 0, 1]) * u[1]
                yU[0, y0:y1, x0:x1] += (f(ku[5, 0]) * u[1]
                                        + f(da[2, 0, 0]) * az)
            else:
                # u: U at the planes z+1, z+2 above the slab
                gz[-1] += f(gu[2, 3, -1]) * u[0] + f(gu[2, 4, -1]) * u[1]
                gz[-2] += f(gu[2, 4, -2]) * u[0]
                yU[-1, y0:y1, x0:x1] += (f(ku[6, -1]) * u[0]
                                         + f(da[2, 2, -1]) * az)

    def apply(self, x: State) -> State:
        """y = A @ x on this rank's slab: the ghost exchange posted, the
        local field kernels, then the ghosts folded in."""
        reqs, recv = self._exchange(lambda side: self.message(x, side))
        yA, yU = self.local_apply(x)
        for r in reqs:
            r.wait()
        self.fold(yA, yU, recv)
        return State(yA, yU)

    def apply_div(self, A: torch.Tensor) -> torch.Tensor:
        """The U rows' div(dA/dt) contraction on this rank's slab of A (the
        per-step right-hand-side term, EC3D.f90:385-392; JAX
        ``_local_div`` :699-722), in the state's arithmetic as the
        single-device flat-roll operator's ``apply_div``."""
        yU = torch.zeros(A.shape[1:], dtype=A.dtype, device=A.device)
        if self.box is None:
            return yU
        y0, y1, x0, x1 = self.box
        # A_z's box plane nearest each neighbour
        reqs, recv = self._exchange(lambda side: A[
            2, 0 if side == "lo" else -1, y0:y1, x0:x1].contiguous())
        da = self.local.da
        Ab = A[:, :, y0:y1, x0:x1]
        yb = torch.zeros(Ab.shape[1:], dtype=A.dtype, device=A.device)
        for c in range(3):
            yb = (yb + da[c, 1] * Ab[c] + da[c, 0] * shift(Ab[c], c, -1)
                  + da[c, 2] * shift(Ab[c], c, +1))
        for r in reqs:
            r.wait()
        if "lo" in recv:
            yb[0] += da[2, 0, 0] * recv["lo"]
        if "hi" in recv:
            yb[-1] += da[2, 2, -1] * recv["hi"]
        yU[:, y0:y1, x0:x1] = yb
        return yU

    def diagonal_padded(self) -> State:
        """The operator's diagonal on this rank's slab, in the state's dtype
        (1 on padded and non-U cells): right-Jacobi's scaling (JAX
        :724-740)."""
        dt = self.dtype
        ka0 = self.local.ka[0].to(dt)
        one = torch.ones((), dtype=dt, device=self.device)
        dA = torch.where(ka0 == 0, one, ka0)[None].expand(
            (3,) + tuple(ka0.shape)).contiguous()
        dU = torch.ones(ka0.shape, dtype=dt, device=self.device)
        if self.box is not None:
            y0, y1, x0, x1 = self.box
            ku0 = self.local.ku[0].to(dt)
            dU[:, y0:y1, x0:x1] = torch.where(ku0 == 0, one, ku0)
        return State(dA, dU)
