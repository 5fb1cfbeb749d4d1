"""The explicit multi-device tier: per-block kernels with ghost exchange over
torch.distributed, on (z, y) blocks.

The PyTorch counterpart of ``eddy_currents_3d_tpu/parallel/shard_op.py``
``ShardedStencilOperator`` (:89).  The grid is cut into ``n_z x n_y``
blocks, one a rank of a :class:`~.mesh.Mesh`: z slabs, each cut into y
columns; x is never cut.  Each rank holds its block of every state field
and of the operator's data, in one of two tiers:

* the field tier (any mesh): its block of ``ka`` and its part of the
  conductor box's ``gu``, ``ku`` and ``da``;
* the coded tier (z-only meshes, float32; ``use_coded=True``, the JAX
  package's default there, :meth:`_init_coded`): its slab of the int32 case
  code, of the conductivity ``cf`` and, where a conductor moves, of the
  convection fields, encoded once on the host with the single-device
  encoder's bit-exact proof (``ops/coded.py`` ``from_assembled_coded``).

One apply is

1. post the exchange of the ghosts with the neighbour blocks, one message
   each way a neighbour (``batch_isend_irecv``): along z the +-1 planes of
   A and the +-2 planes of U (in the box window on the field tier; JAX
   ``_halo_a`` :559, :595-598); along y the +-1 rows of A and the +-2 rows
   of U in the box's x window (JAX :599-605).  No corner ghost: every term
   of the operator is along one axis;
2. the single-device kernels on the local block (:meth:`local_apply`): the
   bulk of the work, which needs no ghost.  The field tier runs
   ``field_a``/``field_u`` (``ops/field_cuda.py``), the coded tier
   ``coded_matvec`` (``ops/coded_cuda.py``) on a
   :class:`~..ops.coded.CodedStencilOperator` of the slab's shape; on the
   CPU their plain versions; at float64, or with ``use_pallas=False``, the
   field tier's plain versions anywhere, as the JAX package runs jnp shifts
   there;
3. wait for the ghosts and fold them into the block's faces
   (:meth:`fold`).

The A stencil's part of steps 1 and 3 is :func:`a_face` and :func:`fold_a`,
which the multigrid V-cycle's levels on the blocks share
(:func:`ghost_apply`, ``parallel/shard_mg.py``).

The kernels guard a neighbour beyond the block (or beyond the box, for
``field_u``) as zero and never clamp (``csrc/field_stencil.cu``,
``csrc/coded_matvec.cu``), so on the field tier step 3 is the pure ghost
adds of the JAX package's jnp backend (:634-649, :692-696, :714-715) along
z and along y: a coefficient times the received plane or row, with the
local coefficients left in place.  The JAX package's y-face coefficient
surgery (:193-226) exists for its Pallas tiling and is not needed; its
clamped-duplicate form (:620-633, :688-689) would subtract a duplicate the
kernels never added.  The coded kernel computes its coefficients from the
slab's own plane indices, so it takes the slab's first and last planes for
grid faces; :meth:`_init_coded` lists the corrections (JAX :265-489).  A
rank folds only the ghosts of the neighbours it has: at the grid's own
faces there is nothing to add.

Layout: z is padded to ``n_z * NZl`` planes, ``NZl = max(2, ceil(nz /
n_z))``, and y to ``n_y * NYl`` rows, ``NYl = max(2, ceil(ny / n_y))``
(``ny`` itself on z-only meshes), with inert planes and rows (zero
coefficients, so they stay zero through BiCGSTAB; JAX :119-125; the +-2 U
ghosts need two planes and two rows a block).  There is no lane or
sublane padding (TPU layout).  The field tier's box: its x window is the
assembled conductor box's, its z window spans the whole padded z (JAX
:44-47), and its y window is the part of the assembled box's rows that lies
in the rank's block, so a rank off the box in y holds no box at all.

Every field of a mesh run is the rank's padded block: the solver's
vectors, :meth:`apply`'s and :meth:`apply_div`'s arguments and results, and
the Jacobi diagonal (:meth:`diagonal_padded`).  :meth:`pad_state` cuts a
global state into this rank's block (no communication); :meth:`unpad_state`
joins the blocks of every rank into the global state (one all-gather a
field).  The solver's dots are per-rank partial sums all-reduced inside the
solve (:meth:`~.mesh.Mesh.all_reduce`, ``solvers/bicgstab.py`` ``reduce``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..assembly.stencil import State, shift
from ..ops.coded import (CodedStencilOperator, CodedUnsupported,
                         from_assembled_coded)
from ..ops.coded_cuda import coded_matvec
from ..ops.field import (FieldStencilOperator, _upcast, field_a_reference,
                         field_u_reference)
from ..ops.field_cuda import field_a, field_u
from .mesh import Mesh

__all__ = ["ShardedStencilOperator", "in_process_blocks", "handover_apply",
           "exchange", "a_face", "fold_a", "ghost_apply",
           "all_gather_blocks", "cut_block", "join_blocks"]

# z below, z above, y below, y above: the side a neighbour's ghost comes
# from, and the side that neighbour sends it on
_SIDES = ("lo", "hi", "ylo", "yhi")
OPPOSITE = {"lo": "hi", "hi": "lo", "ylo": "yhi", "yhi": "ylo"}


def _f32(v: float) -> float:
    """A host float64 value rounded once to float32 (JAX's per-plane
    scalars are float32 arrays)."""
    return float(np.float32(v))


def exchange(mesh: Mesh, make):
    """Start an exchange with the neighbour blocks of this rank's block of
    ``mesh``: to the one on each side the block has, send ``make(side)``
    (None: nothing on that side, which the neighbour knows too) and receive
    a tensor of its shape.  Returns (requests, {side: receive buffer})."""
    ops, recv = [], {}
    for side in _SIDES:
        peer = getattr(mesh, side)
        if peer is None:
            continue
        send = make(side)
        if send is None:
            continue
        recv[side] = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, peer, mesh.group))
        ops.append(dist.P2POp(dist.irecv, recv[side], peer, mesh.group))
    return (dist.batch_isend_irecv(ops) if ops else []), recv


def all_gather_blocks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's block ``t`` of ``mesh``, stacked in rank order (one
    all-gather), on every rank."""
    out = t.new_empty((mesh.size,) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=mesh.group)
    return out


def cut_block(t: torch.Tensor, start, extent) -> torch.Tensor:
    """The block of a global (..., Z, Y, X) tensor at ``start`` (z, y) of
    ``extent`` (bz, by) planes and rows, zero past the tensor's end."""
    (z0, y0), (bz, by) = start, extent
    out = t.new_zeros(t.shape[:-3] + (bz, by) + t.shape[-1:])
    src = t[..., z0:z0 + bz, y0:y0 + by, :]
    out[..., :src.shape[-3], :src.shape[-2], :] = src
    return out


def join_blocks(parts: torch.Tensor, n_z: int, n_y: int,
                shape_zyx) -> torch.Tensor:
    """The global (..., Z, Y, X) view of every block of an ``n_z x n_y``
    mesh, ``parts`` (n_z * n_y, ..., Bz, By, X) stacked in rank order: the
    blocks laid side by side, cropped to ``shape_zyx`` (the padding at the
    global end dropped)."""
    lead = tuple(parts.shape[1:-3])
    Bz, By, X = parts.shape[-3:]
    k = len(lead)
    t = parts.reshape((n_z, n_y) + lead + (Bz, By, X))
    t = t.permute(*range(2, 2 + k), 0, 2 + k, 1, 3 + k, 4 + k)
    t = t.reshape(lead + (n_z * Bz, n_y * By, X))
    return t[..., :shape_zyx[0], :shape_zyx[1], :shape_zyx[2]]


def a_face(A: torch.Tensor, side: str) -> torch.Tensor:
    """The A ghost this block sends to its neighbour on ``side``, flattened
    into one contiguous tensor: the plane (z) or row (y) of every leading
    field of ``A`` (..., Z, Y, X) nearest that neighbour."""
    dim = -3 if side in ("lo", "hi") else -2
    i = 0 if side in ("lo", "ylo") else A.shape[dim] - 1
    return A.select(dim, i).reshape(-1)


def fold_a(yA: torch.Tensor, ka: torch.Tensor, side: str,
           a: torch.Tensor) -> torch.Tensor:
    """Add into ``yA`` (..., Z, Y, X), in place, the 7-point stencil ``ka``'s
    term across the face on ``side``: the coefficient toward that neighbour
    on the face times ``a``, the neighbour's :func:`a_face` (pure adds of
    coefficient times ghost, JAX :574-578, :634-649).  Returns ``a`` viewed
    as the face."""
    z = side in ("lo", "hi")
    lo = side in ("lo", "ylo")
    dim = -3 if z else -2
    i = 0 if lo else yA.shape[dim] - 1
    o = (5 if lo else 6) if z else (3 if lo else 4)
    face = yA.select(dim, i)
    a = a.view(face.shape)
    face += _upcast(ka[o].select(dim, i)) * _upcast(a)
    return a


def ghost_apply(ka: torch.Tensor, x: torch.Tensor, local,
                post) -> torch.Tensor:
    """The 7-point stencils ``ka`` (nb, 7, Z, Y, X) of ``nb`` blocks of a
    mesh applied to ``x`` (nb, ..., Z, Y, X) across it: the exchange of the
    A ghosts (:func:`a_face`) started by ``post(x)``, ``local(ka, x)`` on
    each block alone (every neighbour beyond it read as zero), then the
    ghosts folded in (:func:`fold_a`).  ``post(x)`` returns a function that
    waits for the ghosts and gives each block's {side: ghost}: one block
    over :func:`exchange` on a rank, every block handed over in one process
    (``parallel/shard_mg.py``, whose V-cycle levels apply through this)."""
    wait = post(x)
    ys = [local(k, xi) for k, xi in zip(ka, x)]
    for k, y, ghosts in zip(ka, ys, wait()):
        for side, a in ghosts.items():
            fold_a(y, k, side, a)
    return ys[0][None] if len(ys) == 1 else torch.stack(ys)


class ShardedStencilOperator:
    """The operator on this rank's (z, y) block of a :class:`~.mesh.Mesh`,
    with coefficients in ``coeff_dtype`` (None: ``dtype``) for state in
    ``dtype``.  ``use_pallas`` (None: on for 2- and 4-byte dtypes) selects
    the hand-written kernels for the local apply; off, and at float64, the
    local apply is the field kernels' plain torch versions.
    ``use_coded=True`` (with ``model``; float32, ``use_pallas``, z-only
    meshes) runs the per-slab coded kernel instead of the field kernels."""

    def __init__(self, system, mesh: Mesh, dtype=torch.float32,
                 use_pallas=None, coeff_dtype=None, model=None,
                 use_coded: bool = False):
        if use_pallas is None:
            use_pallas = dtype.itemsize <= 4
        if use_pallas and dtype == torch.float64:
            raise ValueError("use_pallas=True needs float32 or bfloat16 "
                             "state: the field kernels take no float64")
        self.mesh = mesh
        self.n_z, self.n_y = mesh.n_z, mesh.n_y
        self.dtype = dtype
        self.coeff_dtype = coeff_dtype or dtype
        self.use_pallas = bool(use_pallas)
        self.use_coded = bool(use_coded)
        nz, ny, nx = (int(n) for n in system.shape_zyx)
        self.shape_zyx = (nz, ny, nx)
        # each block needs >= 2 planes and rows for the +-2 U ghosts to
        # stay nearest-neighbour (JAX :123-125)
        NZl = max(2, -(-nz // self.n_z))
        NYl = ny if self.n_y == 1 else max(2, -(-ny // self.n_y))
        self.NZl, self.NYl = NZl, NYl
        self.padded_zyx = (self.n_z * NZl, self.n_y * NYl, nx)
        self.block_zyx = (NZl, NYl, nx)
        self.z0 = mesh.index * NZl          # this block's first padded plane
        self.y0 = mesh.iy * NYl             # and first padded row
        self.device = mesh.device
        if self.use_coded:
            if self.n_y != 1:
                raise CodedUnsupported(
                    "the coded shard tier supports z-decomposed meshes only "
                    "(the mesh has a y decomposition)")
            if model is None:
                raise ValueError("use_coded=True requires model=")
            if not self.use_pallas:
                raise ValueError("use_coded=True runs the coded kernel: it "
                                 "needs use_pallas")
            self._init_coded(system, model)
            return
        # this rank's block of each host float64 field, then in coeff_dtype
        cut = lambda a: self.shard(torch.from_numpy(
            np.asarray(a, np.float64))).to(self.coeff_dtype)
        ka = cut(system.np_ka)
        box = system.op.box
        self.gbox = self.box = None
        if box is not None:
            _, _, y0, y1, x0, x1 = (int(b) for b in box)
            self.gbox = (y0, y1, x0, x1)
            ly0, ly1 = max(y0 - self.y0, 0), min(y1 - self.y0, NYl)
            if ly0 < ly1:
                self.box = (ly0, ly1, x0, x1)
        if self.box is None:
            self.local = FieldStencilOperator.without_box(ka, self.block_zyx)
        else:
            ly0, ly1, x0, x1 = self.box
            win = lambda a: self._cut(torch.from_numpy(np.asarray(
                a, np.float64)[..., x0:x1]), self.y0 + ly0,
                ly1 - ly0).to(self.coeff_dtype)
            self.local = FieldStencilOperator(
                ka, win(system.np_gu), win(system.np_ku), win(system.np_da),
                self.block_zyx, (0, NZl, ly0, ly1, x0, x1))

    # -- the coded tier ----------------------------------------------------
    def _init_coded(self, system, model):
        """The slab's case code, ``cf`` and convection fields, and what
        restores the global operator from the local coded kernel (JAX
        ``_init_coded`` :265-412).  The kernel classifies the slab's first
        and last planes as grid faces and reads nothing beyond them, so:

        * the closed-form A z-stencil differs from the true one by per-plane
          scalars (the slab's faces against the grid's): a few plane axpys
          in :meth:`local_apply`, on the slab's two face planes when ``nz``
          is a multiple of ``NZl``, and also around the grid's +z face where
          it lies mid-slab; the stencil's ghost-plane terms in :meth:`fold`;
        * the U-ladder, grad-U and div terms across the slab's faces were
          guarded to zero by the kernel: :meth:`fold` adds (true coefficient
          plane) x (ghost plane), the planes taken from the assembled
          ``np_gu``/``np_ku``/``np_da``, which the encoder has proven equal
          to its decode;
        * the convection pair's z terms across the faces, likewise;
        * the z-padding planes get closed-form A output (their coefficients
          are computed, not streamed): :meth:`fold` zeroes them again, so
          padded cells stay zero through BiCGSTAB.

        The Jacobi diagonal is host-built.  The slab's kernel runs on the
        whole-plane route with a full-shape U, its conducting run over the
        slab's planes whose code is not 0 (none on a slab off the
        conductor, whose planes all take the kernel's air runs)."""
        nz, ny, nx = self.shape_zyx
        NZl, z0 = self.NZl, self.z0
        dev = self.device
        coded = from_assembled_coded(system, model, "cpu", compact_u=False)
        code = self.shard(coded.code)
        live = torch.nonzero((code != 0).flatten(1).any(1)).flatten()
        cond_z = ((int(live.min()), int(live.max()) + 1) if len(live)
                  else (0, 0))
        self.local = CodedStencilOperator(
            code=code, cf=self.shard(coded.cf),
            conv=self.shard(coded.conv) if coded.has_conv else None,
            shape_zyx=(NZl, ny, nx), consts=coded.consts,
            inertia_on_faces=coded.inertia_on_faces, cond_z=cond_z,
            compact_u=False)
        self.gbox = self.box = None

        # ---- per-plane scalar deltas of the closed-form A z-stencil ----
        s, _, _, _, BND = coded.consts
        sz = s[2]
        t_czm = lambda g: 0.0 if g == 0 else (
            BND[2][0] * sz if g == nz - 1 else -sz)
        t_czp = lambda g: 0.0 if g == nz - 1 else (
            BND[2][1] * sz if g == 0 else -sz)
        t_dg = lambda g: sz if g in (0, nz - 1) else 2.0 * sz
        k_czm = lambda z: 0.0 if z == 0 else (
            BND[2][0] * sz if z == NZl - 1 else -sz)
        k_czp = lambda z: 0.0 if z == NZl - 1 else (
            BND[2][1] * sz if z == 0 else -sz)
        k_dg = lambda z: sz if z in (0, NZl - 1) else 2.0 * sz
        # (plane, d diag, d -z, d +z) where any differs; padding planes are
        # zeroed anyway
        self._zfix = []
        for zl in range(NZl):
            g = z0 + zl
            if g >= nz:
                break
            d = (_f32(t_dg(g) - k_dg(zl)),
                 _f32(t_czm(g) - k_czm(zl)) if zl > 0 else 0.0,
                 _f32(t_czp(g) - k_czp(zl)) if zl < NZl - 1 else 0.0)
            if any(d):
                self._zfix.append((zl,) + d)
        # the true coefficient of the ghost plane below and above
        self._czm0 = _f32(t_czm(z0)) if z0 < nz else 0.0
        gl = z0 + NZl - 1
        self._czpl = _f32(t_czp(gl)) if gl < nz else 0.0
        # the slab's planes from here on are padding
        self._pad0 = min(max(nz - z0, 0), NZl)

        # ---- the true U-ladder coefficient planes at the slab's faces ----
        gu, ku, da = system.np_gu, system.np_ku, system.np_da

        def plane(field, g):
            p = (field[g] if 0 <= g < nz else np.zeros((ny, nx)))
            return torch.from_numpy(np.asarray(p, np.float64)).to(
                dev, torch.float32)

        g0, g1 = z0, gl
        self._faces = {
            "g_m1": plane(gu[2, 1], g0), "g_m2a": plane(gu[2, 0], g0),
            "g_m2b": plane(gu[2, 0], g0 + 1),
            "g_p1": plane(gu[2, 3], g1), "g_p2a": plane(gu[2, 4], g1),
            "g_p2b": plane(gu[2, 4], g1 - 1),
            "k_m": plane(ku[5], g0), "k_p": plane(ku[6], g1),
            "d_m": plane(da[2, 0], g0), "d_p": plane(da[2, 2], g1),
        }

        # ---- the Jacobi diagonal, host-built (no coefficient stream lives
        # on the device in this tier) ----
        def one(a):
            t = self.shard(torch.from_numpy(np.asarray(a, np.float64)))
            return torch.where(t == 0, 1.0, t).to(self.dtype)

        ka0 = one(system.np_ka[0])
        self._diag = State(
            ka0[None].expand((3,) + tuple(ka0.shape)).contiguous(),
            one(ku[0]))

    # -- layout ------------------------------------------------------------
    def _cut(self, t: torch.Tensor, y0: int, rows: int) -> torch.Tensor:
        """This rank's ``NZl`` padded planes and the padded rows ``[y0, y0 +
        rows)`` of a global (..., nz, ny, X) tensor, in its own dtype, on
        the mesh's device (zero past the grid)."""
        return cut_block(t, (self.z0, y0), (self.NZl, rows)).to(self.device)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's padded block of a global (..., nz, ny, nx) tensor, in
        its own dtype, on the mesh's device."""
        return self._cut(t, self.y0, self.NYl)

    def own(self, flat: np.ndarray) -> np.ndarray:
        """The block's flat indices of the global flat cells ``flat`` that
        lie in this rank's block, in the block's own numbering."""
        _, ny, nx = self.shape_zyx
        z, r = np.divmod(flat, ny * nx)
        y, x = np.divmod(r, nx)
        z, y = z - self.z0, y - self.y0
        mine = (z >= 0) & (z < self.NZl) & (y >= 0) & (y < self.NYl)
        return ((z * self.NYl + y) * nx + x)[mine].astype(flat.dtype)

    def _join(self, parts):
        """The global tensor of every rank's block, ``parts`` in rank
        order."""
        return join_blocks(torch.stack(parts), self.n_z, self.n_y,
                           self.shape_zyx).contiguous()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global (..., nz, ny, nx) tensor of every rank's block ``t``:
        one all-gather, on every rank."""
        return join_blocks(all_gather_blocks(self.mesh, t), self.n_z,
                           self.n_y, self.shape_zyx).contiguous()

    def gather_first(self, t: torch.Tensor):
        """The global tensor of every rank's block ``t`` on the mesh's
        first rank (one gather to it), None on the others."""
        m = self.mesh
        group = m.group if m.group is not None else dist.group.WORLD
        parts = ([torch.empty_like(t) for _ in range(m.size)]
                 if m.rank == 0 else None)
        dist.gather(t.contiguous(), parts,
                    dst=dist.get_process_group_ranks(group)[0],
                    group=m.group)
        return None if parts is None else self._join(parts)

    def pad_state(self, x: State) -> State:
        """This rank's padded block of a global state (no communication)."""
        return State(self.shard(x.A), self.shard(x.U))

    def unpad_state(self, x: State) -> State:
        """The global state of every rank's block ``x`` (all-gathers)."""
        return State(self.gather(x.A), self.gather(x.U))

    # -- the ghost exchange ------------------------------------------------
    def message(self, x: State, side: str) -> torch.Tensor:
        """What this block sends to its neighbour on ``side`` ("lo"/"hi":
        the block below/above in z, "ylo"/"yhi": in y), flattened into one
        contiguous tensor: along z its A plane and its two U planes nearest
        that neighbour (in the box window on the field tier), along y its A
        row and its two U rows in the box's x window."""
        lo = side in ("lo", "ylo")
        # the k planes (rows) of t along dim nearest that neighbour
        face = lambda t, dim, k: t.narrow(dim, 0 if lo else t.shape[dim] - k,
                                          k)
        parts = [a_face(x.A, side)]
        if side in ("lo", "hi"):
            if self.use_coded:
                parts.append(face(x.U, 0, 2).reshape(-1))
            elif self.box is not None:
                ly0, ly1, x0, x1 = self.box
                parts.append(face(x.U, 0, 2)[:, ly0:ly1, x0:x1].reshape(-1))
        elif self.gbox is not None:
            _, _, x0, x1 = self.gbox
            parts.append(face(x.U, 1, 2)[..., x0:x1].reshape(-1))
        return torch.cat(parts)

    # -- the operator ------------------------------------------------------
    def local_apply(self, x: State):
        """(yA, yU): the kernels on this block alone, every neighbour beyond
        it taken as zero (the bulk of :meth:`apply`); on the coded tier
        with the z-stencil's per-plane deltas, which need no ghost."""
        op, A, U = self.local, x.A, x.U
        if self.use_coded:
            yA, yU = coded_matvec(op, A, U)
            for zl, dg, dm, dp in self._zfix:
                t = dg * A[:, zl]
                if dm:
                    t = t + dm * A[:, zl - 1]
                if dp:
                    t = t + dp * A[:, zl + 1]
                yA[:, zl] += t
            return yA, yU
        if op.box is None:
            yA = (field_a if self.use_pallas else field_a_reference)(op.ka, A)
            return yA, torch.zeros_like(U)
        if self.use_pallas:
            yA = field_a(op.ka, A)
            return yA, field_u(op, A, U, yA)
        yA = field_a_reference(op.ka, A)
        gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, A, U)
        ly0, ly1, x0, x1 = self.box
        yA[:, :, ly0:ly1, x0:x1] += gout
        yU = torch.zeros_like(U)
        yU[:, ly0:ly1, x0:x1] = uout
        return yA, yU

    def fold(self, yA, yU, ghosts: dict) -> None:
        """Add into this block's faces of (yA, yU), in place, the terms of
        the neighbours' ``ghosts`` ({side: that neighbour's :meth:`message`
        to this block}); on the coded tier then zero the padding planes."""
        if self.use_coded:
            self._fold_coded(yA, yU, ghosts)
            return
        op, f = self.local, _upcast
        NZl, NYl, nx = self.block_zyx
        for side, buf in ghosts.items():
            if side in ("lo", "hi"):
                self._fold_z(yA, yU, side, buf)
                continue
            # the A stencil's y neighbour across the face (JAX :574-578)
            nA = 3 * NZl * nx
            a = fold_a(yA, op.ka, side, buf[:nA])
            if self.box is None:
                continue
            ly0, ly1, x0, x1 = self.box
            # the box reaches this face only where its rows touch it; a box
            # face inside the block has zero coefficients across it
            if not (ly0 == 0 if side == "ylo" else ly1 == NYl):
                continue
            gu, ku, da = op.gu, op.ku, op.da
            u = f(buf[nA:].view(NZl, 2, x1 - x0))
            ay = f(a[1, :, x0:x1])
            gy = yA[1, :, ly0:ly1, x0:x1]
            # JAX :663-670
            if side == "ylo":
                # u: U at the rows y-2, y-1 below the block
                gy[:, 0] += (f(gu[1, 1, :, 0]) * u[:, 1]
                             + f(gu[1, 0, :, 0]) * u[:, 0])
                gy[:, 1] += f(gu[1, 0, :, 1]) * u[:, 1]
                yU[:, 0, x0:x1] += (f(ku[3, :, 0]) * u[:, 1]
                                    + f(da[1, 0, :, 0]) * ay)
            else:
                # u: U at the rows y+1, y+2 above the block
                gy[:, -1] += (f(gu[1, 3, :, -1]) * u[:, 0]
                              + f(gu[1, 4, :, -1]) * u[:, 1])
                gy[:, -2] += f(gu[1, 4, :, -2]) * u[:, 0]
                yU[:, -1, x0:x1] += (f(ku[4, :, -1]) * u[:, 0]
                                     + f(da[1, 2, :, -1]) * ay)

    def _fold_z(self, yA, yU, side, buf):
        """The field tier's z ghosts: pure adds of coefficient times ghost
        plane (JAX :634-649, :692-696)."""
        op, f = self.local, _upcast
        # the A stencil's z neighbour across the face
        nA = yA[:, 0].numel()
        a = fold_a(yA, op.ka, side, buf[:nA])
        if self.box is None:
            return
        ly0, ly1, x0, x1 = self.box
        gu, ku, da = op.gu, op.ku, op.da
        u = f(buf[nA:].view(2, ly1 - ly0, x1 - x0))
        az = f(a[2, ly0:ly1, x0:x1])
        gz = yA[2, :, ly0:ly1, x0:x1]
        if side == "lo":
            # u: U at the planes z-2, z-1 below the slab
            gz[0] += f(gu[2, 1, 0]) * u[1] + f(gu[2, 0, 0]) * u[0]
            gz[1] += f(gu[2, 0, 1]) * u[1]
            yU[0, ly0:ly1, x0:x1] += (f(ku[5, 0]) * u[1]
                                      + f(da[2, 0, 0]) * az)
        else:
            # u: U at the planes z+1, z+2 above the slab
            gz[-1] += f(gu[2, 3, -1]) * u[0] + f(gu[2, 4, -1]) * u[1]
            gz[-2] += f(gu[2, 4, -2]) * u[0]
            yU[-1, ly0:ly1, x0:x1] += (f(ku[6, -1]) * u[0]
                                       + f(da[2, 2, -1]) * az)

    def _fold_coded(self, yA, yU, ghosts):
        """The coded tier's ghost adds and padding re-zeroing (JAX
        :459-488)."""
        F, conv = self._faces, self.local.conv
        nA = yA[:, 0].numel()
        for side, buf in ghosts.items():
            a = buf[:nA].view(yA.shape[0], *yA.shape[2:])
            u = buf[nA:].view(2, *yA.shape[2:])
            if side == "lo":
                # a: A at z-1; u: U at z-2, z-1
                yA[:, 0] += self._czm0 * a
                yA[2, 0] += F["g_m1"] * u[1] + F["g_m2a"] * u[0]
                yA[2, 1] += F["g_m2b"] * u[1]
                yU[0] += F["k_m"] * u[1] + F["d_m"] * a[2]
                if conv is not None:
                    yA[:, 0] -= conv[2, 0] * a
            else:
                # a: A at z+1; u: U at z+1, z+2
                yA[:, -1] += self._czpl * a
                yA[2, -1] += F["g_p1"] * u[0] + F["g_p2a"] * u[1]
                yA[2, -2] += F["g_p2b"] * u[0]
                yU[-1] += F["k_p"] * u[0] + F["d_p"] * a[2]
                if conv is not None:
                    yA[:, -1] += conv[2, -1] * a
        if self._pad0 < self.NZl:
            yA[:, self._pad0:] = 0.0
            yU[self._pad0:] = 0.0

    def apply(self, x: State) -> State:
        """y = A @ x on this rank's block: the ghost exchange posted, the
        local kernels, then the ghosts folded in."""
        reqs, recv = exchange(self.mesh,
                              lambda side: self.message(x, side))
        yA, yU = self.local_apply(x)
        for r in reqs:
            r.wait()
        self.fold(yA, yU, recv)
        return State(yA, yU)

    def apply_div(self, A: torch.Tensor) -> torch.Tensor:
        """The U rows' div(dA/dt) contraction on this rank's block of A (the
        per-step right-hand-side term, EC3D.f90:385-392; JAX ``_local_div``
        :699-722, and on the coded tier the coded kernel with U = 0,
        :527-536), in the state's arithmetic as the single-device
        operator's ``apply_div``: the exchange of A's ghosts posted, the
        local contraction, then the ghosts folded in, as :meth:`apply`."""
        reqs, recv = exchange(self.mesh,
                              lambda side: self.div_message(A, side))
        yU = self.local_div(A)
        for r in reqs:
            r.wait()
        self.fold_div(yU, recv)
        return yU

    def div_message(self, A: torch.Tensor, side: str):
        """What this block sends to its neighbour on ``side`` for
        :meth:`apply_div` (None: nothing, which the neighbour knows too):
        along z A_z's plane nearest it (in the box window on the field
        tier), along y A_y's row in the box's x window."""
        lo = side in ("lo", "ylo")
        if self.use_coded:
            return A[2, 0 if lo else -1].contiguous()
        if self.gbox is None:
            return None
        _, _, x0, x1 = self.gbox
        if side in ("lo", "hi"):
            # z neighbours share this block's box rows
            if self.box is None:
                return None
            ly0, ly1 = self.box[:2]
            return A[2, 0 if lo else -1, ly0:ly1, x0:x1].contiguous()
        # y neighbours trade A_y's rows whether or not they hold box rows,
        # so that both ends of an exchange post it
        return A[1, :, 0 if lo else -1, x0:x1].contiguous()

    def local_div(self, A: torch.Tensor) -> torch.Tensor:
        """:meth:`apply_div` on this block alone, every neighbour beyond it
        taken as zero."""
        if self.use_coded:
            # the slab's coded kernel with U = 0 emits the da contraction
            return coded_matvec(self.local, A)
        yU = torch.zeros(self.block_zyx, dtype=A.dtype, device=A.device)
        if self.box is None:
            return yU
        ly0, ly1, x0, x1 = self.box
        da = self.local.da
        Ab = A[:, :, ly0:ly1, x0:x1]
        yb = torch.zeros(Ab.shape[1:], dtype=A.dtype, device=A.device)
        for c in range(3):
            yb = (yb + da[c, 1] * Ab[c] + da[c, 0] * shift(Ab[c], c, -1)
                  + da[c, 2] * shift(Ab[c], c, +1))
        yU[:, ly0:ly1, x0:x1] = yb
        return yU

    def fold_div(self, yU: torch.Tensor, ghosts: dict) -> None:
        """Add the terms of the neighbours' :meth:`div_message` ``ghosts``
        into this block's faces of ``yU``, in place (JAX :716-720)."""
        if self.use_coded:
            F = self._faces
            if "lo" in ghosts:
                yU[0] += F["d_m"] * ghosts["lo"]
            if "hi" in ghosts:
                yU[-1] += F["d_p"] * ghosts["hi"]
            if self._pad0 < self.NZl:
                yU[self._pad0:] = 0.0
            return
        if self.box is None:
            return
        ly0, ly1, x0, x1 = self.box
        da = self.local.da
        yb = yU[:, ly0:ly1, x0:x1]
        if "lo" in ghosts:
            yb[0] += da[2, 0, 0] * ghosts["lo"]
        if "hi" in ghosts:
            yb[-1] += da[2, 2, -1] * ghosts["hi"]
        # the box reaches a y face only where its rows touch it
        if "ylo" in ghosts and ly0 == 0:
            yb[:, 0] += da[1, 0, :, 0] * ghosts["ylo"]
        if "yhi" in ghosts and ly1 == self.NYl:
            yb[:, -1] += da[1, 2, :, -1] * ghosts["yhi"]

    def diagonal_padded(self) -> State:
        """The operator's diagonal on this rank's block, in the state's
        dtype (1 on padded and non-U cells): right-Jacobi's scaling (JAX
        :724-740)."""
        if self.use_coded:
            return self._diag
        dt = self.dtype
        ka0 = self.local.ka[0].to(dt)
        one = torch.ones((), dtype=dt, device=self.device)
        dA = torch.where(ka0 == 0, one, ka0)[None].expand(
            (3,) + tuple(ka0.shape)).contiguous()
        dU = torch.ones(ka0.shape, dtype=dt, device=self.device)
        if self.box is not None:
            ly0, ly1, x0, x1 = self.box
            ku0 = self.local.ku[0].to(dt)
            dU[:, ly0:ly1, x0:x1] = torch.where(ku0 == 0, one, ku0)
        return State(dA, dU)


# -- every block of a mesh in one process ----------------------------------

def in_process_blocks(system, n_z: int, n_y: int = 1, dtype=torch.float32,
                      device="cpu", **kw):
    """The sharded operators of every block of an ``n_z x n_y`` mesh, in
    rank order, in one process and with no process group: each block's
    :class:`~.mesh.Mesh` names its neighbours by their place in the list.
    For checks of the per-block kernels and folds against the global
    operator (:func:`handover_apply`); ``kw`` goes to each
    :class:`ShardedStencilOperator`."""
    out = []
    for r in range(n_z * n_y):
        iz, iy = divmod(r, n_y)
        mesh = Mesh(n_z=n_z, index=iz, device=torch.device(device),
                    lo=r - n_y if iz > 0 else None,
                    hi=r + n_y if iz + 1 < n_z else None, n_y=n_y, iy=iy,
                    ylo=r - 1 if iy > 0 else None,
                    yhi=r + 1 if iy + 1 < n_y else None)
        out.append(ShardedStencilOperator(system, mesh, dtype, **kw))
    return out


def handover_apply(sops, x: State, blocks_out: bool = False):
    """The sharded apply of the global state ``x`` over
    :func:`in_process_blocks`' ``sops``, each block's ghosts taken straight
    from its neighbours' :meth:`~ShardedStencilOperator.message`: the
    global (yA, yU), or with ``blocks_out`` every block's."""
    xs = [s.pad_state(x) for s in sops]
    ys = [s.local_apply(xi) for s, xi in zip(sops, xs)]
    for s, (yA, yU) in zip(sops, ys):
        ghosts = {}
        for side, back in OPPOSITE.items():
            peer = getattr(s.mesh, side)
            if peer is not None:
                ghosts[side] = sops[peer].message(xs[peer], back)
        s.fold(yA, yU, ghosts)
    if blocks_out:
        return ys
    return (sops[0]._join([y[0] for y in ys]),
            sops[0]._join([y[1] for y in ys]))
