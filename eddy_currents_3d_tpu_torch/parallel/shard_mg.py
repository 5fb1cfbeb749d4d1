"""The multigrid V-cycle on a (z, y) mesh: the levels on the rank's block.

The counterpart of the JAX package's GSPMD tier under ``precond="mg"``
(``eddy_currents_3d_tpu/sim/simulate.py:340-356``, :428-437), where XLA's
partitioner shards the unmodified V-cycle of ``solvers/multigrid.py``
(:170-198), turning its rolls into halo permutes and its sums into
all-reduces.  torch has no partitioner, so this module runs the same math
on the blocks of ``parallel/shard_op.py`` with the halos that tier already
moves:

* **The hierarchy is the JAX package's.**  :func:`~..solvers.multigrid.
  hierarchy` coarsens the global host float64 coefficients; the level count
  comes from the global, unpadded shapes.  Each rank cuts its block of each
  level it holds (``ka`` and ``1/diag``).  The shard tier pads z to
  ``n_z * NZl`` and y to ``n_y * NYl`` at the global end, so coarse cell
  ``c`` of a block still holds global fine cells ``2c`` and ``2c + 1``, as
  in JAX's ``galerkin_coarsen``/``_restrict`` (:94, :131): a level zero-
  extended to the padded extent is the JAX level, and the padding cells
  have zero coefficients and a zero right-hand side.  The prolongation is
  cropped to the JAX level's cells, as JAX crops it, so they stay zero.
* **Distributed levels.**  While the block's extent along every cut axis is
  even, a level lives on the blocks: each stencil apply posts the exchange
  of the +-1 ghost planes (z) and rows (y) of the three A components,
  launches ``field_a`` (``multigrid.stencil7_apply``, TPU kernel #4) on the
  block, and folds the ghosts in (``shard_op.ghost_apply``, the same
  ``a_face``/``fold_a`` as the operator's).  Smoothing, restriction and
  prolongation are plain torch ops on the block, as on one device.
* **Agglomeration.**  At the first level whose block extent along a cut
  axis is odd (where the restriction would pair cells of two blocks), each
  rank gathers that level's residual (one all-gather), crops it to JAX's
  shape, and runs the rest of the V-cycle from there on its own: the
  single-device ``correction`` (pad, restrict, ``_vcycle``, prolong,
  crop) on replicated levels, the same bits on every rank (the kernels sum
  in a fixed order, with no atomics).  Then it cuts its block of the
  correction.  team7 (102x102x24) on 4 z slabs holds levels 0 and 1 and
  gathers at level 1; on 2x2 blocks ``NYl`` = 51 is odd, so it gathers the
  fine residual at level 0.

The level plan is fixed when the preconditioner is built: an apply makes
no host read, and its exchanges and gather are captured with the solve
like the operator's.  Every block's tensors carry a leading block axis:
one block on a rank (:func:`build_shard_mg`, :class:`RankLinks`: the
ghosts by ``batch_isend_irecv``, the gather an all-gather), every block of
the mesh in one process for checks (:func:`in_process_mg`,
:func:`handover_vcycle`, :class:`HandoverLinks`: the ghosts and the gather
read from the other blocks).  Only the links differ: the folds, the gather
level's join and the cut of each block's correction are the same code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..assembly.stencil import State
from ..ops.field import field_a_reference
from ..solvers.multigrid import (MGLevel, MGPreconditioner, hierarchy,
                                 inv_diagonal, stencil7_apply)
from .shard_op import (OPPOSITE, a_face, all_gather_blocks, cut_block,
                       exchange, ghost_apply, join_blocks)

__all__ = ["ShardedMG", "RankLinks", "HandoverLinks", "build_shard_mg",
           "in_process_mg", "handover_vcycle", "level_plan"]


def level_plan(shapes, block, cut):
    """(block extents of each level the blocks hold, whether the last of
    them gathers): ``shapes`` the global levels' (z, y, x) extents,
    ``block`` the level-0 block's, ``cut`` whether each axis is cut.  An
    axis that is not cut keeps the global extent, halved up as JAX pads it
    to even; a cut axis halves while the block's extent is even."""
    blocks = [tuple(block)]
    for _ in range(len(shapes) - 1):
        b = blocks[-1]
        if any(c and n % 2 for c, n in zip(cut, b)):
            return blocks, True
        blocks.append(tuple(n // 2 if c else (n + 1) // 2
                            for c, n in zip(cut, b)))
    return blocks, False


class RankLinks:
    """The exchanges of this rank's block of ``mesh`` over
    ``torch.distributed``: :meth:`ghosts` posts the A ghosts'
    ``batch_isend_irecv`` (:func:`~.shard_op.exchange`) and returns the wait
    for them, :meth:`gather` is one all-gather."""

    def __init__(self, mesh):
        self.mesh = mesh

    def ghosts(self, x):
        reqs, recv = exchange(self.mesh, lambda side: a_face(x[0], side))

        def wait():
            for r in reqs:
                r.wait()
            return [recv]
        return wait

    def gather(self, r):
        return all_gather_blocks(self.mesh, r[0])


class HandoverLinks:
    """The exchanges of every block of a mesh in one process (``meshes`` of
    :func:`~.shard_op.in_process_blocks`, in rank order): each block's
    ghosts read from its neighbours' blocks, the gather the blocks
    themselves."""

    def __init__(self, meshes):
        self.meshes = meshes

    def ghosts(self, x):
        return lambda: [{side: a_face(x[getattr(m, side)], back)
                         for side, back in OPPOSITE.items()
                         if getattr(m, side) is not None}
                        for m in self.meshes]

    def gather(self, r):
        return r


@dataclass(frozen=True)
class ShardedMG(MGPreconditioner):
    """The V-cycle on the blocks of a mesh.  ``levels`` are the levels the
    blocks hold, each field with a leading block axis (``ka`` (nb, 7, Bz,
    By, X), ``inv_d`` (nb, 1, Bz, By, X)); ``rep`` is the replicated
    V-cycle from the gather level on (None: the blocks hold every level).
    :meth:`apply_scalar` takes the blocks' fields (nb, ..., Bz, By, X),
    :meth:`apply` a rank's padded block of the solver's state."""

    meshes: tuple = ()         # each block's Mesh
    live: tuple = ()           # per level: 0/1 (nb, 1, Bz, By, X) where a
                               # block holds padding cells, else None
    rep: Optional[MGPreconditioner] = None
    links: object = None       # RankLinks or HandoverLinks

    @property
    def _coarsest(self) -> int:
        # counted from the fine level: with a gather, the coarsest level is
        # ``rep``'s, past the levels the blocks hold
        extra = 0 if self.rep is None else len(self.rep.levels) - 1
        return len(self.levels) - 1 + extra

    def _local(self, ka, x):
        """The stencil on a block alone, every neighbour beyond it read as
        zero: ``field_a`` on the card (``multigrid.stencil7_apply``), else
        its plain version (the flat-roll form would wrap around the
        block)."""
        if self.kernels and x.device.type != "cpu":
            return stencil7_apply(ka, x)
        return field_a_reference(ka, x)

    def _apply(self, li: int, x):
        return ghost_apply(self.levels[li].ka, x, self._local,
                           self.links.ghosts)

    def correction(self, li: int, r):
        if self.rep is not None and li == len(self.levels) - 1:
            return self._agglomerate(li, r)
        e = super().correction(li, r)
        live = self.live[li]
        return e if live is None else e * live

    def _agglomerate(self, li: int, r):
        """The correction of level ``li`` from the replicated levels: every
        block's residual gathered, joined and cropped to the JAX level, its
        single-device correction, and each block's part of it (zero on the
        padding cells)."""
        m0 = self.meshes[0]
        shape = self.rep.levels[0].shape
        e = self.rep.correction(0, join_blocks(self.links.gather(r), m0.n_z,
                                               m0.n_y, shape))
        bz, by, _ = self.levels[li].shape
        return torch.stack([cut_block(e, (m.index * bz, m.iy * by), (bz, by))
                            for m in self.meshes])

    def apply(self, v: State) -> State:
        """State-space M^-1 on a rank's padded block: the V-cycle on each A
        component, the diagonal on U."""
        return State(self.apply_scalar(v.A[None])[0], self.inv_du[0] * v.U)


def _build(ka, sops, links, ku0=None, dtype=None,
           kernels=True) -> ShardedMG:
    s0 = sops[0]
    host = hierarchy(ka)
    shapes = [tuple(h.shape[1:]) for h in host]
    blocks, gathers = level_plan(shapes, s0.block_zyx,
                                 (s0.n_z > 1, s0.n_y > 1, False))
    dtype = dtype or s0.dtype
    dev = lambda a: torch.as_tensor(a).contiguous().to(s0.device, dtype)
    levels, live = [], []
    for h, shape, b in zip(host, shapes, blocks):
        cut = lambda t: torch.stack([cut_block(
            t, (s.mesh.index * b[0], s.mesh.iy * b[1]), b[:2]) for s in sops])
        kas = cut(torch.from_numpy(h))
        real = cut(torch.ones((1,) + shape, dtype=torch.float64))
        levels.append(MGLevel(
            ka=dev(kas), inv_d=dev(inv_diagonal(kas[:, 0].numpy())[:, None]),
            shape=b, pshape=tuple(n + n % 2 for n in b)))
        live.append(None if bool(real.all()) else dev(real))
    rep = None
    if gathers:
        g = len(blocks) - 1
        first = MGLevel(ka=None, inv_d=None, shape=shapes[g],
                        pshape=tuple(n + n % 2 for n in shapes[g]))
        rest = [MGLevel(ka=dev(h), inv_d=dev(inv_diagonal(h[0])), shape=s,
                        pshape=tuple(n + n % 2 for n in s))
                for h, s in zip(host[g + 1:], shapes[g + 1:])]
        rep = MGPreconditioner(levels=(first, *rest), inv_du=None,
                               kernels=kernels)
    d = (np.ones(shapes[0]) if ku0 is None
         else inv_diagonal(np.asarray(ku0, np.float64)))
    inv_du = torch.stack([s.shard(torch.from_numpy(d)) for s in sops]).to(
        s0.device, dtype)
    return ShardedMG(levels=tuple(levels), inv_du=inv_du, kernels=kernels,
                     meshes=tuple(s.mesh for s in sops), live=tuple(live),
                     rep=rep, links=links)


def build_shard_mg(ka, sop, ku0=None, dtype=None,
                   kernels=True) -> ShardedMG:
    """The V-cycle of the global fine A coefficients ``ka`` (7, nz, ny, nx;
    a tensor or a numpy array, as :func:`~..solvers.multigrid.build_mg`
    takes them) on this rank's block of ``sop`` (a
    :class:`~.shard_op.ShardedStencilOperator`), on its device, with
    ``build_mg``'s settings: ``ku0`` the global U-row diagonal, as
    ``build_mg`` takes it; ``dtype`` None for ``sop``'s state dtype;
    ``kernels=False`` applies the levels with torch ops on the card too."""
    return _build(ka, [sop], RankLinks(sop.mesh), ku0, dtype, kernels)


def in_process_mg(ka, sops, dtype=None) -> ShardedMG:
    """:func:`build_shard_mg` for every block of a mesh in one process,
    ``sops`` from :func:`~.shard_op.in_process_blocks`: the ghosts and the
    gather handed over locally (checks of the distributed V-cycle against
    the global one, :func:`handover_vcycle`)."""
    return _build(ka, sops, HandoverLinks([s.mesh for s in sops]),
                  dtype=dtype)


def handover_vcycle(mg: ShardedMG, sops, r: torch.Tensor,
                    blocks_out: bool = False):
    """The V-cycle of the global fields ``r`` (..., nz, ny, nx) over
    :func:`in_process_mg`'s ``mg`` and ``sops``: the global result, or with
    ``blocks_out`` every block's (nb, ..., Bz, By, X)."""
    out = mg.apply_scalar(torch.stack([s.shard(r) for s in sops]))
    if blocks_out:
        return out
    return sops[0]._join(list(out.unbind(0)))
