"""The device mesh of the multi-device tier: (z, y) blocks over
torch.distributed.

The PyTorch counterpart of ``eddy_currents_3d_tpu/parallel/mesh.py``
``make_mesh`` (:28).  The JAX package lays a ``jax.sharding.Mesh`` of shape
``(n_z, n_y)`` over the devices of one process; here each card is a process
of its own, joined by a ``torch.distributed`` process group (NCCL between
cards, gloo on the CPU), and rank ``iz * n_y + iy`` of the group holds
block ``(iz, iy)`` of the grid: z slab ``iz``, y column ``iy`` (the JAX
device order ``devices.reshape(n_z, n_y)``).  A :class:`Mesh` is what a
rank needs to know of that layout: the mesh's extents, its own block, its
device, and the ranks of the blocks beside it along z and along y, with
which it exchanges ghost planes and rows (``parallel/shard_op.py``).

The JAX package's GSPMD tier (``shard_system``/``shard_state``, its
fallback for ``precond="mg"`` and ``use_shard_map=False``) runs here on
the same blocks: the per-block field tier, with the V-cycle's levels on the
rank's block (``parallel/shard_mg.py``).  The caller starts the processes
and the group: one process per card (``torchrun --nproc-per-node n_z*n_y``,
``torch.cuda.set_device`` to the local rank), ``init_process_group`` with
the backend of the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


@dataclass(frozen=True)
class Mesh:
    """(z, y) blocks over a process group, as seen from one rank."""

    n_z: int                  # z slabs
    index: int                # this rank's z slab
    device: torch.device      # where this rank's block lives
    group: object = None      # the process group (None: the default one)
    lo: Optional[int] = None  # global rank of the block below in z, if any
    hi: Optional[int] = None  # global rank of the block above in z, if any
    n_y: int = 1              # y columns
    iy: int = 0               # this rank's y column
    ylo: Optional[int] = None  # global rank of the block below in y, if any
    yhi: Optional[int] = None  # global rank of the block above in y, if any

    @property
    def rank(self) -> int:
        """This rank's place in the mesh: ``index * n_y + iy`` (its rank in
        ``group``)."""
        return self.index * self.n_y + self.iy

    @property
    def size(self) -> int:
        return self.n_z * self.n_y

    def all_reduce(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the mesh's ranks, in place.  bfloat16 is summed
        in float32 and rounded once."""
        if t.dtype == torch.bfloat16:
            wide = t.float()
            dist.all_reduce(wide, group=self.group)
            t.copy_(wide)
        else:
            dist.all_reduce(t, group=self.group)


def make_mesh(n_z: int, n_y: int = 1, group=None, device=None) -> Mesh:
    """This rank's view of ``n_z x n_y`` blocks over ``group`` (None: the
    default process group), which must have ``n_z * n_y`` ranks: rank
    ``iz * n_y + iy`` holds z slab ``iz`` of y column ``iy``.  ``device``
    (None): the current CUDA device under NCCL, the CPU under gloo."""
    if n_z < 1 or n_y < 1:
        raise ValueError(f"mesh extents must be positive, got ({n_z}, {n_y})")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (init_process_group): one process "
                           "per block of the mesh")
    pg = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(pg)
    if world != n_z * n_y:
        raise ValueError(f"n_z={n_z}, n_y={n_y} but the process group has "
                         f"{world} ranks: one rank per (z, y) block")
    me = dist.get_rank(pg)
    ranks = dist.get_process_group_ranks(pg)
    iz, iy = divmod(me, n_y)
    at = lambda z, y: ranks[z * n_y + y]
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(pg) == "nccl" else torch.device("cpu"))
    return Mesh(n_z=n_z, index=iz, device=torch.device(device), group=group,
                lo=at(iz - 1, iy) if iz > 0 else None,
                hi=at(iz + 1, iy) if iz + 1 < n_z else None,
                n_y=n_y, iy=iy,
                ylo=at(iz, iy - 1) if iy > 0 else None,
                yhi=at(iz, iy + 1) if iy + 1 < n_y else None)
