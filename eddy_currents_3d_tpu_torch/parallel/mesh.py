"""The device mesh of the multi-device tier: z slabs over torch.distributed.

The PyTorch counterpart of ``eddy_currents_3d_tpu/parallel/mesh.py``
``make_mesh`` (:28).  The JAX package lays a ``jax.sharding.Mesh`` over the
devices of one process; here each card is a process of its own, joined by a
``torch.distributed`` process group (NCCL between cards, gloo on the CPU),
and rank *r* of the group holds z slab *r* of the grid.  A :class:`Mesh` is
what a rank needs to know of that layout: the number of slabs, its own
slab, its device, and the ranks of the slabs below and above it, with
which it exchanges ghost planes (``parallel/shard_op.py``).

Only z slabs are ported: a (z, y) mesh raises, as does the GSPMD tier the
JAX package builds on ``shard_system``/``shard_state`` (ROADMAP Queue 1).
The caller starts the processes and the group: one process per card
(``torchrun --nproc-per-node N``, ``torch.cuda.set_device`` to the local
rank), ``init_process_group`` with the backend of the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


@dataclass(frozen=True)
class Mesh:
    """z slabs over a process group, as seen from one rank."""

    n_z: int                  # slabs, one a rank
    index: int                # this rank's slab (its rank in ``group``)
    device: torch.device      # where this rank's slab lives
    group: object = None      # the process group (None: the default one)
    lo: Optional[int] = None  # global rank of the slab below, if any
    hi: Optional[int] = None  # global rank of the slab above, if any

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
    """This rank's view of ``n_z`` z slabs over ``group`` (None: the
    default process group), which must have ``n_z`` ranks.  ``device``
    (None): the current CUDA device under NCCL, the CPU under gloo."""
    if n_y != 1:
        raise ValueError(f"n_y={n_y}: (z, y) meshes are not ported; the "
                         "port's mesh is z slabs only (n_y=1)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (init_process_group): one process "
                           "per z slab")
    pg = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(pg)
    if world != n_z:
        raise ValueError(f"n_z={n_z} but the process group has {world} "
                         "ranks: one rank per z slab")
    index = dist.get_rank(pg)
    ranks = dist.get_process_group_ranks(pg)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(pg) == "nccl" else torch.device("cpu"))
    return Mesh(n_z=n_z, index=index, device=torch.device(device),
                group=group,
                lo=ranks[index - 1] if index > 0 else None,
                hi=ranks[index + 1] if index + 1 < n_z else None)
