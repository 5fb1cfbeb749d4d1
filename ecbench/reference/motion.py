"""The moving coil's relocation, per voxel, as EC3D.f90 does it.

A copy of the repository's test oracle (``tests/oracle.py``
``OracleSimulator.run``), a transcription of ``motion_calc`` and ``new_m``
(EC3D.f90:1052-1114): each source function keeps its own ``Distance``,
summed plainly in float64 (``Distance += V dt / delta`` on an axis driven
by a velocity function), the displacement is ``nint(Distance)``, and each
voxel, moved by it, is clamped per axis to ``[2, sd-2]`` (1-based); a clamp
drops that axis's latch ``movestop``, shared by every function, and a voxel
inside re-arms it.  Voxel by voxel, in the order the source lists them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Motion"]


class Motion:
    """The source cells of every step of one transient, integrated from
    its first step."""

    def __init__(self, case):
        self.case = case
        self.dist = np.zeros((len(case.sources), 3))
        self.movestop = [1, 1, 1]
        self.cells = []                 # per step: each source's cells

    def at(self, s: int) -> list[np.ndarray]:
        """Each source's flat cells at step ``s``."""
        case = self.case
        if case.velocity is None:
            return [src.cells for src in case.sources]
        sdx, sdy, sdz = case.shape_xyz
        dt = case.dt
        while len(self.cells) <= s:
            vel = case.velocity(case.times[len(self.cells)])
            step = []
            for fi, src in enumerate(case.sources):
                for a in range(3):
                    if vel[a] is not None:
                        self.dist[fi, a] += vel[a] * dt / case.delta[a]
                d = self.dist[fi]
                length = np.trunc(d + np.where(d >= 0, 0.5, -0.5)).astype(int)
                new_cells = []
                for cell in src.cells.tolist():
                    new = [cell % sdx + length[0],
                           (cell // sdx) % sdy + length[1],
                           cell // (sdx * sdy) + length[2]]
                    for a, sd in enumerate((sdx, sdy, sdz)):
                        if new[a] > sd - 3:
                            self.movestop[a] = 0
                            new[a] = sd - 3
                        elif new[a] < 1:
                            self.movestop[a] = 0
                            new[a] = 1
                        elif self.movestop[a] == 0 and (new[a] < sd - 3
                                                        or new[a] > 1):
                            self.movestop[a] = 1
                    new_cells.append(new[0] + sdx * new[1]
                                     + sdx * sdy * new[2])
                step.append(np.asarray(new_cells, np.int64))
            self.cells.append(step)
        return self.cells[s]
