"""The reference's time step in float64, to judge the program's steps.

One step of the reference's main loop (EC3D.f90:241-455): the source
functions at the step's time, the moving coil's relocation (integrated
here from the transient's start), the right-hand side (sources, the
inertial history ``carry`` and the U rows' coupling to the old A), the
zeroing of the one-sided rows, the solve under the stopping rule and the
post-solve carry ``J = (2C/dt) A_new - rhs`` (EC3D.f90:412-432).

The reference does not solve: it judges.  Given the program's state before
a step (its A and carry; zeros at a transient's first step, which the
reference makes itself) and the program's state after it, it builds the
step's system from the cell's data alone (the :class:`~.case.Case` of the
configuration's case module, ``system.py``, ``motion.py``), on the host
with numpy and scipy, and reads

* ``relres``: the true relative residual, in float64, of the A and U the
  program's solve returned;
* ``carry``: the largest gap between the program's carry and the carry of
  the program's A, over the largest reference carry;
* ``surface``: the cells where the program's A and U after the step are
  not its solution with the one-sided rows zeroed, or its carry is not 0
  on those rows;
* ``sources``: the source cells the program filled that differ from the
  reference's, function by function.
"""

from __future__ import annotations

import numpy as np

from .motion import Motion
from .system import assemble

__all__ = ["StepReference"]


def _host(x) -> np.ndarray:
    """A program tensor as a float64 numpy array."""
    return x.detach().double().cpu().numpy()


class StepReference:
    """The float64 system of a :class:`~.case.Case`."""

    def __init__(self, case):
        self.case = case
        self.sys = sys_ = assemble(case)
        N = sys_.N
        self.M_UA = sys_.M[3 * N:, :3 * N].tocsr()    # U rows, A columns
        self.zero = np.concatenate([sys_.bnd_a, sys_.bnd_u])
        self.motion = Motion(case)
        self.shape = (3,) + case.geo.shape

    def rhs(self, s: int, phase: float, A: np.ndarray, carry: np.ndarray):
        """b of step ``s`` at ``phase`` from the state (A, carry) before it,
        flat [A | U] float64."""
        N, cond = self.sys.N, self.sys.cond
        t = self.case.times[s]
        b = np.zeros(self.sys.M.shape[0])
        for c in range(3):
            b[c * N + cond] = carry[c * N + cond]
        for src, cells in zip(self.case.sources, self.motion.at(s)):
            b[src.axis * N + cells] = src.value(t, phase)
        for c in range(3):
            b[c * N + cond] += self.sys.inert * A[c * N + cond]
        b[3 * N:] = self.M_UA @ A
        b[self.zero] = 0.0
        return b

    def judge(self, s: int, phase: float, before, solved, after,
              src_cells) -> dict:
        """The readings of the program's step ``s`` at ``phase``:
        ``before`` is (A, carry) of the program's state before it, or None
        at a transient's first step (the reference's own zeros); ``solved``
        the (A, U) its solve returned; ``after`` the (A, U, carry) of its
        state after the step; ``src_cells`` the source cells it filled."""
        N, cond, M = self.sys.N, self.sys.cond, self.sys.M
        A, U = (_host(x) for x in solved)
        A_out, U_out, carry = (_host(x).reshape(-1) for x in after)
        A = A.reshape(-1)
        if before is None:
            A0 = np.zeros(3 * N)
            carry0 = np.zeros(3 * N)
        else:
            A0, carry0 = (_host(x).reshape(-1) for x in before)
        b = self.rhs(s, phase, A0, carry0)
        x = np.concatenate([A, U.reshape(-1)[cond]])
        bn = float(np.linalg.norm(b))
        r = float(np.linalg.norm(b - M @ x))
        relres = r / bn if bn > 0 else r
        # the carry: (2C/dt) A - rhs on the conductor, the rhs elsewhere,
        # 0 on the one-sided rows
        want = b[:3 * N].copy()
        for c in range(3):
            k = c * N + cond
            want[k] = self.sys.inert * A[k] - b[k]
        want[self.sys.bnd_a] = 0.0
        scale = float(np.abs(want).max())
        gap = float(np.abs(carry - want).max())
        zeroed = A.copy()
        zeroed[self.sys.bnd_a] = 0.0
        surface = int(np.count_nonzero(A_out != zeroed)
                      + np.count_nonzero(U_out != U.reshape(-1))
                      + np.count_nonzero(carry[self.sys.bnd_a]))
        ref_cells = self.motion.at(s)
        sources = abs(len(src_cells) - len(ref_cells))
        for got, ref in zip(src_cells, ref_cells):
            got = np.asarray(got, np.int64)
            sources += (int(np.count_nonzero(got != ref))
                        if got.shape == ref.shape else max(got.size, ref.size))
        return {"relres": relres, "carry": gap / scale if scale > 0 else gap,
                "surface": surface, "sources": sources}
