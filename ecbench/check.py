"""What decides ``correct``: a sample of the window's steps, drawn from the
seed, kept as the program produced them and judged after the window by the
float64 reference (``reference/step.py``), which builds the step's
system on the host from the cell's data: the case that the configuration's
case module (``cases/<case>.py`` ``reference_case``) gives.

:class:`Recorder` wraps the Simulation's ``_step`` and ``solve`` on the
instance.  It keeps, for the first step of the window's first transient
(the cold start) and for one step of each of up to ``KEEP`` transients
drawn by reservoir sampling from all the window's transients (the step
drawn uniformly), the program's state before the step (A and carry), what
its solve returned (A and U, before the conductor-surface zeroing), its
state and source cells after the step, and the transient's phase.  Nothing
is copied: the program makes these tensors fresh each step, and the sample
holds on to them.
"""

from __future__ import annotations

__all__ = ["Recorder", "judge", "KEEP"]

KEEP = 8      # sampled transients besides the cold start


class Recorder:
    """Samples the window's steps of ``sim`` from ``rng``."""

    def __init__(self, sim, rng):
        self._sim, self._rng = sim, rng
        self._kept = {}            # key ("start" or a slot) -> step record
        self._want = []            # (step, key) of the transient running
        self._phase = None
        self._k = 0
        self._solved = None
        step, solve = sim._step, sim.solve

        def solve_rec(b, x0, eager=False, read=True):
            res = solve(b, x0, eager=eager, read=read)
            self._solved = res.x
            return res

        def step_rec(state, t, eager=False):
            new, info = step(state, t, eager=eager)
            s, self._k = self._k, self._k + 1
            for ws, key in self._want:
                if ws == s:
                    self._kept[key] = (
                        self._phase, s,
                        None if s == 0 else (state.A, state.carry),
                        (self._solved.A, self._solved.U),
                        (new.A, new.U, new.carry), info.src_cells)
            self._solved = None
            return new, info

        sim.solve, sim._step = solve_rec, step_rec

    def begin(self, i: int, phase: float) -> None:
        """Transient ``i`` of the window starts, its currents at ``phase``:
        draw whether it takes a slot of the sample (reservoir sampling) and
        which of its steps."""
        self._k, self._phase = 0, phase
        step = int(self._rng.integers(0, self._sim.n_steps))
        slot = i if i < KEEP else int(self._rng.integers(0, i + 1))
        self._want = [(step, slot)] if slot < KEEP else []
        if i == 0:
            self._want.append((0, "start"))

    def close(self) -> list:
        """Remove the wrappers; returns every kept step record."""
        del self._sim.solve, self._sim._step
        self._want = []
        return list(self._kept.values())


def judge(case, samples) -> dict:
    """The largest of each reading over ``samples`` for the cell whose
    reference data is ``case`` (a ``reference.case.Case``)."""
    from .reference.step import StepReference

    ref = StepReference(case)
    worst = {}
    for phase, s, before, solved, after, cells in samples:
        for name, v in ref.judge(s, phase, before, solved, after,
                                 cells).items():
            worst[name] = max(worst.get(name, v), v)
    return worst
