"""The program's own spans and counters (``utils/trace.py``) over the
window, for the per-layer metrics that read them.

:func:`install`, which each such metric's ``install(sim)`` calls just
before the window, switches the program's tracer on, once however many
metrics ask.  It also wraps ``sim.run`` on the instance, so that the first
transient run under a profiler session (``devtrace.profile_transient``,
after the window) first keeps the tracer's report and switches the tracer
off: under the profiler every span opens a ``record_function`` range, which
the device's timeline shows as an annotation that the trace would read as
device work.  :func:`window` gives a reader the window's report, and the
helpers below reduce it; each gives None where the program keeps no such
span or counter.
"""

from __future__ import annotations

import torch

__all__ = ["install", "window", "host_ms_per_step", "count_per_step"]


def _trace():
    from eddy_currents_3d_tpu_torch.utils import trace
    return trace


def install(sim) -> dict:
    """Switch the program's tracer on for the window, unless an earlier
    metric has; returns what the metrics' readers share."""
    held = getattr(vars(sim).get("run"), "window_trace", None)
    if held is not None:
        return held
    trace = _trace()
    held = {"report": None}
    inner = sim.run

    def run(*args, **kwargs):
        if trace.ON and torch.autograd.profiler._is_profiler_enabled:
            _keep(held)
        return inner(*args, **kwargs)
    run.window_trace = held
    sim.run = run
    trace.enable()
    return held


def _keep(held: dict) -> None:
    """The tracer's report into ``held``; the tracer off."""
    trace = _trace()
    held["report"] = trace.report()
    trace.disable()


def window(ctx, metric: str):
    """The program's report of the window, which ``metric`` installed."""
    held = ctx["installed"].get(metric)
    if held is None:
        return None
    if held["report"] is None:
        _keep(held)
    return held["report"]


def host_ms_per_step(rep, name: str):
    """Host milliseconds a step in the self time of the spans ``name``."""
    spans = [s for s in rep["spans"] if s["name"] == name
             and s["self_ns"] is not None]
    steps = rep["counters"].get("steps")
    if not spans or not steps:
        return None
    return sum(s["self_ns"] for s in spans) / 1e6 / steps


def count_per_step(rep, name: str):
    """The counter ``name`` over the steps."""
    n, steps = rep["counters"].get(name), rep["counters"].get("steps")
    return n / steps if n is not None and steps else None
