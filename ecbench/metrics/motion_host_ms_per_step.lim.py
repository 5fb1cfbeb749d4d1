"""motion_host_ms_per_step.lim (layer: the step's host part): host
milliseconds a step in the program's ``rhs.motion`` spans, the source
functions' relocation (``sim/motion.py``), by their self time over the
window's steps; read from the program's tracer, which :func:`install` turns
on for the window (``spans.py``)."""

from ecbench import spans


def install(sim):
    return spans.install(sim)


def read(ctx):
    rep = spans.window(ctx, "motion_host_ms_per_step.lim")
    return rep and spans.host_ms_per_step(rep, "rhs.motion")
