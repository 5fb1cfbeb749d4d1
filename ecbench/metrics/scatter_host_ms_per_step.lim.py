"""scatter_host_ms_per_step.lim (layer: the step's host part): host
milliseconds a step in the program's ``rhs.scatter`` spans, the fill of
every source function's cells into the right-hand side (their upload and
``index_fill_``), over the window's steps; read from the program's tracer,
which :func:`install` turns on for the window (``spans.py``).  None where
the program has no such span."""

from ecbench import spans


def install(sim):
    return spans.install(sim)


def read(ctx):
    rep = spans.window(ctx, "scatter_host_ms_per_step.lim")
    return rep and spans.host_ms_per_step(rep, "rhs.scatter")
