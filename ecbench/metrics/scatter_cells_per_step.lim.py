"""scatter_cells_per_step.lim (layer: the step's host part): source cells
filled a step, the program's ``scatter.cells`` counter over the window's
steps; read from the program's tracer, which :func:`install` turns on for
the window (``spans.py``).  None where the program has no such counter."""

from ecbench import spans


def install(sim):
    return spans.install(sim)


def read(ctx):
    rep = spans.window(ctx, "scatter_cells_per_step.lim")
    return rep and spans.count_per_step(rep, "scatter.cells")
