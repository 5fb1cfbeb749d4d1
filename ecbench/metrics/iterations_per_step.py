"""iterations_per_step (layer: the solver's algorithm, BiCGSTABwr): the
window's BiCGSTAB iterations, as ``Simulation.run`` reads them once after
each transient, over its steps."""


def read(ctx):
    w = ctx["window"]
    return w["iterations"] / w["steps"] if w["steps"] else None
