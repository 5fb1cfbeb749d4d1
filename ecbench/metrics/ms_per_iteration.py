"""ms_per_iteration (layer: the solver's device program, ``DeviceLoop``):
the traced run's window wall time over its BiCGSTAB iterations (the host
part of each step included)."""


def read(ctx):
    w = ctx["window"]
    return w["wall_s"] * 1e3 / w["iterations"] if w["iterations"] else None
