"""rhs_host_ms_per_step (layer: the step's host part, ``Simulation._rhs``):
host milliseconds a step spends in ``_rhs`` (sources at t, the coil's
relocation, the scatter, the RHS), timed by the host clock around the
method, wrapped on the instance for the traced run's window."""


def read(ctx):
    w = ctx["window"]
    if w["rhs_host_s"] is None or not w["steps"]:
        return None
    return w["rhs_host_s"] * 1e3 / w["steps"]
