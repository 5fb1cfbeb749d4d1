"""device_ms_per_step (layer: device): milliseconds a step in which an
operation ran on the device (the union of the profiled transient's device
intervals over its steps).  Beside ``ms_per_step`` it says how far the
device paces a step without the profiler's own cost, which lengthens the
traced transient's wall time and so its ``device_idle_pct``."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0 or not tr["steps"]:
        return None
    return tr["busy_s"] * 1e3 / tr["steps"]
