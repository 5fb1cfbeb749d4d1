"""device_idle_pct (layer: device): 100 less the share of the profiled
transient's wall time that the union of its device operations covers."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
