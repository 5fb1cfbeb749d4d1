"""operator_us_per_iteration (layer: kernels): device microseconds per
BiCGSTAB iteration in the kernels that ``kernels/*.json`` assign to the
operator, over the profiled transient (the RHS's one apply a step
included)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["iterations"] or not tr["operator"]["launches"]:
        return None
    return tr["operator"]["device_us"] / tr["iterations"]
