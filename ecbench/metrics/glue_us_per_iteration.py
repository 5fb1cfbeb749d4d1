"""glue_us_per_iteration (layer: solver vector glue): device microseconds
per BiCGSTAB iteration in every kernel that ``kernels/*.json`` does not
assign to the operator: the solver's torch kernels in the graphs, and the
step's own RHS, carry and zeroing kernels, over the profiled transient."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["iterations"] or not tr["device_us"]:
        return None
    return (tr["device_us"] - tr["operator"]["device_us"]) / tr["iterations"]
