"""ms_per_step (end to end, host clock): the window's wall time over every
step that its transients completed."""


def read(ctx):
    w = ctx["window"]
    return w["wall_s"] * 1e3 / w["steps"] if w["steps"] else None
