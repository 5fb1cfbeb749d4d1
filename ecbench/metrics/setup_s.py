"""setup_s (end to end, host clock): process start to the first timed
step: imports, the .vxc text and its reading, assembly, the kernels'
loading (and, in a checkout's first run, their build), the graphs' capture
and one warm transient."""


def read(ctx):
    return ctx["setup_s"]
