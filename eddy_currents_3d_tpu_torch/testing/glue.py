"""The iteration's glue route, pinned for the comparisons with a mesh.

A mesh's device loops sum their dots over the ranks and run the glue in
torch ops (``ops/glue_cuda.py`` :class:`TorchGlue`); a float32 loop on one
card runs the glue kernels, whose dots sum in another order.  A run held
bit for bit to a mesh's, or to the batched form's, takes the torch glue
inside :func:`torch_glue`.
"""

from __future__ import annotations

import contextlib

__all__ = ["torch_glue"]


@contextlib.contextmanager
def torch_glue():
    """Every device loop whose first solve runs inside, and every
    per-iteration host loop, on the torch glue."""
    from ..solvers import bicgstab

    route = bicgstab.glue_route
    bicgstab.glue_route = lambda *a, **k: "torch"
    try:
        yield
    finally:
        bicgstab.glue_route = route
