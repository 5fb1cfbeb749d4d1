"""The yardstick's arithmetic: the card's published peaks, a roofline bound,
and the least bytes of one operator apply.

``bound`` is ``chip_smoke.py``'s arithmetic; the peaks are NVIDIA's data
sheet for the H100 SXM (dense, at the 700 W limit): a share of them is
stated beside the card's power limit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_PEAK", "FP32_PEAK", "L2_BYTES", "bound", "operator_bytes",
           "vector_bytes", "distinct_coefficients"]

HBM_PEAK = 3.35e12      # B/s
FP32_PEAK = 67e12       # FLOP/s outside the tensor cores
L2_BYTES = 50 << 20     # the H100's L2 cache


def bound(nbytes: float, ops: float, peak: float = FP32_PEAK):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the HBM peak and the operations over ``peak``."""
    t_b, t_o = nbytes / HBM_PEAK, ops / peak
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def vector_bytes(shape_zyx, n_cond: int, itemsize: int) -> int:
    """Bytes of one solver vector: A's three components on every cell and
    U on the conducting cells, the only cells that carry a U unknown."""
    nz, ny, nx = shape_zyx
    return itemsize * (3 * nz * ny * nx + n_cond)


def operator_bytes(shape_zyx, n_cond: int, itemsize: int,
                   n_coefficients: int) -> int:
    """The least bytes of one apply ``y = A x``: each input byte read once
    (x, and the assembled operator's distinct coefficient values) and each
    output byte written once (y).  It depends on the problem alone, not on
    what a route reads."""
    return (2 * vector_bytes(shape_zyx, n_cond, itemsize)
            + itemsize * n_coefficients)


def distinct_coefficients(*fields: np.ndarray) -> int:
    """The number of distinct nonzero values over the operator's
    coefficient fields."""
    vals = np.unique(np.concatenate([np.unique(f) for f in fields]))
    return int(np.count_nonzero(vals))
