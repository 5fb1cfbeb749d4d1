"""Chebyshev polynomial preconditioning for the Krylov solver.

The PyTorch counterpart of ``eddy_currents_3d_tpu/solvers/chebyshev.py``.
An opt-in accelerator (the reference is unpreconditioned): ``M ~= A^-1`` is
the degree-k Chebyshev iteration for eigenvalues in ``[lmin, lmax]``, pure
matvecs and axpys with no inner products, so it costs k-1 extra operator
applications per use.  Applied as *right* preconditioning in delta form,
the BiCGSTAB stopping test stays on the true residual of the original
system relative to ``||b||``, the reference's criterion (solvers.f90:34-43),
so converged solutions are interchangeable with unpreconditioned ones at
the same tolerance.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .bicgstab import SolveResult, _map, bicgstab_wr_right

__all__ = ["chebyshev_preconditioner", "bicgstab_wr_cheb"]


def chebyshev_preconditioner(apply_fn: Callable, order: int, lmin: float,
                             lmax: float):
    """Returns M(r) ~= A^-1 r, the classic three-term Chebyshev recurrence
    with z0 = 0 (Saad, Iterative Methods, alg. 12.1)."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    def M(r):
        rho = 1.0 / sigma1
        d = _map(lambda ri: ri / theta, r)
        z = d
        for _ in range(order - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            az = apply_fn(z)
            resid = _map(torch.sub, r, az)
            d = _map(lambda di, ri: (rho_new * rho) * di
                     + (2.0 * rho_new / delta) * ri, d, resid)
            z = _map(torch.add, z, d)
            rho = rho_new
        return z

    return M


def bicgstab_wr_cheb(apply_fn: Callable, b, x0, tol, itmax: int, *,
                     order: int, lmin: float, lmax: float,
                     dot_dtype: Optional[torch.dtype] = None,
                     k: Optional[int] = None) -> SolveResult:
    """Right-Chebyshev-preconditioned BiCGSTABwr in delta form:
    :func:`~.bicgstab.bicgstab_wr_right` with the Chebyshev ``M``, so the
    stop test stays ``||b - A x|| / ||b|| < tol`` and a warm start that
    already meets it returns ``x0`` with 0 iterations.  ``dot_dtype`` is
    the reductions' dtype and ``k`` the iterations between host reads, as
    for ``bicgstab_wr``."""
    M = chebyshev_preconditioner(apply_fn, order, lmin, lmax)
    return bicgstab_wr_right(apply_fn, M, b, x0, tol, itmax,
                             dot_dtype=dot_dtype, k=k)
