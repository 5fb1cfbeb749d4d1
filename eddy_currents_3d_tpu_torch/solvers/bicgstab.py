"""Restarted BiCGSTAB ("BiCGSTABwr") on torch tensors.

The PyTorch counterpart of ``eddy_currents_3d_tpu/solvers/bicgstab.py``
``bicgstab_wr``, with the same recurrence and control flow as the reference
solver (solvers.f90:3-63): unpreconditioned BiCGSTAB, convergence on
``||s||/||b|| < tol`` (half-step exit, solvers.f90:34-38) or
``||r||/||b|| < tol``, restart ``r0 = r; p = r`` when
``|r.r0_new|/||b|| < tol`` (solvers.f90:47-49), immediate return for a zero
right-hand side, and an iteration budget of ``itmax + 1`` iterations (the
reference checks ``iter > itmax`` at the top of the loop).

Operands are :class:`~..assembly.stencil.State` values or plain tensors;
dot products reduce over every leaf.  Every scalar of the recurrence stays
a 0-d device tensor; the loop reads one value on the host per iteration,
the ``done`` flag, where the JAX version runs an on-device while loop.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..assembly.stencil import State

__all__ = ["bicgstab_wr", "tree_dot", "tree_norm", "tree_axpy", "SolveResult"]


def _leaves(a):
    return (a.A, a.U) if isinstance(a, State) else (a,)


def _map(fn, *trees):
    """Apply ``fn`` leafwise over States (or plain tensors)."""
    if isinstance(trees[0], State):
        return State(fn(*(t.A for t in trees)), fn(*(t.U for t in trees)))
    return fn(*trees)


def tree_dot(a, b, dtype=None):
    cast = (lambda x: x.to(dtype)) if dtype is not None else (lambda x: x)
    leaves = [torch.sum(cast(x) * cast(y)) for x, y in zip(_leaves(a), _leaves(b))]
    return sum(leaves[1:], leaves[0])


def tree_norm(a, dtype=None):
    return torch.sqrt(tree_dot(a, a, dtype))


def tree_axpy(alpha, x, y):
    """y + alpha * x, leafwise.  ``alpha`` is cast to each leaf's dtype so
    higher-precision reduction scalars (dot_dtype) don't promote the
    iterate."""
    return _map(lambda xi, yi: yi + alpha.to(xi.dtype) * xi, x, y)


class SolveResult(NamedTuple):
    x: object             # solution (State or tensor)
    iterations: int
    relres: torch.Tensor  # last computed ||r||/||b|| (or ||s||/||b||)
    converged: bool
    # seconds the host spent blocked on the per-iteration ``done`` read
    sync_s: float = 0.0


def bicgstab_wr(
    apply_fn: Callable,
    b,
    x0,
    tol,
    itmax: int,
    dot_dtype: Optional[torch.dtype] = None,
    mv_dot: Optional[Callable] = None,
) -> SolveResult:
    """Solve ``A x = b`` with restarted BiCGSTAB.

    ``apply_fn``: the matrix-vector product.
    ``tol``: a float or 0-d tensor; compared in the dtype it carries.
    ``dot_dtype``: accumulate reductions in this dtype; default = operand
    dtype.
    ``mv_dot``: optional fused matvec+reductions hook,
    ``mv_dot(v, w) -> (A v, dot(A v, w), dot(A v, A v))`` — when given, the
    per-iteration ``ap·r0`` / ``as·s`` / ``as·as`` reductions ride the
    matvec kernel (the coded operator provides this).
    """
    dot = partial(tree_dot, dtype=dot_dtype)
    nrm = partial(tree_norm, dtype=dot_dtype)

    r = _map(torch.sub, b, apply_fn(x0))
    bnorm = nrm(b)
    zero_b = bnorm == 0.0
    x, r0, p = x0, r, r
    rr0 = dot(r, r)                        # r0 == r at entry
    relres = torch.full((), float("inf"), dtype=bnorm.dtype,
                        device=bnorm.device)
    t0 = time.perf_counter()
    done = bool(zero_b)
    sync_s = time.perf_counter() - t0
    it = 0
    while not done and it <= itmax:
        it += 1
        if mv_dot is None:
            ap = apply_fn(p)
            ap_r0 = dot(ap, r0)
        else:
            ap, ap_r0, _ = mv_dot(p, r0)
        alpha = rr0 / ap_r0
        s = tree_axpy(-alpha, ap, r)
        s_rel = nrm(s) / bnorm
        conv_s = s_rel < tol

        if mv_dot is None:
            as_ = apply_fn(s)
            omega = dot(as_, s) / dot(as_, as_)
        else:
            as_, as_s, as_as = mv_dot(s, s)
            omega = as_s / as_as
        # On the half-step exit the reference sets x += alpha*p only
        # (solvers.f90:34-38) and the loop ends: gating omega (and below
        # beta) to 0 gives the same x without full-state selects.
        zero = torch.zeros_like(omega)
        omega_g = torch.where(conv_s, zero, omega)
        x = _map(lambda xi, pi, si: (xi + alpha.to(xi.dtype) * pi
                                     + omega_g.to(xi.dtype) * si), x, p, s)
        r_new = tree_axpy(-omega_g, as_, s)
        rr = dot(r_new, r_new)
        r_rel = torch.sqrt(rr) / bnorm
        conv_r = r_rel < tol

        rr0_new = dot(r_new, r0)
        # restart r0 = r; p = r (solvers.f90:47-49) == gating beta to 0 and
        # selecting r0; likewise a converged iteration's p/r0 are dead.
        restart = (torch.abs(rr0_new) / bnorm) < tol
        beta = (alpha / omega) * rr0_new / rr0
        stop = restart | conv_s
        beta_g = torch.where(stop, torch.zeros_like(beta), beta)
        omega_p = torch.where(stop, zero, omega)
        p = _map(lambda ri, pi, api: ri + beta_g.to(ri.dtype)
                 * (pi - omega_p.to(ri.dtype) * api), r_new, p, ap)
        r0 = _map(lambda ri, r0i: torch.where(restart, ri, r0i), r_new, r0)
        # next iteration's dot(r, r0): on restart r0 := r, so it is the
        # freshly computed dot(r, r); otherwise rr0_new verbatim
        rr0 = torch.where(restart, rr, rr0_new)
        r = r_new
        relres = torch.where(conv_s, s_rel, r_rel)
        t0 = time.perf_counter()
        done = bool(conv_s | conv_r)
        sync_s += time.perf_counter() - t0
    return SolveResult(x=x, iterations=it, relres=relres, converged=done,
                       sync_s=sync_s)
