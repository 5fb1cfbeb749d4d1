"""Restarted BiCGSTAB ("BiCGSTABwr") on torch tensors, as a device program.

The PyTorch counterpart of ``eddy_currents_3d_tpu/solvers/bicgstab.py``
``bicgstab_wr``, with the same recurrence and control flow as the reference
solver (solvers.f90:3-63): unpreconditioned BiCGSTAB, convergence on
``||s||/||b|| < tol`` (half-step exit, solvers.f90:34-38) or
``||r||/||b|| < tol``, restart ``r0 = r; p = r`` when
``|r.r0_new|/||b|| < tol`` (solvers.f90:47-49), immediate return for a zero
right-hand side, and an iteration budget of ``itmax + 1`` iterations (the
reference checks ``iter > itmax`` at the top of the loop).

``bicgstab_wr_right`` is the right-preconditioned delta form around it
(``solvers/bicgstab.py:202`` of the JAX package), shared by the Chebyshev,
multigrid and ILU(0) preconditioners; ``bicgstab_jacobi`` the
right-Jacobi form (``:187``).  Each takes ``dot_dtype``, the dtype the
reductions accumulate in (default: the operands').  At bfloat16 state the
iterate stays bfloat16: every scalar of the recurrence is cast to the
leaf's dtype before it scales a leaf.

JAX runs the loop as a ``lax.while_loop`` on the device.  Here
:class:`DeviceLoop` runs it as programs over static tensors (setup, one
iteration, finish), whose scalars (``done``, the iteration count, relres,
...) stay 0-d device tensors.  On the card the three are captured as CUDA
graphs and joined into one graph whose WHILE node runs the iteration
while ``not done and it <= itmax``, JAX's ``cond`` (``csrc/
solve_graph.cu``): a solve is one graph launch, and the host reads
``(done, it)`` once, after it, or not at all.  A CUDA runtime without
conditional nodes (< 12.4) cannot build that graph and raises.  On the
CPU a batch of ``k`` iterations runs between reads, each iteration
gated: every store is a select on ``not done and it <= itmax``, so the
iterations after ``done`` leave every value as it was.  The warm start
is guarded on the device too (JAX's select): a right-preconditioned
solve whose warm start already meets the tolerance starts with ``done``
set and returns ``x0``.  The results equal the per-iteration host loop's
bit for bit (``*_reference``, kept as the plain version the tests and
``Simulation._step(eager=True)`` run; a Simulation's own steps never do).

Operands are :class:`~..assembly.stencil.State` values or plain tensors;
dot products reduce over every leaf.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..assembly.stencil import State
from ..utils.graph import Graph, SolveGraph, read_host

__all__ = ["bicgstab_wr", "bicgstab_wr_right", "bicgstab_jacobi",
           "DeviceLoop", "K", "tree_dot", "tree_norm", "tree_axpy", "SolveResult", "bicgstab_wr_reference",
           "bicgstab_wr_right_reference", "bicgstab_jacobi_reference"]

# Iterations a batch holds on the CPU: the host reads (done, it) once per
# batch, so a solve of n iterations takes ceil(n / K) reads (at least
# one).  On the card a solve is one graph launch and K plays no part.
K = 4


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
    # seconds the host spent blocked on the ``(done, it)`` reads
    sync_s: float = 0.0
    reads: int = 0        # host reads of (done, it)


def _put(dst, fn, *args, on=None):
    """``dst := fn(*args)``, written into ``dst``; where the 0-d bool
    ``on`` is given, only where it is True (a select: ``dst`` keeps its
    bits otherwise)."""
    if on is None:
        fn(*args, out=dst)
    else:
        torch.where(on, fn(*args), dst, out=dst)


def _copy(dst, src):
    _map(lambda d, s: d.copy_(s), dst, src)


class _Static:
    """The static tensors of one :class:`DeviceLoop`."""

    CARRY = ("x", "r", "r0", "p", "rr0", "it", "relres", "done")

    def carry_clone(self):
        """A copy whose carry is cloned (the batch's warm-up runs on it)."""
        c = _Static()
        c.__dict__.update(self.__dict__)
        for name in self.CARRY:
            setattr(c, name, _map(torch.clone, getattr(self, name)))
        return c


class DeviceLoop:
    """BiCGSTABwr for one solve configuration, as a device program over
    static tensors, made at the first :meth:`solve` and reused by every
    later one.

    ``apply_fn``: the operator.  ``mv_dot``: the fused matvec + dots hook,
    ``mv_dot(v, w) -> (A v, dot(A v, w), dot(A v, A v))``, of the same
    operator.  ``scale = (d, inv)``: right-Jacobi, the iterations run on
    ``A D^-1`` (``apply_fn(inv * v)``, ``mv_dot(inv * v, w)``) from
    ``d * x0``, and the solution is ``inv * y``.  ``minv``: right
    preconditioning in delta form (on the scaled operator where ``scale``
    is given), as :func:`bicgstab_wr_right`.  ``k``: iterations per batch
    on the CPU (default :data:`K`).
    ``pool``: the CUDA graph memory pool the programs share (one per
    ``Simulation``).

    On a CUDA device the first solve captures the programs as CUDA graphs
    (``captures`` counts that: once per loop) and joins them into one graph
    with a WHILE node; each solve is one launch of it,
    and one read of ``(done, it)`` unless the caller defers it.  A float
    ``tol`` is baked into the graphs: a loop takes one.  A program that
    cannot be captured raises: the loop never falls back to eager launches
    on the card."""

    def __init__(self, apply_fn: Callable, itmax: int,
                 dot_dtype: Optional[torch.dtype] = None,
                 mv_dot: Optional[Callable] = None, *,
                 minv: Optional[Callable] = None, scale=None,
                 k: Optional[int] = None, pool=None):
        if minv is not None and mv_dot is not None:
            raise ValueError("mv_dot fuses the dots of the operator the "
                             "iterations run on; with minv that is A M^-1")
        k = K if k is None else k
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.apply_fn, self.itmax = apply_fn, int(itmax)
        self.dot_dtype, self.mv_dot = dot_dtype, mv_dot
        self.minv, self.scale, self.k = minv, scale, k
        self.pool = pool
        self.captures = 0
        self._dot = partial(tree_dot, dtype=dot_dtype)
        self._nrm = partial(tree_norm, dtype=dot_dtype)
        self._s = None
        self._graphs = None
        self._tol_const = None
        self._unsettled = []      # status of the solves not read yet

    # -- the operator the iterations run on ------------------------------
    def _scaled(self, v):
        return self.apply_fn(v if self.scale is None
                             else _map(torch.mul, self.scale[1], v))

    def _op(self, v):
        return self._scaled(v if self.minv is None else self.minv(v))

    def _mvd(self, v, w):
        if self.scale is not None:
            v = _map(torch.mul, self.scale[1], v)
        return self.mv_dot(v, w)

    # -- static tensors ----------------------------------------------------
    def _make_static(self, b, x0, tol):
        S = _Static()
        like = lambda t: _map(torch.empty_like, t)
        dev = _leaves(b)[0].device
        td = self.dot_dtype or _leaves(b)[0].dtype
        scalar = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        S.b, S.x0 = like(b), like(x0)
        S.tol_in = (scalar(tol.dtype) if isinstance(tol, torch.Tensor)
                    else None)
        S.x, S.r, S.r0, S.p = like(x0), like(b), like(b), like(b)
        S.rr0, S.relres, S.bnorm = scalar(td), scalar(td), scalar(td)
        S.it, S.done = scalar(torch.int32), scalar(torch.bool)
        if self.minv is not None:
            tol_dt = (torch.promote_types(tol.dtype, td)
                      if isinstance(tol, torch.Tensor) else td)
            S.tol = scalar(tol_dt)      # the inner, rescaled tolerance
            S.already, S.rnorm, S.safe_b = (scalar(torch.bool), scalar(td),
                                            scalar(td))
        if self.scale is not None:
            S.x0s = like(x0)            # d * x0
        if self.minv is not None or self.scale is not None:
            S.x_out, S.relres_out = like(x0), scalar(td)
        S.status = torch.zeros(2, dtype=torch.int32, device=dev)
        return S

    # -- the three programs ------------------------------------------------
    def _init(self, S, b, x0, done0=None):
        """The carry at iteration 0 for ``A x = b`` from ``x0``."""
        r = _map(torch.sub, b, self._op(x0))
        bnorm = self._nrm(b)
        S.bnorm.copy_(bnorm)
        zero_b = bnorm == 0.0
        _copy(S.x, x0)
        for dst in (S.r, S.r0, S.p):
            _copy(dst, r)
        S.rr0.copy_(self._dot(r, r))           # r0 == r at entry
        S.it.zero_()
        S.relres.fill_(float("inf"))
        S.done.copy_(zero_b if done0 is None else zero_b | done0)

    def _setup(self, S):
        x0 = S.x0
        if self.scale is not None:
            _map(lambda o, d, v: torch.mul(d, v, out=o), S.x0s,
                 self.scale[0], x0)
            x0 = S.x0s
        if self.minv is None:
            self._init(S, S.b, x0)
            return
        # right preconditioning in delta form: solve (A M^-1) dhat = b - A x0
        # from zero, the tolerance rescaled by ||b|| / ||b - A x0||
        tol = S.tol_in if S.tol_in is not None else self._tol_const
        r0 = _map(torch.sub, S.b, self._scaled(x0))
        bnorm = self._nrm(S.b)
        rnorm = self._nrm(r0)
        S.rnorm.copy_(rnorm)
        S.safe_b.copy_(torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm))
        # the warm start already meets the tolerance (or b = 0): done at
        # entry, so no iteration runs and finish returns x0
        S.already.copy_(rnorm <= tol * bnorm)
        safe_r = torch.where(rnorm == 0, torch.ones_like(rnorm), rnorm)
        S.tol.copy_(tol * bnorm / safe_r)
        self._init(S, r0, _map(torch.zeros_like, S.b), S.already)

    def _finish(self, S):
        x = S.x
        relres = S.relres
        if self.minv is not None:
            x0 = S.x0s if self.scale is not None else S.x0
            x = _map(torch.add, x0, self.minv(x))
            x = _map(lambda xi, x0i: torch.where(S.already, x0i, xi), x, x0)
            relres = torch.where(S.already, S.rnorm / S.safe_b,
                                 relres * S.rnorm / S.safe_b)
        if self.scale is not None:
            x = _map(torch.mul, self.scale[1], x)
        _copy(S.x_out, x)
        S.relres_out.copy_(relres)

    def _iterate(self, c, on=None):
        """One iteration on the carry of ``c``, written in place; with
        ``on`` (a 0-d bool) every store is a select on it."""
        dot, nrm = self._dot, self._nrm
        if self.mv_dot is None:
            ap = self._op(c.p)
            ap_r0 = dot(ap, c.r0)
        else:
            ap, ap_r0, _ = self._mvd(c.p, c.r0)
        alpha = c.rr0 / ap_r0
        s = tree_axpy(-alpha, ap, c.r)
        s_rel = nrm(s) / c.bnorm
        conv_s = s_rel < c.tol

        if self.mv_dot is None:
            as_ = self._op(s)
            omega = dot(as_, s) / dot(as_, as_)
        else:
            as_, as_s, as_as = self._mvd(s, s)
            omega = as_s / as_as
        # On the half-step exit the reference sets x += alpha*p only
        # (solvers.f90:34-38) and the loop ends: gating omega (and below
        # beta) to 0 gives the same x without full-state selects.
        zero = torch.zeros_like(omega)
        omega_g = torch.where(conv_s, zero, omega)

        def x_new(xi, pi, si):
            t = xi + alpha.to(xi.dtype) * pi
            _put(xi, torch.add, t, omega_g.to(xi.dtype) * si, on=on)

        _map(x_new, c.x, c.p, s)
        neg = -omega_g
        _map(lambda ri, si, ai: _put(ri, torch.add, si, neg.to(ai.dtype) * ai,
                                     on=on), c.r, s, as_)
        rr = dot(c.r, c.r)
        r_rel = torch.sqrt(rr) / c.bnorm
        conv_r = r_rel < c.tol

        rr0_new = dot(c.r, c.r0)
        # restart r0 = r; p = r (solvers.f90:47-49) == gating beta to 0 and
        # selecting r0; likewise a converged iteration's p/r0 are dead.
        restart = (torch.abs(rr0_new) / c.bnorm) < c.tol
        beta = (alpha / omega) * rr0_new / c.rr0
        stop = restart | conv_s
        beta_g = torch.where(stop, torch.zeros_like(beta), beta)
        omega_p = torch.where(stop, zero, omega)

        def p_new(pi, ri, api):
            inner = pi - omega_p.to(ri.dtype) * api
            _put(pi, torch.add, ri, beta_g.to(ri.dtype) * inner, on=on)

        _map(p_new, c.p, c.r, ap)
        sel = restart if on is None else restart & on
        _map(lambda r0i, ri: torch.where(sel, ri, r0i, out=r0i), c.r0, c.r)
        # next iteration's dot(r, r0): on restart r0 := r, so it is the
        # freshly computed dot(r, r); otherwise rr0_new verbatim
        _put(c.rr0, torch.where, restart, rr, rr0_new, on=on)
        _put(c.relres, torch.where, conv_s, s_rel, r_rel, on=on)
        _put(c.done, torch.bitwise_or, conv_s, conv_r, on=on)
        if on is None:
            c.it.add_(1)
        else:
            c.it.add_(on.to(torch.int32))

    def _status(self, S):
        torch.stack([S.done.to(torch.int32), S.it], out=S.status)

    def _batch(self, S):
        """``k`` iterations, each a select on ``not done and it <=
        itmax``; then (done, it) into ``status``."""
        for _ in range(self.k):
            self._iterate(S, ~S.done & (S.it <= self.itmax))
        self._status(S)

    # -- running -----------------------------------------------------------
    def _capture(self, S):
        dev, pool = S.status.device, self.pool
        warm = lambda: self._iterate(S.carry_clone())
        out = hasattr(S, "x_out")

        def finish():
            if out:
                self._finish(S)
            self._status(S)

        self._graphs = (
            Graph(lambda: self._setup(S), dev, pool),
            Graph(lambda: self._iterate(S), dev, pool, warm=warm),
            Graph(finish, dev, pool))
        self._exec = SolveGraph(*(g.raw for g in self._graphs), S.done,
                                S.it, self.itmax)
        self.captures += 1

    def _read(self, S):
        """(done, it) from ``status``, in one device-to-host copy."""
        return read_host(S.status).tolist()

    def settle(self):
        """Add to the wrappers' launch counts what the iterations of the
        solves not read yet (``solve(read=False)``) launched: one read of
        their iteration counts."""
        if self._unsettled:
            its = read_host(torch.stack([s[1] for s in self._unsettled]))
            self._unsettled = []
            self._graphs[1].count(int(its.sum()))

    def _stage(self, b, x0, tol):
        """The static tensors, holding the inputs of a solve."""
        if self._s is None:
            self._s = self._make_static(b, x0, tol)
        S = self._s
        _copy(S.b, b)
        _copy(S.x0, x0)
        if isinstance(tol, torch.Tensor):
            if S.tol_in is None or tol.dtype != S.tol_in.dtype:
                raise ValueError("tol changed kind or dtype between solves")
            S.tol_in.copy_(tol)
        elif S.tol_in is not None:
            raise ValueError("tol changed kind between solves")
        elif self._tol_const is None:
            self._tol_const = float(tol)      # baked into the programs
        elif self._tol_const != float(tol):
            raise ValueError(f"tol {tol} differs from this loop's "
                             f"{self._tol_const}")
        if self.minv is None:
            # the iterations compare against the caller's tol
            S.tol = S.tol_in if S.tol_in is not None else self._tol_const
        return S

    def solve(self, b, x0, tol, read: bool = True) -> SolveResult:
        """Solve ``A x = b`` from ``x0``; ``tol`` a float or a 0-d tensor,
        compared in the dtype it carries.  Returns fresh tensors.

        ``read=False`` lets a solve on the card make no host read:
        ``iterations`` and ``converged`` come back as 0-d device tensors
        (int32, bool), as JAX's do, and the iterations' launches are
        counted at the next :meth:`settle`.  On the CPU the batches read
        anyway, and they come back as int and bool."""
        S = self._stage(b, x0, tol)
        cuda = S.status.device.type == "cuda"
        if cuda and self._graphs is None:
            self._capture(S)
        out = hasattr(S, "x_out")
        sync_s, reads = 0.0, 0
        if cuda:
            # the whole solve is one launch, and at most one read after it
            self._exec.launch()
            self._graphs[0].count()
            self._graphs[2].count()
            if read:
                t0 = time.perf_counter()
                done, it = self._read(S)
                sync_s, reads = time.perf_counter() - t0, 1
                done = bool(done)
                self._graphs[1].count(it)
            else:
                status = S.status.clone()
                self._unsettled.append(status)
                done, it = status[0].bool(), status[1]
        else:
            self._setup(S)
            while True:
                self._batch(S)
                t0 = time.perf_counter()
                done, it = self._read(S)
                sync_s += time.perf_counter() - t0
                reads += 1
                if done or it > self.itmax:
                    break
            done = bool(done)
            if out:
                self._finish(S)
        x, relres = (S.x_out, S.relres_out) if out else (S.x, S.relres)
        return SolveResult(x=_map(torch.clone, x), iterations=it,
                           relres=relres.clone(), converged=done,
                           sync_s=sync_s, reads=reads)

    def reference(self, b, x0, tol) -> SolveResult:
        """The same solve by the per-iteration host loop (the plain
        version), from the same configuration."""
        A = self._scaled
        if self.scale is not None:
            x0 = _map(torch.mul, self.scale[0], x0)
        if self.minv is not None:
            res = bicgstab_wr_right_reference(A, self.minv, b, x0, tol,
                                              self.itmax, self.dot_dtype)
        else:
            res = bicgstab_wr_reference(
                A, b, x0, tol, self.itmax, self.dot_dtype,
                mv_dot=self._mvd if self.mv_dot is not None else None)
        if self.scale is not None:
            res = res._replace(x=_map(torch.mul, self.scale[1], res.x))
        return res


def bicgstab_wr(
    apply_fn: Callable,
    b,
    x0,
    tol,
    itmax: int,
    dot_dtype: Optional[torch.dtype] = None,
    mv_dot: Optional[Callable] = None,
    *,
    k: Optional[int] = None,
) -> SolveResult:
    """Solve ``A x = b`` with restarted BiCGSTAB on the device loop.

    ``apply_fn``: the matrix-vector product.
    ``tol``: a float or 0-d tensor; compared in the dtype it carries.
    ``dot_dtype``: accumulate reductions in this dtype; default = operand
    dtype.
    ``mv_dot``: optional fused matvec+reductions hook,
    ``mv_dot(v, w) -> (A v, dot(A v, w), dot(A v, A v))`` — when given, the
    per-iteration ``ap·r0`` / ``as·s`` / ``as·as`` reductions ride the
    matvec kernel (the coded operator provides this).
    ``k``: iterations between host reads on the CPU (default :data:`K`).
    """
    return DeviceLoop(apply_fn, itmax, dot_dtype, mv_dot, k=k).solve(
        b, x0, tol)


def bicgstab_jacobi(apply_fn: Callable, diag, b, x0, tol, itmax: int,
                    dot_dtype: Optional[torch.dtype] = None, *,
                    k: Optional[int] = None) -> SolveResult:
    """Right-Jacobi-preconditioned BiCGSTABwr: solve ``(A D^-1) y = b``
    with ``x = D^-1 y`` from ``y0 = D x0``, so the residual history and the
    convergence test stay those of the original system."""
    inv = _map(lambda d: 1.0 / d, diag)
    return DeviceLoop(apply_fn, itmax, dot_dtype, scale=(diag, inv),
                      k=k).solve(b, x0, tol)


def bicgstab_wr_right(apply_fn: Callable, minv: Callable, b, x0, tol,
                      itmax: int,
                      dot_dtype: Optional[torch.dtype] = None, *,
                      k: Optional[int] = None) -> SolveResult:
    """Right-preconditioned BiCGSTABwr in delta form for any linear
    ``minv ~= A^-1`` (Chebyshev, V-cycle, ...).

    Solves ``(A M^-1) dhat = b - A x0`` from zero and returns
    ``x = x0 + M^-1 dhat``.  The inner tolerance is rescaled by
    ``||b|| / ||b - A x0||`` so the stop test stays exactly
    ``||b - A x|| / ||b|| < tol``, the reference criterion
    (solvers.f90:34-43), and the reported relres is re-expressed relative
    to ``||b||``.  When the warm start already meets the tolerance (or
    b = 0) the loop starts done and returns ``x0`` with 0 iterations, a
    select on the device as in JAX."""
    return DeviceLoop(apply_fn, itmax, dot_dtype, minv=minv, k=k).solve(
        b, x0, tol)


# ---------------------------------------------------------------------------
# the plain versions: the per-iteration host loop
# ---------------------------------------------------------------------------

def bicgstab_wr_reference(
    apply_fn: Callable,
    b,
    x0,
    tol,
    itmax: int,
    dot_dtype: Optional[torch.dtype] = None,
    mv_dot: Optional[Callable] = None,
) -> SolveResult:
    """:func:`bicgstab_wr` with one host read of ``done`` per iteration
    (the plain version the device loop is held to, bit for bit)."""
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
    reads = 1
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
        zero = torch.zeros_like(omega)
        omega_g = torch.where(conv_s, zero, omega)
        x = _map(lambda xi, pi, si: (xi + alpha.to(xi.dtype) * pi
                                     + omega_g.to(xi.dtype) * si), x, p, s)
        r_new = tree_axpy(-omega_g, as_, s)
        rr = dot(r_new, r_new)
        r_rel = torch.sqrt(rr) / bnorm
        conv_r = r_rel < tol

        rr0_new = dot(r_new, r0)
        restart = (torch.abs(rr0_new) / bnorm) < tol
        beta = (alpha / omega) * rr0_new / rr0
        stop = restart | conv_s
        beta_g = torch.where(stop, torch.zeros_like(beta), beta)
        omega_p = torch.where(stop, zero, omega)
        p = _map(lambda ri, pi, api: ri + beta_g.to(ri.dtype)
                 * (pi - omega_p.to(ri.dtype) * api), r_new, p, ap)
        r0 = _map(lambda ri, r0i: torch.where(restart, ri, r0i), r_new, r0)
        rr0 = torch.where(restart, rr, rr0_new)
        r = r_new
        relres = torch.where(conv_s, s_rel, r_rel)
        t0 = time.perf_counter()
        done = bool(conv_s | conv_r)
        sync_s += time.perf_counter() - t0
        reads += 1
    return SolveResult(x=x, iterations=it, relres=relres, converged=done,
                       sync_s=sync_s, reads=reads)


def bicgstab_jacobi_reference(apply_fn: Callable, diag, b, x0, tol,
                              itmax: int,
                              dot_dtype: Optional[torch.dtype] = None
                              ) -> SolveResult:
    """:func:`bicgstab_jacobi` on the per-iteration host loop."""
    inv = _map(lambda d: 1.0 / d, diag)
    mul = lambda s, v: _map(torch.mul, s, v)
    res = bicgstab_wr_reference(lambda v: apply_fn(mul(inv, v)), b,
                                mul(diag, x0), tol, itmax,
                                dot_dtype=dot_dtype)
    return res._replace(x=mul(inv, res.x))


def bicgstab_wr_right_reference(apply_fn: Callable, minv: Callable, b, x0,
                                tol, itmax: int,
                                dot_dtype: Optional[torch.dtype] = None
                                ) -> SolveResult:
    """:func:`bicgstab_wr_right` on the per-iteration host loop: one host
    read of the warm start's ``already`` decides, before the inner solve,
    whether it runs."""
    r0 = _map(torch.sub, b, apply_fn(x0))
    bnorm = tree_norm(b, dot_dtype)
    rnorm = tree_norm(r0, dot_dtype)
    safe_b = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    t0 = time.perf_counter()
    already = bool(rnorm <= tol * bnorm)
    sync_s = time.perf_counter() - t0
    if already:
        return SolveResult(x=x0, iterations=0, relres=rnorm / safe_b,
                           converged=True, sync_s=sync_s, reads=1)
    tol_eff = tol * bnorm / rnorm
    zero = _map(torch.zeros_like, b)
    res = bicgstab_wr_reference(lambda v: apply_fn(minv(v)), r0, zero,
                                tol_eff, itmax, dot_dtype=dot_dtype)
    x = _map(torch.add, x0, minv(res.x))
    return SolveResult(x=x, iterations=res.iterations,
                       relres=res.relres * rnorm / safe_b,
                       converged=res.converged, sync_s=sync_s + res.sync_s,
                       reads=1 + res.reads)
