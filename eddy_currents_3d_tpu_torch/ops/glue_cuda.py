"""The vector glue of a BiCGSTABwr iteration: its plain torch version and
the wrapper of its three hand-written CUDA kernels.

One iteration of ``solvers/bicgstab.py`` ``DeviceLoop`` is two operator
applies (``ap = A p``, ``as = A s``, each with its dots) and, around them,
the glue: the axpys, the norms and dots of ``s`` and ``r``, the selects and
the recurrence's scalars.  The glue comes in three pieces, each a function
of the iteration's carry ``c`` (``x``, ``r``, ``r0``, ``p``, ``rr0``,
``relres``, ``done``, ``it``, and ``bnorm``, ``tol``) and a :class:`Work`
that carries ``s`` and the scalars from one piece to the next:

* ``s(c, ap, ap_r0)``: ``alpha = rr0 / ap.r0``, ``s = r - alpha ap`` and
  ``ss = s.s``;
* ``xr(c, w, as_, as_s, as_as)``: ``omega``, ``x`` and ``r``, ``r.r`` and
  ``r.r0``, the convergence and restart tests, ``beta``; it writes the
  carry's ``rr0``, ``relres``, ``done`` and ``it += 1``;
* ``p(c, w, ap)``: ``p = r + beta (p - omega ap)``, and ``r0 = r`` on a
  restart.

:class:`TorchGlue` is the plain version, in torch ops, which every route
but the fused one runs (the CPU, bfloat16 and float64 state, a mesh's
reduced dots, a batch's ``on``-gated stores).  :data:`solver_glue` runs
each piece as one kernel of ``csrc/solver_glue.cu``, which streams its
vectors once over both leaves and evaluates the scalars on the device,
equal to the plain version bit for bit but for the dots' summation order;
:func:`glue_route` says where a solve may take it.  The kernels replace no
TPU kernel: the JAX package leaves this glue to XLA.  ``launches`` counts
the kernels' launches, and only those.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional

import torch

from ..assembly.stencil import State
from ..utils.graph import program_scratch
from .coded_cuda import CudaKernel, check_tensors, cuda_only

__all__ = ["TorchGlue", "solver_glue", "glue_route", "Work", "SCALARS",
           "FLAGS", "tree_axpy"]

# The iteration's scalars and flags, in csrc/solver_glue.cu Scalars' order.
SCALARS = ("alpha", "ss", "s_rel", "omega", "omega_g", "rr", "rr0_new",
           "r_rel", "beta", "beta_g", "omega_p")
FLAGS = ("conv_s", "conv_r", "restart")

# The kernels' CTAs of 256 threads: at most GLUE_CTAS_PER_SM an SM.
GLUE_THREADS = 256
GLUE_CTAS_PER_SM = 4


def _leaves(a):
    return (a.A, a.U) if isinstance(a, State) else (a,)


def _map(fn, *trees):
    """Apply ``fn`` leafwise over States (or plain tensors)."""
    if isinstance(trees[0], State):
        return State(fn(*(t.A for t in trees)), fn(*(t.U for t in trees)))
    return fn(*trees)


def tree_axpy(alpha, x, y):
    """y + alpha * x, leafwise.  ``alpha`` is cast to each leaf's dtype so
    higher-precision reduction scalars (dot_dtype) don't promote the
    iterate."""
    return _map(lambda xi, yi: yi + alpha.to(xi.dtype) * xi, x, y)


def _put(dst, fn, *args, on=None):
    """``dst := fn(*args)``, written into ``dst``; where the 0-d bool
    ``on`` is given, only where it is True (a select: ``dst`` keeps its
    bits otherwise)."""
    if on is None:
        fn(*args, out=dst)
    else:
        torch.where(on, fn(*args), dst, out=dst)


class Work(SimpleNamespace):
    """What one piece of an iteration's glue hands the next: ``s`` and the
    scalars (:data:`SCALARS`, :data:`FLAGS`), 0-d tensors."""


class TorchGlue:
    """The glue in torch ops, the plain version of the kernels.  ``dots``:
    ``dots([(a, b), ...]) -> [a.b, ...]``, the loop's (its dtype, and on a
    mesh its sum over the ranks).  With ``on`` (a 0-d bool) every store
    into the carry is a select on it."""

    def __init__(self, dots):
        self.dots = dots

    def s(self, c, ap, ap_r0) -> Work:
        alpha = c.rr0 / ap_r0
        s = tree_axpy(-alpha, ap, c.r)
        ss, = self.dots([(s, s)])
        return Work(s=s, alpha=alpha, ss=ss)

    def xr(self, c, w: Work, as_, as_s, as_as, on=None):
        alpha = w.alpha
        s_rel = torch.sqrt(w.ss) / c.bnorm
        conv_s = s_rel < c.tol
        omega = as_s / as_as
        # On the half-step exit the reference sets x += alpha*p only
        # (solvers.f90:34-38) and the loop ends: gating omega (and below
        # beta) to 0 gives the same x without full-state selects.
        zero = torch.zeros_like(omega)
        omega_g = torch.where(conv_s, zero, omega)

        def x_new(xi, pi, si):
            t = xi + alpha.to(xi.dtype) * pi
            _put(xi, torch.add, t, omega_g.to(xi.dtype) * si, on=on)

        _map(x_new, c.x, c.p, w.s)
        neg = -omega_g
        _map(lambda ri, si, ai: _put(ri, torch.add, si, neg.to(ai.dtype) * ai,
                                     on=on), c.r, w.s, as_)
        rr, rr0_new = self.dots([(c.r, c.r), (c.r, c.r0)])
        r_rel = torch.sqrt(rr) / c.bnorm
        conv_r = r_rel < c.tol

        # restart r0 = r; p = r (solvers.f90:47-49) == gating beta to 0 and
        # selecting r0; likewise a converged iteration's p/r0 are dead.
        restart = (torch.abs(rr0_new) / c.bnorm) < c.tol
        beta = (alpha / omega) * rr0_new / c.rr0
        stop = restart | conv_s
        beta_g = torch.where(stop, torch.zeros_like(beta), beta)
        omega_p = torch.where(stop, zero, omega)
        # next iteration's dot(r, r0): on restart r0 := r, so it is the
        # freshly computed dot(r, r); otherwise rr0_new verbatim
        _put(c.rr0, torch.where, restart, rr, rr0_new, on=on)
        _put(c.relres, torch.where, conv_s, s_rel, r_rel, on=on)
        _put(c.done, torch.bitwise_or, conv_s, conv_r, on=on)
        if on is None:
            c.it.add_(1)
        else:
            c.it.add_(on.to(torch.int32))
        w.__dict__.update(s_rel=s_rel, conv_s=conv_s, omega=omega,
                          omega_g=omega_g, rr=rr, rr0_new=rr0_new,
                          r_rel=r_rel, conv_r=conv_r, restart=restart,
                          beta=beta, beta_g=beta_g, omega_p=omega_p)

    def p(self, c, w: Work, ap, on=None):
        def p_new(pi, ri, api):
            inner = pi - w.omega_p.to(ri.dtype) * api
            _put(pi, torch.add, ri, w.beta_g.to(ri.dtype) * inner, on=on)

        _map(p_new, c.p, c.r, ap)
        sel = w.restart if on is None else w.restart & on
        _map(lambda r0i, ri: torch.where(sel, ri, r0i, out=r0i), c.r0, c.r)


def glue_route(b, x0, tol, dot_dtype: Optional[torch.dtype] = None,
               reduce=None, batched: bool = False) -> str:
    """``"fused"`` where a solve of ``b`` from ``x0`` at ``tol`` may run its
    glue on :data:`solver_glue`, else ``"torch"`` (:class:`TorchGlue`):
    fused where every leaf is a contiguous float32 CUDA tensor, the dots
    are float32 (``dot_dtype`` None or float32), ``tol`` is a float or a
    float32 tensor, and the dots are one device's (no ``reduce``, not
    ``batched``)."""
    leaves = _leaves(b) + _leaves(x0)
    if (reduce is not None or batched
            or dot_dtype not in (None, torch.float32)
            or (isinstance(tol, torch.Tensor) and tol.dtype != torch.float32)
            or sum(t.numel() for t in _leaves(b)) >= 2 ** 31):
        return "torch"
    ok = all(t.device.type == "cuda" and t.dtype == torch.float32
             and t.is_contiguous() for t in leaves)
    return "fused" if ok else "torch"


class _SolverGlue(CudaKernel):
    """The three kernels of ``csrc/solver_glue.cu`` (glue_s, glue_xr,
    glue_p), with :class:`TorchGlue`'s methods and no ``on``; CUDA tensors
    only (:func:`glue_route`)."""

    source = "solver_glue"

    def __init__(self):
        super().__init__()
        self._stream_scratch = {}

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.solver_glue_launch.argtypes = [
            ci, ctypes.POINTER(vp), ctypes.c_longlong, ctypes.c_longlong, ci,
            ctypes.POINTER(vp), ctypes.c_float, ci, vp]
        lib.solver_glue_launch.restype = ci

    def _scratch(self, dev):
        """(Scalars buffer, partials, counter, CTAs at most) on ``dev`` for
        the current stream, or for the device program being warmed up or
        captured (``utils/graph.py`` :func:`program_scratch`): made at its
        first launch there, the counter zeroed then and left zero by every
        launch, as ``ops/coded_cuda.py`` ``MarchKernel`` keeps its own."""
        store = program_scratch()
        if store is None:
            store = self._stream_scratch
            key = (dev, torch.cuda.current_stream(dev).cuda_stream)
        else:
            key = (self, dev)
        if key not in store:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            ctas = GLUE_CTAS_PER_SM * sms
            store[key] = (torch.zeros(16, dtype=torch.int32, device=dev),
                          torch.empty(2 * ctas, dtype=torch.float32,
                                      device=dev),
                          torch.zeros(1, dtype=torch.int32, device=dev),
                          ctas)
        return store[key]

    def _launch(self, which, vecs, scalars, tol_value=0.0):
        """Kernel ``which`` over ``vecs`` (States or tensors of one shape)
        with the 0-d device tensors ``scalars`` ((tensor or None, dtype)
        pairs, in the kernel's order); returns the Scalars buffer."""
        like = _leaves(vecs[0])
        dev = like[0].device
        cuda_only("solver_glue", like[0])
        check_tensors(dev, [(f"vector {j} leaf {k}", t, like[k].shape,
                             torch.float32)
                            for j, v in enumerate(vecs)
                            for k, t in enumerate(_leaves(v))]
                      + [(f"scalar {j}", t, (), dt)
                         for j, (t, dt) in enumerate(scalars)
                         if t is not None])
        lib, _ = self._ready(dev)
        na = like[0].numel()
        nu = like[1].numel() if len(like) > 1 else 0
        ptrs = [q for v in vecs
                for q in ([t.data_ptr() for t in _leaves(v)] + [0])[:2]]
        vec = 4 if (na % 4 == 0 and nu % 4 == 0
                    and all(q % 16 == 0 for q in ptrs)) else 1
        with torch.cuda.device(dev):
            sc, parts, counter, most = self._scratch(dev)
            ctas = min(-(-(na + nu) // (vec * GLUE_THREADS)), most)
            sp = [sc, parts, counter] + [t for t, _ in scalars]
            c_vecs = (ctypes.c_void_p * len(ptrs))(*ptrs)
            c_scal = (ctypes.c_void_p * len(sp))(
                *[None if t is None else t.data_ptr() for t in sp])
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.solver_glue_launch(which, c_vecs, na, nu, vec, c_scal,
                                         tol_value, ctas, stream)
        self._raise_on(err)
        return sc

    def s(self, c, ap, ap_r0) -> Work:
        f32 = torch.float32
        s = _map(torch.empty_like, c.r)
        sc = self._launch(0, [c.r, ap, s], [(c.rr0, f32), (ap_r0, f32)])
        f = sc[:len(SCALARS)].view(f32)
        views = {n: f[j] for j, n in enumerate(SCALARS)}
        views.update({n: sc[len(SCALARS) + j] for j, n in enumerate(FLAGS)})
        return Work(s=s, **views)

    def xr(self, c, w: Work, as_, as_s, as_as, on=None):
        if on is not None:
            raise ValueError("the glue kernels gate no stores")
        f32 = torch.float32
        # tol: the loop's device tensor, or its baked float (a host tensor
        # read as one)
        dev_tol = isinstance(c.tol, torch.Tensor) and c.tol.is_cuda
        self._launch(1, [c.x, c.p, w.s, as_, c.r0, c.r],
                     [(as_s, f32), (as_as, f32), (c.bnorm, f32),
                      (c.tol if dev_tol else None, f32), (c.rr0, f32),
                      (c.relres, f32), (c.done, torch.bool),
                      (c.it, torch.int32)],
                     tol_value=0.0 if dev_tol else float(c.tol))

    def p(self, c, w: Work, ap, on=None):
        if on is not None:
            raise ValueError("the glue kernels gate no stores")
        self._launch(2, [c.p, c.r, ap, c.r0], [])


solver_glue = _SolverGlue()
