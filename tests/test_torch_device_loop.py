"""The port's device loop (``solvers/bicgstab.py`` ``DeviceLoop``: setup,
the iterations, finish, with the scalars on the device) against the
per-iteration host loop it replaces, kept as the plain version
(``*_reference``): bit for bit (``torch.equal`` on x and relres;
iterations and converged equal), for K in {1, 3, 8}, in every solver form
the port runs (``bicgstab_wr`` with and without the fused ``mv_dot``,
``bicgstab_jacobi``, ``bicgstab_wr_right`` with Chebyshev, multigrid and
ILU(0)) at float64, float32 and bfloat16 state (dot_dtype None and
float32), on systems taken from a Simulation's second solve; the edge
cases (a zero right-hand side, a warm start that already converged, the
itmax budget, a restart, the half-step exit); the host reads per solve;
the ungated iteration the card's WHILE-node graph runs, driven by a host
while loop; Simulation's steps on the device loop against the same steps
on the plain loop; and the device loop at float64 against the JAX
package's ``bicgstab_wr`` within tests/test_torch_bicgstab.py's
tolerance.  On the CPU the loop runs K gated iterations between reads
(every store a select on the iteration's flag); the card's graphs are
tested in tests/test_torch_graph.py."""

import math

import numpy as np
import pytest
import torch

from _torch_parity import CPU

import jax.numpy as jnp

from eddy_currents_3d_tpu.solvers.bicgstab import bicgstab_wr as j_bicgstab
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.solvers import bicgstab as bs
from eddy_currents_3d_tpu_torch.solvers.chebyshev import (
    chebyshev_preconditioner)
from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

KS = (1, 3, 8)
DTYPES = {
    "f64": (torch.float64, None),
    "f32": (torch.float32, None),
    "bf16": (torch.bfloat16, None),
    "bf16-dot32": (torch.bfloat16, torch.float32),
}
FORMS = ("wr", "jacobi", "cheb", "mg", "ilu0")

_SYSTEMS = {}


def _leaves(v):
    return (v.A, v.U) if isinstance(v, State) else (v,)


def _assert_same(got, ref):
    """Bit for bit: x, relres, iterations, converged."""
    assert got.iterations == ref.iterations
    assert got.converged == ref.converged
    assert torch.equal(got.relres, ref.relres), (got.relres, ref.relres)
    for g, r in zip(_leaves(got.x), _leaves(ref.x)):
        assert g.dtype == r.dtype and torch.equal(g, r)


def _system(dtype_name, precond):
    """(Simulation, b, x0, tol) of the second solve of a small static case
    at ``dtype_name`` with ``precond``: the inputs the device loop held."""
    key = (dtype_name, precond)
    if key not in _SYSTEMS:
        dtype, dd = DTYPES[dtype_name]
        model = load_case(case_static(shape_xyz=(12, 12, 10), steps=2))
        sim = Simulation(model, dtype, dot_dtype=dd, device=CPU,
                         precond=precond)
        st = sim.init_state()
        for t, _ in sim.steps:
            st, _ = sim._step(st, t)
        (loop,) = sim._loops.values()
        clone = lambda v: State(v.A.clone(), v.U.clone())
        _SYSTEMS[key] = (sim, clone(loop._s.b), clone(loop._s.x0), sim._tol)
    return _SYSTEMS[key]


def _minv(form, sim):
    """The right preconditioner of ``form`` (cheb, mg or ilu0)."""
    if form == "cheb":
        lmax = sim.system.gershgorin * 1.01
        return chebyshev_preconditioner(sim.op.apply, 4, lmax / 30.0, lmax)
    if form == "mg":
        return sim._mg.apply
    return lambda v: sim._ilu.apply(v, sweeps=2)


def _solvers(form, sim, k):
    """(device-loop solve, plain solve) of ``form`` on ``sim``'s operator,
    each a function of (b, x0, tol)."""
    A, itmax, dd = sim.op.apply, sim.model.solver.itmax, sim.dot_dtype
    if form == "wr":
        return (lambda b, x0, tol: bs.bicgstab_wr(A, b, x0, tol, itmax, dd,
                                                  k=k),
                lambda b, x0, tol: bs.bicgstab_wr_reference(A, b, x0, tol,
                                                            itmax, dd))
    if form == "wr-mv_dot":
        mvd = sim.coded_op.apply_dots
        return (lambda b, x0, tol: bs.bicgstab_wr(A, b, x0, tol, itmax, dd,
                                                  mv_dot=mvd, k=k),
                lambda b, x0, tol: bs.bicgstab_wr_reference(
                    A, b, x0, tol, itmax, dd, mv_dot=mvd))
    if form == "jacobi":
        d = sim._jac[0]
        return (lambda b, x0, tol: bs.bicgstab_jacobi(A, d, b, x0, tol, itmax,
                                                      dd, k=k),
                lambda b, x0, tol: bs.bicgstab_jacobi_reference(
                    A, d, b, x0, tol, itmax, dd))
    minv = _minv(form, sim)
    return (lambda b, x0, tol: bs.bicgstab_wr_right(A, minv, b, x0, tol,
                                                    itmax, dd, k=k),
            lambda b, x0, tol: bs.bicgstab_wr_right_reference(
                A, minv, b, x0, tol, itmax, dd))


def _precond(form):
    return {"wr": None, "wr-mv_dot": None, "jacobi": "jacobi",
            "cheb": "cheb"}.get(form, form)


CASES = ([(f, d) for f in FORMS for d in DTYPES]
         + [("wr-mv_dot", "f32")])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form,dtype_name", CASES)
def test_device_loop_equals_host_loop(form, dtype_name, k):
    sim, b, x0, tol = _system(dtype_name, _precond(form))
    device, plain = _solvers(form, sim, k)
    got, ref = device(b, x0, tol), plain(b, x0, tol)
    assert ref.iterations > 0 and ref.converged
    _assert_same(got, ref)
    # one read per batch: ceil(n / K), and at least one
    assert got.reads == max(1, math.ceil(got.iterations / k))
    assert got.reads <= math.ceil((got.iterations + 1) / k) + 1


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", ["wr", "jacobi", "cheb", "mg", "ilu0"])
def test_zero_rhs(form, k):
    """b = 0 (and x0 = 0 for the right-preconditioned form, whose warm
    start then meets the tolerance): 0 iterations; x0 returned (the Jacobi
    form returns D^-1 (D x0), as its plain version does)."""
    sim, b, x0, tol = _system("f32", _precond(form))
    zero = State(torch.zeros_like(b.A), torch.zeros_like(b.U))
    x0 = zero if form in ("cheb", "mg", "ilu0") else x0
    device, plain = _solvers(form, sim, k)
    got, ref = device(zero, x0, tol), plain(zero, x0, tol)
    assert got.iterations == 0 and got.converged and got.reads == 1
    _assert_same(got, ref)
    if form != "jacobi":
        assert torch.equal(got.x.A, x0.A) and torch.equal(got.x.U, x0.U)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form,dtype_name", [("cheb", "f64"), ("mg", "f32"),
                                             ("ilu0", "f64")])
def test_warm_start_already_converged(form, dtype_name, k):
    """A warm start that meets the tolerance: 0 iterations, x0 itself
    (JAX's device-side select), in one read."""
    sim, b, x0, tol = _system(dtype_name, _precond(form))
    device, plain = _solvers(form, sim, k)
    x_conv = plain(b, x0, tol).x
    got, ref = device(b, x_conv, tol), plain(b, x_conv, tol)
    assert ref.iterations == 0 and got.reads == 1
    _assert_same(got, ref)
    assert torch.equal(got.x.A, x_conv.A) and torch.equal(got.x.U, x_conv.U)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", ["wr", "jacobi", "mg"])
def test_itmax_budget(form, k):
    """tol = 0 runs itmax + 1 iterations and does not converge."""
    sim, b, x0, _ = _system("f64", _precond(form))
    tol = torch.zeros((), dtype=torch.float64)
    device, plain = _solvers(form, sim, k)
    sim.model.solver.itmax, itmax = 4, sim.model.solver.itmax
    try:
        device, plain = _solvers(form, sim, k)
        got, ref = device(b, x0, tol), plain(b, x0, tol)
    finally:
        sim.model.solver.itmax = itmax
    assert ref.iterations == 5 and not ref.converged
    _assert_same(got, ref)
    assert got.reads == math.ceil(5 / k)


def _dense(seed, n=20):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * 0.5 + np.eye(n) * 2
    return A, rng.standard_normal(n), rng.standard_normal(n)


def _restarts(A, b, x0, tol, itmax=200):
    """Whether BiCGSTABwr restarts (|r.r0|/||b|| < tol) before it
    converges on this system, in float64 numpy."""
    x, r = x0.copy(), b - A @ x0
    bn = np.linalg.norm(b)
    r0, p, rr0 = r.copy(), r.copy(), r @ r
    for _ in range(itmax + 1):
        ap = A @ p
        alpha = rr0 / (ap @ r0)
        s = r - alpha * ap
        if np.linalg.norm(s) / bn < tol:
            return False
        As = A @ s
        om = (As @ s) / (As @ As)
        r = s - om * As
        if np.linalg.norm(r) / bn < tol:
            return False
        rn = r @ r0
        if abs(rn) / bn < tol:
            return True
        p = r + alpha / om * rn / rr0 * (p - om * ap)
        rr0 = rn
    return False


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("fused", [False, True])
def test_restart(fused, k):
    """A system that restarts (r0 = r; p = r) before it converges."""
    A, b, x0 = _dense(0)
    assert _restarts(A, b, x0, 0.1)
    At = torch.from_numpy(A)
    mv = lambda v: At @ v
    mvd = ((lambda v, w: (lambda y: (y, torch.sum(y * w), torch.sum(y * y)))(
        At @ v)) if fused else None)
    args = (mv, torch.from_numpy(b), torch.from_numpy(x0), 0.1, 200)
    got = bs.bicgstab_wr(*args, mv_dot=mvd, k=k)
    ref = bs.bicgstab_wr_reference(*args, mv_dot=mvd)
    assert ref.iterations > 1 and ref.converged
    _assert_same(got, ref)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("fused", [False, True])
def test_half_step_exit(fused, k):
    """A = 2I: the first half step lands on the solution (s = 0)."""
    n = 16
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(n))
    mv = lambda v: 2.0 * v
    mvd = ((lambda v, w: (lambda y: (y, torch.sum(y * w), torch.sum(y * y)))(
        2.0 * v)) if fused else None)
    got = bs.bicgstab_wr(mv, b, torch.zeros(n, dtype=torch.float64), 1e-8, 50,
                         mv_dot=mvd, k=k)
    ref = bs.bicgstab_wr_reference(mv, b, torch.zeros(n, dtype=torch.float64),
                                   1e-8, 50, mv_dot=mvd)
    assert ref.iterations == 1 and float(ref.relres) == 0.0
    _assert_same(got, ref)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("seed,tol", [(0, 1e-8), (1, 1e-5), (3, 1e-3)])
def test_matches_jax_f64(seed, tol, k):
    """The device loop against JAX's while_loop at float64: the same
    iterations, x within 1e-10 of its scale (test_torch_bicgstab.py)."""
    rng = np.random.default_rng(seed)
    n = 60
    A = rng.standard_normal((n, n)) * 0.3 + np.eye(n) * 6.0
    b, x0 = rng.standard_normal(n), rng.standard_normal(n) * 0.01
    Aj = jnp.asarray(A)
    rj = j_bicgstab(lambda v: Aj @ v, jnp.asarray(b), jnp.asarray(x0), tol,
                    500)
    At = torch.from_numpy(A)
    rt = bs.bicgstab_wr(lambda v: At @ v, torch.from_numpy(b),
                        torch.from_numpy(x0), tol, 500, k=k)
    assert rt.iterations == int(rj.iterations) > 0
    assert rt.converged == bool(rj.converged) is True
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())


def test_loop_reuses_its_static_tensors():
    """One DeviceLoop serves consecutive solves (as Simulation's does):
    each equals a fresh plain solve, and returns tensors of its own."""
    sim, b, x0, tol = _system("f32", None)
    loop = bs.DeviceLoop(sim.op.apply, sim.model.solver.itmax,
                         mv_dot=sim.coded_op.apply_dots, k=3)
    first = loop.solve(b, x0, tol)
    b2 = State(b.A * 0.5, b.U * 0.5)
    second = loop.solve(b2, first.x, tol)
    _assert_same(second, bs.bicgstab_wr_reference(
        sim.op.apply, b2, first.x, tol, sim.model.solver.itmax,
        mv_dot=sim.coded_op.apply_dots))
    _assert_same(first, bs.bicgstab_wr_reference(
        sim.op.apply, b, x0, tol, sim.model.solver.itmax,
        mv_dot=sim.coded_op.apply_dots))
    assert loop.captures == 0          # nothing is captured on the CPU


@pytest.mark.parametrize("precond", [None, "jacobi", "cheb_jacobi", "mg",
                                     "ilu0"])
def test_simulation_steps_equal_plain_loop(precond):
    """Simulation's steps on the device loop against the same steps on
    the per-iteration loop (``_step(eager=True)``), bit for bit, with
    the host reads per solve within ceil((n + 1) / K) + 1."""
    model = load_case(case_static(shape_xyz=(12, 12, 10), steps=3))
    sim = Simulation(model, torch.float32, device=CPU, precond=precond,
                     cheb_order=8)
    s1 = s2 = sim.init_state()
    for t, _ in sim.steps:
        s1, i1 = sim._step(s1, t)
        s2, i2 = sim._step(s2, t, eager=True)
        assert (i1.iterations, i1.converged) == (i2.iterations, i2.converged)
        assert torch.equal(i1.relres, i2.relres)
        assert torch.equal(s1.A, s2.A) and torch.equal(s1.U, s2.U)
        assert torch.equal(s1.carry, s2.carry)
        assert i1.reads <= math.ceil((i1.iterations + 1) / bs.K) + 1
    assert len(sim._loops) == 1


@pytest.mark.parametrize("form,dtype_name", [("wr", "f32"),
                                             ("wr-mv_dot", "f32"),
                                             ("jacobi", "bf16-dot32"),
                                             ("cheb", "f64"), ("mg", "bf16"),
                                             ("ilu0", "f32")])
def test_while_node_body_equals_host_loop(form, dtype_name):
    """What the card's WHILE-node graph runs (csrc/solve_graph.cu), on the
    host: setup, the ungated iteration while not done and it <= itmax,
    then finish; bit for bit with the plain loop."""
    sim, b, x0, tol = _system(dtype_name, _precond(form))
    kw = {}
    if form == "wr-mv_dot":
        kw["mv_dot"] = sim.coded_op.apply_dots
    elif form == "jacobi":
        d = sim._jac[0]
        kw["scale"] = (d, State(1.0 / d.A, 1.0 / d.U))
    elif form != "wr":
        kw["minv"] = _minv(form, sim)
    loop = bs.DeviceLoop(sim.op.apply, sim.model.solver.itmax, sim.dot_dtype,
                         **kw)
    S = loop._stage(b, x0, tol)
    loop._setup(S)
    while not S.done.item() and S.it.item() <= loop.itmax:
        loop._iterate(S)
    if hasattr(S, "x_out"):
        loop._finish(S)
        x, relres = S.x_out, S.relres_out
    else:
        x, relres = S.x, S.relres
    ref = _solvers(form, sim, 1)[1](b, x0, tol)
    assert (S.it.item(), S.done.item()) == (ref.iterations, ref.converged)
    assert torch.equal(relres, ref.relres)
    assert torch.equal(x.A, ref.x.A) and torch.equal(x.U, ref.x.U)
