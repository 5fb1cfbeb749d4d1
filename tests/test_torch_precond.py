"""The port's preconditioned solves against the JAX package's.

* f64: for Jacobi, Chebyshev (order 4, the default) and Chebyshev on
  Jacobi (order 8, as the JAX bench runs team7), the port's CPU transient
  (flat-roll operator) matches JAX ``Simulation(dtype=float64)`` iteration
  for iteration, with A/U/carry within ``F64_TOL`` of tests/test_torch_sim.py.
* f32: the port's coded plain route against JAX's coded operator in
  Pallas interpret mode, on the whole-plane route and on the split route
  (forced as in tests/test_torch_split.py): every step converges and A
  agrees within 4·tol·scale (tests/test_coded.py:230-233).
* The Chebyshev preconditioner and its warm-start exit match JAX's;
  ``mg`` raises with ``use_coded=True``, and ``ilu0`` with ``use_coded=True``
  and bfloat16 coefficients (ILU(0) itself: tests/test_torch_ilu0.py).
"""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.ops import pallas_coded as jpc
from eddy_currents_3d_tpu.ops import pallas_stencil as ps
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.solvers import chebyshev as jcheb
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.ops import coded as tc
from eddy_currents_3d_tpu_torch.solvers import chebyshev as tcheb
from eddy_currents_3d_tpu_torch.testing import cases as tcases

F64_TOL = 1e-9

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=3),
    "moving": lambda c: c.case_moving(shape_xyz=(18, 18, 12), steps=3),
}

# precond -> Simulation keywords; cheb keeps the default order 4
PRECONDS = {
    "jacobi": {"precond": "jacobi"},
    "cheb": {"precond": "cheb"},
    "cheb_jacobi": {"precond": "cheb_jacobi", "cheb_order": 8},
}


def _models(name):
    return (jcases.load_case(CASES[name](jcases)),
            tcases.load_case(CASES[name](tcases)))


def _close(got, ref, tol):
    got, ref = host(got), host(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("precond", sorted(PRECONDS))
def test_f64_precond_matches_jax(precond, name):
    mj, mt = _models(name)
    kw = PRECONDS[precond]
    sj, dj = JSimulation(mj, dtype=jnp.float64, **kw).run()
    tsim = ect.Simulation(mt, torch.float64, device=CPU, **kw)
    assert tsim.coded_op is None
    st, dt = tsim.run()
    assert dt["iterations"] == [int(i) for i in dj["iterations"]]
    assert not dt["unconverged_steps"] and min(dt["iterations"]) > 0
    _close(st.A, sj.A, F64_TOL)
    _close(st.U, sj.U, F64_TOL)
    _close(st.carry, sj.carry, F64_TOL)


@pytest.mark.parametrize("route", ["whole_plane", "split"])
@pytest.mark.parametrize("precond", sorted(PRECONDS))
def test_f32_precond_matches_jax_interpret(precond, route, monkeypatch):
    monkeypatch.setattr(ps, "INTERPRET", True)
    if route == "split":
        monkeypatch.setattr(jpc, "_WHOLE_PLANE_BUDGET", 0)
        monkeypatch.setattr(jpc, "_YT_BLOCK_BUDGET", 150_000)
        monkeypatch.setattr(tc, "_WHOLE_PLANE_BUDGET", 0)
    mj, mt = _models("static")
    kw = PRECONDS[precond]
    jsim = JSimulation(mj, dtype=jnp.float32, use_pallas=True, use_coded=True,
                       **kw)
    assert (jsim.coded_op._uplan() is not None) == (route == "split")
    sj, dj = jsim.run(num_steps=2)
    tsim = ect.Simulation(mt, torch.float32, device=CPU, **kw)
    assert tsim.coded_op.split == (route == "split")
    st, dt = tsim.run(num_steps=2)
    assert not dj["unconverged_steps"] and not dt["unconverged_steps"]
    assert all(i > 0 for i in dt["iterations"])
    _close(st.A, sj.A, 4 * mt.solver.tolerance)


def _flat_ops(name):
    mj, mt = _models(name)
    return (j_assemble(mj, jnp.float64), t_assemble(mt, torch.float64, CPU),
            mt.shape_zyx, mt.cond_mask)


def test_chebyshev_preconditioner_matches_jax():
    sj, st, shape, cond = _flat_ops("static")
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3,) + shape)
    U = rng.standard_normal(shape) * cond
    lmax = st.gershgorin * 1.01
    assert lmax == sj.gershgorin * 1.01
    Mj = jcheb.chebyshev_preconditioner(sj.op.apply, 8, lmax / 30.0, lmax)
    Mt = tcheb.chebyshev_preconditioner(st.op.apply, 8, lmax / 30.0, lmax)
    zj = Mj(JState(jnp.asarray(A), jnp.asarray(U)))
    zt = Mt(TState(torch.from_numpy(A), torch.from_numpy(U)))
    _close(zt.A, zj.A, 1e-12)
    _close(zt.U, zj.U, 1e-12)


def test_cheb_warm_start_already_converged():
    """A warm start that meets the tolerance returns x0 with 0 iterations,
    as JAX's ``already`` exit does: its values, bit for bit (a select on
    the device, as in JAX)."""
    sj, st, shape, cond = _flat_ops("static")
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3,) + shape)
    U = rng.standard_normal(shape) * cond
    x0 = TState(torch.from_numpy(A), torch.from_numpy(U))
    b = st.op.apply(x0)
    lmax = st.gershgorin * 1.01
    kw = dict(order=4, lmin=lmax / 30.0, lmax=lmax)
    res = tcheb.bicgstab_wr_cheb(st.op.apply, b, x0, torch.tensor(5e-3), 50,
                                 **kw)
    assert res.iterations == 0 and res.converged
    assert torch.equal(res.x.A, x0.A) and torch.equal(res.x.U, x0.U)
    xj = JState(jnp.asarray(A), jnp.asarray(U))
    rj = jcheb.bicgstab_wr_cheb(sj.op.apply, sj.op.apply(xj), xj,
                                jnp.asarray(5e-3), 50, **kw)
    assert int(rj.iterations) == 0
    assert float(res.relres) == pytest.approx(float(rj.relres), abs=1e-15)


# precond -> (Simulation keywords, the error, its message): mg never runs
# on the coded operator, so an explicit use_coded=True raises; ilu0 runs on
# it, but not with bfloat16 coefficients, which only the field tier takes
REFUSED = {
    "mg": ({"use_coded": True}, ValueError, "precond='mg'"),
    "ilu0": ({"use_coded": True, "coeff_dtype": torch.bfloat16}, ValueError,
             "coeff_dtype"),
}


@pytest.mark.parametrize("precond", ["mg", "ilu0"])
def test_unported_precond_raises(precond):
    model = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 12), steps=2))
    kw, err, match = REFUSED[precond]
    with pytest.raises(err, match=match):
        ect.Simulation(model, torch.float32, device=CPU, precond=precond, **kw)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        ect.Simulation(model, torch.float32, device=CPU, precond="ssor")
