"""The port's ILU(0) against the JAX package's.

* The native factorization (the port's own ``csrc/ilu0_host.cpp``) equals
  JAX's ``ilu0_native`` bit for bit on a ``to_csr`` of case_static(14, 12,
  10); ``_ilu0_numpy`` agrees to 1e-12; the exact solve likewise; pivot and
  ordering faults raise.
* ``ILU0Preconditioner`` (ELL sweeps) and ``StencilILU0`` (flat-roll
  factors): ``apply`` for 1, 2 and 4 sweeps and ``matvec`` against JAX's,
  rtol 1e-11 / atol 1e-13, on case_static and on a two-domain model whose
  conducting numbering is not monotone (so ku splits entrywise).
* The field-form factors (``field=True``; the field tier's plain versions
  on the CPU) against the flat-roll form, and their fields keep the
  assembled fields' zeros (the invariant ``field_u`` relies on).
* ``convert.stencil_ilu0_from_jax`` carries JAX's flat and padded factors
  across.
* ``Simulation(float64, device="cpu", precond="ilu0")`` against JAX's over
  3 steps: equal iterations, A within 1e-9 of scale; float32 on the CPU
  takes the coded route with a full-shape U (``compact_u=False``).
"""

import numpy as np
import pytest
import torch
from scipy import sparse

from _torch_parity import CPU, host, rand_fields, two_domain_case

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import (assemble_operator as j_assemble,
                                                    to_csr as j_to_csr)
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.ops import native as jnative
from eddy_currents_3d_tpu.ops import pallas_stencil as ps
from eddy_currents_3d_tpu.ops import sparse as jsp
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.solvers import ilu0 as jilu
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.assembly.assemble import (assemble_operator as t_assemble,
                                                          to_csr as t_to_csr)
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.assembly.stencil import StencilOperator
from eddy_currents_3d_tpu_torch.ops import native as tnative
from eddy_currents_3d_tpu_torch.ops import sparse as tsp
from eddy_currents_3d_tpu_torch.ops.field import FieldStencilOperator
from eddy_currents_3d_tpu_torch.solvers import ilu0 as tilu
from eddy_currents_3d_tpu_torch.testing import cases as tcases

MODELS = {
    "static": lambda c: c.case_static(shape_xyz=(14, 12, 10), steps=2),
    "two_domain": two_domain_case,
}


def _models(name):
    return (jcases.load_case(MODELS[name](jcases)),
            tcases.load_case(MODELS[name](tcases)))


def _csr(name="static"):
    """(JAX model, port model, JAX system, port system, sorted scipy CSR)."""
    mj, mt = _models(name)
    sj, st = j_assemble(mj, jnp.float64), t_assemble(mt, torch.float64, CPU)
    a = t_to_csr(st, mt)
    a.sort_indices()
    return mj, mt, sj, st, a


def _close(got, ref):
    np.testing.assert_allclose(host(got), host(ref), rtol=1e-11, atol=1e-13)


def _flatten(model, A, U) -> np.ndarray:
    """Fields -> the reference's global [Ax|Ay|Az|U] vector
    (tests/test_ilu0_stencil.py)."""
    condno = model.cond_number.ravel()
    order = np.nonzero(condno)[0]
    u_cells = order[np.argsort(condno[order])]
    return np.concatenate([np.asarray(A).ravel(), np.asarray(U).ravel()[u_cells]])


def _unflatten(model, z):
    shape = model.shape_zyx
    N = model.n_cells
    condno = model.cond_number.ravel()
    order = np.nonzero(condno)[0]
    u_cells = order[np.argsort(condno[order])]
    U = np.zeros(N)
    U[u_cells] = z[3 * N:]
    return z[:3 * N].reshape((3,) + shape), U.reshape(shape)


def _spd_random(n=40, density=0.1):
    m = sparse.random(n, n, density=density, random_state=np.random.RandomState(5))
    a = (m + m.T).tocsr()
    a.setdiag(np.abs(a).sum(axis=1).A1 + 1.0)   # diagonally dominant
    a.sort_indices()
    return a.tocsr()


def test_native_factorization_matches_jax():
    *_, a = _csr()
    indptr = np.asarray(a.indptr, np.int64)
    cols = np.asarray(a.indices, np.int32)
    ref = jnative.ilu0_native(indptr, cols, a.data)
    assert ref is not None, "the JAX package's native engine did not build"
    got = tnative.ilu0_native(indptr, cols, a.data)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(tilu._ilu0_numpy(indptr, cols, a.data), got,
                               rtol=1e-12, atol=0)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    np.testing.assert_array_equal(
        tnative.ilu0_solve_native(indptr, cols, got, b),
        jnative.ilu0_solve_native(indptr, cols, ref, b))


def test_native_raises_on_faults():
    a = sparse.csr_matrix(np.array([[0.0, 1.0], [1.0, 1.0]]))
    args = (np.asarray(a.indptr, np.int64), np.asarray(a.indices, np.int32))
    with pytest.raises(ZeroDivisionError, match="pivot"):
        tnative.ilu0_native(*args, a.data)
    with pytest.raises(ZeroDivisionError, match="pivot"):
        tilu._ilu0_numpy(*args, a.data)
    with pytest.raises(ZeroDivisionError):
        tilu.ilu0_factorize(tsp.from_scipy(a, torch.float64, CPU))
    indptr = np.array([0, 2, 3], np.int64)
    cols = np.array([1, 0, 1], np.int32)                 # row 0 unsorted
    with pytest.raises(ValueError, match="unsorted"):
        tnative.ilu0_native(indptr, cols, np.ones(3))
    with pytest.raises(ValueError, match="unsorted"):
        tilu._ilu0_numpy(indptr, cols, np.ones(3))
    with pytest.raises(ZeroDivisionError, match="pivot"):   # 1x1, [[0]]
        tnative.ilu0_solve_native(np.array([0, 1]), np.array([0]),
                                  np.zeros(1), np.ones(1))


def test_exact_solve_roundtrip():
    """M^-1 (L U x) == x through the native sequential solver."""
    a = _spd_random(n=35)
    csr = tsp.from_scipy(a, torch.float64, CPU)
    x = np.random.default_rng(1).standard_normal(35)
    M = tilu.ilu0_factorize(csr)
    b = host(M.matvec(torch.from_numpy(x)))
    np.testing.assert_allclose(tilu.ilu0_solve_exact(csr, b), x, rtol=1e-9)
    np.testing.assert_allclose(
        tilu.ilu0_solve_exact(csr, b),
        jilu.ilu0_solve_exact(jsp.from_scipy(a, jnp.float64), b), rtol=1e-13)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ell_preconditioner_matches_jax(name):
    mj, mt, _, _, a = _csr(name)
    Mj = jilu.ilu0_factorize(jsp.from_scipy(a, jnp.float64), dtype=jnp.float64)
    Mt = tilu.ilu0_factorize(tsp.from_scipy(a, torch.float64, CPU))
    for f in ("L", "U"):
        np.testing.assert_array_equal(host(getattr(Mt, f).cols),
                                      host(getattr(Mj, f).cols))
        np.testing.assert_array_equal(host(getattr(Mt, f).vals),
                                      host(getattr(Mj, f).vals))
    np.testing.assert_array_equal(host(Mt.d), host(Mj.d))
    v = np.random.default_rng(2).standard_normal(a.shape[0])
    for sweeps in (1, 2, 4):
        _close(Mt.apply(torch.from_numpy(v), sweeps=sweeps),
               Mj.apply(jnp.asarray(v), sweeps=sweeps))
    _close(Mt.matvec(torch.from_numpy(v)), Mj.matvec(jnp.asarray(v)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stencil_ilu0_matches_jax(name):
    mj, mt, sj, st, a = _csr(name)
    fj = jilu.ilu0_stencil_factorize(sj, mj, dtype=jnp.float64)
    ft = ect.ilu0_stencil_factorize(st, mt, dtype=torch.float64, device=CPU)
    assert not ft.padded and isinstance(ft.L_op, StencilOperator)
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, 3)
    vj = JState(jnp.asarray(A), jnp.asarray(U))
    vt = TState(torch.from_numpy(A), torch.from_numpy(U))
    for sweeps in (1, 2, 4):
        zj, zt = fj.apply(vj, sweeps=sweeps), ft.apply(vt, sweeps=sweeps)
        _close(zt.A, zj.A)
        _close(zt.U, zj.U)
    mj_, mt_ = fj.matvec(vj), ft.matvec(vt)
    _close(mt_.A, mj_.A)
    _close(mt_.U, mj_.U)
    # and the same map as the port's ELL form on the global vector
    M = tilu.ilu0_factorize(tsp.from_scipy(a, torch.float64, CPU))
    z = host(M.apply(torch.from_numpy(_flatten(mt, A, U)), sweeps=2))
    wA, wU = _unflatten(mt, z)
    zt = ft.apply(vt, sweeps=2)
    _close(zt.A, wA)
    _close(zt.U, wU)


def test_ku_splits_on_both_sides_on_two_domains():
    """With PHYS_C numbering that is not monotone, some ku offset puts
    entries in both the lower and the upper factor."""
    _, mt, _, st, _ = _csr("two_domain")
    ft = ect.ilu0_stencil_factorize(st, mt, dtype=torch.float64, device=CPU)
    both = [(ft.L_op.ku[o] != 0).any() and (ft.U_op.ku[o] != 0).any()
            for o in range(1, 7)]
    assert any(both)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_field_factors_match_flat_roll(name):
    """field=True builds field-tier factors whose plain applies give the
    flat-roll factors' map, from the same fields; each factor field is zero
    wherever the assembled field is."""
    _, mt, _, st, _ = _csr(name)
    flat = ect.ilu0_stencil_factorize(st, mt, dtype=torch.float64, device=CPU)
    fld = ect.ilu0_stencil_factorize(st, mt, dtype=torch.float64, device=CPU,
                                     field=True)
    assert fld.padded and isinstance(fld.L_op, FieldStencilOperator)
    for f in ("ka", "gu", "ku", "da"):
        for a, b in ((fld.L_op, flat.L_op), (fld.U_op, flat.U_op)):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    z0, z1, y0, y1, x0, x1 = st.op.box
    win = lambda x: x[..., z0:z1, y0:y1, x0:x1]
    for a in (fld.L_op, fld.U_op):
        assert not torch.any(a.ka[torch.from_numpy(st.np_ka == 0)])
        for f in ("gu", "ku", "da"):
            assembled = torch.from_numpy(win(getattr(st, f"np_{f}")) == 0)
            assert not torch.any(getattr(a, f)[assembled]), f
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, 4)
    v = TState(torch.from_numpy(A), torch.from_numpy(U))
    for sweeps in (1, 2):
        zf, zs = fld.apply(v, sweeps=sweeps), flat.apply(v, sweeps=sweeps)
        np.testing.assert_allclose(host(zf.A), host(zs.A), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(host(zf.U), host(zs.U), rtol=1e-12, atol=1e-14)


def test_convert_carries_the_factors_across():
    mj, mt, sj, st, _ = _csr()
    ref = ect.ilu0_stencil_factorize(st, mt, dtype=torch.float64, device=CPU)
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, 5)
    v = TState(torch.from_numpy(A), torch.from_numpy(U))
    want = ref.apply(v, sweeps=2)
    flat = convert.stencil_ilu0_from_jax(
        jilu.ilu0_stencil_factorize(sj, mj, dtype=jnp.float64),
        mt.shape_zyx, sj.op.box, CPU)
    assert not flat.padded
    padded_j = jilu.ilu0_stencil_factorize(sj, mj, dtype=jnp.float64,
                                           pallas=True)
    assert padded_j.padded
    padded = convert.stencil_ilu0_from_jax(padded_j, mt.shape_zyx, sj.op.box,
                                           CPU)
    assert padded.padded and isinstance(padded.L_op, FieldStencilOperator)
    assert padded.d_A.shape == tuple(mt.shape_zyx)
    for got in (flat.apply(v, sweeps=2), padded.apply(v, sweeps=2)):
        np.testing.assert_allclose(host(got.A), host(want.A), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(host(got.U), host(want.U), rtol=1e-12,
                                   atol=1e-14)


def test_bicgstab_ilu0_matches_jax():
    n = 6
    d = sparse.eye(n)
    lap1 = sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n))
    a = (sparse.kron(sparse.kron(lap1, d), d) + sparse.kron(sparse.kron(d, lap1), d)
         + sparse.kron(sparse.kron(d, d), lap1)).tocsr()
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    x0 = np.zeros(a.shape[0])
    rj = jilu.bicgstab_ilu0(jsp.from_scipy(a, jnp.float64), jnp.asarray(b),
                            jnp.asarray(x0), 1e-8, 2000, sweeps=6,
                            dot_dtype=jnp.float64)
    rt = tilu.bicgstab_ilu0(tsp.from_scipy(a, torch.float64, CPU),
                            torch.from_numpy(b), torch.from_numpy(x0),
                            1e-8, 2000, sweeps=6)
    assert rt.converged and rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(host(rt.x), host(rj.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(a @ host(rt.x), b, atol=1e-8 * np.linalg.norm(b) * 10)


def _sim_close(got, ref, tol):
    got, ref = host(got), host(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def test_f64_simulation_matches_jax():
    mj = jcases.load_case(jcases.case_static(shape_xyz=(12, 12, 10), steps=3))
    mt = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 10), steps=3))
    sj, dj = JSimulation(mj, dtype=jnp.float64, dot_dtype=jnp.float64,
                         precond="ilu0", warm_start="previous").run()
    tsim = ect.Simulation(mt, torch.float64, device=CPU, precond="ilu0",
                          warm_start="previous")
    assert tsim._tier is None and not tsim._ilu.padded
    st, dt = tsim.run()
    assert not dt["unconverged_steps"] and min(dt["iterations"]) > 0
    assert dt["iterations"] == [int(i) for i in dj["iterations"]]
    _sim_close(st.A, sj.A, 1e-9)
    _sim_close(st.U, sj.U, 1e-9)
    _sim_close(st.carry, sj.carry, 1e-9)


@pytest.mark.parametrize("use_coded", [None, False], ids=["coded", "field"])
def test_f32_simulation_ilu0_on_the_cpu(use_coded, monkeypatch):
    """float32 on the CPU: the coded route keeps a full-shape U
    (compact_u=False, even where the split route would be taken), or the
    field tier; both land within 4·tol·scale of the float64 ilu0 run."""
    from eddy_currents_3d_tpu_torch.ops import coded
    monkeypatch.setattr(coded, "_WHOLE_PLANE_BUDGET", 0)
    mt = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 10), steps=3))
    sim = ect.Simulation(mt, torch.float32, device=CPU, precond="ilu0",
                         use_coded=use_coded)
    if use_coded is None:
        assert sim.coded_op is not None
        assert not sim.coded_op.compact_u and not sim.coded_op.split
        assert ect.Simulation(mt, torch.float32, device=CPU).coded_op.split
    else:
        assert sim.coded_op is None and sim.field_op is not None
    assert sim._ilu.padded and sim._ilu.L_op.ka.dtype == torch.float32
    s32, d32 = sim.run()
    s64, _ = ect.Simulation(mt, torch.float64, device=CPU,
                            precond="ilu0").run()
    assert not d32["unconverged_steps"] and min(d32["iterations"]) > 0
    _sim_close(s32.A.double(), s64.A, 4 * mt.solver.tolerance)


def test_ilu0_under_bf16_coefficients_keeps_f32_factors():
    mt = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 10), steps=2))
    sim = ect.Simulation(mt, torch.float32, device=CPU, precond="ilu0",
                         coeff_dtype=torch.bfloat16)
    assert sim.field_op.dtype == torch.bfloat16
    assert sim._ilu.L_op.ka.dtype == torch.float32
    st, diag = sim.run()
    assert not diag["unconverged_steps"] and torch.isfinite(st.A).all()
