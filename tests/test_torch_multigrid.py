"""The port's multigrid preconditioner and field-tier transients against the
JAX package.

* ``galerkin_coarsen`` equals JAX's; restriction and prolongation are
  adjoint and equal JAX's.
* The V-cycle of ``build_mg`` in float64 agrees with JAX's within 1e-12
  relative, on the same ``ka`` and ``ku0``, on an even grid and on an odd
  one (21x19x11, so every pad-and-crop path of the V-cycle runs);
  ``convert.mg_from_jax_levels`` carries a JAX hierarchy across.
* ``MgUnsupported`` above ``MG_CELL_LIMIT``.
* Transients against JAX ``Simulation(dtype=float64, dot_dtype=float64)``
  over 3 steps of case_static(20, 20, 12): ``precond="mg"`` and
  ``use_coded=False`` in float64 with equal iterations and A within 1e-9
  of scale; ``coeff_dtype=bfloat16`` in float32 (the field tier's plain
  versions against JAX's flat-roll operator on bfloat16 coefficients)
  within 4·tol·scale, JAX's own bf16-vs-f32 bound being 0.03·scale
  (tests/test_round2_features.py).
"""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, rand_fields

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.solvers import multigrid as jmg
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.solvers import multigrid as tmg
from eddy_currents_3d_tpu_torch.testing import cases as tcases

CASES = {
    "even": lambda c: c.case_static(shape_xyz=(20, 20, 12), steps=3),
    "odd": lambda c: c.case_static(shape_xyz=(21, 19, 11), steps=3),
}


def _models(name):
    return (jcases.load_case(CASES[name](jcases)),
            tcases.load_case(CASES[name](tcases)))


def _ku0(system):
    """The U-row diagonal on the full grid, zero off the box (as
    simulate.py places it)."""
    ku0 = np.zeros(system.np_ka.shape[1:])
    z0, z1, y0, y1, x0, x1 = system.op.box
    ku0[z0:z1, y0:y1, x0:x1] = host(system.op.ku[0])
    return ku0


def _rel_close(got, ref, rtol):
    got, ref = host(got), host(ref)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


@pytest.mark.parametrize("name", sorted(CASES))
def test_galerkin_coarsen_matches_jax(name):
    mj, _ = _models(name)
    ka = np.asarray(j_assemble(mj, jnp.float64).np_ka)
    rng = np.random.default_rng(4)
    ka = ka * rng.uniform(0.5, 1.5, ka.shape)
    while min(ka.shape[1:]) >= 2:
        got, ref = tmg.galerkin_coarsen(ka), jmg.galerkin_coarsen(ka)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
        ka = ref


def test_restrict_prolong_adjoint_and_match_jax():
    rng = np.random.default_rng(5)
    r = rng.standard_normal((3, 4, 6, 8))
    e = rng.standard_normal((3, 2, 3, 4))
    Rr = tmg._restrict(torch.from_numpy(r))
    Pe = tmg._prolong(torch.from_numpy(e))
    # <R r, e> == <r, P e>
    np.testing.assert_allclose(float((Rr.numpy() * e).sum()),
                               float((r * Pe.numpy()).sum()), rtol=1e-12)
    np.testing.assert_allclose(Rr.numpy(), host(jmg._restrict(jnp.asarray(r))),
                               rtol=1e-12)
    np.testing.assert_array_equal(Pe.numpy(), host(jmg._prolong(jnp.asarray(e))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_vcycle_matches_jax(name):
    mj, mt = _models(name)
    sj = j_assemble(mj, jnp.float64)
    ka, ku0 = np.asarray(sj.np_ka), _ku0(sj)
    jm = jmg.build_mg(ka, ku0=ku0, dtype=jnp.float64)
    tm = tmg.build_mg(ka, ku0=ku0, dtype=torch.float64, device=CPU)
    assert len(tm.levels) == len(jm.levels) >= 3
    assert [l.shape for l in tm.levels] == [l.shape for l in jm.levels]
    if name == "odd":
        assert any(l.pshape != l.shape for l in tm.levels)
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, 6)
    yj = jm.apply(JState(jnp.asarray(A), jnp.asarray(U)))
    x = TState(torch.from_numpy(A), torch.from_numpy(U))
    yt = tm.apply(x)
    _rel_close(yt.A, yj.A, 1e-12)
    _rel_close(yt.U, yj.U, 1e-12)
    # the JAX hierarchy carried across applies the same V-cycle
    cm = convert.mg_from_jax_levels(
        [(host(l.ka), host(l.inv_d)) for l in jm.levels], host(jm.inv_du),
        jm.pre, jm.post, jm.coarse_sweeps, CPU)
    yc = cm.apply(x)
    _rel_close(yc.A, yj.A, 1e-12)
    np.testing.assert_array_equal(host(yc.U), host(yt.U))


def test_mg_unsupported_above_cell_limit():
    nz, ny, nx = 64, 256, 256
    assert nz * ny * nx > tmg.MG_CELL_LIMIT == jmg.MG_CELL_LIMIT
    ka = np.broadcast_to(np.zeros((1, 1, 1, 1), np.float32), (7, nz, ny, nx))
    with pytest.raises(ect.MgUnsupported, match="cells"):
        ect.build_mg(ka)
    assert issubclass(ect.MgUnsupported, ValueError)
    # at the limit it builds
    small = np.zeros((7, 4, 4, 4))
    small[0] = 1.0
    assert len(ect.build_mg(small, dtype=torch.float64).levels) >= 1


def _close(got, ref, tol):
    got, ref = host(got), host(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


# transient cases: (port dtype, Simulation keywords)
TRANSIENTS = {
    "mg_f64": (torch.float64, {"precond": "mg"}),
    "use_coded_false_f64": (torch.float64, {"use_coded": False}),
    "bf16_coeffs_f32": (torch.float32, {"coeff_dtype": "bf16"}),
}


@pytest.mark.parametrize("case", sorted(TRANSIENTS))
def test_field_tier_transient_matches_jax(case):
    mj, mt = _models("even")
    dtype, kw = TRANSIENTS[case]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("coeff_dtype") == "bf16":
        jkw["coeff_dtype"], tkw["coeff_dtype"] = jnp.bfloat16, torch.bfloat16
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sj, dj = JSimulation(mj, dtype=jdt, dot_dtype=jdt, **jkw).run()
    tsim = ect.Simulation(mt, dtype, device=CPU, **tkw)
    assert tsim.coded_op is None
    assert (tsim.field_op is not None) == (dtype == torch.float32)
    st, dt = tsim.run()
    assert not dt["unconverged_steps"] and min(dt["iterations"]) > 0
    if dtype == torch.float64:
        assert dt["iterations"] == [int(i) for i in dj["iterations"]]
        _close(st.A, sj.A, 1e-9)
        _close(st.U, sj.U, 1e-9)
        _close(st.carry, sj.carry, 1e-9)
    else:
        assert tsim.field_op.dtype == torch.bfloat16
        _close(st.A, sj.A, 4 * mt.solver.tolerance)


def test_mg_f32_on_the_field_tier():
    """precond="mg" in float32 on the CPU runs the field tier's plain
    versions and lands within 4·tol·scale of the float64 mg run."""
    _, mt = _models("odd")
    sim32 = ect.Simulation(mt, torch.float32, device=CPU, precond="mg")
    assert sim32.coded_op is None and sim32.field_op is not None
    assert sim32._mg.levels[0].ka.dtype == torch.float32
    s32, d32 = sim32.run()
    s64, d64 = ect.Simulation(mt, torch.float64, device=CPU,
                              precond="mg").run()
    assert not d32["unconverged_steps"] and min(d32["iterations"]) > 0
    _close(s32.A.double(), s64.A, 4 * mt.solver.tolerance)


def test_tier_choice():
    """use_coded=None takes the coded operator where it applies and routes
    CodedUnsupported to the field tier; use_coded=True never degrades."""
    _, mt = _models("even")
    assert ect.Simulation(mt, torch.float32, device=CPU).coded_op is not None
    for kw, why in (({"precond": "mg"}, "precond='mg'"),
                    ({"coeff_dtype": torch.bfloat16}, "coeff_dtype"),):
        with pytest.raises(ValueError, match=why):
            ect.Simulation(mt, torch.float32, device=CPU, use_coded=True, **kw)
    with pytest.raises(ValueError, match="dtype=torch.float64"):
        ect.Simulation(mt, torch.float64, device=CPU, use_coded=True)
    with pytest.raises(ValueError, match="coeff_dtype"):
        ect.Simulation(mt, torch.float32, device=CPU, coeff_dtype=torch.float16)
    text = tcases.case_static(shape_xyz=(12, 12, 12), steps=2).replace(
        "C='mu0*35260000.0'", "C=0")
    nocond = tcases.load_case(text)
    with pytest.raises(ect.CodedUnsupported, match="no conducting"):
        ect.Simulation(nocond, torch.float32, device=CPU, use_coded=True)
    sim = ect.Simulation(nocond, torch.float32, device=CPU)
    assert sim.coded_op is None and sim.field_op.box is None
    st, diag = sim.run()
    assert not diag["unconverged_steps"] and torch.isfinite(st.A).all()
    assert not torch.any(st.U)
