"""The port's bfloat16-state path against the JAX package's.

* Field tier: the plain versions of ``field_a``/``field_u`` at bfloat16
  state and bfloat16 coefficients against JAX's Pallas ``_apply_a`` and
  the whole ``PallasStencilOperator.apply`` (``_apply_a`` + ``_apply_u``)
  in interpret mode, on the grids of tests/test_torch_field.py: within
  ``JAX_TOL`` (2e-2) of the output scale.  JAX rounds every operation in
  bfloat16, and its own error against float64 arithmetic on the same
  bfloat16 values reaches 1.06e-2 of scale on such inputs.  The port sums
  in float32 and rounds once, so against that float64 arithmetic it is
  within ``ONE_ROUNDING`` (4e-3 > 2^-8, half a bfloat16 ulp of the
  largest output plus the float32 sum's error), and twice that on the A
  rows of the conductor box, which field_u's add rounds a second time.
* Solvers: ``bicgstab_jacobi``, ``bicgstab_wr_right`` and
  ``bicgstab_wr_cheb`` with ``dot_dtype`` against JAX's at float64, value
  for value (1e-12 of scale); at bfloat16 state with float32 dots the
  iterate stays bfloat16 and the reductions float32.
* ``Simulation(dtype=bfloat16)`` on 24x24x12 for every preconditioner and
  ``dot_dtype`` in {float32, None}: the state stays bfloat16, each step
  converges where JAX's does, and the step-1 gap to the port's float64
  step 1, max|dA| / (tol · max|A_f64|), is at most twice JAX's own
  bfloat16 gap, measured here on the same model, preconditioner and
  ``dot_dtype`` (JAX runs its flat-roll operator on the CPU).
* The coded float32 route runs its fused ``apply_dots`` only for
  ``dot_dtype=None``, as in JAX.
* The VTK writers give the same bytes from one bfloat16 state, and
  ``convert`` carries a bfloat16 JAX state, multigrid hierarchy and ILU(0)
  factors across bit for bit, equal to what the port builds itself.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, pallas_interpret, rand_fields
from test_torch_field import CASES as FIELD_CASES

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.io import vtk as jvtk
from eddy_currents_3d_tpu.ops import pallas_stencil as ps
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.solvers import bicgstab as jbicg
from eddy_currents_3d_tpu.solvers import chebyshev as jcheb
from eddy_currents_3d_tpu.solvers import ilu0 as jilu
from eddy_currents_3d_tpu.solvers import multigrid as jmg
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.io import vtk as tvtk
from eddy_currents_3d_tpu_torch.ops import coded as tcoded
from eddy_currents_3d_tpu_torch.ops.field import (FieldStencilOperator,
                                                  field_a_reference)
from eddy_currents_3d_tpu_torch.solvers import bicgstab as tbicg
from eddy_currents_3d_tpu_torch.solvers import chebyshev as tcheb
from eddy_currents_3d_tpu_torch.solvers.multigrid import stencil7_apply
from eddy_currents_3d_tpu_torch.testing import cases as tcases

BF16 = torch.bfloat16
JAX_TOL = 2e-2
ONE_ROUNDING = 4e-3
SOLVER_TOL = 1e-12

# ---- the field tier's plain versions at bfloat16 state ----

GRIDS = ("static", "convection", "odd", "nocond")


def _field_systems(name):
    """(JAX bf16 system, port bf16 system, port model)."""
    mj = jcases.load_case(FIELD_CASES[name](jcases))
    mt = tcases.load_case(FIELD_CASES[name](tcases))
    return j_assemble(mj, jnp.bfloat16), t_assemble(mt, BF16, CPU), mt


def _bf16_state(mt, seed):
    """Random A and U rounded to bfloat16, as (port State, JAX State)."""
    A, U = (torch.from_numpy(a).to(BF16)
            for a in rand_fields(mt.shape_zyx, mt.cond_mask, seed))
    to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return TState(A, U), JState(to_j(A), to_j(U))


def _f64_apply(op, x):
    """The operator's bfloat16 coefficients applied to the bfloat16 state in
    float64 arithmetic."""
    f = {k: getattr(op, k).double() for k in ("ka", "gu", "ku", "da")}
    op64 = FieldStencilOperator(**f, shape_zyx=op.shape_zyx, box=op.box)
    return op64.apply(TState(x.A.double(), x.U.double()))


def _gap(got, ref, scale):
    return np.abs(host(got).astype(np.float64)
                  - host(ref).astype(np.float64)).max() / scale


@pytest.mark.parametrize("name", GRIDS)
def test_field_plain_versions_at_bf16_state(name):
    sj, st, mt = _field_systems(name)
    xt, xj = _bf16_state(mt, 4)
    op = FieldStencilOperator.from_assembled(st)
    assert op.dtype == BF16 and (op.box is None) == (name == "nocond")
    pop = ps.from_assembled(sj)
    with pallas_interpret():
        xp = pop.pad_state(xj)
        yj = pop.unpad_state(pop.apply(xp))
        yj_a = pop.unpad_state(JState(ps._apply_a(pop.ka_p, xp.A), xp.U)).A
    assert yj.A.dtype == jnp.bfloat16
    ya = field_a_reference(op.ka, xt.A)
    yt = op.apply(xt)
    assert ya.dtype == yt.A.dtype == yt.U.dtype == BF16
    y64 = _f64_apply(op, xt)
    a64 = field_a_reference(op.ka.double(), xt.A.double())
    scale = max(np.abs(host(y64.A)).max(), np.abs(host(y64.U)).max())
    a_scale = np.abs(host(a64)).max()
    # against JAX's kernels
    assert _gap(ya, yj_a, a_scale) <= JAX_TOL
    assert _gap(yt.A, yj.A, scale) <= JAX_TOL
    assert _gap(yt.U, yj.U, scale) <= JAX_TOL
    # against float64 arithmetic on the same values: one rounding, and two
    # for the A rows of the conductor box (field_a's store, then field_u's
    # add of the grad-U terms, as in JAX's two kernels)
    assert _gap(ya, a64, a_scale) <= ONE_ROUNDING
    assert _gap(yt.U, y64.U, scale) <= ONE_ROUNDING
    assert _gap(yt.A, y64.A, scale) <= 2 * ONE_ROUNDING


def test_field_a_plain_rounds_once():
    """At bfloat16 state the sum is float32 and rounded once at the store;
    the multigrid's stencil apply takes the same path on the CPU."""
    _, st, mt = _field_systems("static")
    op = FieldStencilOperator.from_assembled(st)
    xt, _ = _bf16_state(mt, 6)
    want = field_a_reference(op.ka, xt.A.float()).to(BF16)
    assert torch.equal(field_a_reference(op.ka, xt.A), want)
    assert torch.equal(stencil7_apply(op.ka, xt.A), want)
    # float32 and float64 state are the unrounded sums, as before
    f32 = field_a_reference(op.ka, xt.A.float())
    assert f32.dtype == torch.float32
    assert field_a_reference(op.ka, xt.A.double()).dtype == torch.float64


# ---- solvers with dot_dtype ----

def _system(seed, n=60, shift=6.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * 0.3 + np.eye(n) * shift
    return A, rng.standard_normal(n), rng.standard_normal(n) * 0.01


def _solve(pkg, kind, A, b, x0, tol, dot):
    """One solve of ``kind`` by the JAX package ("j") or the port ("t")."""
    if pkg == "j":
        Am, arr, mod, cheb = jnp.asarray(A), jnp.asarray, jbicg, jcheb
    else:
        Am, arr, mod, cheb = torch.from_numpy(A), torch.from_numpy, tbicg, tcheb
    mv = lambda v: Am @ v
    d = arr(np.diag(A).copy())
    bb, xx = arr(b), arr(x0)
    if kind == "jacobi":
        return mod.bicgstab_jacobi(mv, d, bb, xx, tol, 500, dot_dtype=dot)
    if kind == "right":
        return mod.bicgstab_wr_right(mv, lambda v: v / d, bb, xx, tol, 500,
                                     dot_dtype=dot)
    return cheb.bicgstab_wr_cheb(mv, bb, xx, tol, 500, order=4, lmin=3.0,
                                 lmax=9.0, dot_dtype=dot)


@pytest.mark.parametrize("kind", ["jacobi", "right", "cheb"])
@pytest.mark.parametrize("seed,tol", [(0, 1e-8), (1, 1e-4)])
def test_solvers_with_dot_dtype_match_jax(kind, seed, tol):
    A, b, x0 = _system(seed)
    rj = _solve("j", kind, A, b, x0, tol, jnp.float64)
    rt = _solve("t", kind, A, b, x0, tol, torch.float64)
    assert rt.iterations == int(rj.iterations) > 0
    assert rt.converged == bool(rj.converged) is True
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=SOLVER_TOL * np.abs(xj).max())
    assert float(rt.relres) == pytest.approx(float(rj.relres), rel=1e-9)
    assert np.linalg.norm(b - A @ rt.x.numpy()) / np.linalg.norm(b) < tol


@pytest.mark.parametrize("kind", ["jacobi", "right", "cheb"])
def test_bf16_iterate_stays_bf16(kind):
    """bfloat16 state, float32 dots: the recurrence's float32 scalars are
    cast to the leaf dtype, so every iterate leaf stays bfloat16."""
    A, b, x0 = _system(2, n=40)
    At = torch.from_numpy(A).to(BF16)
    seen = []

    def mv(v):
        seen.append(v.dtype)
        return (At.float() @ v.float()).to(BF16)

    d = torch.from_numpy(np.diag(A).copy()).to(BF16)
    bb, xx = torch.from_numpy(b).to(BF16), torch.from_numpy(x0).to(BF16)
    tol = torch.tensor(5e-3, dtype=BF16)
    if kind == "jacobi":
        res = tbicg.bicgstab_jacobi(mv, d, bb, xx, tol, 200,
                                    dot_dtype=torch.float32)
    elif kind == "right":
        res = tbicg.bicgstab_wr_right(mv, lambda v: v / d, bb, xx, tol, 200,
                                      dot_dtype=torch.float32)
    else:
        res = tcheb.bicgstab_wr_cheb(mv, bb, xx, tol, 200, order=4, lmin=3.0,
                                     lmax=9.0, dot_dtype=torch.float32)
    assert res.converged and res.iterations > 0
    assert res.x.dtype == BF16 and set(seen) == {BF16}
    assert res.relres.dtype == torch.float32


# ---- Simulation at bfloat16 ----

PRECONDS = (None, "jacobi", "cheb", "cheb_jacobi", "mg", "ilu0")
DOTS = {"dot_f32": (torch.float32, jnp.float32), "dot_none": (None, None)}
SIM_CASE = lambda c: c.case_static(shape_xyz=(24, 24, 12), steps=2)


@pytest.fixture(scope="module")
def models():
    return jcases.load_case(SIM_CASE(jcases)), tcases.load_case(SIM_CASE(tcases))


@pytest.fixture(scope="module")
def step1_f64(models):
    """The port's float64 step 1 (the flat-roll operator, unpreconditioned:
    every preconditioner converges to the same tolerance)."""
    st, _ = ect.Simulation(models[1], torch.float64, device=CPU).run(
        num_steps=1)
    return host(st.A)


def _step_gap(A, A64, tol):
    return np.abs(host(A).astype(np.float64) - A64).max() / (
        tol * np.abs(A64).max())


@pytest.mark.parametrize("dots", sorted(DOTS))
@pytest.mark.parametrize("precond", PRECONDS, ids=str)
def test_bf16_simulation_matches_jax(models, step1_f64, precond, dots):
    mj, mt = models
    tdot, jdot = DOTS[dots]
    tol = mt.solver.tolerance
    jsim = JSimulation(mj, dtype=jnp.bfloat16, dot_dtype=jdot,
                       precond=precond)
    assert jsim.pallas_op is None and jsim.coded_op is None
    j1, _ = jsim.run(num_steps=1)
    _, dj = jsim.run(num_steps=2)
    tsim = ect.Simulation(mt, BF16, tdot, device=CPU, precond=precond)
    assert tsim.coded_op is None and tsim.field_op.dtype == BF16
    t1, _ = tsim.run(num_steps=1)
    st, dt = tsim.run(num_steps=2)
    for s in (t1, st):
        assert s.A.dtype == s.U.dtype == s.carry.dtype == BF16
        assert torch.isfinite(s.A.float()).all()
    # every step converges where JAX's does
    assert not dj["unconverged_steps"] and not dt["unconverged_steps"]
    assert min(dt["iterations"]) > 0
    gap_t = _step_gap(t1.A, step1_f64, tol)
    gap_j = _step_gap(j1.A, step1_f64, tol)
    assert gap_t <= 2.0 * gap_j, (gap_t, gap_j)


@pytest.mark.parametrize("precond", [None, "jacobi"], ids=str)
def test_coded_route_fuses_dots_only_without_dot_dtype(monkeypatch, precond):
    mt = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 12), steps=2))
    calls = []
    fused = tcoded.CodedStencilOperator.apply_dots

    def counting(self, *args):
        calls.append(1)
        return fused(self, *args)

    monkeypatch.setattr(tcoded.CodedStencilOperator, "apply_dots", counting)
    runs = {}
    for dot in (torch.float32, None):
        sim = ect.Simulation(mt, torch.float32, dot, device=CPU,
                             precond=precond)
        assert sim.coded_op is not None
        del calls[:]
        runs[dot], diag = sim.run(num_steps=1)
        assert not diag["unconverged_steps"]
        assert bool(calls) == (dot is None), (dot, len(calls))
    scale = np.abs(host(runs[None].A)).max()
    tol = mt.solver.tolerance
    assert _gap(runs[torch.float32].A, runs[None].A, scale) <= 4 * tol


# ---- VTK and convert ----

def test_vtk_bytes_from_a_bf16_state(tmp_path):
    mj, mt = (c.load_case(c.case_static(shape_xyz=(12, 10, 8), steps=2))
              for c in (jcases, tcases))
    rng = np.random.default_rng(11)
    nz, ny, nx = mt.shape_zyx
    A, carry = (torch.from_numpy(rng.standard_normal((3, nz, ny, nx)) * 1e4)
                .to(BF16) for _ in range(2))
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    info = SimpleNamespace(src_cells=[fn.cells for fn in mt.functions],
                           src_values=list(rng.standard_normal(
                               len(mt.functions))))
    jsim = SimpleNamespace(model=mj, system=SimpleNamespace(
        cond_mask=mj.cond_mask))
    jvtk.write_outputs(jsim, SimpleNamespace(A=j(A), carry=j(carry)), info,
                       1, str(tmp_path / "j"))
    tsim = SimpleNamespace(model=mt, system=SimpleNamespace(
        cond_mask=torch.from_numpy(mt.cond_mask)))
    tvtk.write_outputs(tsim, SimpleNamespace(A=A, carry=carry), info, 1,
                       str(tmp_path / "t"))
    for f in ("field_1.vtk", "src_1.vtk"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes()


def test_bf16_run_writes_outputs(tmp_path):
    mt = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 12), steps=3))
    sim = ect.Simulation(mt, BF16, torch.float32, device=CPU)
    st, diag = sim.run(output_dir=str(tmp_path))
    assert not diag["unconverged_steps"]
    f = tvtk.read_vtk_vectors(str(tmp_path / "field_2.vtk"))
    np.testing.assert_array_equal(
        f["Field_A"], np.moveaxis(host(st.A.float()), 0, -1).reshape(-1, 3))


def _bits(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == BF16
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype.name == "bfloat16"
    return a.view(np.int16)


def test_convert_carries_a_bf16_state():
    mj, mt = (c.load_case(c.case_static(shape_xyz=(12, 12, 12), steps=3))
              for c in (jcases, tcases))
    sj, _ = JSimulation(mj, dtype=jnp.bfloat16, dot_dtype=jnp.float32).run(
        num_steps=2)
    state = convert.state_from_numpy(
        host(sj.A), host(sj.U), host(sj.carry), host(sj.prev.A),
        host(sj.prev.U), dtype=BF16, device=CPU)
    for got, ref in ((state.A, sj.A), (state.U, sj.U),
                     (state.carry, sj.carry), (state.prev.A, sj.prev.A),
                     (state.prev.U, sj.prev.U)):
        np.testing.assert_array_equal(_bits(got), _jbits(ref))
    # and the port steps on from it at bfloat16
    tsim = ect.Simulation(mt, BF16, torch.float32, device=CPU)
    nxt, info = tsim._step(state, tsim.steps[2][0])
    assert info.converged and nxt.A.dtype == BF16


def test_convert_carries_a_bf16_hierarchy():
    mj, mt = (c.load_case(c.case_static(shape_xyz=(21, 19, 11), steps=2))
              for c in (jcases, tcases))
    sj, st = j_assemble(mj, jnp.bfloat16), t_assemble(mt, BF16, CPU)
    ku0 = np.zeros(mt.shape_zyx)
    z0, z1, y0, y1, x0, x1 = st.op.box
    ku0[z0:z1, y0:y1, x0:x1] = host(st.op.ku[0].double())
    mg_j = jmg.build_mg(sj.op.ka, ku0=ku0, dtype=jnp.bfloat16)
    got = convert.mg_from_jax_levels(
        [(host(l.ka), host(l.inv_d)) for l in mg_j.levels],
        host(mg_j.inv_du), mg_j.pre, mg_j.post, mg_j.coarse_sweeps, CPU)
    own = ect.build_mg(st.op.ka, ku0=ku0, dtype=BF16, device=CPU)
    assert len(got.levels) == len(own.levels) == len(mg_j.levels) >= 3
    for lj, lg, lo in zip(mg_j.levels, got.levels, own.levels):
        for f in ("ka", "inv_d"):
            np.testing.assert_array_equal(_bits(getattr(lg, f)),
                                          _jbits(getattr(lj, f)))
            np.testing.assert_array_equal(_bits(getattr(lo, f)),
                                          _jbits(getattr(lj, f)))
        assert lg.shape == lo.shape and lg.pshape == lo.pshape
    np.testing.assert_array_equal(_bits(got.inv_du), _jbits(mg_j.inv_du))
    np.testing.assert_array_equal(_bits(own.inv_du), _jbits(mg_j.inv_du))
    # the V-cycle on a bfloat16 field stays bfloat16
    v = torch.from_numpy(rand_fields(mt.shape_zyx, mt.cond_mask, 2)[0]).to(BF16)
    assert own.apply_scalar(v).dtype == BF16


@pytest.mark.parametrize("padded", [False, True], ids=["flat", "padded"])
def test_convert_carries_bf16_ilu0_factors(padded):
    mj, mt = (c.load_case(c.case_static(shape_xyz=(14, 12, 10), steps=2))
              for c in (jcases, tcases))
    sj, st = j_assemble(mj, jnp.float64), t_assemble(mt, torch.float64, CPU)
    fj = jilu.ilu0_stencil_factorize(sj, mj, dtype=jnp.bfloat16,
                                     pallas=padded)
    got = convert.stencil_ilu0_from_jax(fj, mt.shape_zyx, sj.op.box, CPU)
    own = ect.ilu0_stencil_factorize(st, mt, dtype=BF16, device=CPU,
                                     field=padded)
    assert got.padded == own.padded == padded
    for f in ("d_A", "d_U", "inv_dA", "inv_dU"):
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(own, f)))
    for side in ("L_op", "U_op"):
        for f in ("ka", "gu", "ku", "da"):
            np.testing.assert_array_equal(
                _bits(getattr(getattr(got, side), f)),
                _bits(getattr(getattr(own, side), f)))
    # one application at bfloat16 state through the port's factors
    xt, _ = _bf16_state(mt, 8)
    z = own.apply(xt)
    assert z.A.dtype == z.U.dtype == BF16 and torch.isfinite(z.A.float()).all()
