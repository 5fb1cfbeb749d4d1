"""The port's time-step path as a whole against the JAX package.

* f64: ``Simulation(dtype=float64, device="cpu")`` (flat-roll operator)
  against JAX ``Simulation(dtype=float64)``: identical per-step iteration
  counts, A/U/carry within 1e-9·scale (summation order only), the same
  source cells and latch, and the motion distances to 1 ulp.  (Inside its
  jitted step XLA folds ``(c1·sin(x))·(dt/Δ)`` into ``sin(x)·(c1·dt/Δ)``,
  so JAX's own distances move by an ulp against the host float64
  evaluation; on the same velocity values the two motion codes agree bit
  for bit, tests/test_torch_motion.py.)
* f32: the port's coded plain path against JAX's coded operator in Pallas
  interpret mode: every step converges and A agrees within 4·tol·scale
  (tests/test_coded.py:230-233).
* A JAX mid-transient state carried across with ``convert`` steps the same
  in both packages; the VTK writers give byte-identical files; importing
  the port loads no jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, pallas_interpret

import jax.numpy as jnp

from eddy_currents_3d_tpu.io import vtk as jvtk
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.io import vtk as tvtk
from eddy_currents_3d_tpu_torch.testing import cases as tcases

F64_TOL = 1e-9

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=3),
    "moving": lambda c: c.case_moving(shape_xyz=(18, 18, 12), steps=3),
}


def _models(name):
    return (jcases.load_case(CASES[name](jcases)),
            tcases.load_case(CASES[name](tcases)))


def _close(got, ref, tol):
    got, ref = host(got), host(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _assert_motion_equal(mt, mj):
    np.testing.assert_array_equal(mt.movestop, np.asarray(mj.movestop))
    np.testing.assert_allclose(mt.distance, np.asarray(mj.distance),
                               rtol=4e-16, atol=0)
    # the Kahan compensation holds the rounding residue: |comp| <= 1 ulp
    assert np.all(np.abs(mt.comp) <= np.spacing(np.abs(mt.distance)) + 1e-300)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_transient_matches_jax(name):
    mj, mt = _models(name)
    sj, dj = JSimulation(mj, dtype=jnp.float64).run()
    tsim = ect.Simulation(mt, torch.float64, device=CPU)
    assert tsim.coded_op is None
    st, dt = tsim.run()
    assert dt["iterations"] == dj["iterations"]
    assert not dt["unconverged_steps"]
    _close(st.A, sj.A, F64_TOL)
    _close(st.U, sj.U, F64_TOL)
    _close(st.carry, sj.carry, F64_TOL)
    _assert_motion_equal(st.motion, sj.motion)
    if name == "moving":
        assert np.abs(st.motion.distance).max() > 0


def test_f32_coded_plain_matches_jax_interpret():
    mj, mt = _models("static")
    with pallas_interpret():
        jsim = JSimulation(mj, dtype=jnp.float32, use_pallas=True,
                           use_coded=True)
        assert jsim.coded_op is not None
        sj, dj = jsim.run(num_steps=2)
    tsim = ect.Simulation(mt, torch.float32, device=CPU)
    assert tsim.coded_op is not None
    st, dt = tsim.run(num_steps=2)
    assert not dj["unconverged_steps"] and not dt["unconverged_steps"]
    assert all(i > 0 for i in dt["iterations"])
    tol = mt.solver.tolerance
    _close(st.A, sj.A, 4 * tol)


def test_mid_transient_state_carried_across():
    """Both packages take the same next step from a JAX mid-transient
    state (moving coils, so the motion state is carried too)."""
    mj, mt = _models("moving")
    jsim = JSimulation(mj, dtype=jnp.float64)
    sj, _ = jsim.run(num_steps=2)
    state = convert.state_from_numpy(
        host(sj.A), host(sj.U), host(sj.carry), host(sj.prev.A),
        host(sj.prev.U), host(sj.motion.distance), host(sj.motion.movestop),
        host(sj.motion.comp), dtype=torch.float64, device=CPU)
    t = jsim.steps[2][0]
    nj, ij = jsim._step(sj, t)
    tsim = ect.Simulation(mt, torch.float64, device=CPU)
    nt, it = tsim._step(state, tsim.steps[2][0])
    assert it.iterations == int(ij.iterations)
    _close(nt.A, nj.A, F64_TOL)
    _close(nt.U, nj.U, F64_TOL)
    _close(nt.carry, nj.carry, F64_TOL)
    _close(nt.prev.A, nj.prev.A, 0.0)
    _assert_motion_equal(nt.motion, nj.motion)
    for cj, ct in zip(ij.src_cells, it.src_cells):
        np.testing.assert_array_equal(ct, np.asarray(cj))


def test_vtk_writers_byte_identical(tmp_path):
    model = tcases.load_case(tcases.case_static(shape_xyz=(12, 10, 8), steps=2))
    rng = np.random.default_rng(9)
    nz, ny, nx = model.shape_zyx
    A = rng.standard_normal((3, nz, ny, nx))
    carry = rng.standard_normal((3, nz, ny, nx))
    cells = [fn.cells for fn in model.functions]
    vals = list(rng.standard_normal(len(cells)))
    dirs = [fn.direction for fn in model.functions]
    for pkg in ("j", "t"):
        mod = jvtk if pkg == "j" else tvtk
        mod.write_field(str(tmp_path / f"field_{pkg}.vtk"), model.delta, A,
                        carry, model.cond_mask)
        mod.write_field(str(tmp_path / f"bare_{pkg}.vtk"), model.delta, A,
                        carry, None)
        mod.write_src(str(tmp_path / f"src_{pkg}.vtk"), model.delta,
                      model.shape_xyz, cells, vals, dirs)
    for stem in ("field", "bare", "src"):
        assert (tmp_path / f"{stem}_j.vtk").read_bytes() == \
            (tmp_path / f"{stem}_t.vtk").read_bytes()
    np.testing.assert_array_equal(
        tvtk.curl(A, model.delta), jvtk.curl(A, model.delta))


def test_run_writes_outputs(tmp_path):
    model = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 12), steps=3))
    sim = ect.Simulation(model, torch.float32, device=CPU)
    st, diag = sim.run(output_dir=str(tmp_path))
    outs = [o for _, o in sim.steps if o is not None]
    assert outs == [1, 2]
    for n in outs:
        f = tvtk.read_vtk_vectors(str(tmp_path / f"field_{n}.vtk"))
        assert f["dims"] == model.shape_xyz
        assert np.isfinite(f["Vector_field_eddy"]).all()
        s = tvtk.read_vtk_vectors(str(tmp_path / f"src_{n}.vtk"))
        assert s["Vector_field_SRC"].shape[0] == sum(
            len(fn.cells) for fn in model.functions)
    np.testing.assert_array_equal(
        f["Field_A"], np.moveaxis(host(st.A), 0, -1).reshape(-1, 3))
    assert sorted(os.listdir(tmp_path)) == [
        "field_1.vtk", "field_2.vtk", "src_1.vtk", "src_2.vtk"]


def test_unported_options_raise():
    model = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 12), steps=2))
    with pytest.raises(ValueError, match="dtype must be float32 or float64"):
        ect.Simulation(model, torch.bfloat16, device=CPU)   # bf16 state
    with pytest.raises(ValueError, match="warm_start"):
        ect.Simulation(model, torch.float32, device=CPU, warm_start="zero")
    with pytest.raises(TypeError):
        ect.Simulation(model, torch.float32)          # no device given


def test_import_loads_no_jax():
    code = ("import sys, eddy_currents_3d_tpu_torch, "
            "eddy_currents_3d_tpu_torch.convert, "
            "eddy_currents_3d_tpu_torch.ops.sparse, "
            "eddy_currents_3d_tpu_torch.ops.bsr_cuda, "
            "eddy_currents_3d_tpu_torch.ops.native, "
            "eddy_currents_3d_tpu_torch.solvers.ilu0; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'eddy_currents_3d_tpu' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
