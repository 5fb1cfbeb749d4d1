"""The port's ``Simulation.run_scan`` (segments between outputs, each solve
on the device loop) and the rest of ``run`` (``on_output``, ``progress``,
``start_step``), following tests/test_round2_features.py:125-160: the VTK
files run_scan writes equal run's byte for byte, on a static and a moving
case; its diagnostics have the keys, dtypes and lengths of the JAX
package's chunked run_scan; at float64 its iterations equal JAX's
run_scan's step for step."""

import os

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host

import jax.numpy as jnp

from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases as tcases

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(14, 14, 12), steps=4,
                                      jump=2e-3),
    "moving": lambda c: c.case_moving(shape_xyz=(16, 16, 10), steps=4),
}
DTYPES = {"f64": torch.float64, "f32": torch.float32,
          "bf16": torch.bfloat16}


def _files_equal(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    assert any(n.startswith("field_") for n in names)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), f"{n} differs"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_output_matches_run(name, dtype, tmp_path):
    """run_scan's field_N.vtk / src_N.vtk equal run()'s byte for byte."""
    model = tcases.load_case(CASES[name](tcases))
    sim = Simulation(model, DTYPES[dtype], device=CPU)
    st_run, d_run = sim.run(output_dir=str(tmp_path / "run"))
    st_scan, d_scan = sim.run_scan(output_dir=str(tmp_path / "scan"))
    _files_equal(str(tmp_path / "run"), str(tmp_path / "scan"))
    assert d_scan["iterations"].tolist() == d_run["iterations"]
    assert sum(d_run["iterations"]) > 0
    assert bool(d_scan["converged"].all())
    assert torch.equal(st_scan.A, st_run.A)
    assert torch.equal(st_scan.carry, st_run.carry)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_diagnostics_match_jax(name, tmp_path):
    """Keys, dtypes and lengths of JAX's chunked run_scan; at float64 the
    same iterations step for step, relres within 1e-6 relative, the same
    output files."""
    mj = jcases.load_case(CASES[name](jcases))
    mt = tcases.load_case(CASES[name](tcases))
    sj = JSimulation(mj, dtype=jnp.float64, dot_dtype=jnp.float64,
                     donate=False)
    sj._io_cb_ok = False                   # the chunked path
    _, dj = sj.run_scan(output_dir=str(tmp_path / "jax"))
    _, dt = Simulation(mt, torch.float64, torch.float64, device=CPU).run_scan(
        output_dir=str(tmp_path / "port"))
    assert sorted(dt) == sorted(dj)
    for key in ("iterations", "relres", "converged"):
        assert host(dt[key]).dtype == np.asarray(dj[key]).dtype, key
        assert len(dt[key]) == len(np.asarray(dj[key])) == len(sj.steps)
    assert dt["start_step"] == dj["start_step"] == 0
    np.testing.assert_array_equal(host(dt["iterations"]),
                                  np.asarray(dj["iterations"]))
    np.testing.assert_array_equal(host(dt["converged"]),
                                  np.asarray(dj["converged"]))
    np.testing.assert_allclose(host(dt["relres"]), np.asarray(dj["relres"]),
                               rtol=1e-6)
    # the same files (their values differ in the last bits: summation order)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port"))


def test_scan_empty_horizon_dtypes():
    """num_steps=0: empty diagnostics in JAX's empty-horizon dtypes."""
    model = tcases.load_case(CASES["static"](tcases))
    _, d = Simulation(model, torch.float32, device=CPU).run_scan(num_steps=0)
    assert d["iterations"].dtype == torch.int32 and len(d["iterations"]) == 0
    assert d["relres"].dtype == torch.float32 and len(d["relres"]) == 0
    assert d["converged"].dtype == torch.bool and len(d["converged"]) == 0
    assert (d["start_step"], d["io_s"]) == (0, 0.0)


def test_run_on_output_and_progress(capsys):
    """on_output(npoint, state, info) at every output point, the 1% ticker,
    and the keys of JAX's run diagnostics (start_step among them)."""
    mj = jcases.load_case(CASES["static"](jcases))
    mt = tcases.load_case(CASES["static"](tcases))
    seen = []
    st, d = Simulation(mt, torch.float64, device=CPU).run(
        on_output=lambda n, s, i: seen.append((n, i.iterations, s.A.shape)),
        progress=True)
    ticks = capsys.readouterr().out
    outs = [o for _, o in Simulation(mt, torch.float64,
                                     device=CPU).steps if o is not None]
    assert [n for n, _, _ in seen] == outs and outs
    assert all(shape == st.A.shape for _, _, shape in seen)
    assert ticks.count(">") == len(d["iterations"])
    _, dj = JSimulation(mj, dtype=jnp.float64, donate=False).run()
    assert set(dj) <= set(d)
    assert d["start_step"] == 0 and d["steps"] == len(d["iterations"])
