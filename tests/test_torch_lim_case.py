"""The benchmark's linear induction machine (``ecbench/cases/lim.py``, the
cell ``lim.recip``) on the CPU.

* At a small grid, through the harness's own run (``ecbench.run.run_cell``)
  and the port's ``Simulation``: the run is correct; with one winding's
  phase 120 degrees off in the reference alone it is not.
* The program's parse of the cell's text has the upstream's 12 source
  functions, each moving along x with its own ``Vsx`` registration.
* At the published traffic the reference's primary goes 92 cells forward
  over steps 0-99 and back over 100-199; no step's running distance lies
  near a half cell, where the program's Kahan sum and the reference's plain
  one could round apart, and no step's drive angle near a zero of the sine,
  where the sign of ``impl2`` would turn on the last bit.
* The per-layer readers of the program's spans and counters
  (``ecbench/spans.py``): the tracer on for the window alone, off under the
  profiler, and None where the program keeps no such span or counter.
"""

import copy
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from ecbench import cellspec
from ecbench.reference.case import PI
from ecbench.reference.motion import Motion
from ecbench.run import run_cell

from eddy_currents_3d_tpu_torch.models.vxc import read_vxc
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "lim.recip"
# a small machine: the 12 windings at their x, over a 48-cell bar; the
# drive at 150 Hz reverses after 4 steps, 1.2 cells a step (0.1 cell or
# more from every half, the angles 54 k + 0.9 degrees)
SMALL_GRID = [48, 10, 10]
SMALL_MOTION = {"speed_m_per_s": 6.0, "freq_hz": 150}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    yield
    trace.disable()


def _cell(small=True):
    cell = cellspec.Cell(BENCH, CELL)
    if small:
        cell.config = dict(cell.config, grid_xyz=SMALL_GRID)
        cell.traffic = dict(cell.traffic, steps=6,
                            motion=dict(cell.traffic["motion"],
                                        **SMALL_MOTION))
    return cell


def _run(cell):
    return run_cell(cell, 2**31 + 91, 0.0, False, device="cpu",
                    t0=time.perf_counter(), warm_s=0.0)


def test_the_small_machine_is_correct():
    out = _run(_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["info"]["steps"] == 6
    assert out["checks"]["relres"]["value"] < 5e-3 + 1e-6


@pytest.mark.parametrize("winding", [0, 7])
def test_a_winding_off_by_120_degrees_is_not_correct(winding):
    """One winding's phase 120 degrees off in the reference alone."""
    cell = _cell()
    lim = cell.case

    def reference_case(config, traffic):
        case = lim.reference_case(config, traffic)
        case.sources[winding].offset += 2 * PI / 3
        return case
    cell.case = SimpleNamespace(vxc_text=lim.vxc_text,
                                reference_case=reference_case)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["relres"]["value"] > out["checks"]["relres"]["limit"]


def _model(tmp_path, cell):
    path = tmp_path / "lim.vxc"
    path.write_text(cell.case.vxc_text(cell.config, cell.traffic, 0.0))
    return read_vxc(str(path))


def test_the_parse_has_twelve_functions_moving_along_x(tmp_path):
    """As the upstream LIM.vxc parses (tests/test_vxc.py test_lim)."""
    cell = _cell(small=False)
    m = _model(tmp_path, cell)
    assert m.shape_xyz == (176, 32, 22)
    assert m.tran.stop == pytest.approx(0.2)
    assert m.tran.step == pytest.approx(1e-3)
    assert len(m.functions) == 12
    assert all(f.move == (1, 0, 0) for f in m.functions)
    assert [f.vmech_index for f in m.functions] == [
        (k, 0, 0) for k in range(1, 13)]
    assert len(m.vmech) == 12
    assert all(v.expression is not None for v in m.vmech)
    assert all(len(f.cells) == 52 for f in m.functions)
    # forward before the reversal at 0.1 s, back after it
    v0, v1 = float(m.vmech[0](0.001)), float(m.vmech[0](0.101))
    assert v0 == pytest.approx(4.6) and v1 == pytest.approx(-v0)


@pytest.fixture(scope="module")
def published():
    cell = _cell(small=False)
    return cell, cell.case.reference_case(cell.config, cell.traffic)


def test_the_primary_goes_92_cells_forward_and_back(published):
    cell, case = published
    nx = case.shape_xyz[0]
    x0 = cell.config["windings"]["x"]
    mo = Motion(case)
    assert len(case.times) == 200
    at = [[int(c.min() % nx) - x for c, x in zip(mo.at(s), x0)]
          for s in range(len(case.times))]
    assert all(len(set(row)) == 1 for row in at)      # all windings as one
    x = [row[0] for row in at]
    assert x[99] == 92 and x[-1] == 0 and max(x) == 92
    assert all(b >= a for a, b in zip(x[:100], x[1:100]))
    assert all(b <= a for a, b in zip(x[99:], x[100:]))


def test_no_running_distance_lies_near_a_half(published):
    _, case = published
    d, h = 0.0, case.delta[0]
    for t in case.times:
        d += case.velocity(t)[0] * case.dt / h
        assert abs(abs(d) % 1.0 - 0.5) > 0.01, (t, d)


def test_no_drive_angle_lies_near_a_zero_of_the_sine(published):
    cell, case = published
    m = cell.traffic["motion"]
    for t in case.times:
        deg = 360.0 * m["freq_hz"] * t + m["offset_deg"]
        assert abs(deg - 180.0 * round(deg / 180.0)) > 0.1, (t, deg)


@pytest.fixture(scope="module")
def small_sim(tmp_path_factory):
    return Simulation(_model(tmp_path_factory.mktemp("lim"), _cell()),
                      torch.float32, device="cpu")


NEW = ("motion_host_ms_per_step.lim", "scatter_host_ms_per_step.lim",
       "scatter_cells_per_step.lim")


def _installed(sim):
    """Each new metric's ``install``, in turn, as the harness calls them
    before the window."""
    return {name: cellspec.load_install(cellspec.HERE, name)(sim)
            for name in NEW}


def _read(installed, steps):
    ctx = {"installed": installed, "window": {"steps": steps}}
    return {name: cellspec.load_reader(cellspec.HERE, name)(ctx)
            for name in NEW}


def test_the_readers_take_the_window_and_leave_the_profiler_alone(small_sim):
    from torch.profiler import ProfilerActivity, profile

    sim = copy.copy(small_sim)
    assert not trace.ON
    installed = _installed(sim)
    assert trace.ON
    assert len({id(h) for h in installed.values()}) == 1
    _, diag = sim.run()
    sim.run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run()
    assert not trace.ON
    names = {e.name for e in prof.events()}
    assert not names & {"run", "step", "rhs", "rhs.scatter"}
    got = _read(installed, 2 * diag["steps"])
    cells = 12 * 2 * (SMALL_GRID[1] - 6)
    assert got["scatter_cells_per_step.lim"] == cells
    assert got["motion_host_ms_per_step.lim"] > 0
    assert got["scatter_host_ms_per_step.lim"] > 0
    rep = installed[NEW[0]]["report"]
    assert rep["counters"]["steps"] == 2 * diag["steps"]


def test_the_readers_give_none_without_the_spans(small_sim):
    """A program that keeps neither ``rhs.scatter`` nor the counters."""
    sim = copy.copy(small_sim)
    installed = _installed(sim)
    sim.run()
    rep = trace.report()
    rep["spans"] = [s for s in rep["spans"] if s["name"] != "rhs.scatter"]
    rep["counters"] = {k: v for k, v in rep["counters"].items()
                       if k in ("steps", "iterations")}
    installed[NEW[0]]["report"] = rep
    got = _read(installed, 6)
    assert got["scatter_host_ms_per_step.lim"] is None
    assert got["scatter_cells_per_step.lim"] is None
    assert got["motion_host_ms_per_step.lim"] > 0
    assert _read({}, 6) == dict.fromkeys(NEW)
