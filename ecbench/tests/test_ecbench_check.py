"""The check that decides ``correct``, on the CPU at a tiny grid: the
float64 reference against the program's own steps, the whole run with the
timed path broken underneath, and the control (the program's bfloat16
path), each of which the check has to find not correct."""

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ecbench import cellspec  # noqa: E402
from ecbench.reference.step import StepReference  # noqa: E402
from ecbench.run import run_cell  # noqa: E402
from eddy_currents_3d_tpu_torch import Simulation  # noqa: E402
from eddy_currents_3d_tpu_torch.models.vxc import read_vxc  # noqa: E402
from eddy_currents_3d_tpu_torch.solvers import bicgstab  # noqa: E402
from eddy_currents_3d_tpu_torch.testing.cases import (  # noqa: E402
    case_moving, case_static, load_case)

HERE = ROOT / "ecbench"
SHAPE = [20, 20, 12]
CASE = cellspec.load_case(HERE, {})         # team7's: the coil over a plate


def _case(traffic, steps, phase=1.3):
    cfg = json.loads((HERE / "configs/team7.json").read_text())
    cfg["grid_xyz"] = SHAPE
    trf = json.loads((HERE / f"workloads/{traffic}.json").read_text())
    trf["steps"] = steps
    return CASE.vxc_text(cfg, trf, phase)


@pytest.mark.parametrize("traffic,builder", [("static", case_static),
                                             ("moving", case_moving)])
def test_cases_equal_the_programs_builders(traffic, builder):
    """At phase 0 the generator's case is the program's case_static /
    case_moving: the same voxels, solver, transient, sources and motion."""
    a = load_case(_case(traffic, 100, phase=0.0))
    b = load_case(builder(shape_xyz=tuple(SHAPE), steps=100))
    assert np.array_equal(a.geo, b.geo)
    assert (a.tran, a.solver.tolerance) == (b.tran, b.solver.tolerance)
    ts = np.linspace(0.0, 0.04, 9)
    for fa, fb in zip(a.functions, b.functions, strict=True):
        assert (fa.direction, fa.move, fa.vmech_index) == (
            fb.direction, fb.move, fb.vmech_index)
        assert np.array_equal(fa.cells, fb.cells)
        assert [fa(t) for t in ts] == [fb(t) for t in ts]
    for va, vb in zip(a.vmech, b.vmech, strict=True):
        assert [va(t) for t in ts] == [vb(t) for t in ts]


def _data(traffic, steps):
    cfg = json.loads((HERE / "configs/team7.json").read_text())
    cfg["grid_xyz"] = SHAPE
    trf = json.loads((HERE / f"workloads/{traffic}.json").read_text())
    trf["steps"] = steps
    return cfg, trf


def test_every_seed_runs_the_same_phases_in_its_own_order():
    """Every seed takes the same PHASES phases, in an order of its own in
    which every first 2^m are evenly spaced; one seed gives it again."""
    from ecbench.vxc import PHASES, phases

    runs = [phases(np.random.default_rng(seed))
            for seed in (2**31 + 5, 2**31 + 6, 2**31 + 5, 2**31 + 8)]
    assert runs[0] == runs[2] and runs[0] != runs[1] != runs[3]
    grid = [float(f"{2 * np.pi * j / PHASES:.12f}") for j in range(PHASES)]
    for order in runs:
        assert sorted(order) == grid
        for m in (2, 4, 8, 16):
            gaps = np.diff(np.sort(order[:m]))
            assert np.allclose(gaps, 2 * np.pi / m, atol=1e-9), (m, order)


def test_set_phase_is_the_text_at_that_phase():
    """Between transients a run gives the program's parsed model another
    phase; it equals the model of a .vxc written with that phase, and the
    reference's sources at that phase."""
    from ecbench.vxc import phases, set_phase

    order = phases(np.random.default_rng(2**31 + 5))
    ts = np.linspace(0.0, 0.04, 9)
    case = CASE.reference_case(*_data("moving", 10))
    with tempfile.TemporaryDirectory() as d:
        def parsed(phase):
            path = os.path.join(d, f"{phase}.vxc")
            with open(path, "w") as f:
                f.write(_case("moving", 10, phase=phase))
            return read_vxc(path)
        model = parsed(order[0])
        for phase in order[1:3]:
            set_phase(model, phase)
            want = parsed(phase)
            for fa, fb, src in zip(model.functions, want.functions,
                                   case.sources, strict=True):
                got = [fa(t) for t in ts]
                assert got == [fb(t) for t in ts]
                assert np.allclose(got, [src.value(t, phase) for t in ts],
                                   rtol=1e-14, atol=0)


def _oracle():
    """The repository's test oracle, loaded from its file."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ecbench_test_oracle", ROOT / "tests" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("traffic", ["static", "moving"])
def test_reference_system_is_the_test_oracles(traffic, tmp_path):
    """The reference's matrix and one-sided rows, built from the cell's
    data, are the test oracle's, built from the program's parse of the
    text, entry for entry."""
    from ecbench.reference.system import assemble

    path = tmp_path / "case.vxc"
    path.write_text(_case(traffic, 8))
    M, bnd_a, bnd_u = _oracle().OracleSystem(
        read_vxc(str(path))).to_scipy()
    sys_ = assemble(CASE.reference_case(*_data(traffic, 8)))
    assert (abs(sys_.M - M)).nnz == 0 and sys_.M.nnz == M.nnz
    flat = lambda lists: sorted({i - 1 for b in lists for i in b})
    assert list(sys_.bnd_a) == flat(bnd_a)
    assert list(sys_.bnd_u) == flat(bnd_u)


@pytest.mark.parametrize("traffic", ["static", "moving"])
def test_reference_holds_the_programs_steps(traffic, tmp_path):
    path = tmp_path / "case.vxc"
    path.write_text(_case(traffic, 8))
    sim = Simulation(read_vxc(str(path)), torch.float32, device="cpu")
    ref = StepReference(CASE.reference_case(*_data(traffic, 8)))
    solve, got = sim.solve, {}

    def keep(b, x0, eager=False, read=True):
        res = solve(b, x0, eager=eager, read=read)
        got["x"] = res.x
        return res
    sim.solve = keep
    st = sim.init_state()
    cells = []
    for s, (t, _) in enumerate(sim.steps):
        new, info = sim._step(st, t)
        r = ref.judge(s, 1.3, None if s == 0 else (st.A, st.carry),
                      (got["x"].A, got["x"].U), (new.A, new.U, new.carry),
                      info.src_cells)
        tol = sim.model.solver.tolerance
        assert r["relres"] < tol and r["carry"] < 1e-6, (s, r)
        assert r["surface"] == 0 and r["sources"] == 0, (s, r)
        cells.append(info.src_cells[0])
        st = new
    # the moving coil moved, so its relocation was checked
    assert (traffic == "static") == np.array_equal(cells[0], cells[-1])


def _tiny_cell(tmp, traffic="static", steps=4):
    for d in ("cases", "metrics", "kernels", "workloads", "limits",
              "configs"):
        shutil.copytree(HERE / d, tmp / d)
    cfg = json.loads((HERE / "configs/team7.json").read_text())
    cfg["grid_xyz"] = SHAPE
    (tmp / "configs/team7.json").write_text(json.dumps(cfg))
    trf = json.loads((HERE / f"workloads/{traffic}.json").read_text())
    trf["steps"] = steps
    (tmp / f"workloads/{traffic}.json").write_text(json.dumps(trf))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return cellspec.Cell(bench, f"team7.{traffic}", tmp)


def _run(cell, **kw):
    return run_cell(cell, 2**31 + 99, 0.5, False, device="cpu",
                    t0=time.perf_counter(), warm_s=0.0, **kw)


def test_a_sound_run_is_correct(tmp_path):
    out = _run(_tiny_cell(tmp_path, "moving"))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["info"]["samples"] >= 2


def _step_unchanged(monkeypatch):
    step = Simulation._step

    def broken(self, state, t, eager=False):
        _, info = step(self, state, t, eager=eager)
        return state, info
    monkeypatch.setattr(Simulation, "_step", broken)


def _solve_returns_warm_start(monkeypatch):
    solve = bicgstab.DeviceLoop.solve

    def broken(self, b, x0, tol, read=True):
        return solve(self, b, x0, tol, read=read)._replace(x=x0)
    monkeypatch.setattr(bicgstab.DeviceLoop, "solve", broken)


def _answer_altered(monkeypatch):
    solve = Simulation.solve

    def broken(self, b, x0, eager=False, read=True):
        res = solve(self, b, x0, eager=eager, read=read)
        return res._replace(x=type(res.x)(res.x.A * 1.02, res.x.U))
    monkeypatch.setattr(Simulation, "solve", broken)


def _zeroing_left_out(monkeypatch):
    step = Simulation._step

    def broken(self, state, t, eager=False):
        new, info = step(self, state, t, eager=eager)
        A = torch.where(self._bnd_a, 1e-3, new.A)
        return new._replace(A=A), info
    monkeypatch.setattr(Simulation, "_step", broken)


def _source_misplaced(monkeypatch):
    rhs = Simulation._rhs

    def broken(self, state, t):
        out = rhs(self, state, t)
        cells = list(out[4])
        cells[0] = np.roll(cells[0], 1)
        return out[:4] + (tuple(cells),) + out[5:]
    monkeypatch.setattr(Simulation, "_rhs", broken)


@pytest.mark.parametrize("fault", [_step_unchanged, _solve_returns_warm_start,
                                   _answer_altered, _zeroing_left_out,
                                   _source_misplaced])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tmp_path):
    cell = _tiny_cell(tmp_path, "moving")
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct(tmp_path):
    """The program's bfloat16 state, one step below the configuration's
    float32: the true residual and the carry both over their limits."""
    cell = _tiny_cell(tmp_path, "static")
    out = _run(cell, dtype=torch.bfloat16)
    assert not out["correct"]
    assert out["checks"]["relres"]["value"] > out["checks"]["relres"]["limit"]
    assert out["checks"]["carry"]["value"] > out["checks"]["carry"]["limit"]
