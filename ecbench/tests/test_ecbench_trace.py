"""The trace's reduction: the union of device intervals, the idle gaps'
labels; and, on a card, one traced run of a small cell end to end."""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ecbench import cellspec, devtrace  # noqa: E402

HERE = ROOT / "ecbench"


def test_union_merges_overlaps():
    got = devtrace._union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 9)])
    assert got == [[0, 4], [5, 9]]


def test_gaps_are_labelled_by_the_innermost_host_range():
    host = {"ecbench.run": [(0, 100)], "ecbench.step": [(10, 50), (60, 90)],
            "ecbench.rhs": [(12, 20), (62, 70)], "ecbench.solve": [(21, 30)]}
    label = devtrace._labeller(host)
    assert label(15) == "Simulation._rhs"
    assert label(25) == "Simulation.solve"
    assert label(40) == "Simulation._step (carry, zeroing)"
    assert label(55) == "Simulation.run (between steps)"
    assert label(150) == "outside Simulation.run"


@pytest.mark.cuda
def test_a_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ecbench.run import run_cell

    for d in ("cases", "metrics", "kernels", "workloads", "limits",
              "configs"):
        shutil.copytree(HERE / d, tmp_path / d)
    cfg = json.loads((HERE / "configs/team7.json").read_text())
    cfg["grid_xyz"] = [40, 40, 16]
    (tmp_path / "configs/team7.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cellspec.Cell(bench, "team7.static", tmp_path)
    out = run_cell(cell, 11, 1.0, True, t0=time.perf_counter(), warm_s=0.0)
    assert out["correct"], out["checks"]
    names = {m["name"] for m in cell.per_layer}
    assert names <= set(out["metrics"])
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]


@pytest.mark.cuda
def test_the_cards_solve_time_is_read_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ecbench.run import run_cell

    for d in ("cases", "metrics", "kernels", "workloads", "limits",
              "configs"):
        shutil.copytree(HERE / d, tmp_path / d)
    cfg = json.loads((HERE / "configs/team7.json").read_text())
    cfg["grid_xyz"] = [40, 40, 16]
    (tmp_path / "configs/team7.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cellspec.Cell(bench, "team7.moving", tmp_path)
    out = run_cell(cell, 13, 1.0, False, t0=time.perf_counter(), warm_s=0.0)
    assert out["correct"], out["checks"]
    card = out["metrics"]["solve_card_ms_per_step"]["value"]
    wall = out["info"]["window_s"] * 1e3 / out["info"]["steps"]
    assert 0 < card < wall
