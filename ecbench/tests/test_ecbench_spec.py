"""The benchmark's data: every file loads, every name and unit keeps to the
allowed characters, and a new configuration, traffic, cell and metric are
found by name with no file edited."""

import json
import shutil
import sys
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ecbench import cellspec  # noqa: E402

HERE = ROOT / "ecbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_json_loads():
    files = sorted(HERE.rglob("*.json"))
    assert files
    for f in files:
        json.loads(f.read_text())


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ecbench"]
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("ecbench/")
        names += [c["name"], *c["reduced"]]
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (HERE / "workloads" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        names += [w["name"], w["config"], w["traffic"]]
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert cellspec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        # each cell it lists reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells)), m
    for n in names:
        assert cellspec.NAME.match(n), n
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for f in HERE.rglob("*"):
        rel = f.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_each_cell_has_its_metrics_and_limits():
    for w in BENCH["workloads"]:
        cell = cellspec.Cell(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert {"relres", "carry", "surface", "sources"} <= set(cell.limits)
    with pytest.raises(KeyError):
        cellspec.Cell(BENCH, "no.such.cell")


def test_new_config_traffic_cell_and_metric_found_by_name(tmp_path):
    """A later PR adds files only: a configuration, a traffic mix, a cell's
    limits and a metric reader, and entries in BENCHMARK.json."""
    from ecbench.run import run_cell

    for d in ("cases", "metrics", "kernels", "workloads", "limits",
              "configs"):
        shutil.copytree(HERE / d, tmp_path / d)
    cfg = json.loads((HERE / "configs" / "team7.json").read_text())
    cfg.update(name="tiny", grid_xyz=[20, 20, 12])
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    trf = json.loads((HERE / "workloads" / "static.json").read_text())
    trf.update(name="short", steps=3)
    (tmp_path / "workloads" / "short.json").write_text(json.dumps(trf))
    (tmp_path / "limits" / "tiny.short.json").write_text(
        (HERE / "limits" / "team7.static.json").read_text())
    (tmp_path / "metrics" / "steps_per_transient.py").write_text(
        "def read(ctx):\n    w = ctx['window']\n"
        "    return w['steps'] / w['transients']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "ecbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.short", "config": "tiny",
                               "traffic": "short", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "steps_per_transient", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny.short"]})
    # a metric that lists its cells takes the new one by an entry in its list
    for m in bench["end_to_end"]:
        if m["name"] == "ms_per_step":
            m["workloads"].append("tiny.short")
    cell = cellspec.Cell(bench, "tiny.short", tmp_path)
    out = run_cell(cell, 7, 0.0, False, device="cpu", t0=time.perf_counter(),
                   warm_s=0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps_per_transient"]["value"] == 3
    assert set(out["metrics"]) == {"ms_per_step", "setup_s",
                                   "steps_per_transient"}
    assert list(out)[-1] == "checks"


class _Stub:
    """A Simulation whose transients run 10 iterations at ``per_it``
    seconds each, the last value repeating."""

    def __init__(self, per_it):
        self.per_it, self.calls = list(per_it), 0
        self.model = types.SimpleNamespace(functions=[])

    def run(self):
        per_it = self.per_it[min(self.calls, len(self.per_it) - 1)]
        self.calls += 1
        time.sleep(10 * per_it)
        return None, {"total_iterations": 10}


@pytest.mark.parametrize("per_it,warm_s,runs", [
    ([0.01, 0.008], 0.35, (4, 5)),           # fast after the first
    ([0.01] * 5 + [0.008], 0.35, (4, 5)),    # fast late
    ([0.01], 0.35, (4, 4)),                  # never fast
])
def test_warm_up_runs_a_fixed_time(per_it, warm_s, runs):
    """Set-up runs transients for warm_s seconds whatever their speed, so
    that it lasts as long in a run that starts fast as in one that starts
    slow."""
    from ecbench.run import warm_up

    start = time.perf_counter()
    n = warm_up(_Stub(per_it), [0.0, 1.0], warm_s=warm_s)
    took = time.perf_counter() - start
    assert runs[0] <= n <= runs[1]
    assert warm_s <= took < warm_s + 0.3


def test_a_metric_times_the_window_by_an_install_of_its_own(tmp_path):
    """A reader with ``install(sim)`` is installed just before the window,
    and what it returns reaches it: here it counts the window's solves,
    one a step, and none of set-up's."""
    from ecbench.run import run_cell

    for d in ("cases", "metrics", "kernels", "workloads", "limits",
              "configs"):
        shutil.copytree(HERE / d, tmp_path / d)
    cfg = json.loads((HERE / "configs" / "team7.json").read_text())
    cfg["grid_xyz"] = [20, 20, 12]
    (tmp_path / "configs" / "team7.json").write_text(json.dumps(cfg))
    trf = json.loads((HERE / "workloads" / "moving.json").read_text())
    trf["steps"] = 3
    (tmp_path / "workloads" / "moving.json").write_text(json.dumps(trf))
    (tmp_path / "metrics" / "solves_per_step.py").write_text(
        "def install(sim):\n    inner, n = sim.solve, []\n"
        "    def counted(*a, **k):\n        n.append(1)\n"
        "        return inner(*a, **k)\n"
        "    sim.solve = counted\n    return n\n\n"
        "def read(ctx):\n"
        "    return len(ctx['installed']['solves_per_step'])"
        " / ctx['window']['steps']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"].append({"name": "solves_per_step", "unit": "solves",
                                "better": "lower", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["team7.moving"]})
    cell = cellspec.Cell(bench, "team7.moving", tmp_path)
    out = run_cell(cell, 2**31 + 5, 0.0, False, device="cpu",
                   t0=time.perf_counter(), warm_s=0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["solves_per_step"]["value"] == 1
    # the card's time is not read off the card: left out of the line
    assert set(out["metrics"]) == {"setup_s", "solves_per_step"}


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in BENCH["per_layer"] if m["name"].endswith(".moving")))
def test_a_split_metric_reads_as_its_own(name):
    """``<metric>.moving`` reads what ``<metric>`` reads."""
    ctx = {"window": {"wall_s": 51.3, "steps": 30300, "iterations": 747501,
                      "transients": 300, "rhs_host_s": 40.1},
           "trace": {"busy_s": 0.1, "window_s": 0.3, "steps": 101,
                     "iterations": 2492, "device_us": 70400.0,
                     "operator": {"device_us": 46100.0, "launches": 5186}},
           "setup_s": 53.2, "installed": {}}
    base = name[:-len(".moving")]
    assert cellspec.load_reader(HERE, name)(ctx) == \
        cellspec.load_reader(HERE, base)(ctx) is not None
