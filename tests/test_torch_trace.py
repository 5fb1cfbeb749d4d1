"""The port's tracer (``utils/trace.py``) and its spans in the time step, on
the CPU.

* A traced ``run()`` keeps one ``step`` span a step, each holding one
  ``rhs``, one ``solve`` and one ``carry``, under the transient's ``run``
  span and with its run number; inside ``rhs`` one ``rhs.scatter`` span a
  step, over the fill of the source cells, and in the moving cases (the
  coil, the linear machine's twelve windings) one ``rhs.motion`` span
  before it, over their relocation.  Self times are not negative and
  children never cover more than their parent.  The counters equal
  ``run()``'s diagnostics, the source functions relocated and the source
  cells filled; ``run_scan`` keeps the same spans.  Off, nothing is kept and the span sites get one shared null
  context; the state is bit for bit that of an untraced run.
* The device clock, with a stand-in for CUDA's timing events that completes
  when it is recorded (a card with no queue): every span's device interval
  lies inside its host span once put on the host clock through the anchor,
  the wait between runs is measured, and events are reused across runs.
* ``--trace PATH`` writes Chrome trace-event JSON with one host ``step``
  event a step, and device events on the host spans' clock.
* ``summary`` on a report made by hand, and its None cases; under
  ``torch.profiler`` the spans show as ``record_function`` ranges.
"""

import json
import time

import pytest
import torch

from _torch_parity import CPU

from eddy_currents_3d_tpu_torch.__main__ import main
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases
from eddy_currents_3d_tpu_torch.utils import trace

CASES = {"static": cases.case_static, "moving": cases.case_moving,
         "lim": cases.case_lim}
MOTION = {"static": 0, "moving": 1, "lim": 1}   # motion spans a step


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def sims():
    return {k: Simulation(cases.load_case(f()), torch.float32, device=CPU)
            for k, f in CASES.items()}


def _traced_run(sim, **kw):
    trace.enable()
    state, diag = sim.run(**kw)
    rep = trace.report()
    trace.disable()
    return state, diag, rep


def _children(spans, i):
    return [s for s in spans if s["parent"] == i]


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_run_keeps_a_step_span_a_step(sims, case):
    _, diag, rep = _traced_run(sims[case])
    spans = rep["spans"]
    runs = [i for i, s in enumerate(spans) if s["name"] == "run"]
    assert len(runs) == 1 and spans[runs[0]]["parent"] is None
    steps = [i for i, s in enumerate(spans) if s["name"] == "step"]
    assert len(steps) == diag["steps"]
    for k, i in enumerate(steps):
        s = spans[i]
        assert s["parent"] == runs[0] and s["step"] == k
        kids = _children(spans, i)
        assert sorted(c["name"] for c in kids) == ["carry", "rhs", "solve"]
        rhs = next(j for j, c in enumerate(spans)
                   if c["parent"] == i and c["name"] == "rhs")
        motion = _children(spans, rhs)
        assert [c["name"] for c in motion] == (["rhs.motion"] * MOTION[case]
                                               + ["rhs.scatter"])
        for c in kids + motion:
            assert (c["run"], c["step"]) == (s["run"], k)
    assert {s["run"] for s in spans} == {spans[runs[0]]["run"]}
    assert not rep["device"]
    assert all(s["device_start_ns"] is None for s in spans)


@pytest.mark.parametrize("case", sorted(CASES))
def test_self_times_and_children_within_parents(sims, case):
    _, _, rep = _traced_run(sims[case])
    spans = rep["spans"]
    for i, s in enumerate(spans):
        dur = s["end_ns"] - s["start_ns"]
        assert 0 <= s["self_ns"] <= dur
        kids = _children(spans, i)
        assert sum(c["end_ns"] - c["start_ns"] for c in kids) <= dur
        for c in kids:
            assert s["start_ns"] <= c["start_ns"] <= c["end_ns"] <= s["end_ns"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_equal_the_run_diagnostics(sims, case):
    _, diag, rep = _traced_run(sims[case])
    fns = sims[case].model.functions
    want = {"steps": diag["steps"], "iterations": diag["total_iterations"],
            "scatter.cells": sum(len(f.cells) for f in fns) * diag["steps"]}
    if MOTION[case]:
        want["motion.functions"] = len(fns) * diag["steps"]
    assert rep["counters"] == want
    assert rep["runs"] == [{"run": 0, "wait_before_ns": None}]
    s = trace.summary(rep)
    assert (s["steps"], s["iterations"]) == (want["steps"],
                                             want["iterations"])
    assert s["step_host_ms_per_step"] > 0
    assert (s["motion_host_ms_per_step"] is None) == (case == "static")


def test_run_scan_keeps_the_same_spans(sims):
    trace.enable()
    _, sdiag = sims["moving"].run_scan()
    rep = trace.report()
    names = [s["name"] for s in rep["spans"]]
    n = len(sdiag["iterations"])
    assert names.count("run") == 1
    for name, per in (("step", 1), ("rhs", 1), ("solve", 1), ("carry", 1),
                      ("rhs.motion", 1), ("rhs.scatter", 1)):
        assert names.count(name) == per * n
    assert rep["counters"]["iterations"] == int(sdiag["iterations"].sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_off_keeps_nothing(sims, case):
    assert trace.span("step", CPU, "interval", step=0) is trace._NULL
    trace.enable()
    trace.disable()
    sims[case].run()
    trace.count("iterations", 5)
    rep = trace.report()
    assert rep == {"spans": [], "counters": {}, "runs": [], "device": False}


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_is_bit_for_bit_that_of_an_untraced_run(sims, case):
    plain, d0 = sims[case].run()
    traced, d1, _ = _traced_run(sims[case])
    assert d0["iterations"] == d1["iterations"]
    for name in ("A", "U", "carry"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name


class _HostClock:
    """A stand-in for :class:`trace.CudaClock` whose events complete when
    they are recorded: a card with no queue."""

    def __init__(self):
        self.made, self.at = 0, {}

    def new(self, device) -> int:
        self.made += 1
        return self.made

    def record(self, ev, device):
        self.at[ev] = time.perf_counter_ns()

    def synchronize(self, ev):
        assert ev in self.at

    def elapsed(self, evs, end) -> list:
        return [(self.at[end] - self.at[ev]) / 1e6 for ev in evs]


@pytest.fixture
def host_clock(monkeypatch):
    """Spans on the CPU record :class:`_HostClock` events."""
    clock = _HostClock()
    monkeypatch.setattr(trace, "_clock", lambda device: clock)
    return clock


RUNS = 6


def test_device_times_on_the_host_clock(sims, host_clock):
    sim = sims["moving"]
    trace.enable()
    for _ in range(RUNS):
        _, diag = sim.run()
    rep = trace.report()
    assert rep["device"]
    spans = rep["spans"]
    per_run = [s for s in spans if s["name"] != "run" and s["run"] == 0]
    clocked = [s for s in per_run if s["clock"]]
    # a step, its solve and its motion wait
    assert len(clocked) == diag["steps"] * 3
    # the events are reused: a run's are read, and go back to the pool,
    # during the next run, so two runs' events, the held one and the
    # anchors are the most ever made
    assert host_clock.made <= 2 * 2 * len(clocked) + 3
    for s in spans:
        if s["clock"]:
            assert (s["start_ns"] <= s["device_start_ns"]
                    <= s["device_end_ns"] <= s["end_ns"] + 1_000_000)
    assert [r["wait_before_ns"] is not None for r in rep["runs"]] == [
        False] + [True] * (RUNS - 1)
    last = max(s["device_end_ns"] for s in spans
               if s["run"] == 0 and s["clock"])
    first = min(s["device_start_ns"] for s in spans
                if s["run"] == 1 and s["clock"])
    assert abs(rep["runs"][1]["wait_before_ns"] - (first - last)) < 1_000_000
    s = trace.summary(rep)
    assert 0 < s["device_wait_pct"] < s["accounted_pct"] <= 100.5
    assert s["solve_device_us_per_iteration"] > 0
    assert 0 < s["step_outside_solve_ms_per_step"] < s[
        "step_device_ms_per_step"]


def test_the_wait_between_runs_starts_at_the_last_event(host_clock):
    """The wait runs from the last event of one run to the first of the
    next: the first opened span's start, though an inner span closes
    first."""
    trace.enable()
    for _ in range(2):
        with trace.span("run", transient=True):
            with trace.span("outer", CPU, "interval"):
                time.sleep(0.002)
                with trace.span("inner", CPU, "interval"):
                    pass
        time.sleep(0.001)
    rep = trace.report()
    outer = [s for s in rep["spans"] if s["name"] == "outer"]
    gap = outer[1]["start_ns"] - outer[0]["end_ns"]
    assert gap <= rep["runs"][1]["wait_before_ns"] < gap + 1_000_000


def _cli(tmp_path, case, *extra):
    vxc = tmp_path / "in.vxc"
    vxc.write_text(CASES[case]())
    path = tmp_path / "trace.json"
    rc = main([str(vxc), "-o", "-", "--device", "cpu", "--trace", str(path),
               *extra])
    assert rc == 0
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("scan", [False, True])
def test_cli_trace_writes_one_step_event_a_step(tmp_path, capsys, scan):
    doc = _cli(tmp_path, "static", *(["--scan"] if scan else []))
    assert "trace     :" in capsys.readouterr().out
    host = [e for e in doc["traceEvents"]
            if e["ph"] == "X" and e["tid"] == 0]
    steps = [e for e in host if e["name"] == "step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2, 3]
    assert not [e for e in doc["traceEvents"]
                if e["ph"] == "X" and e["tid"] == 1]
    assert not trace.ON


def test_cli_trace_device_track_shares_the_host_clock(tmp_path, host_clock):
    doc = _cli(tmp_path, "moving", "-q")
    ev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    host = {(e["name"], e["args"]["run"], e["args"]["step"]): e
            for e in ev if e["tid"] == 0 and e["name"] in ("step", "solve")}
    dev = [e for e in ev if e["tid"] == 1]
    assert {e["name"] for e in dev} == {"step [interval]", "solve [interval]",
                                        "rhs.motion [wait]"}
    steps = 0
    for e in dev:
        name = e["name"].split(" ")[0]
        if name == "rhs.motion":
            continue
        h = host[(name, e["args"]["run"], e["args"]["step"])]
        assert h["ts"] <= e["ts"] + 1e-3
        assert e["ts"] + e["dur"] <= h["ts"] + h["dur"] + 1000.0
        steps += name == "step"
    assert steps == 4


def _span(name, parent, run, step, t, d=None, clock=None):
    return {"name": name, "parent": parent, "run": run, "step": step,
            "start_ns": t[0], "end_ns": t[1], "self_ns": t[1] - t[0],
            "clock": clock, "device_start_ns": d and d[0],
            "device_end_ns": d and d[1]}


def _report(device=True, motion=True):
    """Two runs of two steps (a solve and, with ``motion``, a motion wait
    in each), host and device times in ns, made by hand."""
    spans = []
    for run, base in ((0, 0), (1, 10_000)):
        r = len(spans)
        spans.append(_span("run", None, run, None, (base, base + 8_000)))
        for k in range(2):
            t = base + 1_000 + 3_000 * k
            dv = lambda a, b: (t + a, t + b) if device else None
            st = len(spans)
            spans.append(_span("step", r, run, k, (t, t + 2_000),
                               dv(100, 2_900), "interval"))
            spans.append(_span("rhs", st, run, k, (t + 10, t + 500)))
            if motion:
                spans.append(_span("rhs.motion", st + 1, run, k,
                                   (t + 20, t + 220), dv(100, 150), "wait"))
                spans[st + 1]["self_ns"] -= 200
            spans.append(_span("solve", st, run, k, (t + 600, t + 1_900),
                               dv(200, 2_700), "interval"))
    counters = {"steps": 4, "iterations": 50}
    return {"spans": spans, "counters": counters,
            "runs": [{"run": 0, "wait_before_ns": None},
                     {"run": 1, "wait_before_ns": 4_200 if device else None}],
            "device": device}


def test_summary_of_a_report_made_by_hand():
    s = trace.summary(_report())
    assert s["wall_ns"] == 18_000
    assert s["step_host_ms_per_step"] == pytest.approx(2_000 / 1e6)
    assert s["motion_host_ms_per_step"] == pytest.approx(200 / 1e6)
    assert s["step_device_ms_per_step"] == pytest.approx(2_800 / 1e6)
    assert s["solve_device_us_per_iteration"] == pytest.approx(
        4 * 2_500 / 1e3 / 50)
    assert s["step_outside_solve_ms_per_step"] == pytest.approx(300 / 1e6)
    # waits: 4 motion waits of 50, a gap of 200 between the steps of each
    # run, and 4_200 between the runs (6_900 to 11_100)
    assert s["device_wait_pct"] == pytest.approx(
        100 * (4 * 50 + 2 * 200 + 4_200) / 18_000)
    assert s["accounted_pct"] == pytest.approx(
        100 * (4 * 2_800 + 2 * 200 + 4_200) / 18_000)
    assert trace.summary(_report(), wall_ns=36_000)["accounted_pct"] == (
        pytest.approx(s["accounted_pct"] / 2))


def test_summary_without_device_times_or_steps():
    s = trace.summary(_report(device=False))
    assert s["step_host_ms_per_step"] == pytest.approx(2_000 / 1e6)
    for name in ("step_device_ms_per_step", "solve_device_us_per_iteration",
                 "step_outside_solve_ms_per_step", "device_wait_pct",
                 "accounted_pct"):
        assert s[name] is None
    assert trace.summary(_report(motion=False))[
        "motion_host_ms_per_step"] is None
    empty = trace.summary(trace.report())
    assert empty["steps"] == 0 and empty["step_host_ms_per_step"] is None


def test_spans_show_in_a_profiler_session(sims):
    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, diag = sims["static"].run()
    names = [e.name for e in prof.events()]
    for name in ("run", "step", "rhs", "solve", "carry"):
        want = 1 if name == "run" else diag["steps"]
        assert names.count(name) == want, name
