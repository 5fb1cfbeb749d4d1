#!/usr/bin/env python3
"""The benchmark of eddy_currents_3d_tpu_torch: whole transients of
implicit eddy-current steps on one CUDA card, as users run them.

    python3 ecbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``configs/``) and traffic (``workloads/``); the
configuration names its case module (``cases/<case>.py``, the coil over a
plate without one).  Set-up writes the case's ``.vxc`` text into a
temporary directory, reads it with the program's ``read_vxc``, builds one
``Simulation(model, float32)`` with the program's defaults and runs one
transient, which loads the kernels and captures the solve's graphs, then
more transients for a fixed ``WARM_S`` seconds, past the card's slow
start (:func:`warm_up`).  The window then runs ``Simulation.run()``, one
whole transient after another from a cold state (a closed loop with one
client), for ``--seconds``, and ends when the transient in flight ends.
The seed draws the order in which the transients take the source
currents' 32 phases (``vxc.py``) and the sample of steps the check
judges.

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics: the window times the step's host part
(``Simulation._rhs``, wrapped on the instance), and after it one more
transient runs under one profiler session (``devtrace.py``).  A metric
whose reader has an ``install(sim)`` times the window itself: the harness
installs it on the instance just before the window.

Correctness (``check.py``): a sample of the window's steps, drawn from the
seed, is judged after the window by the float64 reference
(``reference/``), which builds each step's system from the case module's
data (its ``reference_case``), not from the ``.vxc`` text.  Every number
compared is printed beside its limit, last on standard error and under
``checks`` in the result line.

Exits 2 without the cell's CUDA cards, 3 when the process holds JAX or the
JAX package after the window, 4 on a short trace; prints no result then.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root, in place of this file's directory
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ecbench import cellspec, devtrace  # noqa: E402
from ecbench.check import Recorder, judge  # noqa: E402
from ecbench.vxc import phases, set_phase  # noqa: E402

# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "eddy_currents_3d_tpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
# The warm-up.  On an H100 most fresh processes run their first 2 s to over
# a minute of team7 transients 28 us an iteration (15%) slower than the
# rest, the switch abrupt and at a time that differs from process to
# process (the SM clock at 1980 MHz throughout, the same with the process
# pinned to one core); some start fast.  So set-up runs whole transients
# for a fixed WARM_S seconds, the same in every run whether the card
# starts slow or fast, and the window starts after that.  (Waiting on for
# the switch made set-up 40 s in one run and the 120 s cap in the next,
# where the card had started fast and no switch came.)
WARM_S = 45.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _rhs_timer(sim):
    """Time the host part of each step on the instance; returns the list
    the seconds go into."""
    inner, spent = sim._rhs, []

    def timed(state, t):
        t1 = time.perf_counter()
        out = inner(state, t)
        spent.append(time.perf_counter() - t1)
        return out
    sim._rhs = timed
    return spent


def warm_up(sim, order, warm_s: float = WARM_S) -> int:
    """Whole transients of ``sim`` at the phases of ``order`` until
    ``warm_s`` seconds have passed; returns how many ran."""
    start = time.perf_counter()
    n = 0
    while time.perf_counter() - start < warm_s:
        n += 1
        set_phase(sim.model, order[n % len(order)])
        sim.run()
    return n


def _finite(state) -> bool:
    return bool(torch.isfinite(state.A).all() & torch.isfinite(state.U).all()
                & torch.isfinite(state.carry).all())


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             dtype=None, t0: float = T0, warm_s: float = WARM_S) -> dict:
    """One run of ``cell``: set-up, the window, the trace, the check.
    ``dtype`` in place of the configuration's is for the control
    (``control.py``); it and the CPU tests take ``warm_s=0``.  Returns the
    result line's dict."""
    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed % (1 << 64))
    order = phases(rng)
    if trace:
        devtrace.warmup()
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.models.vxc import read_vxc

    tmp = tempfile.mkdtemp(prefix="ecbench-")
    try:
        path = os.path.join(tmp, "case.vxc")
        with open(path, "w") as f:
            f.write(cell.case.vxc_text(cell.config, cell.traffic, order[0]))
        sim = Simulation(read_vxc(path),
                         dtype or DTYPES[cell.config["dtype"]],
                         device=device)
        sim.run()                    # builds, loads and captures
        warm = warm_up(sim, order, warm_s) if warm_s > 0 else 0
        setup_s = time.perf_counter() - t0

        rec = Recorder(sim, rng)
        spent = _rhs_timer(sim) if trace else None
        reported = cell.per_layer if trace else cell.end_to_end
        installed = {}
        for m in reported:
            install = cellspec.load_install(cell.here, m["name"])
            if install is not None:
                installed[m["name"]] = install(sim)
        steps = its = attempted = failed = 0
        start = time.perf_counter()
        while True:
            phase = order[attempted % len(order)]
            set_phase(sim.model, phase)
            rec.begin(attempted, phase)
            state, diag = sim.run()
            attempted += 1
            steps += diag["steps"]
            its += diag["total_iterations"]
            if diag["unconverged_steps"] or not _finite(state):
                failed += 1
            if time.perf_counter() - start >= seconds:
                break
        wall = time.perf_counter() - start
        del state
        samples = rec.close()
        if spent is not None:
            del sim._rhs
        peak = torch.cuda.max_memory_allocated(sim.device) if cuda else 0
        traced = (devtrace.profile_transient(
            sim, cellspec.kernel_lists(cell.here)) if trace else None)
        del sim
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        readings = judge(cell.case.reference_case(cell.config, cell.traffic),
                         samples)
        ref_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ctx = {"cell": cell.entry, "config": cell.config,
           "traffic": cell.traffic, "setup_s": setup_s,
           "window": {"wall_s": wall, "steps": steps, "iterations": its,
                      "transients": attempted,
                      "rhs_host_s": sum(spent) if spent is not None else None},
           "trace": traced, "installed": installed}
    metrics = {}
    for m in reported:
        value = cellspec.load_reader(cell.here, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": readings[name], "limit": lim}
              for name, lim in cell.limits.items()}
    checks["failed_transients"] = {"value": failed, "limit": 0}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if cuda else "cpu"),
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if traced is not None:
        out["device"].update(busy_s=traced["busy_s"],
                             window_s=traced["window_s"])
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["info"] = {"phases": order, "warm_transients": warm, "steps": steps,
                   "iterations": its, "window_s": wall,
                   "samples": len(samples),
                   "reference_s": ref_s}
    if traced is not None:
        out["info"]["trace_sessions"] = traced["sessions"]
    out["checks"] = checks
    return out


def _card() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi gave no reading"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cellspec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"ecbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}.  The benchmark runs on the card "
              "only: no result.", file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except devtrace.TraceShort as e:
        print(f"ecbench: short trace: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"ecbench: the process holds {', '.join(found)} after the "
              "window: no result.", file=sys.stderr)
        return 3
    print(f"ecbench: {args.workload} seed {args.seed}: {_card()}; "
          f"{json.dumps(out['info'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
