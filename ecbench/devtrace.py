"""One profiler session over whole transients, and what the benchmark reads
from it: the device events, the union of their intervals, the idle gaps
labelled by what the host was doing, and the operator's kernels held to the
launches its wrappers counted.

The profiler misses the kernels of CUDA graphs captured before a process's
first profiler session, and a process's first session can trace no device
event at all (``trace_probe.py``), so :func:`warmup` runs before the
program captures its graphs.  A session that shows fewer (or more) operator
kernels than the wrappers counted is short: its numbers are not read.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

import torch

__all__ = ["warmup", "TraceShort", "profile_transient"]

# host ranges the traced transient is labelled with, innermost last
_LABELS = (("ecbench.run", "Simulation.run (between steps)"),
           ("ecbench.step", "Simulation._step (carry, zeroing)"),
           ("ecbench.rhs", "Simulation._rhs"),
           ("ecbench.solve", "Simulation.solve"))


class TraceShort(RuntimeError):
    """A profiler session whose operator kernels differ from the counts."""


def _session(fn):
    """(fn(), [(name, start us, end us)] device events, {label: [(start,
    end)]} host ranges) over one profiler session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    device, host = [], defaultdict(list)
    for e in prof.events():
        r = e.time_range
        if e.name.startswith("ecbench."):
            # a profiler range shows on the host and, as an annotation
            # spanning the work it launched, on the device timeline
            if e.device_type != DeviceType.CUDA:
                host[e.name].append((float(r.start), float(r.end)))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, float(r.start), float(r.end)))
    return out, device, host


def warmup(tries: int = 5) -> int:
    """Profiler sessions over one elementwise kernel until one holds its
    device event; returns how many it took and raises if none did."""
    x = torch.ones(1 << 16, device="cuda")
    for n in range(1, tries + 1):
        _, device, _ = _session(lambda: x.mul(2.0))
        if device:
            return n
    raise RuntimeError(f"torch.profiler traced no device kernel in {tries} "
                       "sessions over one elementwise kernel")


def short_name(name: str) -> str:
    """A device kernel's name without its namespaces, parameter list and
    return type, at most 160 characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(junk, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:160].rstrip()


def _counter(path: str):
    mod, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def _union(intervals):
    """Merged [start, end] intervals of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labeller(host):
    """A function of a time: what the host was doing then, the innermost
    labelled range that holds it (each label's ranges are disjoint)."""
    ranges = [(sorted(host.get(key, ())), label) for key, label in _LABELS]
    starts = [[s for s, _ in r] for r, _ in ranges]

    def label(t):
        name = "outside Simulation.run"
        for (r, lab), st in zip(ranges, starts):
            i = bisect.bisect_right(st, t) - 1
            if i >= 0 and t <= r[i][1]:
                name = lab
        return name
    return label


def _labelled(sim):
    """Wrap the Simulation's run, step, RHS and solve on the instance in
    profiler ranges; returns a function that removes the wrappers."""
    from torch.profiler import record_function

    def wrap(attr, key):
        inner = getattr(sim, attr)

        def call(*a, **k):
            with record_function(key):
                return inner(*a, **k)
        setattr(sim, attr, call)

    keys = {"run": "ecbench.run", "_step": "ecbench.step",
            "_rhs": "ecbench.rhs", "solve": "ecbench.solve"}
    had = {a: a in vars(sim) for a in keys}
    old = {a: vars(sim)[a] for a in keys if had[a]}
    for attr, key in keys.items():
        wrap(attr, key)

    def undo():
        for attr in keys:
            if had[attr]:
                setattr(sim, attr, old[attr])
            else:
                delattr(sim, attr)
    return undo


def profile_transient(sim, kernel_lists, sessions: int = 3) -> dict:
    """One whole transient of ``sim`` (``Simulation.run()`` from a cold
    state) under one profiler session, read as the benchmark's trace; a
    session whose operator kernels differ from the wrappers' counts is
    short, and another transient is traced in a new session, at most
    ``sessions`` in all.  Raises :class:`TraceShort` when every one was.

    Returns ``{"window_s", "busy_s", "steps", "iterations", "device_us",
    "operator": {"device_us", "launches", "applies"}, "device_ops",
    "idle_gaps", "sessions", "short", "kernels"}``; ``device_ops`` the
    device operations by their summed seconds (:func:`short_name`),
    ``idle_gaps`` the idle seconds by what the host was doing, each sorted,
    longest first, at most 10."""
    counters = [(k, _counter(k["counter"])) for k in kernel_lists]
    short = []
    for n in range(1, sessions + 1):
        before = [c.launches for _, c in counters]
        undo = _labelled(sim)
        try:
            (_, diag), device, host = _session(sim.run)
        finally:
            undo()
        counted = [c.launches - b for (_, c), b in zip(counters, before)]
        op_us, launches, applies, pairs = 0.0, 0, 0, []
        for (k, _), cnt in zip(counters, counted):
            mine = [(s, e) for name, s, e in device
                    if any(p in name for p in k["names"])]
            pairs.append((k["file"], cnt, len(mine)))
            op_us += sum(e - s for s, e in mine)
            launches += cnt
            applies += cnt if k["apply"] else 0
        if all(cnt == seen for _, cnt, seen in pairs) and launches:
            break
        short.append(pairs)
    else:
        raise TraceShort(
            f"{sessions} profiler sessions, each short of the operator "
            f"launches the wrappers counted: (kernel list, counted, traced) "
            f"{short}")
    (t0, t1), = host["ecbench.run"]
    busy = _union([(s, e) for _, s, e in device])
    gaps = defaultdict(float)
    label = _labeller(host)
    edge = t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            gaps[label(0.5 * (edge + s))] += (s - edge) * 1e-6
        edge = max(edge, e)
    ops = defaultdict(float)
    for name, s, e in device:
        ops[short_name(name)] += (e - s) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "steps": diag["steps"], "iterations": diag["total_iterations"],
            "device_us": sum(e - s for _, s, e in device),
            "operator": {"device_us": op_us, "launches": launches,
                         "applies": applies},
            "device_ops": top(ops), "idle_gaps": top(gaps),
            "sessions": n, "short": short, "kernels": pairs}
