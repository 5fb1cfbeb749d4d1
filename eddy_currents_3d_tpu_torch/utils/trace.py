"""Spans and counters inside the time step, timed on the host and, on a CUDA
card, by timing events: where a transient's time goes, read without the
profiler.

Off by default: :func:`enable` switches the tracer on, :func:`disable` off
(dropping what it kept), and :func:`report` returns what was kept since
:func:`enable`.  While it is off a span site (``with trace.span(...)``)
costs the call, one check of the module flag :data:`ON` and a shared null
context: no object, no clock read, no event.

A span keeps its name, its host start and end (``time.perf_counter_ns``),
its parent (the innermost span open when it opened), and the run (one
transient) and step it belongs to: a ``transient`` span (``run``) starts a
new run number, a span given ``step=`` sets the step index, and the spans
inside share both.  A span's self time is its time less what its child
spans cover.  Counters (:func:`count`, or a span's ``counts=``) are kept in
all.

The device clock.  A span given a CUDA ``device`` and a ``clock`` also
records a timing event (``torch.cuda.Event``, :class:`CudaClock`) on the
device's current stream at its start and at its end, taken from a pool of
events that are reused.  A run's events are read only after its own final
wait on the event given to :func:`anchor` (where none was given, the
tracer records one and waits on it when the run's ``transient`` span
closes), so the hot path gains no synchronizing call;
the host clock read just after that wait is the anchor's device time,
which puts every event of the run on the host clock.  They are read in
slices at the closes of the next run's ``interval`` spans, while the card
works through what the host has enqueued ahead of it, and the rest by
:func:`report`.  The time between a span's two events is:

* ``clock="interval"``, for a span that enqueues device work (``step``,
  ``solve``): its device interval.  The intervals of consecutive steps tile
  the device's timeline but for what the host does between them, since the
  host records step k+1's first event just after step k's last one;
* ``clock="wait"``, for a span that enqueues none (``rhs.motion``): its
  device wait, the time the stream sat empty while the host work ran, 0
  where the host was ahead of the card.

The wait between two runs is measured from the last event of one to the
first event of the next.  On the CPU no event is recorded and the device
fields are None.

Under an active ``torch.profiler`` session each span also opens a
``record_function`` range of its own name, so the profiler's trace holds
the program's spans on the profiler's clock.

:func:`summary` reduces a report to numbers a step and an iteration, and
:func:`chrome_trace` to Chrome trace-event JSON (Perfetto): the host spans
on one track, the device intervals and waits on a second, on the same host
clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Optional

import torch

__all__ = ["ON", "enable", "disable", "span", "count", "anchor", "report",
           "summary", "chrome_trace"]

ON = False          # the tracer is on: spans and counters are kept
_NULL = contextlib.nullcontext()
_tracer: Optional["_Tracer"] = None
_profiler = torch.autograd.profiler


class CudaClock:
    """Timing events on CUDA devices: ``torch.cuda.Event`` objects, recorded
    on the device's current stream."""

    def new(self, device) -> torch.cuda.Event:
        """A new timing event (made on the device at its first record)."""
        return torch.cuda.Event(enable_timing=True)

    def record(self, ev, device):
        """Record ``ev`` on ``device``'s current stream."""
        ev.record(torch.cuda.current_stream(device))

    def synchronize(self, ev):
        ev.synchronize()

    def elapsed(self, evs: list, end) -> list:
        """Milliseconds from each of ``evs`` to ``end``, all complete."""
        return [ev.elapsed_time(end) for ev in evs]


_CUDA_CLOCK = CudaClock()


def _clock(device):
    """The clock of spans on ``device``: None but on a CUDA device."""
    return _CUDA_CLOCK if device.type == "cuda" else None


def enable():
    """Switch the tracer on, with nothing kept yet."""
    global ON, _tracer
    _tracer = _Tracer()
    ON = True


def disable():
    """Switch the tracer off and drop what it kept, its events with it."""
    global ON, _tracer
    ON = False
    _tracer = None


def span(name: str, device=None, clock: Optional[str] = None, *,
         step: Optional[int] = None, counts: Optional[str] = None,
         transient: bool = False):
    """A context manager over one span ``name``.  ``device`` and ``clock``
    (``"interval"`` or ``"wait"``) give it the device clock on a CUDA
    device; ``step`` sets the step index of it and the spans inside it;
    ``counts`` names a counter it adds 1 to; ``transient`` makes it a run:
    a new run number, its events put to be read when it closes."""
    if not ON:
        return _NULL
    return _Span(_tracer, name, device if clock else None, clock, step,
                 counts, transient)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if ON:
        _tracer.add(name, n)


def anchor(done):
    """``done``, a ``torch.cuda.Event(enable_timing=True)`` the host has
    just waited for, anchors the events of the run in flight to the host
    clock."""
    if ON:
        _tracer.anchor = (done, time.perf_counter_ns())


def report() -> dict:
    """What the tracer kept since :func:`enable` (empty while off):

    * ``spans``: in the order they opened, each ``{"name", "parent"`` (an
      index into ``spans`` or None), ``"run", "step", "start_ns",
      "end_ns", "self_ns", "clock", "device_start_ns",
      "device_end_ns"}``, the times on the host's ``perf_counter_ns``
      clock, the device's None without a device clock;
    * ``counters``: ``{name: total}``;
    * ``runs``: each ``{"run", "wait_before_ns"}``, the device's wait
      between the run before and this one;
    * ``device``: whether any span carries device times."""
    if _tracer is None:
        return {"spans": [], "counters": {}, "runs": [], "device": False}
    return _tracer.report()


class _Span:
    """One open span; what it keeps goes to its tracer as it closes."""

    __slots__ = ("name", "device", "clock", "step", "counts", "transient",
                 "i", "t0", "ev0", "prof", "tr")

    def __init__(self, tr, name, device, clock, step, counts, transient):
        self.tr = tr
        self.name = name
        self.device = None
        if device is not None:
            clk = _clock(device)
            if clk is not None:
                if tr.clock is None:
                    tr.clock, tr.device = clk, device
                elif device != tr.device:
                    raise ValueError(
                        f"the tracer times spans on {tr.device}; a span on "
                        f"{device} as well is one device too many")
                self.device = device
        self.clock = clock
        self.step = step
        self.counts = counts
        self.transient = transient
        self.prof = None

    def __enter__(self):
        tr = self.tr
        if self.transient:
            tr.run += 1
            tr.step = None
        if self.step is not None:
            tr.step = self.step
        self.i = len(tr.spans)
        tr.spans.append(None)
        tr.device_ns.append(None)
        tr.opened.append((self.name, tr.stack[-1] if tr.stack else None,
                          tr.run, tr.step, self.clock))
        tr.stack.append(self.i)
        if self.transient:
            tr.transients.append(tr.run)
        if self.counts:
            tr.add(self.counts)
        if _profiler._is_profiler_enabled:
            self.prof = _profiler.record_function(self.name)
            self.prof.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.device is not None:
            self.ev0 = tr.record(self.device)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        if self.device is not None:
            tr.pending.append((self.i, self.ev0, tr.record(self.device)))
            if self.clock == "interval":
                # the device is busy with what this span enqueued
                tr.read(_READ_SLICE)
        if self.transient:
            tr.close_run()
        tr.spans[self.i] = (self.t0, time.perf_counter_ns())
        tr.stack.pop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


# events of closed runs read at each close of an ``interval`` span: reading
# one takes a few microseconds of host time, so a run's several hundred are
# read in slices while the card works through the next run's steps, where
# the host is ahead of it, and not while it waits between runs
_READ_SLICE = 64


class _Batch:
    """The closed clocked spans of one run, read against its anchor."""

    def __init__(self, run, spans, events, anchor, free):
        self.run = run
        self.spans = spans      # their indices
        self.events = events    # the spans' two each; the wait's last
        self.anchor = anchor    # (event, host ns)
        self.free = free        # events to pool once read
        self.ms = []            # milliseconds to the anchor, read so far


class _Tracer:
    """What one :func:`enable` keeps.  A span's record is a few tuples of
    numbers and strings in lists, which the garbage collector stops
    walking, and no object of its own: a window keeps tens of thousands."""

    def __init__(self):
        self.opened: list = []    # (name, parent, run, step, clock) a span
        self.spans: list = []     # (host start, end) ns, None while open
        self.device_ns: list = []  # (device start, end) ns, or None
        self.stack: list = []     # indices of the open spans
        self.transients: list = []  # the runs of transient spans
        self.run = -1
        self.step = None
        self.counters = defaultdict(int)
        self.clock = None         # the device clock of the clocked spans
        self.device = None        # and their device, one a process
        self.pool: list = []      # timing events free to record
        self.pending: list = []   # (index, event, event) of closed spans
        self.unread = deque()     # _Batch of closed runs, oldest first
        self.last = None          # the event recorded last
        self.held = None          # the last closed run's last event
        self.anchor = None        # (event, host ns)
        self.waits: dict = {}     # run: device ns since the run before

    def add(self, name, n=1):
        self.counters[name] += n

    def record(self, device):
        ev = self.pool.pop() if self.pool else self.clock.new(device)
        self.clock.record(ev, device)
        self.last = ev
        return ev

    def close_run(self):
        """The closed clocked spans become a batch to read against the
        anchor (one the tracer records and waits for where the run gave
        none), with the last event of the run before for the wait between
        the two; the last event is held for the next."""
        pend, self.pending = sorted(self.pending), []
        if not pend:            # in open order: the run's first event first
            return
        last, own = self.last, []
        if self.anchor is None:
            ev = self.record(self.device)
            self.clock.synchronize(ev)
            self.anchor = (ev, time.perf_counter_ns())
            own = [ev]
        events = [ev for _, e0, e1 in pend for ev in (e0, e1)]
        free = events + own
        if self.held is not None:
            events.append(self.held)
            free.append(self.held)
        self.held = None
        if last in free:        # not an open span's
            free.remove(last)
            self.held = last
        self.unread.append(_Batch(self.run, [i for i, _, _ in pend], events,
                                  self.anchor, free))
        self.anchor = None

    def read(self, limit=None):
        """Read at most ``limit`` events (every one: None) of the closed
        runs, oldest first; a batch read through gives its spans their
        device times and its run the wait before it, and its events go
        back to the pool."""
        while self.unread and (limit is None or limit > 0):
            b = self.unread[0]
            todo = b.events[len(b.ms):]
            if limit is not None:
                todo = todo[:limit]
                limit -= len(todo)
            b.ms += self.clock.elapsed(todo, b.anchor[0])
            if len(b.ms) < len(b.events):
                return
            at = b.anchor[1]
            ns = [at - round(m * 1e6) for m in b.ms]
            for k, i in enumerate(b.spans):
                self.device_ns[i] = (ns[2 * k], ns[2 * k + 1])
            if len(ns) > 2 * len(b.spans):
                self.waits[b.run] = ns[0] - ns[-1]
            self.pool.extend(b.free)
            self.unread.popleft()

    def report(self) -> dict:
        self.close_run()
        self.read()
        host = [t or (None, None) for t in self.spans]
        child = [0] * len(host)
        for (_, parent, *_), (t0, t1) in zip(self.opened, host):
            if parent is not None and t1 is not None:
                child[parent] += t1 - t0
        out = []
        for i, ((name, parent, run, step, clock), (t0, t1), dev) in enumerate(
                zip(self.opened, host, self.device_ns)):
            out.append({"name": name, "parent": parent, "run": run,
                        "step": step, "start_ns": t0, "end_ns": t1,
                        "self_ns": None if t1 is None else t1 - t0 - child[i],
                        "clock": clock,
                        "device_start_ns": dev and dev[0],
                        "device_end_ns": dev and dev[1]})
        return {"spans": out, "counters": dict(self.counters),
                "runs": [{"run": r, "wait_before_ns": self.waits.get(r)}
                         for r in self.transients],
                "device": any(d is not None for d in self.device_ns)}


def _device_ns(s) -> int:
    return s["device_end_ns"] - s["device_start_ns"]


def summary(rep: dict, wall_ns: Optional[int] = None) -> dict:
    """A report's numbers a step and an iteration, over ``wall_ns`` (the
    host extent of its spans where None):

    * ``step_host_ms_per_step``: the host's time in ``step`` spans;
    * ``motion_host_ms_per_step``: ``rhs.motion`` self time (None without
      such spans);
    * ``step_device_ms_per_step``: ``step`` device intervals;
    * ``solve_device_us_per_iteration``: ``solve`` device intervals over
      the ``iterations`` counter;
    * ``step_outside_solve_ms_per_step``: ``step`` device intervals less
      those of the ``solve`` spans inside them: the step's own kernels
      (right-hand side, carry) and any wait of the card inside the step
      that no ``wait`` span covers, the most such waits can be;
    * ``device_wait_pct``: the device's waits (``wait`` spans, between the
      steps of a run, between runs) over the wall time.  A lower bound of
      the idle: a wait inside a step outside the ``wait`` spans counts as
      busy (at most ``step_outside_solve_ms_per_step``);
    * ``accounted_pct``: step intervals and the waits between steps and
      runs over the wall time.  Near 100 by construction, since the step
      intervals and the gaps between them tile the runs: it checks the
      events' anchoring to the host clock, not the idle.

    The device's numbers are None where the report has no device times."""
    spans = [s for s in rep["spans"] if s["end_ns"] is not None]
    c = rep["counters"]
    steps, its = c.get("steps", 0), c.get("iterations", 0)
    if wall_ns is None:
        wall_ns = (max(s["end_ns"] for s in spans)
                   - min(s["start_ns"] for s in spans)) if spans else 0
    named = defaultdict(list)
    for s in spans:
        named[s["name"]].append(s)
    per = lambda ns, n, unit: ns / unit / n if n else None
    out = {"steps": steps, "iterations": its, "wall_ns": wall_ns,
           "step_host_ms_per_step": per(
               sum(s["end_ns"] - s["start_ns"] for s in named["step"]),
               steps, 1e6),
           "motion_host_ms_per_step": (per(
               sum(s["self_ns"] for s in named["rhs.motion"]), steps, 1e6)
               if named["rhs.motion"] else None),
           "step_device_ms_per_step": None,
           "solve_device_us_per_iteration": None,
           "step_outside_solve_ms_per_step": None,
           "device_wait_pct": None, "accounted_pct": None}
    if not rep["device"]:
        return out
    stepd = [s for s in named["step"] if s["device_start_ns"] is not None]
    gaps = sum(b["device_start_ns"] - a["device_end_ns"]
               for a, b in zip(stepd, stepd[1:]) if a["run"] == b["run"])
    between = sum(r["wait_before_ns"] or 0 for r in rep["runs"])
    waits = sum(_device_ns(s) for s in spans
                if s["clock"] == "wait" and s["device_start_ns"] is not None)
    busy = sum(_device_ns(s) for s in stepd)
    solves = [s for s in named["solve"] if s["device_start_ns"] is not None]
    in_steps = sum(_device_ns(s) for s in solves if s["parent"] is not None
                   and rep["spans"][s["parent"]]["name"] == "step")
    out.update(
        step_device_ms_per_step=per(busy, steps, 1e6),
        solve_device_us_per_iteration=per(
            sum(_device_ns(s) for s in solves), its, 1e3),
        step_outside_solve_ms_per_step=per(busy - in_steps, steps, 1e6),
        device_wait_pct=per(100.0 * (waits + gaps + between), wall_ns, 1),
        accounted_pct=per(100.0 * (busy + gaps + between), wall_ns, 1))
    return out


def chrome_trace(rep: dict, pid: int = 0) -> dict:
    """``rep`` as Chrome trace-event JSON: the host spans on track 0, the
    device intervals and waits (``<name> [interval]``, ``<name> [wait]``,
    ``between runs [wait]``) on track 1, microseconds from the first host
    span's start on the one host clock."""
    spans = [s for s in rep["spans"] if s["end_ns"] is not None]
    t0 = min((s["start_ns"] for s in spans), default=0)
    us = lambda ns: (ns - t0) / 1e3
    ev = [{"name": "process_name", "ph": "M", "pid": pid,
           "args": {"name": "eddy_currents_3d_tpu_torch"}},
          {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
           "args": {"name": "host"}},
          {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
           "args": {"name": "device (CUDA events)"}}]
    first = {}
    for s in spans:
        args = {"run": s["run"], "step": s["step"]}
        ev.append({"name": s["name"], "ph": "X", "pid": pid, "tid": 0,
                   "ts": us(s["start_ns"]),
                   "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "args": args})
        if s["device_start_ns"] is not None:
            first.setdefault(s["run"], s["device_start_ns"])
            ev.append({"name": f"{s['name']} [{s['clock']}]", "ph": "X",
                       "pid": pid, "tid": 1, "ts": us(s["device_start_ns"]),
                       "dur": _device_ns(s) / 1e3, "args": args})
    for r in rep["runs"]:
        if r["wait_before_ns"] is not None and r["run"] in first:
            end = first[r["run"]]
            ev.append({"name": "between runs [wait]", "ph": "X", "pid": pid,
                       "tid": 1, "ts": us(end - r["wait_before_ns"]),
                       "dur": r["wait_before_ns"] / 1e3,
                       "args": {"run": r["run"]}})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}
