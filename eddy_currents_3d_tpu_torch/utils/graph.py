"""CUDA graphs of the solver's device programs, and what the kernel
wrappers need to be captured in one.

A device program is a function of static tensors: it reads and writes the
same tensors every time it runs, so on the card it can be captured once as
a CUDA graph (:class:`Graph`), and a solve's programs joined into one graph
launched again and again (:class:`SolveGraph`); on the CPU it is called.  Two things the hand-written kernels' wrappers keep must follow
the graph:

* their scratch (the march kernels' dot partials, last-CTA counter and run
  table, ``ops/coded_cuda.py`` ``MarchKernel``) is made at its first launch
  per operator, device and stream.  A program's warm-up and capture keep
  theirs in the program's own store instead (:func:`program_scratch`), so
  the scratch is made eagerly in the warm-up, where its host-to-device
  copy is legal, the capture finds it, whatever stream the capture runs
  on, and it is freed with the :class:`Graph` that holds the store;
* their launch counts (``launches``) count Python calls.  A capture makes
  no launch, so :class:`Graph` takes back what the capture added and adds
  it again each time the graph runs (:meth:`Graph.count`), so the counts
  stay counts of kernels that ran.  Every wrapper count registers itself
  with :func:`counted`.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Optional

import torch

__all__ = ["counted", "program_scratch", "read_host", "Graph",
           "SolveGraph", "WhilePrimer"]

_COUNTS: list = []          # every launch count of a kernel wrapper
_LOCAL = threading.local()  # the scratch store of the program being captured


def counted(holder):
    """Register ``holder`` (anything with an int ``launches``) so that graph
    runs add to it; returns it."""
    _COUNTS.append(holder)
    return holder


def program_scratch():
    """The scratch store (a dict) of the program being warmed up or
    captured on this thread, else None."""
    return getattr(_LOCAL, "store", None)


def read_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a CPU tensor as it is; a CUDA tensor through one
    copy into pinned memory, waited for on an event (a wait that
    ``torch.cuda.set_sync_debug_mode`` does not flag, so a check under it
    sees every other synchronizing call)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return host


@contextlib.contextmanager
def _program(store):
    prev = getattr(_LOCAL, "store", None)
    _LOCAL.store = store
    try:
        yield
    finally:
        _LOCAL.store = prev


class Graph:
    """``fn()`` (static tensors only) captured as one CUDA graph on ``dev``
    in memory pool ``pool``, after one eager ``warm()`` (default ``fn``)
    on a side stream; both with this graph's scratch store.  A failed
    capture raises.  The captured ``cudaGraph_t`` (:attr:`raw`) is kept for
    a :class:`SolveGraph` to hold as a child node, or the graph is
    launched on its own (:meth:`replay`, instantiated at its first run)."""

    def __init__(self, fn: Callable[[], None], dev, pool=None,
                 warm: Optional[Callable[[], None]] = None):
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._scratch = {}     # the wrappers' scratch its kernels use
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with _program(self._scratch), torch.cuda.stream(side):
            (warm or fn)()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [h.launches for h in _COUNTS]
        with _program(self._scratch), torch.cuda.graph(self._graph, pool=pool):
            fn()
        self._delta = [h.launches - b for h, b in zip(_COUNTS, before)]
        for h, b in zip(_COUNTS, before):
            h.launches = b
        self.raw = self._graph.raw_cuda_graph()

    def replay(self):
        """Run the graph once on the current stream."""
        self._graph.replay()

    def count(self, runs: int = 1):
        """Add to every wrapper's count the launches of ``runs`` runs."""
        for h, d in zip(_COUNTS, self._delta):
            h.launches += d * runs


class SolveGraph:
    """One instantiated CUDA graph of a whole solve (``csrc/solve_graph.cu``):
    the ``setup`` graph, then a WHILE node that runs the ``body`` graph
    while ``not done and it <= itmax`` (``done`` a 0-d bool, ``it`` a 0-d
    int32 tensor), then the ``finish`` graph; the three are raw
    ``cudaGraph_t`` of :class:`Graph` captures, held as child nodes.  :meth:`launch` runs it on the current stream."""

    _lib = None

    @classmethod
    def _library(cls):
        if cls._lib is None:
            from ..ops._build import load_library
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib = load_library("solve_graph")
            lib.solve_graph_build.argtypes = [vp] * 5 + [ci,
                                                         ctypes.POINTER(vp)]
            lib.solve_graph_build.restype = ci
            lib.solve_graph_launch.argtypes = [vp, vp]
            lib.solve_graph_launch.restype = ci
            lib.solve_graph_destroy.argtypes = [vp]
            lib.solve_graph_destroy.restype = ci
            cls._lib = lib
        return cls._lib

    def __init__(self, setup: int, body: int, finish: int,
                 done: torch.Tensor, it: torch.Tensor, itmax: int):
        if done.dtype != torch.bool or it.dtype != torch.int32:
            raise ValueError("done must be bool and it int32")
        self._dev = done.device
        self._exec = None
        lib = self._library()
        out = ctypes.c_void_p()
        with torch.cuda.device(self._dev):
            err = lib.solve_graph_build(setup, body, finish, done.data_ptr(),
                                        it.data_ptr(), int(itmax),
                                        ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"solve_graph_build failed: CUDA error {err} "
                               "(conditional WHILE nodes need CUDA 12.4+, "
                               "and their bodies refuse some captured "
                               "nodes, a multi-rank NCCL collective's "
                               "among them)")
        self._exec = out.value
        self._held = (done, it)
        self._launch = lib.solve_graph_launch

    def launch(self):
        # the current stream's raw handle: a torch.cuda.Stream object costs
        # 7-17 us of host time a launch on an H100's host, time in which
        # the card, idle after the step's host part, waits for the graph
        stream = torch._C._cuda_getCurrentRawStream(self._dev.index)
        err = self._launch(self._exec, stream)
        if err != 0:
            raise RuntimeError(f"solve_graph_launch failed: CUDA error {err}")

    def __del__(self):
        if self._exec is not None and self._lib is not None:
            self._lib.solve_graph_destroy(self._exec)


class WhilePrimer:
    """A small WHILE-node graph (:class:`SolveGraph`) on ``dev``: its body,
    one one-element kernel, runs ``RUNS`` times a :meth:`launch`.

    A ``torch.profiler`` session on an H100 loses kernel records of the
    first WHILE body it sees run (CUPTI): the first solve of every traced
    transient lost some of its first iterations' kernel events, at times
    the operator's, so the trace fell short of the wrappers' launch counts
    (PERF.md, Findings).  A run under an active profiler launches one of
    these before its first solve, and the loss falls on it; a run outside
    a profiler session launches none.  It writes nothing but its own
    counter."""

    RUNS = 8

    def __init__(self, dev):
        self._done = torch.zeros((), dtype=torch.bool, device=dev)
        self._it = torch.zeros((), dtype=torch.int32, device=dev)
        self._body = Graph(lambda: self._it.add_(1), dev)
        self._exec = SolveGraph(None, self._body.raw, None, self._done,
                                self._it, self.RUNS - 1)

    def launch(self):
        """The ``RUNS`` iterations, on the current stream."""
        self._it.zero_()
        self._exec.launch()
