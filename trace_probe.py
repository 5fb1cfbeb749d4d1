#!/usr/bin/env python3
"""Does torch.profiler show every kernel a CUDA graph runs?  On one CUDA
card: team7 (case_static 102x102x24) with ILU(0), 5 graphed steps from a
cold start, profiled N times in one process.

    python3 trace_probe.py [--sessions N] [--cold]

Each profiled run's launches are counted by the wrappers (coded_matvec,
field_a, field_u; chip_smoke.py's counters) and held against the kernel
events of its trace; the run's last state is held bit for bit against an
unprofiled graphed run's, the witness that every counted launch ran.  One
profiler session of an eager kernel comes before the graphs are captured,
as in chip_smoke.py; ``--cold`` captures them before any session.

Prints one JSON line: the sessions, how many held fewer events than
launches, whether every profiled run equalled the unprofiled one, and
each short session's (counted, traced) pairs.  Exits 1 without a card.
"""

import argparse
import json
import sys
import time

import torch


def trace(fn):
    """(fn(), {device kernel name: events}) over one profiler session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sessions", type=int, default=60)
    p.add_argument("--cold", action="store_true",
                   help="capture the graphs before any profiler session")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA card", file=sys.stderr)
        return 1
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u
    from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

    wrappers = {"coded_matvec": (coded_matvec, ("whole_march",)),
                "field_a": (field_a, ("field_a_kernel", "field_a_pairs")),
                "field_u": (field_u, ("field_u_kernel", "field_u_pairs"))}

    def chain(sim):
        st = sim.init_state()
        for t, _ in sim.steps[:5]:
            st, _ = sim._step(st, t)
        torch.cuda.synchronize()
        return st

    if not args.cold:
        x = torch.ones(1024, device="cuda")
        trace(lambda: x * 2)
    model = load_case(case_static(shape_xyz=(102, 102, 24), steps=20))
    sim = Simulation(model, torch.float32, device="cuda", precond="ilu0")
    ref = chain(sim)                      # captures the graphs
    ref = (ref.A.clone(), ref.U.clone())
    short, same = [], True
    t0 = time.perf_counter()
    for i in range(args.sessions):
        sim._settle()
        for w, _ in wrappers.values():
            w.launches = 0
        st, kernels = trace(lambda: chain(sim))
        sim._settle()
        same &= torch.equal(st.A, ref[0]) and torch.equal(st.U, ref[1])
        pairs = {name: (w.launches, sum(c for k, c in kernels.items()
                                        if any(p in k for p in parts)))
                 for name, (w, parts) in wrappers.items()}
        if any(t != c for c, t in pairs.values()):
            short.append({"session": i, **pairs})
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "cold": args.cold, "sessions": args.sessions,
                      "short": len(short), "all_equal_unprofiled": same,
                      "seconds": round(time.perf_counter() - t0, 1),
                      "short_sessions": short}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
