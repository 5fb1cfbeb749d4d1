#!/usr/bin/env python3
"""The control of the benchmark's check: the program's own lower-precision
path (bfloat16 state, the configuration's float32 one step down) run
through a cell's whole run at the cell's own size, which the check has to
find not correct.  Also reads the program's own numbers over many seeds in
one process, where set-up is long.  The benchmark's runs never run it.

    python3 ecbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2 [--dtype bfloat16] [--steps N]

``--steps N`` cuts each transient to its first N steps, for a control that
does not converge at the cell's size (bfloat16 at 256x256x64 runs every
step to itmax, ~20 s a step) and so would never finish a transient.

Prints one JSON line a seed: the seed, ``correct`` and every number
compared beside its limit, then a summary line with each number's largest
and smallest reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from ecbench import cellspec  # noqa: E402
from ecbench.run import DTYPES, run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=None)
    args = p.parse_args(argv)
    cell = cellspec.load_cell(ROOT, args.workload)
    if args.steps is not None:
        cell.traffic["steps"] = args.steps
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    lo, hi = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, device=args.device,
                       dtype=DTYPES[args.dtype], t0=t0, warm_s=0.0)
        for name, c in out["checks"].items():
            lo[name] = min(lo.get(name, c["value"]), c["value"])
            hi[name] = max(hi.get(name, c["value"]), c["value"])
        print(json.dumps({"seed": seed, "dtype": args.dtype,
                          "correct": out["correct"], "checks": out["checks"],
                          "info": out["info"],
                          "setup_s": out["metrics"].get("setup_s")}),
              flush=True)
    print(json.dumps({"workload": args.workload, "dtype": args.dtype,
                      "smallest": lo, "largest": hi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
