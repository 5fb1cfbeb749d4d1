#!/usr/bin/env python3
"""The split pair (coded_stencil, coded_slab) on one CUDA card: another
checkout's build against this tree's.

    python3 split_bench.py --parent DIR [--out OUT]

DIR is another checkout of the repository (an unpacked ``git archive`` of
the parent commit, say, in a directory ``.gitignore`` lists; it needs
``chip_smoke.py`` and ``eddy_currents_3d_tpu_torch/``).  Four processes run
in turns on the same card, DIR, this tree, this tree, DIR; each builds its
own kernels and runs its own ``chip_smoke.py`` phases 3 (coded_matvec
against its plain version), 4 (the split pair against its plain versions),
7 (256x256x64 on both routes) and 16 (device µs per call), then profiles 5
split steps at 256x256x64 (device µs per iteration, busy share), hashes the
outputs of coded_matvec (team7, convection, scale256: apply, apply_dots,
apply_div) and of the split pair (scale256 and convection: apply,
apply_dots, apply_div) on inputs made from fixed seeds, and takes step 1
of 256x256x64 on both routes, each with its kernels' fused dots and with
float64 sums of the same products in their place, against the port's
float64 step 1 on the CPU (computed by the first process, kept for the
others in a temporary directory): max |dA| / (tol scale) of each run to
the float64 state and between the routes, the fused dots' largest error,
and the call at which the two routes' dots part.  The last lines compare the hashes: coded_matvec of
DIR against this tree, the split pair of DIR against this tree, and within
each build the split pair against coded_matvec.

Every process's full output goes to OUT (default split_bench_out/); the
summary is printed.  Without a CUDA device the script exits 1.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TAG = "SPLIT_BENCH "


def _load_smoke(root):
    """``root``'s chip_smoke.py as a module, with ``root`` first on the
    path so that its package is the one imported."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _grids():
    from eddy_currents_3d_tpu_torch.testing.cases import (case_convection,
                                                          case_static)
    return [("team7", case_static(shape_xyz=(102, 102, 24), steps=3)),
            ("convection", case_convection(shape_xyz=(48, 24, 16), steps=3)),
            ("scale256", case_static(shape_xyz=(256, 256, 64), steps=5))]


def _hashes(cs, recs, dev):
    """Output hashes of coded_matvec and the split pair, and whether the
    pair equals coded_matvec bit for bit."""
    import torch

    from eddy_currents_3d_tpu_torch.ops import coded
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 coded_stencil)

    out = {}
    for name, rec in recs.items():
        op = rec["op"]
        x, w = cs._inputs(rec["model"], dev, 7)
        yA, yU = coded_matvec(op, x.A, x.U)
        dA, dU, pw, py = coded_matvec(op, x.A, x.U, w)
        dv = coded_matvec(op, x.A)
        out[f"matvec {name}"] = _digest(yA, yU, dA, dU, pw, py, dv)
        if name == "team7":
            continue
        prev = coded._WHOLE_PLANE_BUDGET
        coded._WHOLE_PLANE_BUDGET = 0          # the split route at any size
        try:
            zb0, zb1 = op.cond_z
            sA = coded_stencil(op, x.A)
            sU = coded_slab(op, x.A, x.U[zb0:zb1], sA)
            sv = coded_slab(op, x.A)
            y, spw, spy = op.apply_dots(op.pad_state(x), op.pad_state(w))
        finally:
            coded._WHOLE_PLANE_BUDGET = prev
        torch.cuda.synchronize()
        out[f"split {name}"] = _digest(sA, sU, sv, y.A, y.U)
        out[f"split dots {name}"] = [float(spw), float(spy)]
        out[f"split == matvec {name}"] = bool(
            torch.equal(sA, yA) and torch.equal(sU, yU[zb0:zb1])
            and torch.equal(sv, dv[zb0:zb1]))
    return out


def _step1_gaps(rec, dev, store):
    """Step 1 of 256x256x64 in float32 on the card, on both routes, each
    with its kernels' fused dots and with those dots replaced by float64
    sums of the same products, against the port's float64 step 1 on the
    CPU (made once, then read from ``store``).  Returns {run: max |dA| /
    (tol scale) to float64}, "split-whole" (the two kernel-dot runs'
    gap), the iterations, each kernel-dot run's largest relative error of
    a fused dot against the float64 sum of its products, and the first
    fused-dot call at which the two routes' dots part by more than 1e-4
    relative."""
    import torch

    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.ops import coded

    model, sysm = rec["model"], rec["system"]
    path = os.path.join(store, "f64_step1.pt")
    if os.path.exists(path):
        ref = torch.load(path)
    else:
        st, diag = Simulation(model, torch.float64,
                              device="cpu").run(num_steps=1)
        ref = {"A": st.A, "iterations": diag["iterations"]}
        torch.save(ref, path)

    def f64_dots(y, w):
        pw = sum((a.double() * b.double()).sum() for a, b in
                 ((y.A, w.A), (y.U, w.U)))
        py = sum((a.double() ** 2).sum() for a in (y.A, y.U))
        return pw, py

    op_cls = coded.CodedStencilOperator
    kernel = op_cls.apply_dots

    def hooked(exact, seen):
        """apply_dots recording (dots, their float64 sums); with ``exact``
        it returns the float64 sums, rounded to float32."""
        def apply_dots(op, x, w):
            y, pw, py = kernel(op, x, w)
            rw, ry = f64_dots(y, w)
            seen.append((float(pw), float(py), float(rw), float(ry)))
            return (y, rw.float(), ry.float()) if exact else (y, pw, py)
        return apply_dots

    out = {"iterations": {"f64": ref["iterations"]}}
    A, seen = {}, {}
    prev = coded._WHOLE_PLANE_BUDGET
    for route, budget in (("split", prev), ("whole", float("inf"))):
        for exact in (False, True):
            run = route + (" f64 dots" if exact else "")
            coded._WHOLE_PLANE_BUDGET = budget
            seen[run] = []
            op_cls.apply_dots = hooked(exact, seen[run])
            try:
                sim = Simulation(model, torch.float32, device=dev,
                                 system=sysm)
                assert sim.coded_op.split == (route == "split")
                st, diag = sim.run(num_steps=1)
            finally:
                coded._WHOLE_PLANE_BUDGET = prev
                op_cls.apply_dots = kernel
            A[run] = st.A.double().cpu()
            out["iterations"][run] = diag["iterations"]
    scale = model.solver.tolerance * ref["A"].abs().max().item()
    for run in A:
        out[run] = (A[run] - ref["A"]).abs().max().item() / scale
    out["split-whole"] = (A["split"] - A["whole"]).abs().max().item() / scale
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out["dot_err"] = {run: max(max(rel(pw, rw), rel(py, ry))
                               for pw, py, rw, ry in seen[run])
                      for run in ("split", "whole")}
    parts = [j for j, (s_, w_) in enumerate(zip(seen["split"],
                                                seen["whole"]))
             if max(rel(s_[0], w_[0]), rel(s_[1], w_[1])) > 1e-4]
    out["first_parting_call"] = parts[0] if parts else None
    out["fused_calls"] = len(seen["split"])
    return out


def child(root, tag, store):
    """One build's phases 3, 4, 7 and 16, a profile, the hashes and the
    float64 witness."""
    import torch

    cs = _load_smoke(root)
    if not torch.cuda.is_available():
        print("split_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = cs.phase_device()
    cs.phase_build()
    grids = _grids()
    recs = cs.phase_kernel_vs_plain(grids, dev)
    cs.phase_split_vs_plain([grids[2], grids[1]], dev)
    cs.phase_scale(recs["scale256"], dev)
    times = cs.phase_device_times(recs, dev)

    from eddy_currents_3d_tpu_torch import Simulation
    rec = recs["scale256"]
    sim = Simulation(rec["model"], torch.float32, device=dev,
                     system=rec["system"])
    (_, diag), kernels, wall = cs.trace(lambda: sim.run(num_steps=5))
    its = diag["total_iterations"]
    dev_us = sum(t for t, _ in kernels.values()) / its
    busy = sum(t for t, _ in kernels.values()) / 1e6 / wall
    print(f"[split_bench {tag}] 256x256x64 split x 5 steps profiled: "
          f"iterations {diag['iterations']}, {wall / its * 1e3:.3f} "
          f"ms/iteration under the profiler, device {dev_us:.1f} "
          f"us/iteration, busy {busy:.1%}", flush=True)
    gaps = _step1_gaps(rec, dev, store)
    print(f"[split_bench {tag}] 256x256x64 step 1, max |dA| / (tol scale) "
          f"to float64: " + ", ".join(
              f"{run} {gaps[run]:.4f}" for run in gaps["iterations"]
              if run != "f64")
          + f"; split to whole {gaps['split-whole']:.4f}; iterations "
          f"{gaps['iterations']}; fused dots' largest relative error "
          f"{gaps['dot_err']}; the routes' fused dots part at call "
          f"{gaps['first_parting_call']} of {gaps['fused_calls']}",
          flush=True)
    res = {"tag": tag, "root": root, "card": card,
           "device_us": {k: None if v is None else v * 1e3
                         for k, v in times.items()},
           "profiled": {"iterations": diag["iterations"],
                        "ms_per_iteration": wall / its * 1e3,
                        "device_us_per_iteration": dev_us, "busy": busy},
           "step1_gaps": gaps,
           "hashes": _hashes(cs, recs, dev)}
    print(TAG + json.dumps(res), flush=True)
    return 0


def _run(args, log):
    """Run this script with ``args`` in a new process; its output goes to
    ``log`` and its TAG line is returned."""
    cmd = [sys.executable, os.path.abspath(__file__), *args]
    with open(log, "w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                              text=True, timeout=1200)
    lines = open(log).read().splitlines()
    for line in lines:
        if line.startswith(("[3]", "[4]", "[7]", "[16]", "[split_bench")):
            print(line, flush=True)
    if proc.returncode != 0:
        print("\n".join(lines[-30:]), flush=True)
        raise SystemExit(f"{' '.join(args)} failed with {proc.returncode}; "
                         f"see {log}")
    return json.loads([ln for ln in lines if ln.startswith(TAG)][-1][len(TAG):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout to compare with")
    ap.add_argument("--out", default=os.path.join(HERE, "split_bench_out"),
                    help="directory for each process's full output")
    ap.add_argument("--child", nargs=3, metavar=("ROOT", "TAG", "STORE"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child(*a.child)
    if not a.parent:
        ap.error("--parent DIR is required")
    import torch
    if not torch.cuda.is_available():
        print("split_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    os.makedirs(a.out, exist_ok=True)
    parent = os.path.abspath(a.parent)
    store = tempfile.mkdtemp(prefix="split_bench_")
    runs = []
    try:
        for j, (root, tag) in enumerate(((parent, "parent"), (HERE, "change"),
                                         (HERE, "change"), (parent, "parent"))):
            runs.append(_run(["--child", root, tag, store],
                             os.path.join(a.out, f"{j}_{tag}.log")))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    by = {tag: [r for r in runs if r["tag"] == tag]
          for tag in ("parent", "change")}
    for tag, rs in by.items():
        for r in rs:
            print(f"[summary] {tag}: device us/call "
                  + ", ".join(f"{k} {v:.2f}" for k, v in r["device_us"].items()
                              if v is not None)
                  + f"; split 5 steps {r['profiled']}; step 1 gaps "
                  f"{r['step1_gaps']}", flush=True)
    hp, hc = by["parent"][0]["hashes"], by["change"][0]["hashes"]
    for key in sorted(hp):
        if key.startswith(("matvec", "split ")) and "dots" not in key \
                and "==" not in key:
            print(f"[summary] {key}: parent {hp[key]} change {hc[key]} "
                  f"equal {hp[key] == hc[key]}", flush=True)
        else:
            print(f"[summary] {key}: parent {hp[key]} change {hc[key]}",
                  flush=True)
    repeat = all(r["hashes"] == by[r["tag"]][0]["hashes"] for r in runs)
    print(f"[summary] each build's hashes repeat across its two runs: "
          f"{repeat}", flush=True)
    print(TAG + json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
