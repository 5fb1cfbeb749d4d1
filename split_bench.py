#!/usr/bin/env python3
"""The coded kernels (coded_matvec, coded_stencil, coded_slab), bsr_spmm
and the field pair (field_a, field_u) on one CUDA card: another
checkout's build against this tree's.

    python3 split_bench.py --parent DIR [--out OUT] [--kernels-only]
    python3 split_bench.py --parent DIR --steps [--out OUT]
    python3 split_bench.py --probe
    python3 split_bench.py --witness

DIR is another checkout of the repository (an unpacked ``git archive`` of
the parent commit, say, in a directory ``.gitignore`` lists; it needs
``chip_smoke.py`` and ``eddy_currents_3d_tpu_torch/``).  Four processes run
in turns on the same card, DIR, this tree, this tree, DIR; each builds its
own kernels and runs its own ``chip_smoke.py`` phases 3 (coded_matvec
against its plain version), 4 (the split pair against its plain versions),
7 (256x256x64 on both routes), 13 (bsr_spmm against its plain version, and
its times at team7), 14 (the matrix-form solve) and 16 (device µs per
call, coded_slab's among them); then

* the whole-plane matvec probe (``--probe``, below);
* the field pair's device µs per call at team7 and scale256, at float32
  state (float32 and bfloat16 coefficients) and at bfloat16 state (on
  each route the build has), and each field kernel's registers, spills
  and resident CTAs per SM;
* team7 at bfloat16 state, dot_dtype float32, 20 steps without VTK after
  2 steps of warm-up: iterations per step (they follow the field kernels'
  bits) and ms per iteration, and each field wrapper's µs per call between
  CUDA events at team7's bfloat16 state (the host's work included);
* profiles 20 team7 main-path steps (ms/iteration, device µs/iteration,
  busy share, device launches per iteration) and 5 split steps at
  256x256x64 (device µs per iteration, busy share);
* hashes, on inputs made from fixed seeds, the outputs yA and yU of
  coded_matvec (team7, convection, scale256: apply, apply_dots,
  apply_div; its dots apart), of the split pair (scale256 and convection:
  apply, apply_dots, apply_div), of bsr_spmm on team7's exported
  operator at k = 1 and k = 128, and of the field pair (field_a's output,
  field_u's yA and yU) on team7, convection and scale256 at each state,
  with, where the build has routes, whether the bfloat16-state scalar
  route gives the chosen route's bits;
* takes step 1 of 256x256x64 on both routes, each with its kernels'
  fused dots and with float64 sums of the same products in their place,
  against the port's float64 step 1 on the CPU (computed by the first
  process, kept for the others in a temporary directory): max |dA| /
  (tol scale) of each run to the float64 state and between the routes,
  the fused dots' largest error, and the call at which the two routes'
  dots part.

The last lines compare the hashes (DIR against this tree, and within each
build the split pair against coded_matvec) and give each build's numbers.
``--kernels-only`` leaves out the 256x256x64 runs (phase 7, the split
profile and the step-1 witness), which take most of the time.

``--steps`` (with ``--parent``) runs only team7's 20 main-path steps in
each process, in the same turns, after one step of warm-up: ms/step and
ms/iteration of the eager per-iteration loop (a build without the device
loop has no other) and of the graphed solve (:func:`steps_child`).

``--probe`` alone measures this tree's whole-plane matvec at team7: its
registers, spills and resident CTAs per SM, device µs per call of apply,
apply_dots (the kernel, and every kernel the call launches) and apply_div,
the same with every case code set to 0 (no decode), and coded_slab
launched over the whole grid.  ``--witness`` alone takes this tree's
step-1 witness (the last item above), for a change of the dots' order.

Every process's full output goes to OUT (default split_bench_out/); the
summary is printed.  Without a CUDA device the script exits 1.
"""

import argparse
import ast
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
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:        # numpy has no bfloat16
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
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
        out[f"matvec {name}"] = _digest(yA, yU, dA, dU, dv)
        out[f"matvec dots {name}"] = [float(pw), float(py)]
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


H100_SMS = 132
WHOLE_KERNELS = ("coded_matvec_kernel", "whole_march")   # parent, change
WHOLE_PATTERNS = ("coded_matvec_kernelILi1ELb0E", "whole_marchILi1ELb0E")


def _per_call(cs, fn, names, calls=20):
    """(device µs per launch of the kernels whose name holds one of
    ``names``, device µs per call of every kernel, device launches per
    call) over ``calls`` calls of ``fn``.  The profiler may miss an event,
    so each kernel counts as its mean time times its launches a call,
    rounded."""
    fn()
    _, kernels, _ = cs.trace(lambda: [fn() for _ in range(calls)])
    own = [(t, c) for k, (t, c) in kernels.items()
           if any(n in k for n in names)]
    per = {k: (t / c, round(c / calls)) for k, (t, c) in kernels.items()
           if c}
    return (sum(t for t, _ in own) / max(sum(c for _, c in own), 1),
            sum(m * r for m, r in per.values()),
            sum(r for _, r in per.values()))


def _ptxas_regs(line):
    """Registers per thread in a ptxas "Used N registers" line, or None."""
    import re
    m = re.search(r"Used (\d+) registers", line)
    return int(m.group(1)) if m else None


def _matvec_probe(cs, rec, dev, log):
    """The whole-plane coded matvec at team7: its resources, device µs per
    call in each mode, the same on team7's grid with no conducting cell
    (code 0 everywhere: no decode), and coded_slab launched over the whole
    grid (cond_z = (0, nz), full-shape U): the split route's z-march."""
    import dataclasses

    import torch

    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 plan_of)

    op = rec["op"]
    nz, ny, nx = op.shape_zyx
    x, w = cs._inputs(rec["model"], dev, 0)
    out = {}
    for pat in WHOLE_PATTERNS:
        ptx = cs._ptxas(log, pat)
        if ptx != "not in the build log":
            out["ptxas"] = ptx
    regs = _ptxas_regs(out.get("ptxas", ""))
    if hasattr(coded_matvec, "info"):
        out["ctas_per_sm"] = coded_matvec.info(1, False, dev)["ctas_per_sm"]
    elif regs:
        # the parent (256 threads, 64 B of static shared memory): the
        # occupancy rule, registers allocated in units of 8 per thread
        out["ctas_per_sm"] = min(8, 65536 // (-(-regs // 8) * 8 * 256))
    zero = dataclasses.replace(op, code=torch.zeros_like(op.code))
    for label, o in (("team7", op), ("no conductor", zero)):
        for mode, fn in (("apply", lambda o=o: coded_matvec(o, x.A, x.U)),
                         ("apply_dots", lambda o=o: coded_matvec(o, x.A, x.U,
                                                                 w)),
                         ("apply_div", lambda o=o: coded_matvec(o, x.A))):
            k_us, all_us, n = _per_call(cs, fn, WHOLE_KERNELS)
            out[f"{label} {mode}"] = {"kernel_us": k_us, "all_us": all_us,
                                      "launches": n}
    whole = dataclasses.replace(op, cond_z=(0, nz), compact_u=False)
    yA = torch.empty_like(x.A)
    k_us, _, _ = _per_call(cs, lambda: coded_slab(whole, x.A, x.U, yA, w),
                           ("slab_march",))
    plan = plan_of(whole)
    info = coded_slab.info(1, False, dev)
    out["slab_march over the grid"] = {
        "kernel_us": k_us, "ctas": plan.slab_ctas,
        "waves": plan.slab_ctas / (info["ctas_per_sm"] * H100_SMS),
        "ctas_per_sm": info["ctas_per_sm"], "registers": info["registers"]}
    cs.say(f"[probe] coded_matvec team7 {nx}x{ny}x{nz}: " + json.dumps(out))
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
                # the hook reads each dot on the host: the eager
                # per-iteration loop, whose bits the graphed solve equals
                st, info = sim._step(sim.init_state(), sim.steps[0][0],
                                     eager=True)
            finally:
                coded._WHOLE_PLANE_BUDGET = prev
                op_cls.apply_dots = kernel
            A[run] = st.A.double().cpu()
            out["iterations"][run] = [info.iterations]
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


FIELD_STATES = {   # (coefficient dtype, state dtype) by name
    "f32": ("float32", "float32"), "bf16 coef": ("bfloat16", "float32"),
    "bf16": ("bfloat16", "bfloat16")}


def _field_op_state(cs, rec, state, dev, seed):
    """The field operator of ``rec`` and inputs from ``seed`` at ``state``
    (a key of FIELD_STATES)."""
    import torch

    from eddy_currents_3d_tpu_torch.assembly.stencil import State

    coef, sd = (getattr(torch, n) for n in FIELD_STATES[state])
    op = cs._field_op(rec["system"], coef)
    x, _ = cs._inputs(rec["model"], dev, seed)
    return op, State(x.A.to(sd), x.U.to(sd))


def _routes(field_a):
    """The bfloat16-state routes a build's field wrapper can be asked for
    by name: none in a build before the paired route."""
    return ("paired", "scalar") if hasattr(field_a, "paired") else ()


def _field_hashes(cs, recs, dev):
    """Hashes of field_a's output and field_u's yA and yU on team7,
    convection and scale256, at each state of FIELD_STATES, on inputs from
    a fixed seed; where the build has routes, whether the scalar route's
    outputs equal the chosen route's at bfloat16 state."""
    import torch

    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    def outputs(op, x, **kw):
        ya = field_a(op.ka, x.A, **kw)
        yA = ya.clone()
        return ya, yA, field_u(op, x.A, x.U, yA, **kw)

    out = {}
    for name, rec in recs.items():
        for state in FIELD_STATES:
            op, x = _field_op_state(cs, rec, state, dev, 11)
            ys = outputs(op, x)
            out[f"field {state} {name}"] = _digest(*ys)
            if state == "bf16" and _routes(field_a):
                other = outputs(op, x, route="scalar")
                torch.cuda.synchronize()
                out[f"field bf16 scalar == chosen {name}"] = all(
                    torch.equal(a, b) for a, b in zip(ys, other))
    return out


def _field_times(cs, recs, dev):
    """Device µs per call (cs.device_ms, 20 calls) of field_a and field_u
    at team7 and scale256 at each state of FIELD_STATES; at bfloat16
    state on each route the build has (else as it launches)."""
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    out = {}
    for name in ("team7", "scale256"):
        for state in FIELD_STATES:
            op, x = _field_op_state(cs, recs[name], state, dev, 0)
            yb = field_a(op.ka, x.A)
            routes = _routes(field_a) if state == "bf16" else ()
            for route in routes or (None,):
                kw = {} if route is None else {"route": route}
                tag = f"{state}{'' if route is None else ' ' + route} {name}"
                for kname, fn in (
                        ("field_a", lambda: field_a(op.ka, x.A, **kw)),
                        ("field_u", lambda: field_u(op, x.A, x.U, yb, **kw))):
                    ms = cs.device_ms(fn, kname)
                    out[f"{kname} {tag}"] = None if ms is None else ms * 1e3
    return out


def _field_kernel_names():
    """This tree's ``ops/field_cuda.py`` KERNEL_NAMES (the field kernels'
    names and a piece of each mangled name), read from the source, so
    that either build's log is searched for the same kernels."""
    path = os.path.join(HERE, "eddy_currents_3d_tpu_torch", "ops",
                        "field_cuda.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "KERNEL_NAMES":
            return ast.literal_eval(node.value)
    raise LookupError(f"no KERNEL_NAMES in {path}")


def _field_resources(cs, log, dev):
    """Each field kernel of the build: its ptxas line, registers and
    resident CTAs per SM (the runtime's where the build reports them, else
    the occupancy rule for 256 threads from the ptxas registers)."""
    from eddy_currents_3d_tpu_torch.ops import field_cuda

    out = {}
    for kernel, pattern in _field_kernel_names().items():
        ptx = cs._ptxas(log, pattern)
        if ptx == "not in the build log":
            continue
        rec = {"ptxas": ptx}
        if hasattr(field_cuda, "KERNEL_NAMES"):
            rec.update(field_cuda.field_a.info(kernel, dev))
        else:
            regs = _ptxas_regs(ptx)
            rec["ctas_per_sm"] = min(8, 65536 // (-(-regs // 8) * 8 * 256))
        out[kernel] = rec
    return out


def _bf16_team7(cs, dev):
    """team7 at bfloat16 state, dot_dtype float32: 20 steps without VTK
    after 2 of warm-up (iterations per step, which follow the field
    kernels' outputs to the last bit, and ms per iteration), and each
    field wrapper's µs per call between CUDA events (200 calls) on the
    system's operator and the run's last state."""
    import torch

    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u
    from eddy_currents_3d_tpu_torch.testing.cases import (case_static,
                                                          load_case)

    model = load_case(case_static(shape_xyz=(102, 102, 24), steps=20))
    sim = Simulation(model, torch.bfloat16, torch.float32, device=dev)
    sim.run(num_steps=2)
    x, diag = sim.run()
    op = sim.field_op
    ya = field_a(op.ka, x.A)
    return {"iterations": diag["iterations"],
            "ms_per_iteration": diag["wall_s"] / diag["total_iterations"]
            * 1e3,
            "field_a_event_us": cs.cuda_ms(lambda: field_a(op.ka, x.A), 200)
            * 1e3,
            "field_u_event_us": cs.cuda_ms(
                lambda: field_u(op, x.A, x.U, ya), 200) * 1e3}


def _bsr_hashes(B, dev):
    """Hashes of bsr_spmm's outputs on B at k = 1 and k = 128."""
    import numpy as np
    import torch

    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import bsr_spmm
    rng = np.random.default_rng(9)
    out = {}
    for k in (1, 128):
        x = torch.from_numpy(rng.standard_normal((B.shape[1], k))).to(
            dev, torch.float32)
        out[f"bsr k={k} team7"] = _digest(bsr_spmm(B, x))
    return out


def _team7_profile(cs, dev):
    """20 team7 main-path steps (no VTK) under the profiler."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.testing.cases import (case_static,
                                                          load_case)
    import torch

    model = load_case(case_static(shape_xyz=(102, 102, 24), steps=20))
    sim = Simulation(model, torch.float32, device=dev)
    sim.run(num_steps=2)                              # builds, warms up
    (_, diag), kernels, wall = cs.trace(lambda: sim.run())
    its = diag["total_iterations"]
    dev_s = sum(t for t, _ in kernels.values()) / 1e6
    return {"iterations": its,
            "ms_per_iteration": wall / its * 1e3,
            "device_us_per_iteration": dev_s / its * 1e6,
            "busy": dev_s / wall,
            "launches_per_iteration": sum(c for _, c in kernels.values())
            / its}


def _scale256_runs(cs, rec, dev, store, tag):
    """5 split steps at 256x256x64 profiled, and the step-1 witness."""
    import torch

    from eddy_currents_3d_tpu_torch import Simulation
    sim = Simulation(rec["model"], torch.float32, device=dev,
                     system=rec["system"])
    sim.run(num_steps=1)                              # builds, warms up
    (_, diag), kernels, wall = cs.trace(lambda: sim.run(num_steps=5))
    its = diag["total_iterations"]
    dev_us = sum(t for t, _ in kernels.values()) / its
    busy = sum(t for t, _ in kernels.values()) / 1e6 / wall
    print(f"[split_bench {tag}] 256x256x64 split x 5 steps profiled: "
          f"iterations {diag['iterations']}, {wall / its * 1e3:.3f} "
          f"ms/iteration under the profiler, device {dev_us:.1f} "
          f"us/iteration, busy {busy:.1%}", flush=True)
    gaps = _say_gaps(tag, _step1_gaps(rec, dev, store))
    return ({"iterations": diag["iterations"],
             "ms_per_iteration": wall / its * 1e3,
             "device_us_per_iteration": dev_us, "busy": busy}, gaps)


def _say_gaps(tag, gaps):
    """Print the step-1 witness of :func:`_step1_gaps`; returns it."""
    print(f"[split_bench {tag}] 256x256x64 step 1, max |dA| / (tol scale) "
          f"to float64: " + ", ".join(
              f"{run} {gaps[run]:.4f}" for run in gaps["iterations"]
              if run != "f64")
          + f"; split to whole {gaps['split-whole']:.4f}; iterations "
          f"{gaps['iterations']}; fused dots' largest relative error "
          f"{gaps['dot_err']}; the routes' fused dots part at call "
          f"{gaps['first_parting_call']} of {gaps['fused_calls']}",
          flush=True)
    return gaps


def child(root, tag, store, scale_runs=True):
    """One build's phases 3, 4, 7, 13, 14 and 16, the matvec probe, the
    profiles, the hashes and the float64 witness; without ``scale_runs``
    not phase 7, the split profile or the witness (the 256x256x64 runs)."""
    import torch

    cs = _load_smoke(root)
    if not torch.cuda.is_available():
        print("split_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = cs.phase_device()
    logs = cs.phase_build()
    grids = _grids()
    recs = cs.phase_kernel_vs_plain(grids, dev)
    cs.phase_split_vs_plain([grids[2], grids[1]], dev)
    if scale_runs:
        cs.phase_scale(recs["scale256"], dev)
    times = cs.phase_device_times(recs, dev)
    t7 = recs["team7"]
    B, csr, setup, bsr_recs = cs.phase_bsr_vs_plain(t7["model"],
                                                     t7["system"], dev)
    cs.phase_matrix_solve(t7["model"], dev, B, csr, setup)
    bsr = {k: {"device_us": (None if r["device_ms"] is None
                             else r["device_ms"] * 1e3),
               "events_us": r["times"][0] * 1e3}
           for k, r in bsr_recs.items() if k in (1, 128)}
    bsr_hashes = _bsr_hashes(B, dev)
    del B
    probe = _matvec_probe(cs, t7, dev, logs.get("coded_matvec", ""))
    field_us = _field_times(cs, recs, dev)
    field_res = _field_resources(cs, logs.get("field_stencil", ""), dev)
    bf16 = _bf16_team7(cs, dev)
    print(f"[split_bench {tag}] field device us/call: {json.dumps(field_us)}; "
          f"resources {json.dumps(field_res)}; team7 bf16 20 steps "
          f"{json.dumps(bf16)}", flush=True)
    team7 = _team7_profile(cs, dev)
    print(f"[split_bench {tag}] team7 x 20 steps profiled: {team7}",
          flush=True)

    profiled = gaps = None
    if scale_runs:
        profiled, gaps = _scale256_runs(cs, recs["scale256"], dev, store, tag)
    res = {"tag": tag, "root": root, "card": card,
           "device_us": {k: None if v is None else v * 1e3
                         for k, v in times.items()},
           "profiled": profiled,
           "step1_gaps": gaps, "bsr_spmm": bsr, "probe": probe,
           "team7": team7, "field_us": field_us,
           "field_resources": field_res, "bf16_team7": bf16,
           "hashes": dict(_hashes(cs, recs, dev), **bsr_hashes,
                          **_field_hashes(cs, recs, dev))}
    print(TAG + json.dumps(res), flush=True)
    return 0


def probe():
    """The whole-plane matvec probe of this tree alone."""
    import torch

    cs = _load_smoke(HERE)
    if not torch.cuda.is_available():
        print("split_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cs.phase_device()
    logs = cs.phase_build()
    model, sysm, op = cs._case_ops(_grids()[0][1], dev)
    _matvec_probe(cs, {"model": model, "op": op}, dev,
                  logs.get("coded_matvec", ""))
    return 0


def witness():
    """The step-1 witness (:func:`_step1_gaps`) of this tree alone."""
    import torch

    cs = _load_smoke(HERE)
    if not torch.cuda.is_available():
        print("split_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cs.phase_device()
    model, sysm, _ = cs._case_ops(_grids()[2][1], dev)
    store = tempfile.mkdtemp(prefix="split_bench_")
    try:
        _say_gaps("this tree", _step1_gaps({"model": model, "system": sysm},
                                           dev, store))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return 0


def steps_child(root, tag):
    """team7's main path in ``root``'s build, 20 steps after one of
    warm-up (which captures the graphs), three runs each: ms/step and
    ms/iteration of the eager per-iteration loop, and, where the build has
    the device loop (``Simulation._step(eager=...)``), of the graphed
    solve."""
    import inspect
    import time

    import torch

    cs = _load_smoke(root)
    dev = torch.device("cuda:0")
    cs.phase_build()
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.testing.cases import (case_static,
                                                          load_case)

    model = load_case(case_static(shape_xyz=(102, 102, 24), steps=20))
    sim = Simulation(model, torch.float32, device=dev)
    modes = {"eager": {}}
    if "eager" in inspect.signature(sim._step).parameters:
        modes = {"eager": {"eager": True}, "graphed": {}}
    out = {"tag": tag}
    for name, kw in modes.items():
        sim._step(sim.init_state(), sim.steps[0][0], **kw)
        walls = []
        for _ in range(3):
            st, its = sim.init_state(), []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t, _ in sim.steps:
                st, info = sim._step(st, t, **kw)
                its.append(int(info.iterations))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"iterations": its,
                     "ms_per_step": [w / len(its) * 1e3 for w in walls],
                     "ms_per_iteration": [w / sum(its) * 1e3 for w in walls]}
        print(f"[split_bench {tag}] team7 20 steps {name}: ms/step "
              + " ".join(f"{v:.3f}" for v in out[name]["ms_per_step"])
              + ", ms/iteration "
              + " ".join(f"{v:.4f}" for v in out[name]["ms_per_iteration"]),
              flush=True)
    print(TAG + json.dumps(out), flush=True)
    return 0


def steps(parent, out_dir):
    """:func:`steps_child` of ``parent`` and of this tree in turns
    (parent, change, change, parent)."""
    os.makedirs(out_dir, exist_ok=True)
    runs = [_run(["--steps-child", root, tag],
                 os.path.join(out_dir, f"steps_{j}_{tag}.log"))
            for j, (root, tag) in enumerate(
                ((parent, "parent"), (HERE, "change"), (HERE, "change"),
                 (parent, "parent")))]
    its = {json.dumps(r[m]["iterations"]) for r in runs for m in r
           if m != "tag"}
    print(f"[summary] team7 iterations per step equal in every run and "
          f"mode: {len(its) == 1}", flush=True)
    print(TAG + json.dumps({"runs": runs}), flush=True)
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
        if line.startswith(("[3]", "[4]", "[7]", "[13]", "[14]", "[16]",
                            "[probe]", "[split_bench")):
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
    ap.add_argument("--kernels-only", action="store_true",
                    help="with --parent: skip the 256x256x64 runs (phase 7, "
                    "the split profile, the step-1 witness)")
    ap.add_argument("--probe", action="store_true",
                    help="only the whole-plane matvec probe of this tree")
    ap.add_argument("--witness", action="store_true",
                    help="only the step-1 witness of this tree")
    ap.add_argument("--steps", action="store_true",
                    help="with --parent: only team7's 20 main-path steps, "
                    "eager (and graphed where the build has it)")
    ap.add_argument("--child", nargs=3, metavar=("ROOT", "TAG", "STORE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--steps-child", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child(*a.child, scale_runs=not a.kernels_only)
    if a.steps_child:
        return steps_child(*a.steps_child)
    if a.probe:
        return probe()
    if a.witness:
        return witness()
    if not a.parent:
        ap.error("--parent DIR is required")
    import torch
    if not torch.cuda.is_available():
        print("split_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    os.makedirs(a.out, exist_ok=True)
    parent = os.path.abspath(a.parent)
    if a.steps:
        return steps(parent, a.out)
    store = tempfile.mkdtemp(prefix="split_bench_")
    runs = []
    try:
        for j, (root, tag) in enumerate(((parent, "parent"), (HERE, "change"),
                                         (HERE, "change"), (parent, "parent"))):
            runs.append(_run(["--child", root, tag, store]
                             + (["--kernels-only"] if a.kernels_only else []),
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
                  + f"; bsr_spmm team7 {r['bsr_spmm']}; matvec probe "
                  f"{json.dumps(r['probe'])}; team7 20 steps {r['team7']}; "
                  f"split 5 steps {r['profiled']}; step 1 gaps "
                  f"{r['step1_gaps']}; field device us/call "
                  f"{json.dumps(r['field_us'])}; field resources "
                  f"{json.dumps(r['field_resources'])}; team7 bf16 20 steps "
                  f"{json.dumps(r['bf16_team7'])}", flush=True)
    hp, hc = by["parent"][0]["hashes"], by["change"][0]["hashes"]
    for key in sorted(set(hp) | set(hc)):
        p_, c_ = hp.get(key), hc.get(key)
        if key.startswith(("matvec", "split ", "bsr", "field")) and \
                "dots" not in key and "==" not in key:
            print(f"[summary] {key}: parent {p_} change {c_} equal "
                  f"{p_ == c_}", flush=True)
        else:
            print(f"[summary] {key}: parent {p_} change {c_}", flush=True)
    its = [r["bf16_team7"]["iterations"] for r in runs]
    print(f"[summary] team7 bf16 iterations per step equal in every run: "
          f"{all(i == its[0] for i in its)} ({its[0]})", flush=True)
    for key in ("ms_per_iteration", "field_a_event_us", "field_u_event_us"):
        print(f"[summary] team7 bf16 {key} in run order (parent, change, "
              f"change, parent): " + ", ".join(
                  f"{r['bf16_team7'][key]:.4f}" for r in runs), flush=True)
    repeat = all(r["hashes"] == by[r["tag"]][0]["hashes"] for r in runs)
    print(f"[summary] each build's hashes repeat across its two runs: "
          f"{repeat}", flush=True)
    print(TAG + json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
