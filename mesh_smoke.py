#!/usr/bin/env python3
"""The port's multi-device tier across cards: one process a card, NCCL between
them.

    torchrun --nproc-per-node 4 mesh_smoke.py
    torchrun --nproc-per-node 4 mesh_smoke.py --cpu --shape 16,16,14 --steps 3
    python3 mesh_smoke.py --cli 4 [--cpu]

(``python -m torch.distributed.run`` where ``torchrun`` is not on the path.)
Each rank takes the card of its local rank, joins the NCCL group that
torchrun's environment describes (gloo on the CPU with ``--cpu``) and runs
``case_static`` (102x102x24 by default) on ``make_mesh(N)``, its z slab of
the grid, at float32 on the coded tier (the default there) and on the field
tier (``use_coded=False``), and at float64 with float64 dots; with
``precond="mg"`` (the V-cycle on the rank's block, ``parallel/shard_mg.py``)
at float64 and float32, and ``use_shard_map=False`` (the JAX package's
GSPMD tier: the field tier) at float64; then, where N is even, on
``make_mesh(N / 2, 2)``, its (z, y) block, at float32 (the field tier) and
float64, and with ``precond="mg"`` at both.  Each Simulation is graphed:
a first step captures the solve, then ``--steps`` steps are timed.  Every rank then runs the same
model on its own card alone (the same tier at float32: the unsharded coded
operator or field tier; the flat-roll operator at float64), solves step 1
at float64 to 1e-8 (right-Jacobi: the converged solution) and checks:

* float64: A within 1e-9 of scale (the largest |A| of the unsharded run
  after the timed steps) of the unsharded run after step 1 and after the
  timed steps, with the same iterations (tests/test_shard_op.py's bound);
* step 1's solutions, the mesh's and the card's alone, at both dtypes:
  the true residual ||b - A x|| / ||b||, recomputed at float64 on the host
  with the float64 operator, under the tolerance;
* float32, the mesh's and the card's alone: A after step 1 no farther from
  the converged solution than the float64 run's, plus the one-device
  float32 bound: max |A - A_conv| <= max |A_f64 - A_conv| + 4 tol scale
  (scale: max |A_f64|), what the one-device bound max |A - A_f64| <= 4 tol
  scale says of accuracy.  Each float32 run's distance to the float64 run
  is printed: float32 solves of team7's step 1 stop at either of two
  answers ~6.7 tol scale apart, both under the stopping rule, and which
  one a run reaches turns on the order its dots are summed in (with
  ``--cpu`` the card-alone runs sum on one thread and reach the far one);
* step 1 graphed equals step 1 on the per-iteration host loop bit for
  bit;
* one capture per Simulation, and the dots' all-reduce called while the
  solve is captured and never after (it runs inside the graph).

For the float32 ``mg`` runs on several ranks rank 0 also prints where an
iteration's time goes (``_breakdown``): the V-cycle, the same V-cycle
without its communication, its replicated levels and the operator's apply,
each graphed alone and timed, and the V-cycle's device time by kernel
class (NCCL's, ``field_a``, the rest) from torch.profiler.

Rank 0 prints the device, each run's iterations and ms/iteration at this
world size, and, last, one JSON line with ``"ok"``.  A failed check raises,
and torchrun stops the other ranks.

``--cli N`` (not under torchrun) runs the CLI as users start it on a mesh:
``python -m torch.distributed.run --standalone --nproc-per-node N -m
eddy_currents_3d_tpu_torch in.vxc --mesh N`` and ``--mesh N/2,2``, on the
static case (``--shape``, 3 steps, an output every step) at float64, and
``--mesh N --precond mg`` at float64, against the CLI on one card (with
the same ``--precond``) (every printed line the same but the backend line and
the wall times; the field files, which hold float32, within 1e-9 of each
field's scale beyond one float32 rounding of the one card's value: two
float64 answers 1e-10 apart can round to neighbouring float32 values; the
source files byte for byte), and at float32 (converged, timed); torchrun
must exit 0, every rank having left.
"""

import argparse
import dataclasses
import datetime
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist


def _run(sim, steps, note):
    """(state, diagnostics, wall seconds, all-reduce calls during the
    first graphed step, after it) of ``steps`` steps, after step 1 on the
    per-iteration host loop and graphed (which captures), the two equal
    bit for bit."""
    calls = []
    real = sim.mesh.all_reduce
    object.__setattr__(sim.mesh, "all_reduce",
                       lambda t: calls.append(1) or real(t))
    try:
        s0 = sim.shard_state(sim.init_state())
        t1 = sim.steps[0][0]
        note("step 1 on the host loop")
        se, ie = sim._step(s0, t1, eager=True)
        note("step 1 graphed")
        n0 = len(calls)
        sg, ig = sim._step(s0, t1)
        n_cap = len(calls) - n0
        if not (int(ig.iterations) == ie.iterations
                and torch.equal(sg.A, se.A) and torch.equal(sg.U, se.U)):
            raise AssertionError("the graphed step differs from the host "
                                 "loop's")
        note("timed run")
        n0 = len(calls)
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, diag = sim.run(num_steps=steps)
        wall = time.perf_counter() - t0
    finally:
        object.__setattr__(sim.mesh, "all_reduce", real)
    return st, diag, wall, n_cap, len(calls) - n0


def _trace(fn):
    """{kernel: device µs} of torch.profiler over one call of ``fn`` ended
    by a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out[e.key] = t if t is not None else e.self_cuda_time_total
    return out


class _NoLinks:
    """A V-cycle's links with the communication taken out, for timing the
    rest: no ghosts, and the gather this rank's block in every place."""

    def __init__(self, size):
        self.size = size

    def ghosts(self, x):
        return lambda: [{}]

    def gather(self, r):
        return r.expand((self.size,) + tuple(r.shape[1:]))


def _breakdown(sim, dev, rank):
    """Where a float32 mg iteration's time goes on the mesh: the V-cycle
    (``sim._mg.apply``; two an iteration), the same V-cycle with its
    communication taken out (:class:`_NoLinks`: no ghost exchange, no
    gather), its replicated levels alone (the correction from the gather
    level on, which every rank computes whole) and the operator's apply
    (two an iteration), each on the rank's block of step 1's right-hand
    side, captured alone as a CUDA graph (``utils/graph.py``) and timed
    between events over 20 replays (every rank replays, so the exchanges
    meet; on the CPU called and timed on the host clock); and, on the
    card, torch.profiler's device time over 10 replays of the V-cycle's
    graph on rank 0 by kernel: NCCL's, field_a, the rest.  Returns
    {part: ms} and {kernel class: µs a V-cycle} (empty where the trace
    holds no device event)."""
    from eddy_currents_3d_tpu_torch.utils.graph import Graph

    mg, sop = sim._mg, sim.shard_op
    b, _ = sim.step_system(sim.shard_state(sim.init_state()),
                           sim.steps[0][0])
    quiet = dataclasses.replace(mg, links=_NoLinks(mg.meshes[0].size))
    parts = {"vcycle": lambda: mg.apply(b),
             "vcycle_no_comm": lambda: quiet.apply(b),
             "operator_apply": lambda: sop.apply(b)}
    if mg.rep is not None:
        gen = torch.Generator().manual_seed(rank)
        rg = torch.randn((3,) + mg.rep.levels[0].shape, generator=gen).to(
            dev, b.A.dtype)
        parts["replicated_levels"] = lambda: mg.rep.correction(0, rg)
    cuda = dev.type == "cuda"
    ms, runs = {}, {}
    for name, fn in parts.items():
        run = runs[name] = Graph(fn, dev).replay if cuda else fn
        for _ in range(3):
            run()
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            ms[name] = e0.elapsed_time(e1) / 20
        else:
            ms[name] = (time.perf_counter() - t0) * 1e3 / 20
    kinds = {}
    if cuda:
        dist.barrier()
        replay10 = lambda: [runs["vcycle"]() for _ in range(10)]
        if rank == 0:
            for k, us in _trace(replay10).items():
                kind = ("nccl" if "nccl" in k.lower() else
                        "field_a" if "field_a" in k else "other")
                kinds[kind] = kinds.get(kind, 0.0) + us / 10
        else:
            replay10()
        torch.cuda.synchronize()
    dist.barrier()
    return ms, kinds


def _cli_runs(n, cpu, shape):
    """``--cli``: the CLI on one card and under torchrun on ``n`` ranks as
    ``--mesh n`` and ``--mesh n/2,2``; raises on a failed check."""
    import tempfile

    import numpy as np

    from eddy_currents_3d_tpu_torch.io.vtk import read_vtk_vectors
    from eddy_currents_3d_tpu_torch.testing.cases import case_static

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    dev = ["--device", "cpu"] if cpu else []
    meshes = [str(n)] + ([f"{n // 2},2"] if n % 2 == 0 else [])
    # (dtype, arguments, meshes): the default tiers, then mg on z slabs
    cases = [("f64", [], meshes), ("f32", [], meshes),
             ("f64", ["--precond", "mg"], [str(n)])]

    def run(cwd, ranks, args):
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks)] if ranks else [sys.executable])
        t0 = time.perf_counter()
        p = subprocess.run(cmd + ["-m", "eddy_currents_3d_tpu_torch",
                                  "../in.vxc", "-o", "out"] + dev + args,
                           cwd=cwd, env=env, capture_output=True, text=True,
                           timeout=240)
        wall = time.perf_counter() - t0
        if p.returncode != 0 or "unconverged step(s)" not in p.stdout:
            raise AssertionError(f"CLI {ranks} ranks {args}: exit "
                                 f"{p.returncode}\n{p.stdout[-2000:]}\n"
                                 f"{p.stderr[-4000:]}")
        return p.stdout, wall

    lines = lambda text: [ln for ln in text.splitlines()
                          if not ln.startswith(("backend", "Tcalc"))]
    pick = lambda text, key: next(ln for ln in text.splitlines()
                                  if ln.startswith(key))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.vxc"), "w") as f:
            f.write(case_static(shape_xyz=shape, steps=3, jump=0.001))
        for dtype, extra, on in cases:
            tag = "_".join([dtype] + extra[1:])
            ref = os.path.join(tmp, f"one_{tag}")
            os.makedirs(ref)
            text1, w1 = run(ref, 0, ["--dtype", dtype] + extra)
            print(f"[cli] one card {dtype} {extra}: {pick(text1, 'Tcalc')}, "
                  f"command {w1:.1f} s", flush=True)
            for mesh in on:
                cwd = os.path.join(tmp, f"m{mesh}_{tag}")
                os.makedirs(cwd)
                text, wall = run(cwd, n, ["--mesh", mesh, "--dtype", dtype]
                                 + extra)
                gap = raw = 0.0
                names = sorted(os.listdir(os.path.join(ref, "out")))
                same = sorted(os.listdir(os.path.join(cwd, "out"))) == names
                for name in names if dtype == "f64" else ():
                    a = os.path.join(ref, "out", name)
                    b = os.path.join(cwd, "out", name)
                    if name.startswith("src_"):
                        with open(a, "rb") as fa, open(b, "rb") as fb:
                            same = same and fa.read() == fb.read()
                        continue
                    fa, fb = read_vtk_vectors(a), read_vtk_vectors(b)
                    for key in fa:
                        if key != "dims":
                            scale = max(np.abs(fa[key]).max(), 1e-30)
                            d = np.abs(fb[key].astype(np.float64)
                                       - fa[key].astype(np.float64))
                            big = np.maximum(np.abs(fa[key]),
                                             np.abs(fb[key]))
                            ulp = np.spacing(big.astype(np.float32)).astype(
                                np.float64)
                            raw = max(raw, d.max() / scale)
                            gap = max(gap, (d - ulp).max() / scale)
                print(f"[cli] --mesh {mesh} {dtype} {extra} under torchrun: "
                      f"{pick(text, 'backend')}; {pick(text, 'Tcalc')}; "
                      f"{[ln for ln in text.splitlines() if 'iterations total' in ln]}"
                      f"; torchrun exited 0 after {wall:.1f} s; files as "
                      f"one card's: {same}"
                      + (f", fields within {raw:.2e} of scale, {gap:.2e} "
                         f"beyond one float32 rounding (limit 1e-9), lines "
                         f"equal: {lines(text) == lines(text1)}"
                         if dtype == "f64" else ""), flush=True)
                if not same or (dtype == "f64" and (
                        gap > 1e-9 or lines(text) != lines(text1))):
                    raise AssertionError(f"--mesh {mesh} {dtype} differs "
                                         "from one card")
                out[" ".join([mesh, tag])] = {"command_s": wall,
                                              "gap": raw,
                                              "beyond_rounding": gap}
    print(json.dumps({"ok": True, "cli": out}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU (a rehearsal)")
    p.add_argument("--shape", default="102,102,24", help="nx,ny,nz")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--cli", type=int, default=0, metavar="N",
                   help="run the CLI under torchrun on N ranks against one "
                   "card (not under torchrun itself)")
    p.add_argument("--deadline", type=float, default=600.0,
                   help="seconds after which every rank prints its Python "
                   "stacks and exits (a collective waits at most this long)")
    args = p.parse_args(argv)
    if args.cli:
        if not args.cpu and not torch.cuda.is_available():
            print("mesh_smoke: no CUDA device (--cpu rehearses on the CPU)",
                  file=sys.stderr)
            return 1
        shape = tuple(int(n) for n in args.shape.split(","))
        return _cli_runs(args.cli, args.cpu, shape)
    if "RANK" not in os.environ:
        print("mesh_smoke: start it with torchrun --nproc-per-node N",
              file=sys.stderr)
        return 2
    if not args.cpu and not torch.cuda.is_available():
        print("mesh_smoke: no CUDA device (--cpu rehearses on the CPU)",
              file=sys.stderr)
        return 1

    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import tree_norm
    from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

    faulthandler.dump_traceback_later(args.deadline, exit=True)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    # a collective that waits longer than this raises instead of hanging
    limit = datetime.timedelta(seconds=args.deadline)
    if args.cpu:
        dist.init_process_group("gloo", timeout=limit)
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", timeout=limit,
                                device_id=torch.device("cuda", local))

    def say(*parts):
        if rank == 0:
            print(*parts, flush=True)

    def note(stage):
        print(f"[rank {rank}] {stage} at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    try:
        if not args.cpu:
            # a profiler session before the first capture: graphs captured
            # before a process's first session never show in a trace
            x = torch.ones(1 << 16, device="cuda")
            for _ in range(5):
                if _trace(lambda: x.mul(2.0)):
                    break
        mesh = make_mesh(world)
        dev = mesh.device
        if rank == 0 and not args.cpu:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60)
            say(smi.stdout.strip())
        shape = tuple(int(n) for n in args.shape.split(","))
        model = load_case(case_static(shape_xyz=shape, steps=args.steps + 1))
        tol = model.solver.tolerance
        f32, f64 = torch.float32, torch.float64
        cpu = torch.device("cpu")

        def step1(sim):
            """Step 1's solution from rest, global, on the host."""
            st = sim.shard_state(sim.init_state()) if sim.mesh else \
                sim.init_state()
            x = sim.solve(*sim.step_system(st, sim.steps[0][0])).x
            if sim.mesh is not None:
                x = sim.shard_op.unpad_state(x)
            return State(x.A.to(cpu, f64), x.U.to(cpu, f64))

        note("step 1 at float64 and converged, on the card alone")
        one64 = Simulation(model, f64, f64, device=dev)
        b, x0 = one64.step_system(one64.init_state(), one64.steps[0][0])
        x64 = one64.solve(b, x0).x
        tight = dataclasses.replace(model, solver=dataclasses.replace(
            model.solver, tolerance=1e-8))
        conv = Simulation(tight, f64, device=dev, precond="jacobi").solve(
            b, x0)
        host = assemble_operator(model, f64, "cpu")
        b = State(b.A.to(cpu), b.U.to(cpu))
        surface = lambda A: torch.where(host.bnd_a, 0.0, A)
        A64 = surface(x64.A.to(cpu))
        Ac = surface(conv.x.A.to(cpu))
        scale1 = A64.abs().max().item()
        dist1 = lambda A, ref: ((surface(A) - ref).abs().max().item()
                                / (tol * scale1))
        f64_to_conv = dist1(A64, Ac)
        bound = f64_to_conv + 4.0

        def held(x):
            """(true residual, tol scale to the float64 run, to the
            converged solution) of a step-1 solution."""
            y = host.op.apply(x)
            rel = (tree_norm(State(b.A - y.A, b.U - y.U))
                   / tree_norm(b)).item()
            return rel, dist1(x.A, A64), dist1(x.A, Ac)

        say(f"[mesh] step 1 at float64 on one card: {int(conv.iterations)} "
            f"iterations to 1e-8 (jacobi); the tol-{tol} answer lies "
            f"{f64_to_conv:.3f} tol scale from it; float32 bound "
            f"{bound:.3f}")
        out = {"f64_to_conv": f64_to_conv}
        mg = {"precond": "mg"}
        configs = [("f32 coded z", f32, None, mesh, {}),
                   ("f32 field z", f32, None, mesh, {"use_coded": False}),
                   ("f64 z", f64, f64, mesh, {}),
                   ("f64 mg z", f64, f64, mesh, mg),
                   ("f32 mg z", f32, None, mesh, mg),
                   ("f64 gspmd z", f64, f64, mesh, {"use_shard_map": False})]
        if world % 2 == 0:
            yz = make_mesh(world // 2, 2)
            configs += [("f32 field zy", f32, None, yz, {"use_coded": False}),
                        ("f64 zy", f64, f64, yz, {}),
                        ("f64 mg zy", f64, f64, yz, mg),
                        ("f32 mg zy", f32, None, yz, mg)]
        for label, dtype, dot, on, kw in configs:
            note(f"{label}: mesh run")
            sim = Simulation(model, dtype, dot, mesh=on, **kw)
            coded = sim.shard_op.use_coded
            if coded != (label == "f32 coded z"):
                raise AssertionError(f"{label}: the mesh took another tier")
            st, diag, wall, n_cap, n_after = _run(sim, args.steps, note)
            note(f"{label}: one-device run")
            ref = Simulation(model, dtype, dot, device=dev, **kw)
            s1, d1 = sim.run(num_steps=1)
            r1, _ = ref.run(num_steps=1)
            step = {"mesh": held(step1(sim)), "one card": held(step1(ref))}
            for who, (rel, to64, toc) in step.items():
                say(f"[mesh] {label} step 1, {who}: true residual {rel:.6f}"
                    f" (tol {tol}); {to64:.3f} tol scale from the float64 "
                    f"run, {toc:.3f} from the converged solution")
                if rel >= tol or (dtype == f32 and toc > bound):
                    raise AssertionError(
                        f"{label} step 1, {who}: true residual {rel}, "
                        f"{toc} tol scale from the converged solution "
                        f"(bound {bound})")
            sr, dr = ref.run(num_steps=args.steps)
            scale = sr.A.abs().max().item()
            gap1 = (s1.A - r1.A).abs().max().item() / scale
            gap = (st.A - sr.A).abs().max().item() / scale
            its = diag["iterations"]
            ms = wall / diag["total_iterations"] * 1e3
            sop = sim.shard_op
            plan = ""
            if kw.get("precond") == "mg":
                plan = (f"; V-cycle levels on the blocks "
                        f"{[lvl.shape for lvl in sim._mg.levels]}"
                        + (f", gathered at level {len(sim._mg.levels) - 1}"
                           if sim._mg.rep is not None else ""))
            say(f"[mesh] {label} {shape} on {sop.n_z}x{sop.n_y} (z, y) "
                f"blocks of {sop.block_zyx} ({'coded' if coded else 'field'}"
                f" tier{plan}): iterations {its} (one device "
                f"{dr['iterations']}); max |dA| / scale after step 1 "
                f"{gap1:.2e} ({gap1 / tol:.3f} tol scale), after "
                f"{args.steps} steps {gap:.2e} ({gap / tol:.3f})"
                f"{', limit 1e-9' if dtype == f64 else ''}; "
                f"{ms:.3f} ms/iteration at world size {world}, "
                f"{wall / args.steps * 1e3:.2f} ms/step; captures "
                f"{sim.captures}; all-reduce calls {n_cap} in the capturing "
                f"step, {n_after} in the timed run")
            graphed = (sim.captures == 1 and n_cap > 0 and n_after == 0
                       if dev.type == "cuda" else True)   # no graph on CPU
            if not (graphed and not diag["unconverged_steps"]):
                raise AssertionError(f"{label}: step-1 gap {gap1}, captures "
                                     f"{sim.captures}, all-reduce calls "
                                     f"{n_cap}, {n_after}, iterations {its}")
            if dtype == f64 and (its != dr["iterations"]
                                 or max(gap1, gap) > 1e-9):
                raise AssertionError(f"f64: iterations {its} against "
                                     f"{dr['iterations']}, gaps {gap1}, "
                                     f"{gap}")
            if kw.get("precond") == "mg" and dtype == f32 and world > 1:
                note(f"{label}: breakdown")
                parts, kinds = _breakdown(sim, dev, rank)
                dev_us = sum(kinds.values())
                say(f"[mesh] {label} where an iteration goes, each part "
                    f"graphed alone (ms): {json.dumps(parts)}; an iteration "
                    f"holds two V-cycles and two operator applies "
                    f"({2 * (parts['vcycle'] + parts['operator_apply']):.3f} "
                    f"ms of its {ms:.3f}); the V-cycle's device time by "
                    f"kernel on rank 0 (us): "
                    + (json.dumps(kinds) + f", {dev_us / 1e3:.3f} ms of its "
                       f"{parts['vcycle']:.3f}" if kinds else
                       "not traced"))
                out.setdefault("breakdown", {})[label] = {
                    "ms": parts, "device_us_per_vcycle": kinds}
            out[label] = {"iterations": its, "ms_per_iteration": ms,
                          "one_device_iterations": dr["iterations"],
                          "gap_step1": gap1, "gap": gap,
                          "step1": {k: dict(zip(("true_relres", "to_f64",
                                                  "to_conv"), v))
                                    for k, v in step.items()}}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        say(json.dumps({"ok": True, "world": world, "device": str(
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            "runs": out}))
    except Exception:
        # the other ranks may wait in a collective this rank never joins:
        # report and leave without destroy_process_group, which would wait
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    # every rank has passed the barrier after its last collective; leave
    # without destroy_process_group, which on 4 H100s has waited past the
    # deadline on some ranks with the graphs that hold NCCL's collectives
    # still alive
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
