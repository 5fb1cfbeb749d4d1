"""Command-line entry point:
``python -m eddy_currents_3d_tpu_torch [in.vxc]``.

The counterpart of ``python -m eddy_currents_3d_tpu`` (its ``__main__.py``),
with the same flags, prints and exit codes.  The reference is a single
executable run with ``in.vxc`` in the working directory (EC3D.f90:5,
86-89); this CLI reproduces that workflow — default input ``in.vxc``,
output directory from the case's ``SOLVER DIR`` line (``vxc2data.f90:74``
default ``out``), parsed-parameter and matrix-stats prints, the 1% ``>``
progress ticker, and the final ``Tcalc`` wall-time print — plus dtype,
preconditioning and checkpoint/resume behind flags.  It runs on the CUDA
card unless ``--device`` names another device (``--device cpu``), at
every ``--dtype`` (float64 on the flat-roll operator) and
``--coeff-dtype``.

``--trace PATH`` keeps the run's spans (``utils/trace.py``) and writes
them to PATH as Chrome trace-event JSON, which Perfetto opens
(ui.perfetto.dev, "Open trace file"): the host's spans on one track, the
card's step and solve intervals and its waits on a second, on the one host
clock; on a mesh each rank writes its own, ``PATH.rank<r>``.

``--mesh Z[,Y]`` runs the multi-device tier (``parallel/shard_op.py``) on
``Z x Y`` (z, y) blocks, one process a block, under torchrun::

    torchrun --nproc-per-node 4 -m eddy_currents_3d_tpu_torch in.vxc --mesh 2,2

Each rank joins the process group that torchrun's environment describes:
NCCL on the card of its local rank, gloo with ``--device cpu``.  A run of
``--mesh 1`` outside torchrun starts a group of one rank itself.  The first
rank prints the lines and writes the VTK files and checkpoints (the global
fields, gathered to it); the backend line names the world size.  A world
size other than ``Z * Y`` exits with code 2 on every rank before any rank
joins a group.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

def _dtype(name: str):
    import torch

    return {
        "f32": torch.float32, "float32": torch.float32,
        "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
        "f64": torch.float64, "float64": torch.float64,
    }[name]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m eddy_currents_3d_tpu_torch",
        description="3D time-domain eddy-current simulation in PyTorch on a "
        "CUDA card (VoxCad .vxc input, legacy-VTK output).",
    )
    p.add_argument("vxc", nargs="?", default="in.vxc",
                   help="input .vxc case (default: in.vxc in the cwd, like "
                   "the reference executable)")
    p.add_argument("-o", "--out", default=None,
                   help="output directory (default: the case's SOLVER DIR, "
                   "usually 'out'); pass '-' to skip VTK output")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the current CUDA "
                   "card; 'cpu' runs the kernels' plain versions)")
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "float32", "bf16", "bfloat16", "f64",
                            "float64"],
                   help="field dtype (default f32; f64 runs the flat-roll operator)")
    p.add_argument("--dot-dtype", default=None,
                   choices=[None, "f32", "f64"],
                   help="accumulate solver dot products in this dtype")
    p.add_argument("--coeff-dtype", default=None,
                   choices=[None, "bf16", "f32"],
                   help="store the operator coefficient streams in this "
                   "dtype (runs the field tier; bf16 halves its coefficient "
                   "traffic; state and accumulation stay in --dtype)")
    p.add_argument("--steps", type=int, default=None,
                   help="run only the first N timesteps")
    p.add_argument("--precond", default=None,
                   choices=["cheb", "jacobi", "cheb_jacobi", "mg", "ilu0"],
                   help="right preconditioning: Chebyshev polynomial, "
                   "Jacobi, Chebyshev-on-Jacobi-scaled, geometric "
                   "multigrid V-cycle, or ILU(0)")
    p.add_argument("--mesh", default=None, metavar="Z[,Y]",
                   help="shard over Z x Y (z, y) blocks, one process a "
                   "block: run under torchrun --nproc-per-node Z*Y (a mesh "
                   "of 1 runs without it)")
    p.add_argument("--warm-start", default="extrapolate",
                   choices=["extrapolate", "previous"],
                   help="per-step solver warm start: linear extrapolation "
                   "of the last two solutions (default) or the "
                   "reference's previous-solution start (EC3D.f90:408)")
    p.add_argument("--scan", action="store_true",
                   help="run the transient through run_scan: segments "
                   "between outputs with no host read inside them (with "
                   "--checkpoint-dir the run also segments at checkpoints)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write ckpt_<step>.npz files here")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="checkpoint every N steps (requires --checkpoint-dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in --checkpoint-dir")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="keep the run's spans and write them to PATH as "
                   "Chrome trace-event JSON (open it in Perfetto, "
                   "ui.perfetto.dev): host spans on one track, the card's "
                   "step and solve intervals and waits on a second, on one "
                   "clock; on a mesh rank r writes PATH.rank<r>")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the parameter/progress prints")
    return p


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _route(sim) -> str:
    """The operator route the solve runs on."""
    sop = sim.shard_op
    if sop is not None:
        tier = ("coded" if sop.use_coded
                else "field tier" if sop.use_pallas else "field plain")
        return f"{tier} per block of {sop.n_z}x{sop.n_y}"
    if sim.coded_op is not None:
        return "coded split" if sim.coded_op.split else "coded whole-plane"
    if sim.field_op is not None:
        return "field tier"
    return "flat-roll"


def _traced(s: dict) -> str:
    """A trace summary (``utils/trace.py`` ``summary``) in one line; the
    card waited at least the share given, and at most that plus what a step
    spends outside its solve."""
    if not s["steps"]:
        return "no step"
    line = f"host {s['step_host_ms_per_step']:.3f} ms a step"
    if s["step_device_ms_per_step"] is not None:
        line += (f"; card {s['step_device_ms_per_step']:.3f} ms a step, "
                 f"{s['step_outside_solve_ms_per_step']:.3f} of it outside "
                 f"the solve, solve {s['solve_device_us_per_iteration']:.1f} "
                 f"us an iteration, waited at least "
                 f"{s['device_wait_pct']:.2f}% of the run")
    return line


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not os.path.exists(args.vxc):
        return _error(f"input file {args.vxc!r} not found "
                      "(the reference reads in.vxc from the working "
                      "directory)")
    if args.resume and not args.checkpoint_dir:
        return _error("--resume requires --checkpoint-dir")
    if args.checkpoint_dir and not args.checkpoint_every and not args.resume:
        return _error("--checkpoint-dir without --checkpoint-every writes no "
                      "checkpoints; pass --checkpoint-every N (or --resume "
                      "to continue from an existing run)")
    dims = None
    if args.mesh:
        try:
            dims = [int(v) for v in args.mesh.split(",")]
        except ValueError:
            dims = []
        if not 1 <= len(dims) <= 2 or min(dims) < 1:
            return _error(f"--mesh {args.mesh!r}: give Z or Z,Y, positive "
                          "integers")
        if len(dims) == 1:
            dims.append(1)
        # checked on every rank before any joins a group, so that no rank
        # waits for one that has left
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != dims[0] * dims[1]:
            return _error(f"--mesh {args.mesh} takes {dims[0] * dims[1]} "
                          f"ranks, one a block, but the world size is "
                          f"{world}: run it under torchrun --nproc-per-node "
                          f"{dims[0] * dims[1]}")

    from .utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        return _error(f"{e} (--device cpu)")
    if dims is None:
        return _run(args, device, None)
    from .parallel.mesh import make_mesh

    with _group(device) as device:
        return _run(args, device, make_mesh(*dims, device=device))


@contextlib.contextmanager
def _group(device):
    """This rank's device in the process group torchrun's environment
    describes, or, outside torchrun, in a group of one rank on a file store
    in a temporary directory; the group is destroyed on leaving.  NCCL on
    the card of the local rank, gloo on the CPU."""
    import tempfile

    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        kw = {"backend": "nccl", "device_id": device}
    else:
        kw = {"backend": "gloo"}
    with tempfile.TemporaryDirectory(prefix="ec3d_mesh_") as tmp:
        if "RANK" in os.environ:
            dist.init_process_group(**kw)
        else:
            dist.init_process_group(init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1, **kw)
        try:
            yield device
        finally:
            dist.destroy_process_group()


def _run(args, device, mesh) -> int:
    """The run of ``main`` on ``device``, on this rank's block of
    ``mesh`` if one is given."""
    import gc
    import json
    import time

    import torch

    from .models.vxc import read_vxc
    from .sim.simulate import Simulation
    from .utils import trace

    model = read_vxc(args.vxc)
    outdir = args.out if args.out is not None else model.solver.files
    output_dir = None if outdir == "-" else outdir

    sim = Simulation(
        model,
        dtype=_dtype(args.dtype),
        dot_dtype=_dtype(args.dot_dtype) if args.dot_dtype else None,
        device=device if mesh is None else None,
        mesh=mesh,
        coeff_dtype=_dtype(args.coeff_dtype) if args.coeff_dtype else None,
        precond=args.precond,
        warm_start=args.warm_start,
    )

    # on a mesh the first rank prints
    info = not args.quiet and (mesh is None or mesh.rank == 0)
    if info:
        sdx, sdy, sdz = model.shape_xyz
        # the reference prints grid/domain/solver parameters during parsing
        # (vxc2data.f90:99-248) and matrix stats after assembly
        # (EC3D.f90:965-971, 1046-1047)
        st = sim.system.matrix_stats()   # exact counts of the assembled coeffs
        print(f"case      : {args.vxc}")
        print(f"grid      : {sdx} x {sdy} x {sdz} = {model.n_cells} cells "
              f"({model.n_cond} conducting)")
        print(f"unknowns  : {3 * model.n_cells + model.n_cond} "
              f"(3N A-rows + {model.n_cond} U-rows)")
        print(f"matrix    : num_nzX= {st['nnz_x']} num_nzY= {st['nnz_y']} "
              f"num_nzZ= {st['nnz_z']} num_nzU= {st['nnz_u']}")
        print(f"            num_bndX= {st['bnd_x']} num_bndY= {st['bnd_y']} "
              f"num_bndZ= {st['bnd_z']}")
        print(f"            Non zero elem= {st['nnz']} "
              f"Density of matrix: {st['density_pct']:.5g}%")
        print(f"domains   : {model.nsub} material + {model.nsub_air} air, "
              f"{len(model.functions)} source fn, {len(model.vmech)} motion fn")
        print(f"transient : stop={model.tran.stop} step={model.tran.step} "
              f"jump={model.tran.jump} -> {sim.n_steps} steps")
        print(f"solver    : {model.solver.solv} tol={model.solver.tolerance} "
              f"itmax={model.solver.itmax} bound={model.solver.bound}")
        card = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        ranks = 1 if mesh is None else mesh.size
        print(f"backend   : {card} ({device}) x{ranks}, dtype={args.dtype}, "
              f"dot_dtype={args.dot_dtype or args.dtype}, "
              f"route={_route(sim)}"
              f"{', precond=' + args.precond if args.precond else ''}")
        if output_dir:
            print(f"output    : {output_dir}/field_N.vtk, src_N.vtk")

    if args.trace:
        trace.enable()
    try:
        if args.scan:
            t0 = time.perf_counter()
            state, sdiag = sim.run_scan(num_steps=args.steps,
                                        output_dir=output_dir,
                                        checkpoint_dir=args.checkpoint_dir,
                                        checkpoint_every=args.checkpoint_every,
                                        resume=args.resume)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            start = int(sdiag["start_step"])
            it = sdiag["iterations"].tolist()
            diag = {
                "wall_s": wall, "io_s": float(sdiag["io_s"]),
                "steps": len(it),
                "iterations": it, "total_iterations": int(sum(it)),
                "unconverged_steps":
                    [start + i
                     for i, c in enumerate(sdiag["converged"].tolist())
                     if not c],
            }
        else:
            state, diag = sim.run(
                num_steps=args.steps,
                output_dir=output_dir,
                progress=info,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume,
            )
        spans = trace.report() if args.trace else None
    finally:
        if args.trace:
            trace.disable()
    if spans is not None:
        rank = 0 if mesh is None else mesh.rank
        trace_path = (args.trace if mesh is None
                      else f"{args.trace}.rank{rank}")
        with open(trace_path, "w") as f:
            json.dump(trace.chrome_trace(spans, pid=rank), f)

    if info:
        print()
        it = diag["iterations"]
        med = sorted(it)[len(it) // 2] if it else 0
        # "Tcalc" is the reference's end-of-run wall-time print (EC3D.f90:461)
        print(f"Tcalc = {diag['wall_s']:.2f} s "
              f"({diag['wall_s'] / max(diag['steps'], 1):.4f} s/step, "
              f"io {diag['io_s']:.2f} s)")
        print(f"solver    : {diag['total_iterations']} iterations total, "
              f"median {med}/step, "
              f"{len(diag['unconverged_steps'])} unconverged step(s)")
        if spans is not None:
            print(f"trace     : {trace_path}, {_traced(trace.summary(spans))}")
    if mesh is not None:
        # free the solve's graphs, which hold the group's collectives, and
        # wait for every rank before the group goes
        del sim, state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        import torch.distributed as dist

        dist.barrier(group=mesh.group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
