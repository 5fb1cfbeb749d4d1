#!/usr/bin/env python3
"""Smoke run of the PyTorch port (eddy_currents_3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions,
   and the profiler's warm-up (sessions over one small kernel until a
   trace shows it; none in 5 fails);
2. build the native sources (csrc/coded_matvec.cu, csrc/coded_split.cu,
   csrc/field_stencil.cu, csrc/bsr_spmm.cu and the solve's WHILE-node
   graph csrc/solve_graph.cu with nvcc, the host ILU(0) engine
   csrc/ilu0_host.cpp and the VTK encoder csrc/ecio.cpp with g++), all at
   once, and load them;
3. the whole-plane kernel (coded_matvec) against its plain torch version on
   the card, for apply, apply_dots and apply_div, on case_static
   102x102x24, a small case_convection and case_static 256x256x64, with the
   CPU tests' tolerances (3e-6 x output scale; dots 2e-5 relative), the
   time per call of each, a hash of its outputs (yA, yU of the three modes,
   on inputs from seed 0; split_bench.py --parent sets another build's
   against them) and the device launches per apply_dots, which must be
   one (20 calls: the wrapper's launch count rises by exactly one a call,
   and torch.profiler traces the whole-plane kernel, at most once a call,
   and nothing else; the dots are finished in the kernel);
4. the split route's kernels (coded_stencil, coded_slab) against their plain
   versions the same way, for apply, apply_dots and apply_div, on
   case_static 256x256x64 (its compact U: the conductor's 5 planes) and the
   small case_convection (the slab kernel's convection branch); the slab
   kernel given the stencil kernel's dots returns their sum bit for bit;
   one split apply_dots is 2 device launches (20 calls: each wrapper's
   count rises by exactly one a call, and torch.profiler traces each
   kernel at most once a call and nothing else; a trace with no event of
   a kernel fails);
5. the main path: Simulation(float32, device="cuda").run(output_dir=...)
   over 20 steps of case_static 102x102x24, each solve one CUDA graph
   (solvers/bicgstab.py DeviceLoop); every step converges, A and the
   carry are finite, the VTK files exist, and the whole-plane kernel's
   launch count is at least 2 x the solver iterations (the wrappers count
   the launches each graph run made: utils/graph.py);
6. the first 5 steps of the same case on the card at float32 against the
   port at float64 on the CPU (flat-roll operator): each float32 step taken
   from the float64 state within 4 tol scale, but step 1 within STEP1_GAP
   (float32 solves of that step stop at either of two answers ~6.7 tol
   scale apart, by their dots' order), held besides as mesh_smoke.py holds
   a mesh's (its true residual under tol, and no farther from the
   converged solution than the float64 run's plus 4 tol scale); the free
   float32 run within STEP1_GAP after the first step and 8 tol scale
   after the fifth (see phase_cross_check);
7. the main path at 256x256x64, 5 steps, on the split route (the default
   there: both split kernels launch, the whole-plane kernel never) and on
   the whole-plane kernel with a full-shape U, in turns (split, whole,
   whole, split); every step converges, and the two routes' A agree within
   4 tol scale after one step; ms/step, ms/iteration and iterations of
   each; then 5 split steps profiled: device us per iteration and busy
   share;
8. team7 (102x102x24) preconditioned, 20 steps each with cheb_jacobi
   (order 8) and with jacobi: every step converges; then 3 jacobi steps on
   the card, each taken from the float64 CPU jacobi state, within 4 tol
   scale;
9. the field tier's kernels (field_a, field_u; csrc/field_stencil.cu)
   against their plain versions on the card, with float32 and bfloat16
   coefficients, on team7, the small case_convection (whose moving
   conductor puts the convection terms into ka), a no-conductor model of
   team7's size (field_a only) and case_static 256x256x64, within 3e-6 x
   output scale; microseconds per call (CUDA events, 50 calls), the plain
   version's time, and bytes per call against the 3.35 TB/s peak;
10. team7 on the field tier, 20 steps each: use_coded=False
   unpreconditioned, coeff_dtype=bfloat16 with cheb_jacobi order 8, and
   precond="mg": every step converges, A is finite, field_a launches at
   least 2 x the solver iterations and no coded kernel launches; the
   use_coded=False run takes the recorded iterations per step
   (F32_FIELD_ITERS), the witness that the f32 field kernels' and the glue
   kernels' sums keep their last bits; then 3 mg
   steps on the card, each from the float64 CPU mg state, within 4 tol
   scale;
11. scale: 256x256x64 with use_coded=False against the split route, 5
   steps each in turns (field, split, split, field); 128x128x64 (1.05M
   cells) with precond="mg", 3 steps; and precond="mg" at 256x256x64
   raises MgUnsupported;
12. the no-conductor model on the card (it raised CodedUnsupported before
   the field tier was ported): 5 steps converge through field_a alone;
13. the block-sparse SpMM kernel (bsr_spmm, csrc/bsr_spmm.cu) against its
   plain version (gather + einsum, TF32 off) on the card: scipy random
   matrices on a grid that is not a multiple of the block size, (8, 8),
   (4, 8) and (8, 16) blocks, k in {1, 4, 33, 128}, float32 and float64,
   one product at least on each of the four routes (vec, warp, lanes at
   the ragged k = 33, tiles); and team7's exported operator (to_csr) as
   (8, 8) blocks at k = 1 (float32, vec route) and k = 128 (float32 and
   float64, tiles route).  Tolerance 3e-6 (float32) and 1e-12 (float64)
   of max(|B|·|X|): both sides sum at most width·C products, in other
   orders.  For team7: the route each product took, that it repeats bit
   for bit, device µs (torch.profiler) and CUDA-event µs over 50 calls,
   the plain version's µs, bytes, operations and bound (FP32 FMAs at 67
   TFLOP/s, FP64 at the card's 67 on its FP64 tensor cores) and the
   share of it, and the library call's µs
   (torch.sparse_bsr_tensor of scipy's unpadded BSR @ X; the port never
   calls it); the public k = 128 product's launches counted from 0 (the
   tiles route's record); and the library time of the coded and field
   operators at team7: the exported CSR as torch.sparse_csr_tensor @ x, x
   in the reference's [Ax|Ay|Az|U] layout, the same function as
   coded_matvec's apply and as the field pair's;
14. the matrix-form solve at team7: two consecutive main-path solutions
   x_{k-1}, x_k (float32 on the card, warm_start="previous") flattened to
   the reference's [Ax|Ay|Az|U]; bsr_matvec(B, x_k) equals the coded
   operator's apply within 3e-6 of max(|B|·|x|); BiCGSTABwr on
   bsr_matvec solves B x = b (b = B x_k in float64 on the host) from
   x_{k-1}, with the true residual, recomputed in float64 on the host,
   below tol and bsr_spmm launched at least twice per iteration; the
   same solve replayed and on the per-iteration host loop, both equal to
   it bit for bit, with ms/iteration of each and the capture's host
   seconds; then bicgstab_ilu0 on the CSR on the card (the ELL sweep
   tier) converges too; iterations, ms/iteration and the host setup
   seconds;
15. team7 with precond="ilu0", 20 steps on the coded route (full-shape U)
   and 20 with use_coded=False: every step converges, A is finite,
   field_a launches at least 8 x the iterations (two preconditioner
   applies per iteration, each 2 + 2 factor sweeps) and no split kernel
   launches; the factor operators' field_a/field_u against their plain
   versions; then 3 ilu0 steps on the card, each from the float64 CPU ilu0
   state, within 4 tol scale;
15b. bfloat16 state: field_a and field_u at bfloat16 state and bfloat16
   coefficients against their plain versions on phase 9's grids and an
   odd one (101x101x24), bit for bit (both sum in float32 in one order
   with no FMA and round once), with the same times and bytes as phase 9,
   on each bfloat16-state route: the paired kernels (two cells a thread;
   the route pair_route chooses on phase 9's grids) and the scalar ones
   (asked for by name there, chosen on the odd grid), each launch counted
   on its route, and the two routes' outputs equal bit for bit; the
   pair's library yardstick at team7 (its CSR at bfloat16 @ x, with its
   largest difference from the pair's output, or torch's refusal); team7
   at bfloat16 state, 20 steps unpreconditioned with VTK at
   dot_dtype=float32 and 20 at dot_dtype=None, then 5 steps each of
   jacobi, cheb_jacobi (order 8), mg and ilu0 (dot_dtype=float32): every
   step converges, the state stays bfloat16, A is finite, field_a
   launches at least 2 x the iterations, every field launch is a
   bfloat16-state one counted on one route (the 20-step float32-dot run
   all on the paired route) and no coded kernel launches; the free bfloat16 run
   after steps 1-3 against the float64 CPU run, within 16 tol scale after
   step 1; 256x256x64 at bfloat16 state against the float32 field route,
   3 steps each in turns (bf16, f32, f32, bf16), A finite, convergence
   reported, the bf16 field launches all on the paired route; one step each of those and of bfloat16 with dot_dtype=None
   profiled, with the six kernels that take the most device time;
16. device µs per call (torch.profiler) of the kernels other than
   bsr_spmm at the shapes of their records (field_a and field_u at float32
   and at bfloat16 state, on both bfloat16-state routes, at team7 and at
   256x256x64), and each kernel's summary: events, device
   time, bound, plain version and main-path launches; the library time of
   the split pair's function at 256x256x64 (its exported CSR @ x, with the
   export's host seconds); for coded_matvec at team7 and the split pair
   at 256x256x64 also the plan (tile, ring depth, runs of planes, CTAs),
   each kernel's ptxas registers, spills and static shared memory from
   the build log, its dynamic shared memory and resident CTAs per SM, and
   the device launches per apply_dots (phases 3 and 4); the same
   resources of every field kernel;
17. the solve as one device program (run after phase 8): in each of
   GRAPH_CONFIGS (team7 coded with none, jacobi, cheb_jacobi order 8 and
   ilu0; team7's field route and mg; team7 at bfloat16 state with
   dot_dtype float32; 256x256x64 on the split route), 5 graphed steps
   against 5 on the eager per-iteration loop (Simulation._step(eager=
   True)), bit for bit at every step (iterations, relres, A, U), host
   reads per solve within ceil((n + 1) / K) + 1, one capture per
   Simulation and its host seconds, and ms/iteration of eager and graphed
   runs in turns, each also profiled (device µs per iteration, busy
   share), with each wrapper's counted launches in the profiled run held
   against its kernels' events in the trace (every counted launch traced
   but for the profiler's dropped events: at least TRACE_SHARE of them,
   and no more events than launches), the profiled run itself equal to
   the eager loop's bit for bit; every loop on the glue kernels (csrc/
   solver_glue.cu, DeviceLoop.glue "fused") at float32, the eager loop
   too, 3 glue launches an iteration by the wrapper's count, and on the
   torch glue with none at bfloat16 state; run_scan over team7's 20 steps
   with VTK,
   its files equal run's byte for byte, a run_scan that makes no
   synchronizing call (torch.cuda.set_sync_debug_mode("error"); the
   solves' reads wait on an event, which it does not flag), and a run
   resumed from the checkpoint at step 10 equal to the uninterrupted one
   bit for bit;
18. (run last, after phase 16) the run as users start it, and the
   overlapped VTK writer with the native encoder (csrc/ecio.cpp): team7
   (case_static 102x102x24, 20 steps, an output every step) in-process
   with no VTK, with a synchronous write of each state through the numpy
   writers (on_output, EC3D_NATIVE_IO=0) and with the overlapped writer
   and the native encoder (run(output_dir)), two rounds in turns, ms/step
   and io seconds of each, every file equal byte for byte to the first
   synchronous numpy run's; then python -m eddy_currents_3d_tpu_torch
   in.vxc -o out as a subprocess, and the same with --scan: each exits 0
   and prints its Tcalc line, its matrix line equals matrix_stats(), and
   its files equal the synchronous numpy run's byte for byte (the coded
   whole-plane route repeats bit for bit); the CLI's main() in this
   process, its kernels counted from 0 (coded_matvec must launch); the
   same run(output_dir) under set_sync_debug_mode("error") (the loop's
   thread makes no synchronizing call); examples/moving_coil.vxc through
   the CLI (moving sources through the writer): every step converges and
   every output file is there; and one output at 256x256x64 (a 252 MB
   field file) with each of those, as at team7, in one round.
19. (field_a and field_u at bfloat16 state with float32 coefficients
   before phase 16, the rest after phase 18; none of it profiled but the
   first) float64, float32 coefficients at bfloat16 state and the z-slab
   tier: field_a and field_u at bfloat16 state with float32 coefficients
   against their plain versions on team7, the small convection case and
   the odd 101x101x24 grid, bit for bit: field_a on the paired route
   (field_a_pairs_f32) on the even grids and the scalar (float, bf16)
   kernel, both with the same bits, on the odd one the scalar kernel;
   field_u on its scalar kernel; with times, bytes and device µs of each
   field_a route and of field_u at team7; team7 at float64 on the card (the flat-roll
   operator, graphed, 5 steps) against phase 6's float64 CPU run within
   F64_GAP (1e-9) of scale with the same iterations and no kernel
   launched, and team7's exported matrix as float64 (8, 8) blocks through
   bsr_matvec against the flat-roll float64 apply; the float32 flat-roll
   tier (use_pallas=False) against the field tier within STEP1_GAP after
   step 1, each held besides as phase 6 holds the main path's; team7 at
   bfloat16 state with float32 coefficients, 5 steps,
   every field launch a float32-coefficient one (field_a's all paired,
   field_u's all scalar), within BF16_GAP of the float64 CPU run after
   step 1; the per-shard field kernels with their
   ghost-plane corrections in one process (team7 and 256x256x64 cut into
   2 and 4 z slabs and 2x2 (z, y) blocks, the ghosts handed over locally)
   against the global kernels within SLAB_TOL of scale; the per-slab
   coded_matvec with its corrections likewise (team7 in 2, 4 and 5 slabs,
   256x256x64 in 2 and 4, one launch a slab), with the per-slab route
   timed at 256x256x64 (the slab's conductor planes, every plane, the
   split pair's slab kernel on every plane); Simulation(mesh=make_mesh(1))
   over NCCL at team7, float32, graphed, under set_sync_debug_mode
   ("error"), its dots' all-reduce called during the capture and never
   after: the coded tier (the default) within 4 tol scale of the float64
   run after step 1, its iterations beside the unsharded coded run's, and
   use_coded=False equal bit for bit to the unsharded use_coded=False run;
   and the CLI with --mesh 1 over NCCL as a subprocess, its files within
   4 tol scale of the one-device CLI's.
20. (after phase 19) the multigrid V-cycle on a mesh
   (parallel/shard_mg.py) at team7: in one process, the ghosts and the
   gather handed over locally, team7 in 2 and 4 z slabs and 2x2 (z, y)
   blocks at float32 against the single-device V-cycle on the card within
   SLAB_TOL of scale, with field_a's launches a V-cycle (each distributed
   level's applies once a block, the replicated levels' once) and the
   time of each; Simulation(precond="mg", mesh=make_mesh(1)) over NCCL,
   graphed, 5 steps under set_sync_debug_mode("error"), at float32 within
   4 tol scale of the float64 CPU mg run after step 1 and bit for bit
   with the unsharded mg run, and at float64 within F64_GAP of scale of
   the unsharded float64 mg run on the card with the same iterations;
   use_shard_map=False over NCCL bit for bit with the field mesh
   (use_coded=False); ms/iteration of each beside the unsharded run's.
21. (after phase 4) the BiCGSTABwr iteration's glue kernels (csrc/
   solver_glue.cu: glue_s, glue_xr, glue_p) against their plain version
   (ops/glue_cuda.py TorchGlue) on the card, at team7, 101x101x24 and
   101x101x23, on every branch (a plain step, the half-step exit, a
   restart, b = 0): given the kernels' dots, every vector, carry scalar
   and iteration scalar bit for bit; the dots within GLUE_DOT_TOL of
   torch.sum and of float64; a second run bit for bit; each kernel's µs a
   call at team7 (device and events) beside its bytes' time at HBM peak
   (not a bound: its working set sits in the L2) and its plain
   version's.

Any failure raises and the exit code is not 0.  The line before the last
is the card's name and power limit; the one before it the kernels' JSON
record, each kernel's launches counted over the main path it serves
(phase 5 for coded_matvec, phase 7's first split run for the split pair,
phase 10's use_coded=False run for field_a and field_u, phase 14's BSR
solve for bsr_spmm (the vec route at k = 1), phase 13's public product
at team7, k = 128 for bsr_spmm_tiles (the tiles route; its float64
product's numbers under "f64"), phase 15b's 20-step dot_dtype=float32
run for the bfloat16-state field_a_bf16 and field_u_bf16, phase 19's
5-step run for field_a_f32coef and field_u_f32coef, bfloat16 state with
float32 coefficients; the field records also carry the route the run
took, "kernel_route", the bfloat16-state ones their launches on each
route, "launches_by_route", coded_matvec's record its launches on
phase 19's coded mesh of one rank, "mesh", and field_a's its launches on
phase 20's float32 mg mesh of one rank, "mesh_mg"), with its bound (bytes
over 3.35 TB/s or operations over 67 TFLOP/s FP32, the larger) and the
library call's time where one PyTorch call computes the same function;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device
the script exits 1 and prints no result.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ATOL = 3e-6        # matvec: x output scale (tests/test_torch_coded.py)
DOT_RTOL = 2e-5    # fused dots, relative to float64 sums
SOURCES = ("coded_matvec", "coded_split", "field_stencil", "bsr_spmm",
           "solve_graph", "solver_glue", "ilu0_host", "ecio")
HBM_PEAK = 3.35e12  # B/s, H100 SXM data sheet
FP32_PEAK = 67e12   # FLOP/s outside the tensor cores, H100 SXM data sheet
FP64_PEAK = 67e12   # FLOP/s, H100 SXM data sheet: IEEE float64 on the FP64
                    # tensor cores, the card's peak for the type
SPMM_TOL = {torch.float32: 3e-6, torch.float64: 1e-12}
# bfloat16-state field kernels against their plain versions, x output scale:
# both sum in float32 in one order, with no FMA, and round once to bfloat16,
# so they must agree bit for bit (one FMA would move a cell by one bfloat16
# ulp, up to 2^-8 of the scale)
BF16_TOL = 0.0
# team7's iterations per step on the float32 field route (use_coded=False,
# 20 steps, on the glue kernels, whose dots' order they depend on too): the
# f32 field kernels' and glue kernels' outputs to the last bit decide them,
# so a build whose f32 sums round otherwise shows here (PERF.md, Findings)
F32_FIELD_ITERS = [50, 38, 36, 31, 23, 25, 16, 9, 8, 16, 25, 21, 17, 33, 19,
                   15, 11, 8, 8, 15]
# the same on the torch glue (testing/glue.py), the glue of a mesh's loops
F32_FIELD_ITERS_TORCH = [50, 43, 30, 28, 20, 20, 20, 7, 8, 14, 21, 28, 29,
                         10, 14, 15, 28, 9, 10, 15]
# team7's float32 step 1 against the float64 step 1, and two float32 tiers'
# step 1 against each other, tol scale: float32 solves of that step stop at
# either of two answers ~6.7 tol scale apart, both under the stopping rule,
# by the order of their dots (ROADMAP Queue 3 item 3), so the bound sits
# above the far answer's readings (PERF.md, Findings); later steps keep 4
STEP1_GAP = 7.5
BF16_GAP = 16.0    # bf16 team7 step 1 vs the f64 CPU step 1, tol scale
F64_GAP = 1e-9     # f64 on the card vs the f64 CPU run, x scale (the CPU
                   # parity bound of tests/test_shard_op.py's transients)
SLAB_TOL = ATOL    # per-slab field kernels + ghost folds vs the global ones
FIELD_ROUTES = ("paired", "scalar")   # the bfloat16-state field kernels
KERNELS = {        # name: (source, TPU kernel it replaces)
    "coded_matvec": ("eddy_currents_3d_tpu_torch/csrc/coded_matvec.cu",
                     "eddy_currents_3d_tpu/ops/pallas_coded.py:405"),
    "coded_stencil": ("eddy_currents_3d_tpu_torch/csrc/coded_split.cu",
                      "eddy_currents_3d_tpu/ops/pallas_coded.py:602"),
    "coded_slab": ("eddy_currents_3d_tpu_torch/csrc/coded_split.cu",
                   "eddy_currents_3d_tpu/ops/pallas_coded.py:658"),
    "field_a": ("eddy_currents_3d_tpu_torch/csrc/field_stencil.cu",
                "eddy_currents_3d_tpu/ops/pallas_stencil.py:136"),
    "field_u": ("eddy_currents_3d_tpu_torch/csrc/field_stencil.cu",
                "eddy_currents_3d_tpu/ops/pallas_stencil.py:206"),
    "bsr_spmm": ("eddy_currents_3d_tpu_torch/csrc/bsr_spmm.cu",
                 "eddy_currents_3d_tpu/ops/pallas_sparse.py:39"),
    # bsr_spmm's tiles route (k >= 32): the TPU kernel's own width, 128
    "bsr_spmm_tiles": ("eddy_currents_3d_tpu_torch/csrc/bsr_spmm.cu",
                       "eddy_currents_3d_tpu/ops/pallas_sparse.py:39"),
    # the bfloat16-state instantiations of field_a and field_u
    "field_a_bf16": ("eddy_currents_3d_tpu_torch/csrc/field_stencil.cu",
                     "eddy_currents_3d_tpu/ops/pallas_stencil.py:136"),
    "field_u_bf16": ("eddy_currents_3d_tpu_torch/csrc/field_stencil.cu",
                     "eddy_currents_3d_tpu/ops/pallas_stencil.py:206"),
    # the (float, bf16) instantiations: bfloat16 state, float32
    # coefficients (coeff_dtype=torch.float32)
    "field_a_f32coef": ("eddy_currents_3d_tpu_torch/csrc/field_stencil.cu",
                        "eddy_currents_3d_tpu/ops/pallas_stencil.py:136"),
    "field_u_f32coef": ("eddy_currents_3d_tpu_torch/csrc/field_stencil.cu",
                        "eddy_currents_3d_tpu/ops/pallas_stencil.py:206"),
}


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, n):
    """Mean milliseconds per call of ``fn`` between CUDA events, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def trace(fn):
    """(fn(), {kernel: (device µs, launches)}, wall seconds) over one call
    of ``fn`` ended by a synchronize: the kernels from torch.profiler, the
    wall time from the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            kernels[e.key] = (t if t is not None else e.self_cuda_time_total,
                              e.count)
    return out, kernels, wall


def device_ms(fn, name, n=20):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``name`` over ``n`` calls of ``fn``; None when the trace holds no
    device time for them."""
    fn()
    _, kernels, _ = trace(lambda: [fn() for _ in range(n)])
    hits = [v for k, v in kernels.items() if name in k]
    total, count = sum(t for t, _ in hits), sum(c for _, c in hits)
    return total / count / 1e3 if total > 0 and count else None


def device_launches(fn, kernels, calls=20):
    """Device launches per call of ``fn`` over ``calls`` calls after a
    warm-up, each kernel of ``kernels`` ({device kernel name: its
    wrapper}) counted by its wrapper's ``launches``; raises unless each
    launched exactly once a call and the trace (:func:`trace`) holds no
    other kernel.  The profiler may drop an event, so the trace holds each
    kernel to at least one event and at most one a call."""
    fn()
    before = {n: w.launches for n, w in kernels.items()}
    _, traced, _ = trace(lambda: [fn() for _ in range(calls)])
    per_call = {n: (w.launches - before[n]) / calls
                for n, w in kernels.items()}
    seen = {n: sum(c for k, (_, c) in traced.items() if n in k)
            for n in kernels}
    other = [k for k in traced if not any(n in k for n in kernels)]
    if (other or any(p != 1 for p in per_call.values())
            or not all(0 < c <= calls for c in seen.values())):
        raise AssertionError(
            f"{calls} calls: wrapper launches per call {per_call}, traced "
            f"{traced} (each of {list(kernels)} once a call, nothing else)")
    return sum(per_call.values())


def _busy(kernels, wall, iters):
    """Device µs per iteration and busy share of a traced run."""
    dev_s = sum(t for t, _ in kernels.values()) / 1e6
    if dev_s <= 0:
        return "device time not measured"
    return (f"device {dev_s / iters * 1e6:.0f} us/iteration, busy "
            f"{dev_s / wall:.1%}")


def bound(nbytes, ops, peak=None):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM peak and the operations over ``peak`` (FP32 by default)."""
    t_b, t_o = nbytes / HBM_PEAK * 1e3, ops / (peak or FP32_PEAK) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def wrappers():
    """{kernel name: its wrapper}; each wrapper counts its launches."""
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import bsr_spmm
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 coded_stencil)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u
    from eddy_currents_3d_tpu_torch.ops.glue_cuda import solver_glue
    return {"coded_matvec": coded_matvec, "coded_stencil": coded_stencil,
            "coded_slab": coded_slab, "field_a": field_a, "field_u": field_u,
            "bsr_spmm": bsr_spmm, "solver_glue": solver_glue}


def counters():
    """{kernel name: its launch count's holder}: the wrappers, the field
    wrappers' counts of their bfloat16-state launches, of those with
    float32 coefficients, and of those on each bfloat16-state route
    (paired, scalar)."""
    ws = wrappers()
    out = dict(ws, field_a_bf16=ws["field_a"].bf16_state,
               field_u_bf16=ws["field_u"].bf16_state,
               field_a_f32coef=ws["field_a"].f32_coef,
               field_u_f32coef=ws["field_u"].f32_coef)
    for k in ("field_a", "field_u"):
        for route in FIELD_ROUTES:
            out[f"{k}_{route}"] = getattr(ws[k], route)
    return out


def operator_counts(counts):
    """``counts`` without the solver's glue kernels, which every float32
    device loop on one card launches whatever its operator."""
    return {k: v for k, v in counts.items() if k != "solver_glue"}


def counted(fn):
    """(fn(), {kernel: launches}) with every count set to 0 just before
    ``fn`` and read just after."""
    ws = counters()
    for w in ws.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in ws.items()}


@contextlib.contextmanager
def whole_plane_route():
    """The coded operator on the whole-plane kernel with a full-shape U at
    any plane size (what ``from_assembled_coded(compact_u=False)`` gives),
    by lifting the route gate's budget."""
    from eddy_currents_3d_tpu_torch.ops import coded

    prev = coded._WHOLE_PLANE_BUDGET
    coded._WHOLE_PLANE_BUDGET = float("inf")
    try:
        yield
    finally:
        coded._WHOLE_PLANE_BUDGET = prev


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[1] device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    say(f"[1] profiler warm-up: {profiler_warmup()} session(s) to the first "
        "traced device kernel")
    return card


def profiler_warmup(tries=5):
    """Profiler sessions over one small elementwise kernel until a trace
    holds its device event; returns how many it took, and raises if none
    did.  A process's first session can trace no device event at all
    while the kernels run (an empty eager trace in phase 3, twice on an
    H100), as torch.profiler's own schedule discards its warm-up steps;
    every later trace is held as strictly as before."""
    x = torch.ones(1 << 16, device="cuda")
    for n in range(1, tries + 1):
        _, kernels, _ = trace(lambda: x.mul(2.0))
        if kernels:
            return n
    raise AssertionError(f"torch.profiler traced no device kernel in {tries} "
                         "sessions over one elementwise kernel")


def phase_build():
    from eddy_currents_3d_tpu_torch.ops._build import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build_library, SOURCES))
    wall = time.perf_counter() - t0
    for w in wrappers().values():
        w._library()
    from eddy_currents_3d_tpu_torch.io import native as native_io
    from eddy_currents_3d_tpu_torch.ops.native import get_lib
    get_lib()
    native_io.get_lib()
    for name, (path, log, seconds) in zip(SOURCES, built):
        say(f"[2] built {os.path.relpath(path)} in {seconds:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say("    ptxas:", line.strip())
    say(f"[2] the {len(SOURCES)} builds took {wall:.2f} s of wall time")
    return {name: log for name, (_, log, _) in zip(SOURCES, built)}


def _case_ops(text, dev):
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.ops.coded import from_assembled_coded
    from eddy_currents_3d_tpu_torch.testing.cases import load_case

    model = load_case(text)
    sysm = assemble_operator(model, torch.float32, dev)
    return model, sysm, from_assembled_coded(sysm, model, dev)


def _inputs(model, dev, seed):
    """Random x and w on the card, U masked to the conductor."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State

    shape = model.shape_zyx
    rng = np.random.default_rng(seed)
    cm = np.asarray(model.cond_mask)
    f = lambda a: torch.from_numpy(a).to(dev, torch.float32)
    x = State(f(rng.standard_normal((3,) + shape)),
              f(rng.standard_normal(shape) * cm))
    w = State(f(rng.standard_normal((3,) + shape)),
              f(rng.standard_normal(shape) * cm))
    return x, w


def output_digest(*tensors):
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _f64_dots(parts):
    """dot(y, w) and dot(y, y) in float64 over (y, w) tensor pairs."""
    ref_w = sum(float((y.double() * w.double()).sum()) for y, w in parts)
    ref_y = sum(float((y.double() ** 2).sum()) for y, _ in parts)
    return ref_w, ref_y


def _dot_err(pw, py, ref_w, ref_y):
    return max(abs(float(pw) - ref_w) / max(abs(ref_w), 1.0),
               abs(float(py) - ref_y) / max(abs(ref_y), 1.0))


def _maxabs(a, b):
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        a, b = a.double(), b.double()
    return (a - b).abs().max().item()


def phase_kernel_vs_plain(grids, dev):
    """The whole-plane kernel.  Returns {grid name: record} with errors and
    per-call times."""
    from eddy_currents_3d_tpu_torch.ops.coded import coded_apply_reference
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec

    out = {}
    for name, text in grids:
        model, sysm, op = _case_ops(text, dev)
        shape = model.shape_zyx
        x, w = _inputs(model, dev, 0)
        plain = lambda U=x.U, ww=None: coded_apply_reference(
            x.A, U, op.code, op.cf, op.conv, op.consts, op.inertia_on_faces, ww)

        rA, rU = plain()
        scale = rA.abs().max().item()
        uscale = max(rU.abs().max().item(), scale)
        yA, yU = coded_matvec(op, x.A, x.U)
        errs = {"apply": max(_maxabs(yA, rA) / scale, _maxabs(yU, rU) / uscale)}
        abs_err = max(_maxabs(yA, rA), _maxabs(yU, rU))

        dA, dU, pw, py = coded_matvec(op, x.A, x.U, w)
        errs["apply_dots"] = max(_maxabs(dA, rA) / scale,
                                 _maxabs(dU, rU) / uscale)
        dot_err = _dot_err(pw, py, *_f64_dots([(dA, w.A), (dU, w.U)]))
        abs_err = max(abs_err, _maxabs(dA, rA), _maxabs(dU, rU))

        rD = plain(U=None)[1]
        dscale = max(rD.abs().max().item(), 1.0)
        yD = coded_matvec(op, x.A)
        errs["apply_div"] = _maxabs(yD, rD) / dscale
        abs_err = max(abs_err, _maxabs(yD, rD))
        torch.cuda.synchronize()
        digest = output_digest(yA, yU, dA, dU, yD)
        # the dots are finished in the kernel: one device launch a call
        per_call = device_launches(lambda: coded_matvec(op, x.A, x.U, w),
                                   {"whole_march": coded_matvec})

        n_k = 50
        n_p = 10 if np.prod(shape) < 1_000_000 else 4
        t = {
            "apply": (cuda_ms(lambda: coded_matvec(op, x.A, x.U), n_k),
                      cuda_ms(lambda: plain(), n_p)),
            "apply_dots": (cuda_ms(lambda: coded_matvec(op, x.A, x.U, w), n_k),
                           cuda_ms(lambda: plain(ww=w), n_p)),
            "apply_div": (cuda_ms(lambda: coded_matvec(op, x.A), n_k),
                          cuda_ms(lambda: plain(U=None), n_p)),
        }
        nz, ny, nx = shape
        say(f"[3] coded_matvec {name} ({nx}x{ny}x{nz}, conv={op.has_conv}): "
            + "  ".join(f"{m} err {errs[m]:.2e} kernel {t[m][0] * 1e3:.1f} us"
                        f" plain {t[m][1] * 1e3:.1f} us" for m in t)
            + f"  dots rel err {dot_err:.2e}; {per_call:g} device launch "
            f"per apply_dots; outputs sha256 {digest}")
        bad = {m: e for m, e in errs.items() if not e <= ATOL}
        if bad or not dot_err <= DOT_RTOL:
            raise AssertionError(f"kernel != plain on {name}: {bad}, "
                                 f"dots {dot_err:.3e}")
        out[name] = {"model": model, "system": sysm, "op": op, "times": t,
                     "max_abs_err": abs_err, "digest": digest,
                     "launches_per_apply_dots": per_call}
    return out


def phase_split_vs_plain(grids, dev):
    """The split route's two kernels, each against its plain version.
    Returns {grid name: {kernel: record}} with errors and per-call times."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.ops.coded import (coded_slab_reference,
                                                      coded_stencil_reference)
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 coded_stencil)

    out = {}
    for name, text in grids:
        model, _, op = _case_ops(text, dev)
        nz, ny, nx = model.shape_zyx
        zb0, zb1 = op.cond_z
        x, w = _inputs(model, dev, 1)
        Uc, wc = x.U[zb0:zb1], State(w.A, w.U[zb0:zb1])
        own = torch.cat([torch.arange(0, zb0), torch.arange(zb1, nz)]).to(dev)
        plain_st = lambda wA=None: coded_stencil_reference(
            x.A, op.consts, op.cond_z, wA)
        plain_sl = lambda U=Uc, ww=None: coded_slab_reference(
            x.A, U, op.code, op.cf, op.conv, op.consts, op.inertia_on_faces,
            op.cond_z, ww)

        # ---- stencil kernel: the planes outside the slab ----
        rA = plain_st()[:, own]
        scale = rA.abs().max().item()
        yA = coded_stencil(op, x.A)[:, own]
        dA, st_dots = coded_stencil(op, x.A, w.A)
        dA = dA[:, own]
        st_err = {"apply": _maxabs(yA, rA) / scale,
                  "apply_dots": _maxabs(dA, rA) / scale}
        st_dot = _dot_err(*st_dots, *_f64_dots([(dA, w.A[:, own])]))
        st_abs = max(_maxabs(yA, rA), _maxabs(dA, rA))

        # ---- slab kernel: the slab's planes, compact U ----
        sA, sU = plain_sl()
        sscale = sA.abs().max().item()
        uscale = max(sU.abs().max().item(), sscale)
        yS = torch.empty_like(x.A)
        yU = coded_slab(op, x.A, Uc, yS)
        yS = yS[:, zb0:zb1]
        dS = torch.empty_like(x.A)
        dU, sl_dots = coded_slab(op, x.A, Uc, dS, wc)
        dS = dS[:, zb0:zb1]
        # the pair's dots: the slab kernel adds the stencil kernel's first
        _, pair = coded_slab(op, x.A, Uc, torch.empty_like(x.A), wc, st_dots)
        if not torch.equal(pair, st_dots + sl_dots):
            raise AssertionError(f"slab dots with the stencil's {pair} != "
                                 f"{st_dots} + {sl_dots} on {name}")
        rD = plain_sl(U=None)
        yD = coded_slab(op, x.A)
        dscale = max(rD.abs().max().item(), 1.0)
        sl_err = {"apply": max(_maxabs(yS, sA) / sscale, _maxabs(yU, sU) / uscale),
                  "apply_dots": max(_maxabs(dS, sA) / sscale,
                                    _maxabs(dU, sU) / uscale),
                  "apply_div": _maxabs(yD, rD) / dscale}
        sl_dot = _dot_err(*sl_dots, *_f64_dots([(dS, w.A[:, zb0:zb1]),
                                                (dU, wc.U)]))
        sl_abs = max(_maxabs(yS, sA), _maxabs(yU, sU), _maxabs(dS, sA),
                     _maxabs(dU, sU), _maxabs(yD, rD))
        torch.cuda.synchronize()

        n_k, n_p = 50, 4
        buf = torch.empty_like(x.A)
        st_t = {"apply": (cuda_ms(lambda: coded_stencil(op, x.A), n_k),
                          cuda_ms(lambda: plain_st(), n_p)),
                "apply_dots": (cuda_ms(lambda: coded_stencil(op, x.A, w.A), n_k),
                               cuda_ms(lambda: plain_st(w.A), n_p))}
        sl_t = {"apply": (cuda_ms(lambda: coded_slab(op, x.A, Uc, buf), n_k),
                          cuda_ms(lambda: plain_sl(), n_p)),
                "apply_dots": (cuda_ms(lambda: coded_slab(op, x.A, Uc, buf, wc),
                                       n_k),
                               cuda_ms(lambda: plain_sl(ww=wc), n_p)),
                "apply_div": (cuda_ms(lambda: coded_slab(op, x.A), n_k),
                              cuda_ms(lambda: plain_sl(U=None), n_p))}
        # the device launches of one apply_dots where the operator takes
        # the split route
        per_call = None
        if op.split:
            xs, ws = op.pad_state(x), op.pad_state(w)
            per_call = device_launches(lambda: op.apply_dots(xs, ws),
                                       {"stencil_march": coded_stencil,
                                        "slab_march": coded_slab})
            say(f"[4] split apply_dots {name}: {per_call:g} device launches "
                f"per call")
        for kname, errs, t, derr in (("coded_stencil", st_err, st_t, st_dot),
                                     ("coded_slab", sl_err, sl_t, sl_dot)):
            say(f"[4] {kname} {name} ({nx}x{ny}x{nz}, slab z {zb0}..{zb1 - 1}, "
                f"conv={op.has_conv}): "
                + "  ".join(f"{m} err {errs[m]:.2e} kernel {t[m][0] * 1e3:.1f}"
                            f" us plain {t[m][1] * 1e3:.1f} us" for m in t)
                + f"  dots rel err {derr:.2e}")
            bad = {m: e for m, e in errs.items() if not e <= ATOL}
            if bad or not derr <= DOT_RTOL:
                raise AssertionError(f"{kname} != plain on {name}: {bad}, "
                                     f"dots {derr:.3e}")
        out[name] = {"coded_stencil": {"times": st_t, "max_abs_err": st_abs},
                     "coded_slab": {"times": sl_t, "max_abs_err": sl_abs},
                     "launches_per_apply_dots": per_call}
    return out


# the glue kernels' dots against torch.sum and against float64 sums, as a
# share of sum |a_i b_i|: float32 summation in two orders over ~1e6 terms
GLUE_DOT_TOL = 2e-6
# phase 21's grids (nz, ny, nx): team7, the odd grid, and an odd plane count
# whose leaves are no multiple of 4 floats (the kernels' float route)
GLUE_GRIDS = (("team7", (24, 102, 102)), ("odd", (24, 101, 101)),
              ("odd23", (23, 101, 101)))
GLUE_BRANCHES = ("plain", "conv_s", "restart", "zero_b")


def _glue_inputs(shape, branch, dev, seed, tol_kind):
    """(carry, ap, as): a random carry on the card whose iteration takes
    ``branch``, and random operator outputs; ``tol_kind`` "float" (baked)
    or "tensor" (a float32 device scalar)."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import _Static, tree_dot

    g = torch.Generator(device=dev).manual_seed(seed)
    st = lambda scale=1.0: State(
        scale * torch.randn((3,) + shape, generator=g, device=dev),
        scale * torch.randn(shape, generator=g, device=dev))
    c = _Static()
    c.x, c.r, c.p = st(), st(), st()
    # restart: r0 nearly orthogonal to r, so |r.r0| / |b| < tol
    c.r0 = st(1e-9 if branch == "restart" else 1.0)
    c.rr0 = tree_dot(c.r, c.r0)
    scalar = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt, device=dev)
    c.bnorm = scalar({"zero_b": 0.0, "restart": 1.0}.get(branch, 17.0))
    tol = {"conv_s": 1e6, "restart": 1e-3}.get(branch, 1e-6)
    c.tol = scalar(tol) if tol_kind == "tensor" else tol
    c.relres = scalar(float("inf"))
    c.done = scalar(False, torch.bool)
    c.it = scalar(3, torch.int32)
    return c, st(), st()


def _glue_clone(c):
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import _Static, _map

    d = _Static()
    d.__dict__.update({k: _map(torch.clone, v) if hasattr(v, "A")
                       or isinstance(v, torch.Tensor) else v
                       for k, v in c.__dict__.items()})
    return d


def _glue_run(c0, ap, as_):
    """The three glue kernels once from a copy of ``c0``: (carry after
    each piece, s, the scalars after s and after xr, ap.r0, as.s, as.as)."""
    from eddy_currents_3d_tpu_torch.ops.glue_cuda import (FLAGS, SCALARS,
                                                          solver_glue)
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import tree_dot

    snap = lambda w: {n: getattr(w, n).clone() for n in SCALARS + FLAGS
                      if hasattr(w, n)}
    c = _glue_clone(c0)
    ap_r0 = tree_dot(ap, c.r0)
    w = solver_glue.s(c, ap, ap_r0)
    after_s = snap(w)
    as_s, as_as = tree_dot(as_, w.s), tree_dot(as_, as_)
    solver_glue.xr(c, w, as_, as_s, as_as)
    c_xr = _glue_clone(c)
    after_xr = snap(w)
    solver_glue.p(c, w, ap)
    torch.cuda.synchronize()
    return c_xr, c, w.s, after_s, after_xr, (ap_r0, as_s, as_as)


def _bits(a, b):
    """Bit for bit, NaNs included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _glue_same(label, got, ref, names):
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import _leaves

    bad = [n for n in names
           if not all(_bits(x, y) for x, y in zip(_leaves(getattr(got, n)),
                                                   _leaves(getattr(ref, n))))]
    if bad:
        raise AssertionError(f"{label}: {bad} differ from the plain glue's")


def _glue_dot_err(k, a, b):
    """(|k - torch.sum|, |k - float64 sum|) over sum |a_i b_i|, for the
    kernel's dot k of the States a and b."""
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import _leaves, tree_dot

    mag = sum(float((x.double() * y.double()).abs().sum())
              for x, y in zip(_leaves(a), _leaves(b)))
    f64 = sum(float((x.double() * y.double()).sum())
              for x, y in zip(_leaves(a), _leaves(b)))
    k = float(k)
    return (abs(k - float(tree_dot(a, b))) / mag, abs(k - f64) / mag)


def phase_glue(dev):
    """[21] The BiCGSTABwr iteration's vector glue kernels (csrc/
    solver_glue.cu: glue_s, glue_xr, glue_p) against their plain version
    (ops/glue_cuda.py TorchGlue) on the card, at team7, the odd 101x101x24
    grid and 101x101x23 (leaves no multiple of 4: the float route), on
    every branch (a plain step, the half-step exit, a restart, b = 0), with
    tol baked and as a device tensor (team7): given the kernels' dots, the
    plain version's s, x, r, p, r0, rr0, relres, done, it and every scalar
    equal the kernels' bit for bit; each dot within GLUE_DOT_TOL of
    torch.sum's and of float64's (of sum |a_i b_i|); a second run equal to
    the first bit for bit.  Then at team7 the µs a call of each kernel
    (device by torch.profiler, 20 calls; events, 50) beside its bytes'
    time at HBM peak and its plain version's events time."""
    from eddy_currents_3d_tpu_torch.ops.glue_cuda import (FLAGS, SCALARS,
                                                          TorchGlue,
                                                          solver_glue)
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import tree_dot

    worst = [0.0, 0.0]
    n_checks = 0
    for grid, shape in GLUE_GRIDS:
        kinds = ("float", "tensor") if grid == "team7" else ("float",)
        for branch in GLUE_BRANCHES:
            for kind in kinds:
                label = f"{grid} {branch} tol {kind}"
                seed = 100 + GLUE_BRANCHES.index(branch)
                c0, ap, as_ = _glue_inputs(shape, branch, dev, seed, kind)
                c_xr, c_p, s, sc_s, sc_xr, (ap_r0, as_s, as_as) = \
                    _glue_run(c0, ap, as_)
                # the plain version, given the kernels' dots
                plain = TorchGlue(None)
                cp = _glue_clone(c0)
                plain.dots = lambda pairs: [sc_s["ss"]]
                wp = plain.s(cp, ap, ap_r0)
                if not (all(_bits(x, y) for x, y in ((s.A, wp.s.A),
                                                     (s.U, wp.s.U)))
                        and _bits(sc_s["alpha"], wp.alpha)):
                    raise AssertionError(f"{label}: s or alpha differ from "
                                         "the plain glue's")
                plain.dots = lambda pairs: [sc_xr["rr"], sc_xr["rr0_new"]]
                plain.xr(cp, wp, as_, as_s, as_as)
                _glue_same(f"{label} xr", c_xr, cp,
                           ("x", "r", "r0", "p", "rr0", "relres", "done",
                            "it"))
                bad = [n for n in SCALARS if not _bits(sc_xr[n],
                                                       getattr(wp, n))]
                bad += [n for n in FLAGS
                        if bool(sc_xr[n]) != bool(getattr(wp, n))]
                if bad:
                    raise AssertionError(f"{label}: scalars {bad} differ "
                                         "from the plain glue's")
                plain.p(cp, wp, ap)
                _glue_same(f"{label} p", c_p, cp, ("x", "r", "r0", "p"))
                want = {"conv_s": ("conv_s",), "restart": ("restart",)}
                for flag in want.get(branch, ()):
                    if not bool(sc_xr[flag]):
                        raise AssertionError(f"{label}: {flag} not taken")
                if branch in ("plain", "zero_b") and (
                        bool(sc_xr["conv_s"]) or bool(sc_xr["restart"])):
                    raise AssertionError(f"{label}: took another branch")
                # the dots against torch.sum and float64
                for k, a, b in ((sc_s["ss"], s, s),
                                (sc_xr["rr"], c_xr.r, c_xr.r),
                                (sc_xr["rr0_new"], c_xr.r, c0.r0)):
                    errs = _glue_dot_err(k, a, b)
                    worst = [max(w, e) for w, e in zip(worst, errs)]
                # a second run repeats the first bit for bit
                again = _glue_run(c0, ap, as_)
                _glue_same(f"{label} repeat", again[1], c_p,
                           ("x", "r", "r0", "p", "rr0", "relres", "done",
                            "it"))
                if not all(_bits(again[4][n], sc_xr[n])
                           for n in SCALARS + FLAGS):
                    raise AssertionError(f"{label}: a second run's scalars "
                                         "differ")
                n_checks += 1
    if not max(worst) <= GLUE_DOT_TOL:
        raise AssertionError(f"glue dots off by {worst} of sum |a b| "
                             f"(torch.sum, float64; limit {GLUE_DOT_TOL})")
    say(f"[21] glue kernels: {n_checks} cases (grids "
        f"{[g for g, _ in GLUE_GRIDS]}, branches {list(GLUE_BRANCHES)}) "
        f"equal the plain glue bit for bit given the kernels' dots, and "
        f"repeat bit for bit; dots within {worst[0]:.2e} of torch.sum and "
        f"{worst[1]:.2e} of float64 (of sum |a b|; limit {GLUE_DOT_TOL})")

    # times at team7
    c, ap, as_ = _glue_inputs(GLUE_GRIDS[0][1], "plain", dev, 7, "tensor")
    ap_r0 = tree_dot(ap, c.r0)
    w = solver_glue.s(c, ap, ap_r0)
    as_s, as_as = tree_dot(as_, w.s), tree_dot(as_, as_)
    plain = TorchGlue(lambda pairs: [tree_dot(a, b) for a, b in pairs])
    wp = plain.s(_glue_clone(c), ap, ap_r0)
    cp = _glue_clone(c)
    plain.xr(cp, wp, as_, as_s, as_as)
    vec_bytes = 4 * sum(t.numel() for t in (c.x.A, c.x.U))
    n = vec_bytes // 4
    fns = {"glue_s": (lambda: solver_glue.s(c, ap, ap_r0),
                      lambda: plain.s(cp, ap, ap_r0), 3, 3),
           "glue_xr": (lambda: solver_glue.xr(c, w, as_, as_s, as_as),
                       lambda: plain.xr(cp, wp, as_, as_s, as_as), 7, 10),
           "glue_p": (lambda: solver_glue.p(c, w, ap),
                      lambda: plain.p(cp, wp, ap), 4, 4)}
    for name, (fk, fp, vecs, flops) in fns.items():
        b_ms, b_by = bound(vecs * vec_bytes, flops * n)
        ms, dev_ms, plain_ms = cuda_ms(fk, 50), device_ms(fk, name), \
            cuda_ms(fp, 50)
        # not a bound: the kernels' 12-28 MB sit in the 50 MB L2, whose
        # bandwidth is not measured here
        say(f"[21] {name} at team7: events {ms * 1e3:.2f} us, device "
            + ("not measured" if dev_ms is None else
               f"{dev_ms * 1e3:.2f} us ({b_ms / dev_ms:.0%} of its HBM "
               "bytes time)")
            + f", HBM bytes time {b_ms * 1e3:.2f} us by {b_by} "
            f"({vecs * vec_bytes / 1e6:.1f} MB at HBM_PEAK), plain "
            f"{plain_ms * 1e3:.2f} us")


def phase_main_path(dev):
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

    model = load_case(case_static(shape_xyz=(102, 102, 24), steps=20))
    sim = Simulation(model, dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        (st, diag), counts = counted(lambda: sim.run(output_dir=tmp))
        outs = [o for _, o in sim.steps if o is not None]
        missing = [f"{k}_{n}.vtk" for n in outs for k in ("field", "src")
                   if not os.path.isfile(os.path.join(tmp, f"{k}_{n}.vtk"))]
    its = diag["iterations"]
    launches = counts["coded_matvec"]
    if diag["unconverged_steps"] or min(its) <= 0:
        raise AssertionError(f"main path did not converge: {its}")
    if not (torch.isfinite(st.A).all() and torch.isfinite(st.carry).all()):
        raise AssertionError("main path produced non-finite fields")
    if missing or not outs:
        raise AssertionError(f"VTK outputs missing: {missing or 'no outputs'}")
    if launches < 2 * diag["total_iterations"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{diag['total_iterations']} solver iterations")
    steps = diag["steps"]
    solve_s = diag["wall_s"] - diag["io_s"]
    say(f"[5] main path 102x102x24 x {steps} steps: "
        f"{diag['wall_s'] / steps * 1e3:.2f} ms/step with VTK, "
        f"{solve_s / steps * 1e3:.2f} ms/step without "
        f"({len(outs)} outputs, io {diag['io_s']:.2f} s); "
        f"iterations/step {np.mean(its):.1f} {its}; "
        f"{solve_s / diag['total_iterations'] * 1e3:.3f} ms/iteration; "
        f"host blocked on the (done, it) reads {diag['sync_s'] / solve_s:.1%} of "
        f"the solve; kernel launches {counts}")
    return model, launches


def _to(state, dev, dtype):
    """A SimState's tensors on ``dev`` in ``dtype`` (motion stays on the
    host)."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State

    f = lambda t: t.to(dev, dtype)
    return state._replace(A=f(state.A), U=f(state.U), carry=f(state.carry),
                          prev=State(f(state.prev.A), f(state.prev.U)))


def _per_step_gaps(model, dev, n, keep=None, **kw):
    """n steps of the float64 CPU run; before each, the float32 card step
    from the float64 state.  Returns (per-step gaps, the free float32 run's
    gaps, f32 iterations, f64 iterations, CPU seconds), gaps as
    max |dA| / (tol scale); ``keep`` (a list) gets the float64 A after each
    step."""
    from eddy_currents_3d_tpu_torch import Simulation

    sim32 = Simulation(model, torch.float32, device=dev, **kw)
    sim64 = Simulation(model, torch.float64, device="cpu", **kw)
    s32, s64 = sim32.init_state(), sim64.init_state()
    tol = model.solver.tolerance
    step_ratios, ratios, its32, its64 = [], [], [], []
    t_cpu = 0.0
    for t, _ in sim32.steps[:n]:
        f32, if32 = sim32._step(_to(s64, dev, torch.float32), t)
        s32, i32 = sim32._step(s32, t)
        t0 = time.perf_counter()
        s64, i64 = sim64._step(s64, t)
        t_cpu += time.perf_counter() - t0
        if keep is not None:
            keep.append(s64.A)
        if not (i32.converged and i64.converged and if32.converged):
            raise AssertionError(f"cross-check step at t={t} did not converge")
        its32.append(int(i32.iterations))
        its64.append(int(i64.iterations))
        scale = tol * s64.A.abs().max().item()
        step_ratios.append((f32.A.cpu().double() - s64.A).abs().max().item()
                           / scale)
        ratios.append((s32.A.cpu().double() - s64.A).abs().max().item() / scale)
    return step_ratios, ratios, its32, its64, t_cpu


def _fmt(rs):
    return " ".join(f"{r:.2f}" for r in rs)


def _step1_accuracy(model, dev, tiers=({},)):
    """Step 1's float32 solution on the card, for each Simulation keywords
    of ``tiers``, held as mesh_smoke.py holds a mesh's: [(its true
    residual ||b - A x|| / ||b||, recomputed at float64 on the host; its
    tol scale to the converged solution A_conv, step 1 solved to 1e-8 at
    float64; the bound max |A_f64 - A_conv| + 4 tol scale; its tol scale to
    the float64 run)], scale max |A_f64|."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import tree_norm

    f64, cpu = torch.float64, torch.device("cpu")
    tol = model.solver.tolerance
    one64 = Simulation(model, f64, f64, device=dev)
    b, x0 = one64.step_system(one64.init_state(), one64.steps[0][0])
    x64 = one64.solve(b, x0).x
    tight = dataclasses.replace(model, solver=dataclasses.replace(
        model.solver, tolerance=1e-8))
    conv = Simulation(tight, f64, device=dev, precond="jacobi").solve(b, x0)
    host = assemble_operator(model, f64, "cpu")
    surface = lambda A: torch.where(host.bnd_a, 0.0, A.to(cpu, f64))
    A64, Ac = surface(x64.A), surface(conv.x.A)
    dist = lambda A, ref: ((surface(A) - ref).abs().max().item()
                           / (tol * A64.abs().max().item()))
    bh = State(b.A.to(cpu), b.U.to(cpu))
    out = []
    for kw in tiers:
        sim32 = Simulation(model, torch.float32, device=dev, **kw)
        x32 = sim32.solve(*sim32.step_system(sim32.init_state(),
                                             sim32.steps[0][0])).x
        y = host.op.apply(State(x32.A.to(cpu, f64), x32.U.to(cpu, f64)))
        rel = (tree_norm(State(bh.A - y.A, bh.U - y.U))
               / tree_norm(bh)).item()
        out.append((rel, dist(x32.A, Ac), dist(A64, Ac) + 4.0,
                     dist(x32.A, A64)))
    return out


def phase_cross_check(model, dev):
    """The first 5 steps, f32 on the card against f64 on the CPU.

    * Per step: each f32 step starts from the f64 run's state, so it
      measures one solve; A must agree within 4 tol scale at steps 2-5,
      and within STEP1_GAP at step 1 (from rest): float32 solves of it
      stop at either of two answers ~6.7 tol scale apart, both under the
      stopping rule, by the order of their dots (ROADMAP Queue 3 item 3).
      Step 1 is held besides as mesh_smoke.py holds a mesh's: its true
      residual, recomputed at float64, under tol, and its A no farther
      from the converged solution than the f64 run's plus 4 tol scale
      (:func:`_step1_accuracy`).
    * Free run: the f32 run carries its own state.  After one step it must
      agree within STEP1_GAP, as above.  The gap then grows as each
      step's solve error feeds the next step's right-hand side: on this
      grid the JAX package's own f32 run (flat-roll operator, CPU) sits
      4.04 tol scale from its f64 run after 5 steps, so the 5-step bound
      of the free run is twice that gap, 8 tol scale.

    Returns (the float64 A after each step, the float64 iterations)."""
    a64 = []
    step_ratios, ratios, its32, its64, t_cpu = _per_step_gaps(model, dev, 5,
                                                              keep=a64)
    (rel, to_conv, bound1, to_f64), = _step1_accuracy(model, dev)
    tol = model.solver.tolerance
    say(f"[6] f32 cuda vs f64 cpu, max |dA| / (tol scale): per step from the "
        f"f64 state {_fmt(step_ratios)} (limits {STEP1_GAP} at step 1, 4 "
        f"after it); free run {_fmt(ratios)} (limits {STEP1_GAP} after step "
        f"1, 8 after step 5); iterations f32 {its32} "
        f"f64 {its64}; cpu f64 steps {t_cpu:.1f} s; step 1: true residual "
        f"{rel:.6f} (limit {tol}), {to_conv:.3f} tol scale from the "
        f"converged solution (limit {bound1:.3f}), {to_f64:.3f} from the "
        f"f64 run's")
    if not (step_ratios[0] <= STEP1_GAP and max(step_ratios[1:]) <= 4.0
            and ratios[0] <= STEP1_GAP and ratios[-1] <= 8.0
            and rel < tol and to_conv <= bound1):
        raise AssertionError(f"f32 cuda vs f64 cpu out of bounds: per step "
                             f"{step_ratios}, free run {ratios}, step 1 "
                             f"residual {rel}, to A_conv {to_conv} (bound "
                             f"{bound1})")
    return a64, its64


def phase_scale(rec, dev):
    """256x256x64 on both routes.  Returns the split pair's launch counts
    over the first split run."""
    from eddy_currents_3d_tpu_torch import Simulation

    model, sysm = rec["model"], rec["system"]
    tol = model.solver.tolerance
    sims = {"split": Simulation(model, torch.float32, device=dev, system=sysm)}
    zb0, zb1 = sims["split"].coded_op.cond_z
    if not sims["split"].coded_op.split or zb1 - zb0 != 5:
        raise AssertionError(f"256x256x64 is not on the split route with 5 "
                             f"compact planes: cond_z {(zb0, zb1)}")
    with whole_plane_route():
        sims["whole"] = Simulation(model, torch.float32, device=dev, system=sysm)
        if sims["whole"].coded_op.split:
            raise AssertionError("whole-plane route not taken")
    route = {"split": contextlib.nullcontext, "whole": whole_plane_route}
    must = {"split": ("coded_stencil", "coded_slab"), "whole": ("coded_matvec",)}

    def run(name, steps):
        with route[name]():
            (st, diag), counts = counted(
                lambda: sims[name].run(num_steps=steps))
        if diag["unconverged_steps"]:
            raise AssertionError(f"256x256x64 {name} did not converge: "
                                 f"{diag['iterations']}")
        if not (torch.isfinite(st.A).all() and torch.isfinite(st.carry).all()):
            raise AssertionError(f"256x256x64 {name} produced non-finite fields")
        ops = operator_counts(counts)
        if any(ops[k] == 0 for k in must[name]) or any(
                ops[k] for k in ops if k not in must[name]):
            raise AssertionError(f"256x256x64 {name} route launched {counts}")
        return st, diag, counts

    one = {name: run(name, 1)[0] for name in ("split", "whole")}
    scale = tol * one["whole"].A.abs().max().item()
    gap1 = (one["split"].A - one["whole"].A).abs().max().item() / scale
    runs = [(name, run(name, 5)) for name in ("split", "whole", "whole", "split")]
    for name, (st, diag, counts) in runs:
        wall = diag["wall_s"]
        say(f"[7] 256x256x64 {name} x 5 steps: {wall / 5 * 1e3:.2f} ms/step, "
            f"iterations {diag['iterations']}, "
            f"{wall / diag['total_iterations'] * 1e3:.3f} ms/iteration, "
            f"host blocked on the (done, it) reads {diag['sync_s'] / wall:.1%}; "
            f"launches {counts}")
    last = {name: st for name, (st, _, _) in runs}
    gap5 = (last["split"].A - last["whole"].A).abs().max().item() / (
        tol * last["whole"].A.abs().max().item())
    say(f"[7] split vs whole max |dA| / (tol scale): {gap1:.3f} after step 1 "
        f"(limit 4), {gap5:.3f} after step 5; compact U planes {zb0}..{zb1 - 1}")
    (_, d5), kernels, wall5 = trace(lambda: sims["split"].run(num_steps=5))
    say(f"[7] 256x256x64 split x 5 steps profiled: "
        f"{wall5 / d5['total_iterations'] * 1e3:.3f} ms/iteration under the "
        f"profiler, {_busy(kernels, wall5, d5['total_iterations'])}")
    if not gap1 <= 4.0:
        raise AssertionError(f"split and whole-plane routes differ by "
                             f"{gap1:.3f} tol scale after step 1")
    return runs[0][1][2]


def phase_precond(model, dev):
    """team7 with cheb_jacobi (order 8) and jacobi: 20 steps each, then the
    jacobi per-step check against the f64 CPU state."""
    from eddy_currents_3d_tpu_torch import Simulation

    for kw in ({"precond": "cheb_jacobi", "cheb_order": 8},
               {"precond": "jacobi"}):
        sim = Simulation(model, torch.float32, device=dev, **kw)
        (st, diag), counts = counted(lambda: sim.run())
        its = diag["iterations"]
        if diag["unconverged_steps"] or min(its) <= 0:
            raise AssertionError(f"{kw} did not converge: {its}")
        if not torch.isfinite(st.A).all() or counts["coded_matvec"] == 0:
            raise AssertionError(f"{kw}: non-finite A or no kernel launch")
        wall = diag["wall_s"]
        say(f"[8] team7 {kw} x {diag['steps']} steps: "
            f"{wall / diag['steps'] * 1e3:.2f} ms/step, iterations/step "
            f"{np.mean(its):.2f} {its}, "
            f"{wall / diag['total_iterations'] * 1e3:.3f} ms/iteration, host "
            f"blocked on the (done, it) reads {diag['sync_s'] / wall:.1%}; "
            f"launches {counts}")
    step_ratios, _, its32, its64, t_cpu = _per_step_gaps(model, dev, 3,
                                                         precond="jacobi")
    say(f"[8] jacobi f32 cuda steps from the f64 cpu state, max |dA| / "
        f"(tol scale): {_fmt(step_ratios)} (limit 4); iterations f32 "
        f"{its32} f64 {its64}; cpu f64 steps {t_cpu:.1f} s")
    if not max(step_ratios) <= 4.0:
        raise AssertionError(f"jacobi f32 vs f64 out of bounds: {step_ratios}")


def _nocond_text(shape_xyz):
    """case_static with a non-conducting plate: no conducting cell, so the
    coded encoder refuses the model and the field tier serves it."""
    from eddy_currents_3d_tpu_torch.testing.cases import case_static

    text = case_static(shape_xyz=shape_xyz, steps=5)
    out = text.replace("C='mu0*35260000.0'", "C=0")
    if out == text:
        raise AssertionError("no-conductor model: plate conductivity not found")
    return out


def _field_op(sysm, coef):
    from eddy_currents_3d_tpu_torch.ops.field import FieldStencilOperator

    if coef != torch.float32:
        sysm = dataclasses.replace(sysm, op=sysm.op.astype(coef))
    return FieldStencilOperator.from_assembled(sysm)


def _on_route(w, route, fn):
    """fn(), which must launch wrapper ``w``'s kernel once on ``route`` (at
    bfloat16 state; None: any float32-state launch)."""
    before = (w.launches, w.paired.launches, w.scalar.launches)
    out = fn()
    step = {None: (1, 0, 0), "paired": (1, 1, 0), "scalar": (1, 0, 1)}[route]
    after = (w.launches, w.paired.launches, w.scalar.launches)
    if after != tuple(a + s for a, s in zip(before, step)):
        raise AssertionError(f"{type(w).__name__} launches (all, paired, "
                             f"scalar) went {before} -> {after}, not one on "
                             f"the {route} route")
    return out


def _field_recs(op, x, cells, route=None, u_route=None):
    """field_a (and field_u where ``op`` has a box) on the card against
    their plain versions on the same inputs: {kernel: record} with the
    error relative to the output scale, bytes per call and the times per
    call of kernel (CUDA events, 50 calls) and plain version.  ``route``:
    the bfloat16-state route each launch takes (checked by the counts);
    ``u_route``: field_u's, where it differs."""
    from eddy_currents_3d_tpu_torch.ops.field import (field_a_reference,
                                                      field_u_reference)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    cs, ss = op.ka.element_size(), x.A.element_size()
    kw = {} if route is None else {"route": route}
    u_route = route if u_route is None else u_route
    ukw = {} if u_route is None else {"route": u_route}
    recs = {}
    # ---- field_a over the grid, the three A components ----
    ra = field_a_reference(op.ka, x.A)
    scale = ra.abs().max().item()
    ya = _on_route(field_a, route, lambda: field_a(op.ka, x.A, **kw))
    err = _maxabs(ya, ra)
    recs["field_a"] = {
        "err": err / scale, "max_abs_err": err,
        "bytes": cells * (7 * cs + 2 * 3 * ss),
        "times": (cuda_ms(lambda: field_a(op.ka, x.A, **kw), 50),
                  cuda_ms(lambda: field_a_reference(op.ka, x.A), 4))}
    if op.box is not None:
        # ---- field_u over the box, adding into yA ----
        gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, x.A, x.U)
        z0, z1, y0, y1, x0, x1 = op.box
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        rA = ya.clone()
        rA[(slice(None),) + sl] += gout
        rU = torch.zeros_like(x.U)
        rU[sl] = uout
        yA = ya.clone()
        yU = _on_route(field_u, u_route,
                       lambda: field_u(op, x.A, x.U, yA, **ukw))
        uscale = max(rU.abs().max().item(), scale)
        err = max(_maxabs(yA, rA), _maxabs(yU, rU))
        nbox = (z1 - z0) * (y1 - y0) * (x1 - x0)
        buf = ya.clone()
        recs["field_u"] = {
            "err": max(_maxabs(yA, rA) / scale, _maxabs(yU, rU) / uscale),
            "max_abs_err": err,
            # the kernel's own bytes over the box: 31 coefficients, U, A,
            # yA read and written, yU written (the wrapper's zero fill of
            # the rest of yU is a separate fill, not the kernel's)
            "bytes": nbox * (31 * cs + 11 * ss),
            "times": (cuda_ms(lambda: field_u(op, x.A, x.U, buf, **ukw), 50),
                      cuda_ms(lambda: field_u_reference(
                          op.gu, op.ku, op.da, op.box, x.A, x.U), 4))}
    torch.cuda.synchronize()
    return recs


def _say_field_recs(tag, recs, label, tol):
    """Print each record of :func:`_field_recs`; raise past ``tol``."""
    for kname, r in recs.items():
        k_ms, p_ms = r["times"]
        say(f"[{tag}] {kname} {label}: err {r['err']:.2e} of scale; kernel "
            f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us; "
            f"{r['bytes'] / 1e6:.1f} MB/call, "
            f"{r['bytes'] / (k_ms * 1e-3) / 1e9:.0f} GB/s = "
            f"{r['bytes'] / (k_ms * 1e-3) / HBM_PEAK:.1%} of 3.35 TB/s")
        if not r["err"] <= tol:
            raise AssertionError(f"{kname} != plain on {label}: "
                                 f"{r['err']:.3e}")


def phase_field_vs_plain(grids, dev):
    """field_a and field_u against their plain versions, float32 and
    bfloat16 coefficients.  grids: (name, model, float32 system on dev).
    Returns {(grid name, coefficient name): {kernel: record}}."""
    out = {}
    for name, model, sysm in grids:
        nz, ny, nx = model.shape_zyx
        x, _ = _inputs(model, dev, 2)
        for cname, coef in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            recs = _field_recs(_field_op(sysm, coef), x, nz * ny * nx)
            _say_field_recs(9, recs, f"{name} ({nx}x{ny}x{nz}, {cname} "
                            f"coefficients)", ATOL)
            out[(name, cname)] = recs
    return out


def _field_run(sim, tag, label, **run_kw):
    """Run ``sim`` (``run_kw`` to its ``run``) with every count at 0; the
    field kernels must carry it (field_a >= 2 x iterations) and no coded
    kernel may launch."""
    (st, diag), counts = counted(lambda: sim.run(**run_kw))
    its = diag["iterations"]
    if diag["unconverged_steps"] or min(its) <= 0:
        raise AssertionError(f"{label} did not converge: {its}")
    if not (torch.isfinite(st.A).all() and torch.isfinite(st.carry).all()):
        raise AssertionError(f"{label} produced non-finite fields")
    if counts["field_a"] < 2 * diag["total_iterations"] or any(
            counts[k] for k in ("coded_matvec", "coded_stencil", "coded_slab")):
        raise AssertionError(f"{label} launched {counts} for "
                             f"{diag['total_iterations']} iterations")
    wall = diag["wall_s"]
    say(f"[{tag}] {label} x {diag['steps']} steps: "
        f"{wall / diag['steps'] * 1e3:.2f} ms/step, iterations/step "
        f"{np.mean(its):.2f} {its}, "
        f"{wall / diag['total_iterations'] * 1e3:.3f} ms/iteration, host "
        f"blocked on the (done, it) reads {diag['sync_s'] / wall:.1%}; "
        f"launches {counts}")
    return st, diag, counts


def phase_field_team7(model, dev):
    """team7 on the field tier, 20 steps each.  Returns the field kernels'
    launch counts over the use_coded=False run."""
    from eddy_currents_3d_tpu_torch import Simulation

    runs = {"use_coded=False": {"use_coded": False},
            "bf16 cheb_jacobi": {"coeff_dtype": torch.bfloat16,
                                 "precond": "cheb_jacobi", "cheb_order": 8},
            "mg": {"precond": "mg"}}
    counts = {}
    for label, kw in runs.items():
        sim = Simulation(model, torch.float32, device=dev, **kw)
        if sim.coded_op is not None or sim.field_op is None:
            raise AssertionError(f"team7 {label} is not on the field tier")
        _, diag, counts[label] = _field_run(sim, 10, f"team7 {label}")
        if label == "use_coded=False" and diag["iterations"] != F32_FIELD_ITERS:
            raise AssertionError(
                f"team7 f32 field route took {diag['iterations']} iterations, "
                f"not {F32_FIELD_ITERS}: the f32 field kernels' sums moved")
    step_ratios, _, its32, its64, t_cpu = _per_step_gaps(model, dev, 3,
                                                         precond="mg")
    say(f"[10] mg f32 cuda steps from the f64 cpu state, max |dA| / "
        f"(tol scale): {_fmt(step_ratios)} (limit 4); iterations f32 "
        f"{its32} f64 {its64}; cpu f64 steps {t_cpu:.1f} s")
    if not max(step_ratios) <= 4.0:
        raise AssertionError(f"mg f32 vs f64 out of bounds: {step_ratios}")
    return counts["use_coded=False"]


def phase_field_scale(rec, dev):
    """256x256x64 field tier against the split route; 128x128x64 mg; mg
    refused at 256x256x64."""
    from eddy_currents_3d_tpu_torch import MgUnsupported, Simulation
    from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

    model, sysm = rec["model"], rec["system"]
    sims = {"field": Simulation(model, torch.float32, device=dev, system=sysm,
                                use_coded=False),
            "split": Simulation(model, torch.float32, device=dev, system=sysm)}
    if not sims["split"].coded_op.split or sims["field"].field_op is None:
        raise AssertionError("256x256x64 routes not as expected")
    for name in ("field", "split", "split", "field"):
        (st, diag), counts = counted(lambda: sims[name].run(num_steps=5))
        if diag["unconverged_steps"] or not torch.isfinite(st.A).all():
            raise AssertionError(f"256x256x64 {name}: {diag['iterations']}")
        own = ("field_a", "field_u") if name == "field" else (
            "coded_stencil", "coded_slab")
        ops = operator_counts(counts)
        if any(ops[k] == 0 for k in own) or any(
                ops[k] for k in ops if k not in own):
            raise AssertionError(f"256x256x64 {name} launched {counts}")
        wall = diag["wall_s"]
        say(f"[11] 256x256x64 {name} x 5 steps: {wall / 5 * 1e3:.2f} ms/step, "
            f"iterations {diag['iterations']}, "
            f"{wall / diag['total_iterations'] * 1e3:.3f} ms/iteration, "
            f"host blocked on the (done, it) reads {diag['sync_s'] / wall:.1%}; "
            f"launches {counts}")
    try:
        Simulation(model, torch.float32, device=dev, system=sysm, precond="mg")
    except MgUnsupported as e:
        say(f"[11] 256x256x64 precond='mg' raises MgUnsupported: {e}")
    else:
        raise AssertionError("precond='mg' at 256x256x64 did not raise")
    m128 = load_case(case_static(shape_xyz=(128, 128, 64), steps=3))
    sim = Simulation(m128, torch.float32, device=dev, precond="mg")
    _field_run(sim, 11, "128x128x64 mg")


def phase_no_conductor(dev):
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.testing.cases import load_case

    sim = Simulation(load_case(_nocond_text((102, 102, 24))), torch.float32,
                     device=dev)
    if sim.coded_op is not None or sim.field_op.box is not None:
        raise AssertionError("no-conductor model not on the field tier")
    _, _, counts = _field_run(sim, 12, "no-conductor 102x102x24")
    if counts["field_u"]:
        raise AssertionError(f"no-conductor model launched field_u: {counts}")


def _abs_bound(b, x):
    """max over outputs of (|B|·|X|), the scale of the SpMM tolerance."""
    C = b.block_shape[1]
    gx = x.abs().reshape(-1, C, x.shape[1])[b.block_cols]
    return torch.einsum("rwij,rwjk->rik", b.blocks.abs(), gx).max().item()


def _spmm_check(label, b, x):
    """The kernel against the plain version; returns |kernel - plain|."""
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import (bsr_spmm,
                                                         bsr_spmm_reference)

    y = bsr_spmm(b, x)
    ref = bsr_spmm_reference(b, x)
    torch.cuda.synchronize()
    err = _maxabs(y, ref)
    scale = _abs_bound(b, x)
    if not err <= SPMM_TOL[b.blocks.dtype] * scale:
        raise AssertionError(f"bsr_spmm != plain on {label}: {err:.3e} of "
                             f"scale {scale:.3e}")
    return err, scale


def _sparse_bsr(csr, block_shape, dtype, dev):
    """torch's own BSR tensor of scipy's unpadded BSR (sorted, unique block
    columns, as cuSPARSE wants): the library call's operand."""
    import scipy.sparse as sp

    R, C = block_shape
    n, m = csr.shape
    mb = sp.csr_matrix(csr)
    mb.resize((-(-n // R) * R, -(-m // C) * C))
    bs = mb.tobsr(blocksize=block_shape)
    bs.sort_indices()
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    return torch.sparse_bsr_tensor(f(bs.indptr, torch.int64),
                                   f(bs.indices, torch.int64),
                                   f(bs.data, dtype), size=bs.shape,
                                   check_invariants=True)


def csr_library_ms(model, sysm, dev, csr=None):
    """(ms per call, the export's host seconds, 0 when ``csr`` is given)
    of the library yardstick of the coded and field operators: their
    exported CSR (to_csr) as torch.sparse_csr_tensor @ x, x (n, 1) in the
    reference's [Ax|Ay|Az|U] layout, the same function as their apply.
    The port never calls it."""
    from eddy_currents_3d_tpu_torch.assembly.assemble import to_csr

    t0 = time.perf_counter()
    if csr is None:
        csr = to_csr(sysm, model)
    t_csr = time.perf_counter() - t0
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    S = torch.sparse_csr_tensor(f(csr.indptr, torch.int64),
                                f(csr.indices, torch.int64),
                                f(csr.data, torch.float32), size=csr.shape)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (csr.shape[1], 1))).to(dev, torch.float32)
    return cuda_ms(lambda: S @ x, 20), t_csr


def _spmm_team7(label, B, x, S, dev):
    """bsr_spmm at team7 on ``x``: its error against the plain version,
    the route it took, that it repeats bit for bit, device µs
    (torch.profiler) and CUDA-event µs over 50 calls, the plain version's
    µs, bytes, operations and bound (FP32 or FP64 peak), and the library
    call's µs (``S @ x``, torch.sparse_bsr_tensor; the port never calls
    it)."""
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import (bsr_spmm,
                                                         bsr_spmm_reference)

    dtype, k = B.blocks.dtype, x.shape[1]
    err, scale = _spmm_check(label, B, x)
    y = bsr_spmm(B, x)
    if not torch.equal(bsr_spmm(B, x), y):
        raise AssertionError(f"bsr_spmm {label} does not repeat bit for bit")
    isz = B.blocks.element_size()
    nbytes = (B.blocks.numel() * isz + B.block_cols.numel() * 4
              + (x.numel() + B.shape[0] * k) * isz)
    ops = 2 * B.blocks.numel() * k
    b_ms, b_by = bound(nbytes, ops, FP64_PEAK if isz == 8 else FP32_PEAK)
    ms = cuda_ms(lambda: bsr_spmm(B, x), 50)
    dev_ms = device_ms(lambda: bsr_spmm(B, x), "bsr_")
    plain_ms = cuda_ms(lambda: bsr_spmm_reference(B, x), 5)
    try:
        lib_err = _maxabs(S @ x, y) / scale
        lib_ms = cuda_ms(lambda: S @ x, 50)
        lib = (f"{lib_ms * 1e3:.2f} us (|lib - kernel| {lib_err:.2e} of "
               f"max(|B|·|X|))")
    except Exception as e:  # the yardstick only: report, do not fail
        lib_ms, lib = None, f"refused: {type(e).__name__}: {e}"
    width = B.block_cols.shape[1]
    route = bsr_spmm.route(B.block_shape, k, dtype, all(
        t.data_ptr() % 16 == 0 for t in (B.blocks, x)), width)
    want = "vec" if k == 1 else "tiles"
    if route != want:
        raise AssertionError(f"bsr_spmm {label} took the {route} route, not "
                             f"{want}")
    if route == "tiles":
        say(f"[13] bsr_spmm {label}: tiles kernel "
            f"{bsr_spmm.tiles_info(width, B.block_shape, k, dtype, dev)}")
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us"
    share = "" if dev_ms is None else f", device {b_ms / dev_ms:.1%} of it"
    say(f"[13] bsr_spmm {label} ({route} route): err {err / scale:.2e} of "
        f"max(|B|·|X|), repeats bit for bit; device {dev_txt}, events "
        f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP, bound "
        f"{b_ms * 1e3:.2f} us by {b_by} (events {b_ms / ms:.1%} of it"
        f"{share}); library {lib}")
    return {"times": (ms, plain_ms), "max_abs_err": err,
            "bound": (b_ms, b_by), "library_ms": lib_ms, "device_ms": dev_ms,
            "route": route}


def phase_bsr_vs_plain(model, sysm, dev):
    """bsr_spmm against its plain version, random matrices and team7's
    exported operator.  Returns (team7 BSR, scipy CSR, host setup seconds,
    {1: the f32 k = 1 record, 128: f32 k = 128, "128 f64": f64 k = 128,
    "tiles_launches": the public k = 128 product's launches counted from
    0, "csr_ms": the coded and field operators' library time})."""
    import scipy.sparse as sp

    from eddy_currents_3d_tpu_torch.assembly.assemble import to_csr
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import bsr_spmm
    from eddy_currents_3d_tpu_torch.ops.sparse import bsr_from_scipy

    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    rng = np.random.default_rng(13)
    routes = set()
    for seed, block_shape in enumerate(((8, 8), (4, 8), (8, 16))):
        a = sp.random(4099, 4099, density=0.002,
                      random_state=np.random.RandomState(seed)).tocsr()
        a.setdiag(1.0)
        for dtype in (torch.float32, torch.float64):
            b = bsr_from_scipy(a, block_shape=block_shape, dtype=dtype,
                               device=dev)
            width = b.blocks.shape[1]
            errs = []
            for k in (1, 4, 33, 128):
                x = torch.from_numpy(rng.standard_normal((b.shape[1], k))).to(
                    dev, dtype)
                err, scale = _spmm_check(f"random {block_shape} k={k}", b, x)
                route = bsr_spmm.route(block_shape, k, dtype,
                                       x.data_ptr() % 16 == 0, width)
                routes.add(route)
                errs.append(f"k={k} ({route}) {err / scale:.1e}")
                worst = max(worst, err) if dtype == torch.float32 else worst
            say(f"[13] bsr_spmm random 4099x4099 {block_shape} "
                f"{str(dtype)[6:]}: width {width}, |kernel - "
                f"plain| / max(|B|·|X|): " + ", ".join(errs))
    if routes != {"vec", "warp", "lanes", "tiles"}:
        raise AssertionError(f"the random products took the routes {routes}, "
                             "not all four")

    t0 = time.perf_counter()
    csr = to_csr(sysm, model)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    B = bsr_from_scipy(csr, block_shape=(8, 8), dtype=torch.float32,
                       device=dev)
    torch.cuda.synchronize()
    t_bsr = time.perf_counter() - t0
    nbr, width = B.block_cols.shape
    say(f"[13] team7 to_csr: {csr.shape[0]} rows, {csr.nnz} nonzeros, "
        f"{model.n_cond} conducting cells, {t_csr:.2f} s; bsr_from_scipy "
        f"(8, 8): {nbr} block rows of width {width}, "
        f"{B.blocks.numel() * 4 / 1e6:.1f} MB of blocks, {t_bsr:.2f} s")
    S = _sparse_bsr(csr, (8, 8), torch.float32, dev)
    recs = {}
    for k in (1, 128):
        x = torch.from_numpy(rng.standard_normal((B.shape[1], k))).to(
            dev, torch.float32)
        recs[k] = _spmm_team7(f"team7 k={k}", B, x, S, dev)
        worst = max(worst, recs[k]["max_abs_err"])
        recs[k]["max_abs_err"] = worst
    # the tiles route's own path: the public product at k = 128, counted
    _, counts = counted(lambda: bsr_spmm(B, x))
    recs["tiles_launches"] = counts["bsr_spmm"]
    del S
    B64 = bsr_from_scipy(csr, block_shape=(8, 8), dtype=torch.float64,
                         device=dev)
    x64 = torch.from_numpy(rng.standard_normal((B.shape[1], 128))).to(
        dev, torch.float64)
    recs["128 f64"] = _spmm_team7("team7 k=128 f64", B64, x64,
                                  _sparse_bsr(csr, (8, 8), torch.float64,
                                              dev), dev)
    del B64, x64
    recs["csr_ms"], _ = csr_library_ms(model, sysm, dev, csr)
    say(f"[13] library yardstick of coded_matvec and the field pair at "
        f"team7: its CSR ({csr.nnz} nonzeros) as torch.sparse_csr_tensor "
        f"@ x {recs['csr_ms'] * 1e3:.2f} us")
    return B, csr, (t_csr, t_bsr), recs


def _u_cells(model, dev):
    """The flat cells of the U unknowns in the reference's numbering."""
    condno = model.cond_number.ravel()
    order = np.nonzero(condno)[0]
    return torch.from_numpy(order[np.argsort(condno[order])]).to(dev)


def phase_matrix_solve(model, dev, B, csr, setup):
    """The matrix-form solve at team7.  Returns bsr_spmm's launches over
    the BSR solve."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import bsr_matvec
    from eddy_currents_3d_tpu_torch.ops.sparse import from_scipy
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import (DeviceLoop,
                                                             bicgstab_wr)
    from eddy_currents_3d_tpu_torch.solvers.ilu0 import (bicgstab_ilu0,
                                                          ilu0_factorize)

    sim = Simulation(model, torch.float32, device=dev, warm_start="previous")
    st = sim.init_state()
    for t, _ in sim.steps[:3]:
        prev = st
        st, info = sim._step(st, t)
        if not info.converged:
            raise AssertionError("phase 14: main-path step did not converge")
    cells = _u_cells(model, dev)
    n = csr.shape[0]
    pad = B.shape[1] - n          # zero rows and columns up to whole blocks
    flat = lambda A, U: torch.nn.functional.pad(
        torch.cat([A.reshape(-1), U.reshape(-1)[cells]]), (0, pad))
    xk, xk1 = flat(st.A, st.U), flat(prev.A, prev.U)

    y = bsr_matvec(B, xk)
    ref = sim.coded_op.apply(State(st.A, st.U))
    err = _maxabs(y, flat(ref.A, ref.U))
    scale = _abs_bound(B, xk[:, None])
    say(f"[14] bsr_matvec(B, x_k) vs the coded operator's apply: "
        f"{err / scale:.2e} of max(|B|·|x|) (limit 3e-6)")
    if not err <= 3e-6 * scale:
        raise AssertionError(f"bsr_matvec != coded apply: {err:.3e}")

    x64 = xk[:n].cpu().double().numpy()
    b64 = csr @ x64
    b = torch.from_numpy(np.pad(b64, (0, pad))).to(dev, torch.float32)
    tol = model.solver.tolerance
    itmax = model.solver.itmax
    true_res = lambda x: (np.linalg.norm(
        b64 - csr @ x[:n].cpu().double().numpy()) / np.linalg.norm(b64))

    # one device loop: its first solve captures the graphs (counted: the
    # warm-up's launches and the graph's), then the same solve replayed,
    # and by the per-iteration host loop (the plain version)
    loop = DeviceLoop(lambda v: bsr_matvec(B, v), itmax)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (res, counts), wall = timed(lambda: counted(
        lambda: loop.solve(b, xk1, tol)))
    launches = counts["bsr_spmm"]
    rel = true_res(res.x)
    again, wall_g = timed(lambda: loop.solve(b, xk1, tol))
    ref, wall_e = timed(lambda: loop.reference(b, xk1, tol))
    its = max(res.iterations, 1)
    say(f"[14] matrix-form BiCGSTABwr on bsr_matvec (team7, from x_(k-1)): "
        f"{res.iterations} iterations, true residual {rel:.3e} (tol {tol}), "
        f"launches {counts}; ms/iteration graphed {wall_g / its * 1e3:.3f}, "
        f"eager per-iteration loop {wall_e / its * 1e3:.3f}, first solve "
        f"with its capture {wall / its * 1e3:.3f} (capture "
        f"{wall - wall_g:.3f} s of host time)")
    if not (res.converged and rel < tol):
        raise AssertionError(f"matrix-form solve: converged {res.converged}, "
                             f"true residual {rel:.3e}")
    if ((again.iterations, ref.iterations) != (res.iterations,) * 2
            or not torch.equal(again.x, ref.x)
            or not torch.equal(res.x, ref.x)):
        raise AssertionError("matrix-form solve: graphed differs from the "
                             "per-iteration loop")
    if launches < 2 * res.iterations or any(
            v for k_, v in operator_counts(counts).items()
            if k_ != "bsr_spmm"):
        raise AssertionError(f"matrix-form solve launched {counts} for "
                             f"{res.iterations} iterations")
    r1, kernels, wall1 = trace(lambda: loop.solve(b, xk1, tol))
    say(f"[14] the same solve replayed, profiled: {r1.iterations} "
        f"iterations, {wall1 / max(r1.iterations, 1) * 1e3:.3f} ms/iteration, "
        f"{_busy(kernels, wall1, r1.iterations)}")

    a = from_scipy(csr, torch.float32, dev)
    t0 = time.perf_counter()
    r2 = bicgstab_ilu0(a, b[:n], xk1[:n], tol, itmax)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    rel2 = true_res(r2.x)
    # the same solve timed apart from its factorization
    t0 = time.perf_counter()
    M = ilu0_factorize(a)
    torch.cuda.synchronize()
    t_fac = time.perf_counter() - t0
    minv = lambda v: M.apply(v, sweeps=4)
    t0 = time.perf_counter()
    r3 = bicgstab_wr(lambda v: a.matvec(minv(v)), b[:n], M.matvec(xk1[:n]),
                     tol, itmax)
    torch.cuda.synchronize()
    t_it = (time.perf_counter() - t0) / max(r3.iterations, 1)
    say(f"[14] bicgstab_ilu0 on the CSR (ELL sweeps, 4 per triangle): "
        f"{r2.iterations} iterations, {wall2:.2f} s with its factorization, "
        f"{t_it * 1e3:.3f} ms/iteration without it (the one-shot solve's "
        f"capture included), true residual "
        f"{rel2:.3e}; host setup to_csr {setup[0]:.2f} s, bsr_from_scipy "
        f"{setup[1]:.2f} s, ilu0_factorize {t_fac:.2f} s")
    if not (r2.converged and rel2 < tol):
        raise AssertionError(f"bicgstab_ilu0: converged {r2.converged}, "
                             f"true residual {rel2:.3e}")
    return launches


def phase_ilu0(model, dev):
    """team7 with precond="ilu0", coded and field routes; the factor
    kernels against their plain versions; the per-step check against the
    float64 CPU ilu0 state."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.ops.field import (field_a_reference,
                                                      field_u_reference)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    for label, kw in (("coded", {}), ("use_coded=False", {"use_coded": False})):
        t0 = time.perf_counter()
        sim = Simulation(model, torch.float32, device=dev, precond="ilu0", **kw)
        t_setup = time.perf_counter() - t0
        if (sim.coded_op is not None) != (label == "coded") or (
                sim.coded_op is not None and sim.coded_op.compact_u):
            raise AssertionError(f"ilu0 {label}: route not as expected")
        (st, diag), counts = counted(lambda: sim.run())
        its = diag["iterations"]
        total = diag["total_iterations"]
        if diag["unconverged_steps"] or min(its) <= 0:
            raise AssertionError(f"ilu0 {label} did not converge: {its}")
        if not torch.isfinite(st.A).all():
            raise AssertionError(f"ilu0 {label} produced non-finite fields")
        if counts["field_a"] < 8 * total or counts["coded_stencil"] or \
                counts["coded_slab"]:
            raise AssertionError(f"ilu0 {label} launched {counts} for "
                                 f"{total} iterations")
        wall = diag["wall_s"]
        (_, d3), kernels, wall3 = trace(lambda: sim.run(num_steps=3))
        say(f"[15] team7 ilu0 {label} x {diag['steps']} steps: "
            f"{wall / diag['steps'] * 1e3:.2f} ms/step, iterations/step "
            f"{np.mean(its):.2f} {its}, {wall / total * 1e3:.3f} "
            f"ms/iteration, host blocked on the (done, it) reads "
            f"{diag['sync_s'] / wall:.1%}; setup {t_setup:.2f} s; "
            f"launches {counts}; 3 steps profiled: "
            f"{_busy(kernels, wall3, d3['total_iterations'])}")
    x, _ = _inputs(model, dev, 15)
    errs = []
    for name, op in (("L", sim._ilu.L_op), ("U", sim._ilu.U_op)):
        ra = field_a_reference(op.ka, x.A)
        ya = field_a(op.ka, x.A)
        gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, x.A, x.U)
        z0, z1, y0, y1, x0, x1 = op.box
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        rA = ra.clone()
        rA[(slice(None),) + sl] += gout
        yA = ya.clone()
        yU = field_u(op, x.A, x.U, yA)
        scale = rA.abs().max().item()
        err = max(_maxabs(yA, rA), _maxabs(yU[sl], uout)) / scale
        errs.append(f"{name} {err:.2e}")
        if not err <= ATOL:
            raise AssertionError(f"ilu0 factor {name}: kernels != plain, "
                                 f"{err:.3e}")
    say(f"[15] ilu0 factor operators, field_a + field_u vs plain: "
        + ", ".join(errs) + " of scale (limit 3e-6)")
    step_ratios, _, its32, its64, t_cpu = _per_step_gaps(model, dev, 3,
                                                         precond="ilu0")
    say(f"[15] ilu0 f32 cuda steps from the f64 cpu state, max |dA| / "
        f"(tol scale): {_fmt(step_ratios)} (limit 4); iterations f32 "
        f"{its32} f64 {its64}; cpu f64 steps {t_cpu:.1f} s")
    if not max(step_ratios) <= 4.0:
        raise AssertionError(f"ilu0 f32 vs f64 out of bounds: {step_ratios}")


def _bf16_state(x):
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    return State(x.A.to(torch.bfloat16), x.U.to(torch.bfloat16))


def phase_bf16_kernels(grids, dev):
    """[15b] field_a and field_u at bfloat16 state and bfloat16
    coefficients against their plain versions, on phase 9's grids and an
    odd one (101x101x24), on each route that applies: the route pair_route
    chooses must be the paired one on phase 9's grids and the scalar one on
    the odd grid, and on an even grid the scalar kernels, asked for by
    name, must give the paired route's bits.  Returns {(grid name, route):
    {kernel: record}}."""
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.ops.field_cuda import (field_a, field_u,
                                                           pair_route)
    from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

    odd = load_case(case_static(shape_xyz=(101, 101, 24), steps=3))
    grids = list(grids) + [("odd", odd, assemble_operator(odd, torch.float32,
                                                          dev))]
    out = {}
    for name, model, sysm in grids:
        nz, ny, nx = model.shape_zyx
        x, _ = _inputs(model, dev, 2)
        xb = _bf16_state(x)
        op = _field_op(sysm, torch.bfloat16)
        chosen = pair_route(model.shape_zyx, op.box)
        if chosen != ("scalar" if name == "odd" else "paired"):
            raise AssertionError(f"{name}: pair_route chose {chosen}")
        # the route chosen is the one launched
        ya = _on_route(field_a, chosen, lambda: field_a(op.ka, xb.A))
        if op.box is not None:
            _on_route(field_u, chosen, lambda: field_u(op, xb.A, xb.U, ya))
        outs = {}
        for route in FIELD_ROUTES if chosen == "paired" else ("scalar",):
            recs = _field_recs(op, xb, nz * ny * nx, route)
            _say_field_recs("15b", recs, f"{name} ({nx}x{ny}x{nz}, bf16 "
                            f"state and coefficients, {route} route)",
                            BF16_TOL)
            out[(name, route)] = recs
            outs[route] = _field_outputs(op, xb, route)
        if len(outs) == 2 and not all(torch.equal(p, s) for p, s in zip(
                outs["paired"], outs["scalar"])):
            raise AssertionError(f"{name}: the paired route's outputs differ "
                                 f"from the scalar route's")
    return out


def _field_outputs(op, x, route):
    """(field_a's y, field_u's yA and yU) of one apply on ``route``."""
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    ya = field_a(op.ka, x.A, route=route)
    if op.box is None:
        return (ya,)
    yA = ya.clone()
    return ya, yA, field_u(op, x.A, x.U, yA, route=route)


def csr_bf16_library(model, sysm, csr, dev):
    """The library yardstick of the bfloat16-state field pair at team7: the
    exported CSR (to_csr) as torch.sparse_csr_tensor(...).to(bfloat16) @ x,
    x the pair's bfloat16 input in the reference's [Ax|Ay|Az|U] layout.
    Returns (ms per call or None, text): the time and the largest
    difference from the pair's output, or torch's refusal in its own words.
    The port never calls it."""
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    x, _ = _inputs(model, dev, 2)
    xb = _bf16_state(x)
    op = _field_op(sysm, torch.bfloat16)
    cells = _u_cells(model, dev)
    flat = lambda A, U: torch.cat([A.reshape(-1), U.reshape(-1)[cells]])
    y = op.apply(xb)
    want = flat(y.A, y.U).double()
    try:
        S = torch.sparse_csr_tensor(f(csr.indptr, torch.int64),
                                    f(csr.indices, torch.int64),
                                    f(csr.data, torch.float32),
                                    size=csr.shape).to(torch.bfloat16)
        v = flat(xb.A, xb.U)[:, None]
        got = (S @ v)[:, 0]
        torch.cuda.synchronize()
        err = (got.double() - want).abs().max().item()
        ms = cuda_ms(lambda: S @ v, 20)
    except Exception as e:  # the yardstick only: report, do not fail
        return None, f"refused: {type(e).__name__}: {e}"
    scale = want.abs().max().item()
    return ms, (f"{ms * 1e3:.2f} us, |library - pair| <= {err:.4g} "
                f"({err / scale:.2e} of the pair's output scale {scale:.4g})")


def _bf16_run(sim, label, **run_kw):
    """:func:`_field_run` of a bfloat16-state ``sim``: the state stays
    bfloat16 and every field kernel launch is a bfloat16-state one."""
    st, diag, counts = _field_run(sim, "15b", label, **run_kw)
    if not all(t.dtype == torch.bfloat16 for t in (st.A, st.U, st.carry)):
        raise AssertionError(f"{label}: state left bfloat16: {st.A.dtype}")
    if (counts["field_a_bf16"], counts["field_u_bf16"]) != (
            counts["field_a"], counts["field_u"]):
        raise AssertionError(f"{label}: field launches not all at bfloat16 "
                             f"state: {counts}")
    for k in ("field_a", "field_u"):
        if sum(counts[f"{k}_{r}"] for r in FIELD_ROUTES) != counts[k]:
            raise AssertionError(f"{label}: {k}'s launches not each counted "
                                 f"on one route: {counts}")
    return st, diag, counts


def phase_bf16_team7(model, dev):
    """[15b] team7 at bfloat16 state: 20 steps unpreconditioned with VTK
    (dot_dtype float32, then None), 5 steps each of jacobi, cheb_jacobi
    (order 8), mg and ilu0; the free run's A after steps 1-3 against the
    float64 CPU run.  Returns the field kernels' launch counts over the
    20-step float32-dot run."""
    from eddy_currents_3d_tpu_torch import Simulation

    bf16 = torch.bfloat16
    main = Simulation(model, bf16, torch.float32, device=dev)
    if main.coded_op is not None or main.field_op.ka.dtype != bf16:
        raise AssertionError("team7 bf16 is not on the bf16 field tier")
    with tempfile.TemporaryDirectory() as tmp:
        st, diag, counts = _bf16_run(main, "team7 bf16 dot_dtype=float32",
                                     output_dir=tmp)
        if (counts["field_a_paired"], counts["field_u_paired"]) != (
                counts["field_a"], counts["field_u"]):
            raise AssertionError(f"team7 bf16: field launches not all on "
                                 f"the paired route: {counts}")
        outs = [o for _, o in main.steps if o is not None]
        missing = [f"{k}_{n}.vtk" for n in outs for k in ("field", "src")
                   if not os.path.isfile(os.path.join(tmp, f"{k}_{n}.vtk"))]
    if missing or not outs:
        raise AssertionError(f"bf16 VTK outputs missing: {missing or outs}")
    say(f"[15b] team7 bf16: {len(outs)} VTK outputs, io {diag['io_s']:.2f} "
        f"s; {(diag['wall_s'] - diag['io_s']) / diag['total_iterations'] * 1e3:.3f}"
        f" ms/iteration without VTK")
    _bf16_run(Simulation(model, bf16, device=dev), "team7 bf16 dot_dtype=None")
    for kw in ({"precond": "jacobi"},
               {"precond": "cheb_jacobi", "cheb_order": 8},
               {"precond": "mg"}, {"precond": "ilu0"}):
        sim = Simulation(model, bf16, torch.float32, device=dev, **kw)
        _bf16_run(sim, f"team7 bf16 {kw}", num_steps=5)

    # the free bf16 run against the float64 CPU run, steps 1-3
    sim64 = Simulation(model, torch.float64, device="cpu")
    s16, s64 = main.init_state(), sim64.init_state()
    tol = model.solver.tolerance
    gaps, its16, its64 = [], [], []
    t0 = time.perf_counter()
    for t, _ in main.steps[:3]:
        s16, i16 = main._step(s16, t)
        s64, i64 = sim64._step(s64, t)
        if not (i16.converged and i64.converged):
            raise AssertionError(f"bf16 cross-check step at t={t} did not "
                                 "converge")
        its16.append(int(i16.iterations))
        its64.append(int(i64.iterations))
        gaps.append((s16.A.cpu().double() - s64.A).abs().max().item()
                    / (tol * s64.A.abs().max().item()))
    say(f"[15b] bf16 cuda vs f64 cpu free run, max |dA| / (tol scale): "
        f"{_fmt(gaps)} after steps 1-3 (limit {BF16_GAP:g} after step 1); "
        f"iterations bf16 {its16} f64 {its64}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not gaps[0] <= BF16_GAP:
        raise AssertionError(f"bf16 step 1 is {gaps[0]:.2f} tol scale from "
                             f"the f64 step 1")
    return counts


def phase_bf16_scale(rec, dev):
    """[15b] 256x256x64 at bfloat16 state (dot_dtype float32) against the
    float32 field route, 3 steps each in turns (bf16, f32, f32, bf16); then
    one step each of those two and of bfloat16 with dot_dtype=None
    profiled, with the kernels that take the most device time.  A must be
    finite; convergence is reported."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator

    model = rec["model"]
    sims = {"bf16": Simulation(model, torch.bfloat16, torch.float32,
                               device=dev, system=assemble_operator(
                                   model, torch.bfloat16, dev)),
            "f32": Simulation(model, torch.float32, device=dev,
                              system=rec["system"], use_coded=False)}
    for name in ("bf16", "f32", "f32", "bf16"):
        (st, diag), counts = counted(lambda: sims[name].run(num_steps=3))
        if not torch.isfinite(st.A.float()).all():
            raise AssertionError(f"256x256x64 {name}: non-finite A")
        if counts["field_a"] == 0 or counts["field_a_bf16"] != (
                counts["field_a"] if name == "bf16" else 0) or (
                counts["field_a_paired"], counts["field_u_paired"]) != (
                (counts["field_a"], counts["field_u"]) if name == "bf16"
                else (0, 0)):
            raise AssertionError(f"256x256x64 {name} launched {counts}")
        wall = diag["wall_s"]
        say(f"[15b] 256x256x64 {name} field route x 3 steps: iterations "
            f"{diag['iterations']}, unconverged steps "
            f"{diag['unconverged_steps']}, "
            f"{wall / diag['total_iterations'] * 1e3:.3f} ms/iteration, "
            f"host blocked on the (done, it) reads {diag['sync_s'] / wall:.1%}")
    # one step of each profiled: where the device time goes
    sims["bf16 dot_dtype=None"] = Simulation(model, torch.bfloat16,
                                             device=dev,
                                             system=sims["bf16"].system)
    sims["bf16 dot_dtype=None"].run(num_steps=1)     # captures its graphs
    for name in ("bf16", "bf16 dot_dtype=None", "f32"):
        (_, d1), kernels, wall1 = trace(lambda: sims[name].run(num_steps=1))
        its = d1["total_iterations"]
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        say(f"[15b] 256x256x64 {name} x 1 step profiled: {its} iterations, "
            f"{wall1 / its * 1e3:.3f} ms/iteration under the profiler, "
            f"{_busy(kernels, wall1, its)}; top kernels, device us/iteration "
            f"(launches/iteration): " + "; ".join(
                f"{k[:70]} {t / its:.0f} ({c / its:.1f})"
                for k, (t, c) in top))


def phase_f64_card(model, dev, ref, csr):
    """[19] float64 on the card: team7 (``model``), 5 steps graphed on the
    flat-roll operator, against phase 6's float64 run on the CPU (``ref``:
    its A after each step and its iterations): within F64_GAP of the scale
    after every step, the same iterations, no hand-written kernel launched
    (JAX leaves float64 to XLA); ms/step and ms/iteration.  Then the matrix
    form at float64: team7's exported matrix as (8, 8) float64 blocks,
    bsr_matvec on the card against the flat-roll float64 apply, within
    SPMM_TOL of max(|B|·|x|)."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import bsr_matvec
    from eddy_currents_3d_tpu_torch.ops.sparse import bsr_from_scipy

    a64, its64 = ref
    f64 = torch.float64
    sim = Simulation(model, f64, device=dev)
    if sim.op is not sim.system.op or sim.use_pallas:
        raise AssertionError("float64 on the card is not on the flat-roll "
                             "operator")
    st = sim.init_state()
    gaps, its = [], []
    counts = {}
    t0 = time.perf_counter()
    for t, _ in sim.steps[:len(a64)]:
        (st, info), c = counted(lambda: sim._step(st, t))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        its.append(int(info.iterations))
        scale = a64[len(gaps)].abs().max().item()
        gaps.append((st.A.cpu() - a64[len(gaps)]).abs().max().item() / scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (_, d5), _ = counted(lambda: sim.run(num_steps=5))
    say(f"[19] f64 on the card, team7 x {len(its)} steps (graphed, "
        f"captures {sim.captures}): max |dA| / scale against the CPU's f64 "
        f"run {' '.join(f'{g:.2e}' for g in gaps)} (limit {F64_GAP:g}); "
        f"iterations card {its} cpu {its64}; a second 5-step run "
        f"{d5['wall_s'] / 5 * 1e3:.2f} ms/step, "
        f"{d5['wall_s'] / d5['total_iterations'] * 1e3:.3f} ms/iteration "
        f"(the first, with its capture, {wall / len(its) * 1e3:.2f} "
        f"ms/step); hand-written kernel launches {sum(counts.values())}")
    if its != its64 or max(gaps) > F64_GAP or any(counts.values()):
        raise AssertionError(f"f64 card vs cpu: gaps {gaps}, iterations "
                             f"{its} against {its64}, launches {counts}")
    # the matrix form at float64
    B = bsr_from_scipy(csr, block_shape=(8, 8), dtype=f64, device=dev)
    x, _ = _inputs(model, dev, 4)
    x = State(x.A.double(), x.U.double())
    cells = _u_cells(model, dev)
    flat = lambda A, U: torch.cat([A.reshape(-1), U.reshape(-1)[cells]])
    pad = B.shape[1] - csr.shape[0]
    xv = torch.nn.functional.pad(flat(x.A, x.U), (0, pad))
    n0 = counters()["bsr_spmm"].launches
    y = bsr_matvec(B, xv)[:csr.shape[0]]
    ref_y = sim.system.op.apply(x)
    want = flat(ref_y.A, ref_y.U)
    scale = _abs_bound(B, xv[:, None])
    err = (y - want).abs().max().item()
    say(f"[19] f64 matrix form: bsr_matvec of team7's (8, 8) float64 "
        f"blocks against the flat-roll float64 apply: err "
        f"{err / scale:.2e} of max(|B|·|x|) (limit "
        f"{SPMM_TOL[f64]:g}), bsr_spmm launches "
        f"{counters()['bsr_spmm'].launches - n0}")
    if not err <= SPMM_TOL[f64] * scale:
        raise AssertionError(f"f64 bsr_matvec != flat apply: {err / scale}")


def phase_flat_f32(model, dev):
    """[19] the float32 flat-roll tier (use_pallas=False, torch shifts) on
    the card against the field tier (use_coded=False): step 1 within
    STEP1_GAP of each other (float32 solves of it stop at either of two
    answers ~6.7 tol scale apart, by the rounding of their operator and
    dots), and each held as phase 6 holds the main path's
    (:func:`_step1_accuracy`), 5 steps each in turns (flat, field, field,
    flat), ms/iteration; the flat tier launches no operator kernel."""
    from eddy_currents_3d_tpu_torch import Simulation

    sims = {"flat": Simulation(model, torch.float32, device=dev,
                               use_pallas=False),
            "field": Simulation(model, torch.float32, device=dev,
                                use_coded=False)}
    one = {k: s.run(num_steps=1)[0].A for k, s in sims.items()}
    tol = model.solver.tolerance
    gap = (one["flat"] - one["field"]).abs().max().item() / (
        tol * one["field"].abs().max().item())
    ms = {"flat": [], "field": []}
    for name in ("flat", "field", "field", "flat"):
        (_, diag), counts = counted(lambda: sims[name].run(num_steps=5))
        if diag["unconverged_steps"]:
            raise AssertionError(f"flat f32 {name}: {diag['iterations']}")
        if name == "flat" and any(operator_counts(counts).values()):
            raise AssertionError(f"the flat-roll tier launched {counts}")
        ms[name].append(diag["wall_s"] / diag["total_iterations"] * 1e3)
    held = _step1_accuracy(model, dev, ({"use_pallas": False},
                                        {"use_coded": False}))
    say(f"[19] f32 flat-roll tier (use_pallas=False) against the field "
        f"tier, team7 step 1: max |dA| / (tol scale) {gap:.3f} (limit "
        f"{STEP1_GAP}); step 1 of "
        f"each (flat, field): true residual "
        f"{', '.join(f'{h[0]:.6f}' for h in held)} (limit {tol}), "
        f"{', '.join(f'{h[1]:.3f}' for h in held)} tol scale from the "
        f"converged solution (limit {held[0][2]:.3f}), "
        f"{', '.join(f'{h[3]:.3f}' for h in held)} from the f64 run's; "
        f"ms/iteration over 5 steps flat {_fmt(ms['flat'])}, field "
        f"{_fmt(ms['field'])}")
    if not (gap <= STEP1_GAP
            and all(rel < tol and d <= bound for rel, d, bound, _ in held)):
        raise AssertionError(f"flat and field f32 step 1: gap {gap}, {held}")


def phase_f32coef_kernels(grids, dev):
    """[19] field_a and field_u at bfloat16 state with float32
    coefficients against their plain versions on team7, the small
    convection case and the odd 101x101x24 grid, bit for bit, each launch
    counted as a float32-coefficient one: field_a on the route pair_route
    chooses (paired on the even grids, scalar on the odd one) and, where
    that is the paired one, on the scalar route too, both with the same
    bits; field_u on its scalar kernel.  Times, bytes, and device µs of
    each field_a route and of field_u at team7.  Returns ({(grid, route):
    {kernel: record}}, {kernel: device ms at team7})."""
    from eddy_currents_3d_tpu_torch.ops.field_cuda import (field_a, field_u,
                                                           pair_route)

    out = {}
    for name, model, sysm in grids:
        nz, ny, nx = model.shape_zyx
        x, _ = _inputs(model, dev, 2)
        xb = _bf16_state(x)
        op = _field_op(sysm, torch.float32)
        chosen = pair_route(model.shape_zyx, coef_bf16=False)
        if chosen != ("scalar" if name == "odd" else "paired"):
            raise AssertionError(f"{name}: pair_route chose {chosen} for "
                                 "float32 coefficients")
        for route in FIELD_ROUTES if chosen == "paired" else ("scalar",):
            n0 = (field_a.f32_coef.launches, field_u.f32_coef.launches)
            recs = _field_recs(op, xb, nz * ny * nx, route, "scalar")
            if field_a.f32_coef.launches == n0[0] or (
                    op.box is not None
                    and field_u.f32_coef.launches == n0[1]):
                raise AssertionError(f"{name}: no float32-coefficient "
                                     "launch counted")
            _say_field_recs(19, recs, f"{name} ({nx}x{ny}x{nz}, bf16 state, "
                            f"f32 coefficients, field_a {route} route)",
                            BF16_TOL)
            out[(name, route)] = recs
        if chosen == "paired" and not torch.equal(
                field_a(op.ka, xb.A, route="paired"),
                field_a(op.ka, xb.A, route="scalar")):
            raise AssertionError(f"{name}: float32-coefficient field_a's "
                                 "routes differ")
    model, sysm = grids[0][1], grids[0][2]
    x, _ = _inputs(model, dev, 2)
    xb = _bf16_state(x)
    op = _field_op(sysm, torch.float32)
    yb = field_a(op.ka, xb.A)
    dev_ms = {"field_a_f32coef": device_ms(
                  lambda: field_a(op.ka, xb.A, route="paired"), "field_a"),
              "field_a_f32coef scalar": device_ms(
                  lambda: field_a(op.ka, xb.A, route="scalar"), "field_a"),
              "field_u_f32coef": device_ms(
                  lambda: field_u(op, xb.A, xb.U, yb), "field_u")}
    say("[19] device us per call at team7 (torch.profiler, 20 calls; "
        "field_a_f32coef on the paired route unless scalar is named): "
        + ", ".join(f"{k} " + ("not measured" if v is None
                                else f"{v * 1e3:.2f}")
                    for k, v in dev_ms.items()))
    return out, dev_ms


def phase_f32coef_team7(model, dev, ref):
    """[19] team7 at bfloat16 state with float32 coefficients, 5 steps:
    every step converges, the state stays bfloat16, every field launch is
    a bfloat16-state one with float32 coefficients; the free run's A
    against phase 6's float64 CPU run after each step, within BF16_GAP
    tol scale after step 1 (phase 15b's bound).  Returns the field
    kernels' launch counts over the run."""
    from eddy_currents_3d_tpu_torch import Simulation

    a64, _ = ref
    sim = Simulation(model, torch.bfloat16, torch.float32, device=dev,
                     coeff_dtype=torch.float32)
    if sim.coded_op is not None or sim.field_op.ka.dtype != torch.float32:
        raise AssertionError("team7 bf16/f32 is not on the f32-coefficient "
                             "field tier")
    st, diag, counts = _bf16_run(sim, "team7 bf16 state, f32 coefficients",
                                 num_steps=5)
    if (counts["field_a_f32coef"], counts["field_u_f32coef"]) != (
            counts["field_a"], counts["field_u"]):
        raise AssertionError(f"bf16/f32: field launches not all with f32 "
                             f"coefficients: {counts}")
    if (counts["field_a_paired"], counts["field_u_scalar"]) != (
            counts["field_a"], counts["field_u"]):
        raise AssertionError(f"bf16/f32: field_a not all paired or field_u "
                             f"not all scalar: {counts}")
    s = sim.init_state()
    tol = model.solver.tolerance
    gaps = []
    for (t, _), a in zip(sim.steps[:3], a64):
        s, _ = sim._step(s, t)
        gaps.append((s.A.cpu().double() - a).abs().max().item()
                    / (tol * a.abs().max().item()))
    say(f"[19] bf16 state with f32 coefficients vs f64 cpu free run, max "
        f"|dA| / (tol scale): {_fmt(gaps)} after steps 1-3 (limit "
        f"{BF16_GAP:g} after step 1)")
    if not gaps[0] <= BF16_GAP:
        raise AssertionError(f"bf16/f32 step 1 is {gaps[0]:.2f} tol scale "
                             "from the f64 step 1")
    return counts


def _blocks(system, n_z, n_y, dev, **kw):
    """The float32 sharded operators of every (z, y) block of ``system``
    on ``dev``, in one process (the ghosts handed over locally)."""
    from eddy_currents_3d_tpu_torch.parallel.shard_op import (
        in_process_blocks)

    return in_process_blocks(system, n_z, n_y, torch.float32, dev, **kw)


def _sharded_check(label, sops, x, ref, launches, global_ms):
    """Hold the sharded apply of ``x`` over ``sops`` to ``ref`` (the global
    kernels' (yA, yU)) within SLAB_TOL of the output scale, its launches
    ({wrapper: expected launches of one apply}) to the wrappers' counts, and
    print its time in one process against ``global_ms``."""
    from eddy_currents_3d_tpu_torch.parallel.shard_op import handover_apply

    ws = wrappers()
    before = {k: ws[k].launches for k in launches}
    yA, yU = handover_apply(sops, x)
    torch.cuda.synchronize()
    got = {k: ws[k].launches - before[k] for k in launches}
    if got != launches:
        raise AssertionError(f"{label}: launches {got}, expected {launches}")
    scale = ref[0].abs().max().item()
    uscale = max(ref[1].abs().max().item(), scale)
    err = max((yA - ref[0]).abs().max().item() / scale,
              (yU - ref[1]).abs().max().item() / uscale)
    ms = cuda_ms(lambda: handover_apply(sops, x), 10)
    say(f"[19] {label}: against the global kernels err {err:.2e} of scale "
        f"(limit {SLAB_TOL:g}); launches {got}; {ms * 1e3:.1f} us per "
        f"sharded apply in one process (block copies and messages "
        f"included), global apply {global_ms * 1e3:.1f} us")
    if not err <= SLAB_TOL:
        raise AssertionError(f"{label}: {err:.3e}")
    return err


def phase_slab_kernels(recs, dev):
    """[19] the per-shard field kernels with their ghost corrections, in
    one process: team7 and 256x256x64 cut into 2 and 4 z slabs and into
    2x2 (z, y) blocks, each block's field_a and field_u launched on its own
    block and its neighbours' ghost planes and rows folded in (the exchange
    swapped for a local hand-over), against the global field kernels on
    the same input: within SLAB_TOL of the output scale (the same float32
    products, summed in another order at the block faces)."""
    for name in ("team7", "scale256"):
        model, system = recs[name]["model"], recs[name]["system"]
        x, _ = _inputs(model, dev, 6)
        op = _field_op(system, torch.float32)
        ref = op.apply(x)
        g_ms = cuda_ms(lambda: op.apply(x), 10)
        for dims in ((2, 1), (4, 1), (2, 2)):
            sops = _blocks(system, *dims, dev)
            boxes = sum(s.box is not None for s in sops)
            _sharded_check(
                f"{name} in {dims[0]}x{dims[1]} (z, y) blocks of "
                f"{sops[0].block_zyx} (padded {sops[0].padded_zyx}), "
                f"{boxes} holding box rows: per-block field_a + field_u with "
                f"ghost corrections", sops, x, (ref.A, ref.U),
                {"field_a": len(sops), "field_u": boxes}, g_ms)


def phase_slab_coded(recs, dev):
    """[19] the per-slab coded kernel with its corrections, in one process:
    team7 and 256x256x64 cut into 2 and 4 z slabs, and team7 into 5 (slabs
    of 5 planes over 24: the grid's +z face mid-slab, a padding plane), each
    slab's coded_matvec launched on its own slab and the neighbours' ghosts
    folded in, against the global coded_matvec on the same input within
    SLAB_TOL of the output scale, one launch a slab.  At 256x256x64 also
    the per-slab route: each slab's coded_matvec with its conducting run
    over its own conductor planes (the route taken), over every plane of
    the slab (JAX's cond_z = (0, NZl)), and the split pair's slab kernel
    over the whole slab (the split pair with a full-slab cond_z, whose
    stencil kernel has no plane), each timed and held to the first."""
    import dataclasses

    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import coded_slab

    errs = []
    for name, counts in (("team7", (2, 4, 5)), ("scale256", (2, 4))):
        rec = recs[name]
        model, system, op = rec["model"], rec["system"], rec["op"]
        x, _ = _inputs(model, dev, 7)
        ref = coded_matvec(op, x.A, x.U)
        g_ms = cuda_ms(lambda: coded_matvec(op, x.A, x.U), 10)
        for n in counts:
            sops = _blocks(system, n, 1, dev, model=model, use_coded=True)
            errs.append(_sharded_check(
                f"{name} in {n} z slabs of {sops[0].NZl} planes (padded "
                f"{sops[0].padded_zyx}, conductor planes "
                f"{[s.local.cond_z for s in sops]}, per-plane fixes on "
                f"{[len(s._zfix) for s in sops]} planes): per-slab "
                f"coded_matvec with its corrections", sops, x, ref,
                {"coded_matvec": n}, g_ms))
            if name != "scale256":
                continue
            rows = []
            for s in sops:
                xs = s.pad_state(x)
                full = dataclasses.replace(s.local, cond_z=(0, s.NZl))
                split = dataclasses.replace(full, compact_u=True)
                yA0, yU0 = coded_matvec(s.local, xs.A, xs.U)
                yA1, yU1 = coded_matvec(full, xs.A, xs.U)
                yA2 = torch.empty_like(xs.A)
                yU2 = coded_slab(split, xs.A, xs.U, yA2)
                torch.cuda.synchronize()
                same = (torch.equal(yA0, yA1) and torch.equal(yU0, yU1),
                        (yA2 - yA0).abs().max().item()
                        / max(yA0.abs().max().item(), 1e-30))
                fns = ((lambda: coded_matvec(s.local, xs.A, xs.U),
                        "whole_march"),
                       (lambda: coded_matvec(full, xs.A, xs.U),
                        "whole_march"),
                       (lambda: coded_slab(split, xs.A, xs.U, yA2),
                        "slab_march"))
                t = [cuda_ms(fn, 20) for fn, _ in fns]
                dt = [device_ms(fn, k) for fn, k in fns]
                rows.append((s.local.cond_z, t, same, dt))
                if not (same[0] and same[1] <= SLAB_TOL
                        and torch.allclose(yU2, yU0, rtol=0, atol=SLAB_TOL
                                           * max(yU0.abs().max().item(),
                                                 1e-30))):
                    raise AssertionError(f"scale256 / {n}: the per-slab "
                                         f"routes differ: {same}")
            us = lambda v: "not measured" if v is None else f"{v * 1e3:.2f}"
            say(f"[19] scale256 in {n} slabs, per-slab route, us per call, "
                f"events (host included) / device (conductor planes: "
                f"whole_march on them, whole_march on every plane, "
                f"coded_slab on every plane): "
                + "; ".join(f"{cz} " + ", ".join(
                    f"{t[k] * 1e3:.1f} / {us(d[k])}" for k in range(3))
                    for cz, t, _, d in rows)
                + "; device sums " + ", ".join(
                    "not measured" if any(r[3][k] is None for r in rows)
                    else f"{sum(r[3][k] for r in rows) * 1e3:.2f}"
                    for k in range(3))
                + f"; the slab kernel against whole_march at most "
                f"{max(r[2][1] for r in rows):.2e} of scale")
    return max(errs)


def _mesh_of_one(backend="nccl"):
    """A one-rank process group on a file store in a temporary directory,
    as a context: yields the directory."""
    import torch.distributed as dist

    @contextlib.contextmanager
    def group():
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1)
            try:
                yield tmp
            finally:
                dist.destroy_process_group()
    return group()


def phase_mesh_nccl(model, dev, ref64):
    """[19] a mesh of one rank over NCCL, team7, float32, graphed, 5 steps
    each under set_sync_debug_mode("error"), the dots' all-reduce called
    while the solve is captured and never after (its Python calls stop):

    * Simulation(mesh=make_mesh(1)), the coded tier (the default on a
      z-only mesh), against phase 6's float64 CPU run (``ref64``) within
      4 tol scale after step 1, its iterations beside the unsharded coded
      run's, coded_matvec launched on every apply (its launches per
      iteration, which this returns with its counts);
    * use_coded=False on the mesh, the field tier, bit for bit with the
      unsharded use_coded=False run on the mesh's (torch) glue, the
      iterations F32_FIELD_ITERS_TORCH's first 5.

    The unsharded runs take the torch glue, as the mesh's loops do.
    ms/iteration of each, at world size 1."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh
    from eddy_currents_3d_tpu_torch.testing.glue import torch_glue

    a64 = ref64[0][0]
    tol = model.solver.tolerance
    out = {}
    with _mesh_of_one():
        mesh = make_mesh(1)
        calls = []
        real = mesh.all_reduce
        object.__setattr__(mesh, "all_reduce",
                           lambda t: calls.append(1) or real(t))
        for label, kw in (("coded", {}), ("field", {"use_coded": False})):
            sim = Simulation(model, torch.float32, mesh=mesh, **kw)
            ref = Simulation(model, torch.float32, device=dev, **kw)
            if sim.shard_op.use_coded != (label == "coded") or (
                    label == "coded" and ref.coded_op is None):
                raise AssertionError(f"{label}: the mesh took another tier")
            n0 = len(calls)
            s1, _ = sim.run(num_steps=1)
            with torch_glue():      # the mesh's glue
                ref.run(num_steps=1)
            n_cap = len(calls) - n0
            gap1 = ((s1.A.cpu().double() - a64).abs().max().item()
                    / (tol * a64.abs().max().item()))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                (st, d), counts = counted(lambda: sim.run(num_steps=5))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sr, dr = ref.run(num_steps=5)
            st2, d2 = sim.run(num_steps=5)
            ms = [x["wall_s"] / x["total_iterations"] * 1e3
                  for x in (d, dr, d2)]
            equal = (torch.equal(st.A, sr.A)
                     and torch.equal(st.carry, sr.carry))
            per_it = counts["coded_matvec"] / d["total_iterations"]
            say(f"[19] mesh of 1 rank over NCCL, team7 f32 x 5 steps, "
                f"{label} tier: iterations {d['iterations']} (unsharded "
                f"{dr['iterations']}, equal: "
                f"{d['iterations'] == dr['iterations']}), A and carry equal "
                f"to the unsharded run's bit for bit: {equal}; step 1 "
                f"{gap1:.3f} tol scale from the f64 CPU run (limit 4); "
                f"captures {sim.captures}; all-reduce calls {n_cap} by the "
                f"first step's capture, {len(calls) - n0 - n_cap} after; no "
                f"sync flagged; ms/iteration at world size 1: mesh "
                f"{ms[0]:.3f}, {ms[2]:.3f}, unsharded {ms[1]:.3f}; launches "
                f"{counts} ({per_it:.2f} coded_matvec a solver iteration)")
            ok = (sim.captures == 1 and n_cap > 0
                  and len(calls) == n0 + n_cap and gap1 <= 4.0
                  and not d["unconverged_steps"])
            if label == "field":
                ok = ok and (equal and d["iterations"] == dr["iterations"]
                             == F32_FIELD_ITERS_TORCH[:5]
                             and counts["field_a"] >= 2 * d["total_iterations"]
                             and counts["coded_matvec"] == 0)
            else:
                ok = ok and (counts["coded_matvec"] >= 2 * d["total_iterations"]
                             and counts["field_a"] == 0)
                out = {"launches": counts["coded_matvec"],
                       "per_iteration": per_it, "ms_per_iteration": ms[0],
                       "iterations": d["iterations"]}
            if not ok:
                raise AssertionError(f"the {label} mesh of one rank failed "
                                     "its checks")
    return out


def phase_cli_mesh(dev):
    """[19] the CLI on a mesh of one rank over NCCL, as a subprocess:
    python -m eddy_currents_3d_tpu_torch in.vxc --mesh 1 (team7, 3 steps,
    an output every step) starts its own one-rank group on the card; it
    exits 0, names world size 1 and the coded tier on its backend line, and
    writes the one-device CLI's files, the fields within 4 tol of scale."""
    from eddy_currents_3d_tpu_torch.io.vtk import read_vtk_vectors
    from eddy_currents_3d_tpu_torch.testing.cases import case_static

    text = case_static(shape_xyz=(102, 102, 24), steps=3, jump=0.001)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.vxc"), "w") as f:
            f.write(text)
        one = _cli(["in.vxc", "-o", "one"], tmp)
        mesh = _cli(["in.vxc", "-o", "mesh", "--mesh", "1"], tmp)
        line = _cli_line(mesh, "backend")
        names = sorted(os.listdir(os.path.join(tmp, "one")))
        if ("x1," not in line or "coded per block of 1x1" not in line
                or sorted(os.listdir(os.path.join(tmp, "mesh"))) != names
                or not names):
            raise AssertionError(f"CLI --mesh 1: {line}, files {names}")
        gap = 0.0
        for n in names:
            if not n.startswith("field_"):
                continue
            a = read_vtk_vectors(os.path.join(tmp, "one", n))["Field_A"]
            b = read_vtk_vectors(os.path.join(tmp, "mesh", n))["Field_A"]
            gap = max(gap, np.abs(a - b).max() / (5e-3 * np.abs(a).max()))
    total = [ln for ln in mesh.splitlines() if "iterations total" in ln]
    say(f"[19] CLI --mesh 1 over NCCL: {line}; {_cli_line(mesh, 'Tcalc')}; "
        f"{total}; {len(names)} files as the one-device CLI's, Field_A within "
        f"{gap:.3f} tol scale of them (limit 4); one device: "
        f"{_cli_line(one, 'backend')}")
    if not gap <= 4.0:
        raise AssertionError(f"CLI --mesh 1: {gap} tol scale")


def _vcycle_launches(mg):
    """field_a launches of one V-cycle of ``mg`` (parallel/shard_mg.py):
    two applies a level but the coarsest (the residual and the one
    post-smoothing sweep), coarse_sweeps - 1 on the coarsest, every
    distributed level's once a block."""
    nb = len(mg.meshes)
    if mg.rep is None:
        return nb * 2 * (len(mg.levels) - 1) + mg.coarse_sweeps - 1
    return (nb * 2 * len(mg.levels) + 2 * (len(mg.rep.levels) - 2)
            + mg.coarse_sweeps - 1)


def phase_mesh_mg(recs, model, dev, ref64):
    """[20] the multigrid V-cycle on a mesh (parallel/shard_mg.py) at team7:

    * in one process, the ghosts and the gather handed over locally: team7
      in 2 and 4 z slabs and 2x2 (z, y) blocks, float32, the distributed
      V-cycle against the single-device V-cycle on the card on the same
      input, and both against the plain V-cycle (build_mg(kernels=False):
      torch ops in place of field_a at every level, the block levels'
      (3, 6, 102, 102), (3, 12, 51, 102), (3, 3, 51, 51) and the replicated
      (3, 6, 26, 26), (3, 3, 13, 13) included), within SLAB_TOL of scale,
      its field_a launches a V-cycle (_vcycle_launches), and its time
      against the single-device one's;
    * Simulation(precond="mg", mesh=make_mesh(1)) over NCCL, graphed, 5
      steps under set_sync_debug_mode("error"): float32 within 4 tol scale
      of the float64 CPU mg run after step 1 and bit for bit with the
      unsharded mg run on the mesh's (torch) glue (a mesh of one holds
      every level and gathers nothing), field_a launched at least 2 + 2 x (one V-cycle's
      launches) a solver iteration (two applies and two V-cycles; the
      setup's apply and the finish's V-cycle besides); float64 within
      F64_GAP of scale of the unsharded float64 mg run on the card with
      the same iterations;
    * use_shard_map=False over NCCL (the JAX package's GSPMD tier) bit for
      bit with the field mesh (use_coded=False), 5 steps, within 4 tol
      scale of phase 6's float64 CPU run (``ref64``) after step 1;

    ms/iteration of each mesh run beside its unsharded run's.  Returns
    field_a's record of the float32 mesh mg run."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh
    from eddy_currents_3d_tpu_torch.parallel.shard_mg import (handover_vcycle,
                                                              in_process_mg)
    from eddy_currents_3d_tpu_torch.solvers.multigrid import build_mg
    from eddy_currents_3d_tpu_torch.testing.glue import torch_glue

    system = recs["team7"]["system"]
    ka = system.op.ka
    one = build_mg(ka, dtype=torch.float32, device=dev)
    r = _inputs(model, dev, 8)[0].A
    plain = build_mg(ka, dtype=torch.float32, device=dev,
                     kernels=False).apply_scalar(r)
    (ref, counts) = counted(lambda: one.apply_scalar(r))
    torch.cuda.synchronize()
    one_ms = cuda_ms(lambda: one.apply_scalar(r), 10)
    scale = ref.abs().max().item()
    pscale = plain.abs().max().item()
    one_err = (ref - plain).abs().max().item() / pscale
    say(f"[20] single-device V-cycle at team7 on the card: levels "
        f"{[lvl.shape for lvl in one.levels]}, field_a launches "
        f"{counts['field_a']} a V-cycle, {one_ms * 1e3:.1f} us; against the "
        f"plain V-cycle err {one_err:.2e} of scale (limit {SLAB_TOL:g})")
    if not one_err <= SLAB_TOL:
        raise AssertionError(f"single-device V-cycle vs plain: {one_err}")
    errs = {"plain": one_err}
    for dims in ((2, 1), (4, 1), (2, 2)):
        sops = _blocks(system, *dims, dev)
        mg = in_process_mg(ka, sops, dtype=torch.float32)
        got, counts = counted(lambda: handover_vcycle(mg, sops, r))
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item() / scale
        perr = (got - plain).abs().max().item() / pscale
        want = _vcycle_launches(mg)
        ms = cuda_ms(lambda: handover_vcycle(mg, sops, r), 10)
        g = len(mg.levels) - 1
        say(f"[20] team7 V-cycle on {dims[0]}x{dims[1]} (z, y) blocks in one "
            f"process: blocks hold levels {[lvl.shape for lvl in mg.levels]}"
            + (f", gather at level {g} (replicated levels "
               f"{[lvl.shape for lvl in mg.rep.levels[1:]]})"
               if mg.rep is not None else ", no gather")
            + f"; against the single-device V-cycle err {err:.2e} of scale, "
            f"against the plain one {perr:.2e} (limit {SLAB_TOL:g}); field_a "
            f"launches {counts['field_a']} "
            f"(expected {want}); {ms * 1e3:.1f} us a V-cycle in one process "
            f"(block copies and hand-overs included), single device "
            f"{one_ms * 1e3:.1f} us")
        if not (max(err, perr) <= SLAB_TOL and counts["field_a"] == want):
            raise AssertionError(f"mesh V-cycle {dims}: err {err}, against "
                                 f"plain {perr}, field_a {counts['field_a']} "
                                 f"(expected {want})")
        errs[f"{dims[0]}x{dims[1]}"] = max(err, perr)
    tol = model.solver.tolerance
    out = {"vcycle_max_err": max(errs.values())}
    # step 1 of the float64 CPU runs: mg's, and phase 6's unpreconditioned
    mg64, _ = Simulation(model, torch.float64, device="cpu",
                         precond="mg").run(num_steps=1)
    runs = (("mg f32", torch.float32, {"precond": "mg"}, {"precond": "mg"},
             mg64.A),
            ("mg f64", torch.float64, {"precond": "mg"}, {"precond": "mg"},
             mg64.A),
            ("use_shard_map=False", torch.float32, {"use_shard_map": False},
             None, ref64[0][0]))
    with _mesh_of_one():
        mesh = make_mesh(1)
        for label, dtype, kw, one_kw, a64 in runs:
            sim = Simulation(model, dtype, mesh=mesh, **kw)
            ref = (Simulation(model, dtype, device=dev, **one_kw)
                   if one_kw is not None else
                   Simulation(model, dtype, mesh=mesh, use_coded=False))
            if sim.shard_op.use_coded or ref.shard_op is not None and \
                    ref.shard_op.use_coded:
                raise AssertionError(f"{label}: the mesh took the coded tier")
            s1, _ = sim.run(num_steps=1)
            with torch_glue():      # the mesh's glue
                ref.run(num_steps=1)
            gap1 = ((s1.A.cpu().double() - a64).abs().max().item()
                    / (tol * a64.abs().max().item()))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                (st, d), counts = counted(lambda: sim.run(num_steps=5))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sr, dr = ref.run(num_steps=5)
            st2, d2 = sim.run(num_steps=5)
            ms = [x["wall_s"] / x["total_iterations"] * 1e3
                  for x in (d, dr, d2)]
            equal = (torch.equal(st.A, sr.A)
                     and torch.equal(st.carry, sr.carry))
            gap = ((st.A - sr.A).abs().max().item()
                   / sr.A.abs().max().item())
            per_it = counts["field_a"] / d["total_iterations"]
            say(f"[20] mesh of 1 rank over NCCL, team7 x 5 steps, {label}: "
                f"iterations {d['iterations']} (unsharded"
                f"{'' if one_kw is not None else ' field mesh'} "
                f"{dr['iterations']}), A and carry bit for bit: {equal}, "
                f"max |dA| / scale {gap:.2e}; step 1 {gap1:.3f} tol scale "
                f"from the f64 CPU {'mg ' if one_kw else ''}run; captures "
                f"{sim.captures}; no sync "
                f"flagged; ms/iteration at world size 1: mesh {ms[0]:.3f}, "
                f"{ms[2]:.3f}, unsharded {ms[1]:.3f}; launches {counts} "
                f"({per_it:.2f} field_a a solver iteration)")
            ok = (sim.captures == 1 and not d["unconverged_steps"]
                  and d["iterations"] == dr["iterations"]
                  and counts["coded_matvec"] == 0)
            if dtype == torch.float64:
                ok = ok and gap <= F64_GAP and counts["field_a"] == 0
            else:
                ok = ok and equal and gap1 <= 4.0
            if label == "mg f32":
                vc = _vcycle_launches(sim._mg)
                ok = ok and counts["field_a"] >= (2 + 2 * vc) * d[
                    "total_iterations"]
                out.update(launches=counts["field_a"], per_iteration=per_it,
                           per_vcycle=vc, ms_per_iteration=ms[0],
                           one_device_ms_per_iteration=ms[1],
                           iterations=d["iterations"])
            if not ok:
                raise AssertionError(f"the {label} mesh of one rank failed "
                                     "its checks")
    return out


def phase_device_times(recs, dev):
    """Device µs per call (torch.profiler, 20 calls) of the kernels other
    than bsr_spmm at the shapes their JSON records use (team7 for the field
    kernels, at float32 and at bfloat16 state)."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 coded_stencil)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    out = {}
    t7 = recs["team7"]
    op = t7["op"]
    x, w = _inputs(t7["model"], dev, 0)
    out["coded_matvec"] = device_ms(lambda: coded_matvec(op, x.A, x.U, w),
                                    "whole_march")
    s = recs["scale256"]
    sop = s["op"]
    zb0, zb1 = sop.cond_z
    xs, ws = _inputs(s["model"], dev, 1)
    Uc = xs.U[zb0:zb1]
    wc = State(ws.A, ws.U[zb0:zb1])
    buf = torch.empty_like(xs.A)
    out["coded_stencil"] = device_ms(lambda: coded_stencil(sop, xs.A, ws.A),
                                     "stencil_march")
    out["coded_slab"] = device_ms(
        lambda: coded_slab(sop, xs.A, Uc, buf, wc), "slab_march")
    # the field pair at team7 (the records' shape) and at scale256, at
    # float32 and at bfloat16 state (the route pair_route chooses, the
    # paired one, and the scalar one asked for by name)
    for grid, (rec, xg) in (("", (t7, x)), (" scale256", (s, xs))):
        fop = _field_op(rec["system"], torch.float32)
        yb = field_a(fop.ka, xg.A)
        out["field_a" + grid] = device_ms(lambda: field_a(fop.ka, xg.A),
                                          "field_a")
        out["field_u" + grid] = device_ms(
            lambda: field_u(fop, xg.A, xg.U, yb), "field_u")
        bop = _field_op(rec["system"], torch.bfloat16)
        xb = _bf16_state(xg)
        ybb = field_a(bop.ka, xb.A)
        for route, tag in ((None, ""), ("scalar", " scalar")):
            out["field_a_bf16" + tag + grid] = device_ms(
                lambda: field_a(bop.ka, xb.A, route=route), "field_a")
            out["field_u_bf16" + tag + grid] = device_ms(
                lambda: field_u(bop, xb.A, xb.U, ybb, route=route), "field_u")
    say("[16] device us per call (torch.profiler, 20 calls; field kernels "
        "at team7, and at scale256 where named; bf16 on the paired route "
        "unless scalar is named): " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v * 1e3:.2f}'}"
            for k, v in out.items()))
    return out


def phase_field_details(logs, dev):
    """The field kernels' resources: ptxas registers and spills from the
    build log, and registers and resident CTAs per SM at the threads a CTA
    each launches with."""
    from eddy_currents_3d_tpu_torch.ops.field_cuda import (KERNEL_NAMES,
                                                           field_a)

    log = logs.get("field_stencil", "")
    for kernel, pattern in KERNEL_NAMES.items():
        info = field_a.info(kernel, dev)
        say(f"[16] {kernel}: ptxas {_ptxas(log, pattern)}; runtime "
            f"{info['registers']} registers, {info['ctas_per_sm']} CTAs of "
            f"{info['threads']} threads per SM, {info['local_bytes']} B "
            f"local per thread")


def _ptxas(log, pattern):
    """The build log's ptxas lines (spills; registers and static shared
    memory) of the entry function whose mangled name holds ``pattern``."""
    lines = log.splitlines()
    for j, line in enumerate(lines):
        if "Compiling entry function" in line and pattern in line:
            out = []
            for nxt in lines[j + 1:j + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "spill" in nxt or "Used" in nxt:
                    out.append(nxt.strip().replace("ptxas info    : ", ""))
            return "; ".join(out)
    return "not in the build log"


def phase_march_details(recs, logs, per_call, dev):
    """The march kernels: coded_matvec's plan at team7 and the split pair's
    at 256x256x64, each kernel's resources, and the device launches per
    apply_dots that phases 3 and 4 measured."""
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import (
        AIR_CHUNK, COND_CHUNK, WHOLE_TY, coded_matvec, whole_plan)
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (
        CHUNK, SLAB_TILE, STENCIL_TILE, coded_slab, coded_stencil, plan_of)

    op = recs["team7"]["op"]
    nz, ny, nx = op.shape_zyx
    zb0, zb1 = op.cond_z
    plan = whole_plan(op.shape_zyx, op.cond_z, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    say(f"[16] whole plan at {nx}x{ny}x{nz}, conductor z {zb0}..{zb1 - 1}: "
        f"coded_matvec segments of {32 * WHOLE_TY} columns (one a thread), "
        f"conducting runs of <= {COND_CHUNK} planes, the others <= "
        f"{AIR_CHUNK}, runs (first, last, conducting) {list(plan.runs)}: "
        f"{plan.segments} segments x {len(plan.runs)} runs = {plan.items} items "
        f"for {plan.ctas} CTAs")
    op = recs["scale256"]["op"]
    nz, ny, nx = op.shape_zyx
    zb0, zb1 = op.cond_z
    plan = plan_of(op)
    (svx, sty, sst), (lvx, lty, lst) = STENCIL_TILE, SLAB_TILE
    say(f"[16] split plan at {nx}x{ny}x{nz}, slab z {zb0}..{zb1 - 1}: "
        f"coded_stencil tile {32 * svx}x{sty} cells ({svx} per thread, "
        f"{32 * sty} threads), ring of {sst} planes, runs of <= {CHUNK} "
        f"planes {list(plan.chunks)}: {plan.stencil_tiles} tiles x "
        f"{len(plan.chunks)} runs = {plan.stencil_ctas} CTAs; coded_slab "
        f"tile {32 * lvx}x{lty} cells, ring of {lst} planes, runs "
        f"{list(plan.slab_chunks)}: {plan.slab_ctas} CTAs")
    for name, w, log, pattern in (
            ("coded_matvec", coded_matvec, logs.get("coded_matvec", ""),
             "whole_marchILi1ELb0EE"),
            ("coded_stencil", coded_stencil, logs.get("coded_split", ""),
             "stencil_marchILb1EE"),
            ("coded_slab", coded_slab, logs.get("coded_split", ""),
             "slab_marchILi1ELb0EE")):
        info = w.info(1, False, dev)
        say(f"[16] {name} (apply_dots): ptxas {_ptxas(log, pattern)}; "
            f"runtime {info['registers']} registers, "
            f"{info['static_smem']} B static + {info['dynamic_smem']} B "
            f"dynamic shared memory per CTA, {info['ctas_per_sm']} CTAs "
            f"per SM, {info['local_bytes']} B local per thread")
    say(f"[16] device launches per apply_dots: whole-plane "
        + ", ".join(f"{r['launches_per_apply_dots']:g} at {name}"
                    for name, r in recs.items())
        + f" (phase 3), split {per_call:g} at scale256 (phase 4)")


# phase 17: the solve configurations whose graphed solve is held to the
# the device kernels of each wrapper on the Simulation's path, by the pieces
# of their names in a trace
GRAPH_KERNELS = {"coded_matvec": ("whole_march",),
                 "coded_stencil": ("stencil_march",),
                 "coded_slab": ("slab_march",),
                 "field_a": ("field_a_kernel", "field_a_pairs"),
                 "field_u": ("field_u_kernel", "field_u_pairs"),
                 "solver_glue": ("glue_s", "glue_xr", "glue_p")}
# the share of a wrapper's counted launches its trace must show.  The
# profiler drops some of a graphed run's kernel events now and then while
# the run is unchanged bit for bit (trace_probe.py on an H100: 108 of 113
# and 380 of 432; in this script once 103 of 113), and every graph kernel
# event after ~45 such sessions in one process (this script profiles
# fewer than 20 graphed runs); a launch counted but not run also shows in
# the profiled run's own steps, which phase 17 holds to the eager loop's
TRACE_SHARE = 0.85
# phase 17's configurations, graphed against the eager per-iteration loop,
# each (label, case, Simulation keywords)
GRAPH_CONFIGS = (
    ("team7", "team7", {}),
    ("team7 jacobi", "team7", {"precond": "jacobi"}),
    ("team7 cheb_jacobi", "team7", {"precond": "cheb_jacobi",
                                    "cheb_order": 8}),
    ("team7 ilu0", "team7", {"precond": "ilu0"}),
    ("team7 field", "team7", {"use_coded": False}),
    ("team7 mg", "team7", {"precond": "mg"}),
    ("team7 bf16", "team7", {"dtype": torch.bfloat16,
                             "dot_dtype": torch.float32}),
    ("scale256 split", "scale256", {}),
)


def _chain(sim, n, eager=False):
    """n steps of ``sim`` from a cold start, graphed (or on the eager
    per-iteration loop): (states, infos, wall seconds ended by a
    synchronize)."""
    st = sim.init_state()
    states, infos = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, _ in sim.steps[:n]:
        st, info = sim._step(st, t, eager=eager)
        states.append(st)
        infos.append(info)
    torch.cuda.synchronize()
    return states, infos, time.perf_counter() - t0


def _same_chain(label, got, ref):
    """Raise unless two chains agree bit for bit at every step: iterations,
    converged, relres, A and U."""
    for i, (sg, ig, sr, ir) in enumerate(zip(got[0], got[1], ref[0], ref[1])):
        if ((int(ig.iterations), bool(ig.converged))
                != (ir.iterations, ir.converged)
                or not torch.equal(ig.relres, ir.relres)
                or not torch.equal(sg.A, sr.A) or not torch.equal(sg.U, sr.U)):
            raise AssertionError(
                f"{label} step {i + 1}: graphed ({int(ig.iterations)}, "
                f"{ig.relres.item()}) differs from the eager loop "
                f"({ir.iterations}, {ir.relres.item()})")


def _traced_chain(sim, eager):
    """5 steps of ``sim`` from a cold start under the profiler, the counts
    set to 0 before them and read after the run's launches are settled:
    (the chain (:func:`_chain`), traced kernels, wall seconds, launches by
    counter)."""
    def run():
        out = trace(lambda: _chain(sim, 5, eager=eager))
        sim._settle()
        return out

    sim._settle()           # the earlier runs' launches, outside the count
    (chain, kernels, wall), counts = counted(run)
    return chain, kernels, wall, counts


def _traced_launches(label, kernels, counts):
    """{wrapper: (counted launches, traced events)} of one profiled run;
    raises unless every wrapper's trace shows at most its counted launches
    and at least TRACE_SHARE of them, naming every wrapper's pair."""
    out = {}
    for name, parts in GRAPH_KERNELS.items():
        seen = sum(c for k, (_, c) in kernels.items()
                   if any(p in k for p in parts))
        out[name] = (counts[name], seen)
    bad = [n for n, (c, t) in out.items() if t > c or t < TRACE_SHARE * c]
    out = {k: v for k, v in out.items() if v[0] or v[1]}
    if bad:
        raise AssertionError(
            f"{label}: {', '.join(bad)} outside [{TRACE_SHARE}, 1] of the "
            f"counted launches; counted/traced {out}; the traced run equals "
            f"the eager loop's bit for bit; {len(kernels)} kernel names, "
            f"{sum(c for _, c in kernels.values())} events in the trace")
    return out


def phase_graph(recs, model, dev):
    """[17] The solve as one device program, in each of GRAPH_CONFIGS (team7
    is ``model``, the main path's 20-step case): 5 steps graphed against 5
    on the eager per-iteration loop, bit for bit (iterations, relres, A, U
    at every step); host reads per solve within ceil((n + 1) / K) + 1 (a
    graphed step makes none: its counts stay on the device until a run
    reads them all); one capture per Simulation; ms/iteration and
    ms/step of eager and graphed runs in turns (after one graphed step of
    warm-up, which captures), and each one profiled: device µs per
    iteration and busy share."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.solvers import bicgstab

    cases = {"team7": (model, recs["team7"]["system"]),
             "scale256": (recs["scale256"]["model"],
                          recs["scale256"]["system"])}
    # one graphed step traced first: a process's first profile of a graph
    # once came back without the graph's kernels
    warm = Simulation(model, torch.float32, device=dev,
                      system=recs["team7"]["system"])
    _chain(warm, 1)
    trace(lambda: _chain(warm, 1))
    del warm
    for label, case, kw in GRAPH_CONFIGS:
        kw = dict(kw)
        dtype = kw.pop("dtype", torch.float32)
        case_model, system = cases[case]
        sim = Simulation(case_model, dtype, device=dev,
                         system=system if dtype == torch.float32 else None,
                         **kw)
        t_cap = _chain(sim, 1)[2]            # captures
        # the glue's route: the kernels at float32 on one card
        route = "fused" if dtype == torch.float32 else "torch"
        if {loop.glue for loop in sim._loops.values()} != {route}:
            raise AssertionError(f"{label}: glue routes "
                                 f"{[l.glue for l in sim._loops.values()]}"
                                 f", expected {route}")
        runs = {"eager": [], "graphed": []}
        for mode in ("eager", "graphed", "graphed", "eager"):
            runs[mode].append(_chain(sim, 5, eager=mode == "eager"))
        _same_chain(label, runs["graphed"][0], runs["eager"][0])
        _same_chain(label, runs["graphed"][1], runs["eager"][1])
        infos = runs["graphed"][0][1]
        its = [int(i.iterations) for i in infos]
        reads = [i.reads for i in infos]
        bad = [(n, r) for n, r in zip(its, reads)
               if r > -(-(n + 1) // bicgstab.K) + 1]
        if bad or sim.captures != 1 or not all(bool(i.converged)
                                                for i in infos):
            raise AssertionError(f"{label}: reads {reads} for iterations "
                                 f"{its}, captures {sim.captures}")
        n_it = sum(its)
        ms = {m: [w / n_it * 1e3 for _, _, w in rs] for m, rs in runs.items()}
        t_one = _chain(sim, 1)[2]
        prof, seen = {}, {}
        for mode in ("eager", "graphed"):
            chain, kernels, wall, counts = _traced_chain(sim,
                                                         mode == "eager")
            # the profiled run's own steps: a launch counted but not run
            # would change them
            _same_chain(f"{label} {mode} profiled", chain, runs["eager"][0])
            prof[mode] = _busy(kernels, wall, n_it)
            seen[mode] = _traced_launches(f"{label} {mode}", kernels, counts)
            # the glue kernels: 3 launches an iteration on the fused route
            # (eager and graphed alike), none on the torch glue
            n_prof = sum(int(i.iterations) for i in chain[1])
            want = 3 * n_prof if route == "fused" else 0
            if counts["solver_glue"] != want:
                raise AssertionError(
                    f"{label} {mode}: solver_glue launches "
                    f"{counts['solver_glue']}, expected {want} ({route} "
                    f"glue, {n_prof} iterations)")
        say(f"[17] {label}: 5 steps, iterations {its}, graphed equals eager "
            f"bit for bit, {route} glue; host reads per solve {reads}; capture "
            f"{t_cap - t_one:.3f} s of host time (the first graphed step "
            f"{t_cap:.3f} s, a later one {t_one:.3f}); ms/iteration "
            f"eager {_fmt(ms['eager'])}, graphed {_fmt(ms['graphed'])}; "
            f"profiled: eager {prof['eager']}; graphed {prof['graphed']}; "
            f"launches counted/traced: eager {seen['eager']}, graphed "
            f"{seen['graphed']}")
        del sim


def phase_scan(model, dev):
    """[17] run_scan: team7 20 steps with VTK, byte for byte with run's
    files; a run_scan without outputs under torch.cuda.set_sync_debug_mode
    ("error") (the solves' reads are event waits, which it does not
    flag); and a resume from the checkpoint taken at step 10 gives step
    20's fields bit for bit."""
    from eddy_currents_3d_tpu_torch import Simulation

    sim = Simulation(model, torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "run"), os.path.join(tmp, "scan")
        st_run, _ = sim.run(output_dir=a)
        st_scan, diag = sim.run_scan(output_dir=b)
        names = sorted(os.listdir(a))
        differ = [n for n in names if open(os.path.join(a, n), "rb").read()
                  != open(os.path.join(b, n), "rb").read()]
        if not names or sorted(os.listdir(b)) != names or differ:
            raise AssertionError(f"run_scan VTK files differ from run's: "
                                 f"{differ or names}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            st_free, d_free = sim.run_scan()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ck = os.path.join(tmp, "ck")
        Simulation(model, torch.float32, device=dev).run_scan(
            num_steps=10, checkpoint_dir=ck, checkpoint_every=10)
        st_res, d_res = Simulation(model, torch.float32, device=dev).run_scan(
            checkpoint_dir=ck, checkpoint_every=10, resume=True)
    if not all(torch.equal(getattr(st_res, f), getattr(st_scan, f))
               for f in ("A", "U", "carry")) or d_res["start_step"] != 10:
        raise AssertionError("the run resumed at step 10 differs from the "
                             "uninterrupted run_scan")
    if not (torch.equal(st_scan.A, st_run.A) and torch.equal(st_free.A,
                                                             st_run.A)):
        raise AssertionError("run_scan's final A differs from run's")
    its = diag["iterations"].tolist()
    say(f"[17] run_scan team7 x {len(its)} steps: VTK files ({len(names)}) "
        f"equal run's byte for byte; without outputs {wall / sum(its) * 1e3:.3f}"
        f" ms/iteration with no sync flagged (set_sync_debug_mode error); "
        f"resumed from ckpt_10 equals the uninterrupted run bit for bit "
        f"(iterations {d_res['iterations'].tolist()})")


@contextlib.contextmanager
def _native_io(on):
    """EC3D_NATIVE_IO set to select the native encoder (on) or the numpy
    writers, restored after."""
    prev = os.environ.get("EC3D_NATIVE_IO")
    os.environ["EC3D_NATIVE_IO"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("EC3D_NATIVE_IO", None)
        else:
            os.environ["EC3D_NATIVE_IO"] = prev


def _vtk_run(sim, writer, encoder, out):
    """run()'s diagnostics with VTK to ``out``: writer "overlapped"
    (output_dir: the overlapped writer) or "sync" (on_output writing each
    state as it comes, through io/vtk.py write_outputs), encoder "native"
    or "numpy"; writer None writes nothing."""
    from eddy_currents_3d_tpu_torch.io.vtk import write_outputs

    with _native_io(encoder == "native"):
        if writer is None:
            return sim.run()[1]
        if writer == "overlapped":
            return sim.run(output_dir=out)[1]
        return sim.run(on_output=lambda n, st, i: write_outputs(
            sim, st, i, n, out))[1]


def _same_files(ref, out, label):
    """The number of files in ``out``, each equal to ``ref``'s byte for
    byte (the same names)."""
    import filecmp

    names = sorted(os.listdir(ref))
    differ = [n for n in names if not filecmp.cmp(
        os.path.join(ref, n), os.path.join(out, n), shallow=False)]
    if not names or sorted(os.listdir(out)) != names or differ:
        raise AssertionError(f"{label}: VTK files differ from the "
                             f"synchronous numpy run's: {differ or names}")
    return len(names)


# the writers timed by phase 18, in turns: (writer, encoder); None: no VTK
IO_RUNS = ((None, None), ("sync", "numpy"), ("overlapped", "native"))


def _io_table(label, sim, tmp, rounds):
    """Each of IO_RUNS ``rounds`` times in turns (the order reversed every
    other round) on ``sim``, after a one-step run that captures the
    solve's graphs; every VTK run's files equal the first
    synchronous numpy run's byte for byte.  Returns {(writer, encoder):
    [(ms/step, io s), ...]}."""
    ref = os.path.join(tmp, "sync-numpy")
    table = {}
    sim.run(num_steps=1)        # the first solve captures its graphs
    for r in range(rounds):
        for writer, encoder in (IO_RUNS if r % 2 == 0 else IO_RUNS[::-1]):
            out = os.path.join(tmp, f"{writer}-{encoder}")
            d = _vtk_run(sim, writer, encoder, out)
            if d["unconverged_steps"]:
                raise AssertionError(f"{label}: unconverged steps "
                                     f"{d['unconverged_steps']}")
            table.setdefault((writer, encoder), []).append(
                (d["wall_s"] / d["steps"] * 1e3, d["io_s"]))
            if writer is not None and out != ref:
                _same_files(ref, out, f"{label} {writer} {encoder}")
                shutil.rmtree(out)
    return table


def _say_io(label, table, nbytes):
    parts = []
    for (writer, encoder), runs in table.items():
        name = "no VTK" if writer is None else f"{writer} {encoder}"
        parts.append(f"{name} " + ", ".join(
            f"{ms:.2f} ms/step (io {io:.3f} s)" for ms, io in runs))
    say(f"[18] {label} (a field file of {nbytes / 1e6:.1f} MB): "
        + "; ".join(parts))


def _cli(args, cwd):
    """``python -m eddy_currents_3d_tpu_torch args`` run in ``cwd`` as a
    user runs it; raises unless it exits 0 and prints its Tcalc line.
    Returns its standard output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "eddy_currents_3d_tpu_torch", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "Tcalc = " not in proc.stdout:
        raise AssertionError(
            f"CLI {args} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
            f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def _cli_line(text, key):
    return next(ln for ln in text.splitlines() if ln.startswith(key))


def _matrix_numbers(text):
    """The numbers of the CLI's three matrix lines."""
    import re

    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("matrix"))
    return [float(v) for v in re.findall(r"[=:] ([0-9.e+-]+)",
                                         " ".join(lines[i:i + 3]))]


def phase_cli(dev):
    """[18] The run as users start it, python -m eddy_currents_3d_tpu_torch
    in.vxc on the card, and the overlapped VTK writer with the native
    encoder.  Fails on any fault."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.__main__ import main as cli_main
    from eddy_currents_3d_tpu_torch.models.vxc import read_vxc
    from eddy_currents_3d_tpu_torch.sim.simulate import _schedule
    from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

    text = case_static(shape_xyz=(102, 102, 24), steps=20)
    model = load_case(text)
    nbytes = 60 * model.n_cells
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.vxc"), "w") as f:
            f.write(text)
        # the in-process reference first: the synchronous numpy run, whose
        # files every other writer must equal; then each writer in turns
        sim = Simulation(model, torch.float32, device=dev)
        table = _io_table("team7 x 20 steps, an output every step", sim,
                          tmp, 2)
        ref = os.path.join(tmp, "sync-numpy")
        # the entry point as a user runs it, and with --scan
        outs = {}
        for extra in ([], ["--scan"]):
            out = "out" + "".join(extra).replace("-", "_")
            stdout = _cli(["in.vxc", "-o", out, *extra], tmp)
            n_files = _same_files(ref, os.path.join(tmp, out),
                                  f"CLI {extra}")
            outs[" ".join(["python -m ... in.vxc", *extra])] = (
                _cli_line(stdout, "Tcalc"), _cli_line(stdout, "backend"),
                n_files)
            st = sim.system.matrix_stats()
            want = [st[k] for k in ("nnz_x", "nnz_y", "nnz_z", "nnz_u",
                                    "bnd_x", "bnd_y", "bnd_z", "nnz")]
            want.append(float(f"{st['density_pct']:.5g}"))
            if _matrix_numbers(stdout) != want:
                raise AssertionError(f"CLI matrix line "
                                     f"{_matrix_numbers(stdout)} against "
                                     f"matrix_stats() {want}")
        # the same entry point in this process, its kernels counted
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            rc, counts = counted(lambda: cli_main(["in.vxc", "-o", "counted",
                                                   "-q"]))
        finally:
            os.chdir(cwd)
        _same_files(ref, os.path.join(tmp, "counted"), "CLI main()")
        if rc != 0 or counts["coded_matvec"] <= 0:
            raise AssertionError(f"CLI main() rc {rc}, launches {counts}")
        # the loop's thread makes no synchronizing call with an output every
        # step (the writer's threads wait on events, which the check does
        # not flag)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            d_sync = sim.run(output_dir=os.path.join(tmp, "nosync"))[1]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _same_files(ref, os.path.join(tmp, "nosync"), "run under the check")
        for out in ("out", "out__scan", "counted", "nosync"):
            shutil.rmtree(os.path.join(tmp, out))
    for run, (tcalc, backend, n_files) in outs.items():
        say(f"[18] {run}: {n_files} VTK files equal the in-process "
            f"synchronous numpy run's byte for byte; matrix line equals "
            f"matrix_stats(); {backend.strip()}; {tcalc.strip()}")
    say(f"[18] CLI main() in this process: kernel launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    say(f"[18] run(output_dir) under set_sync_debug_mode('error'): no "
        f"synchronizing call, {d_sync['wall_s'] / d_sync['steps'] * 1e3:.2f}"
        f" ms/step, io {d_sync['io_s']:.3f} s")
    _say_io("team7 x 20 steps, 19 outputs", table, nbytes)

    # moving sources through the writer: examples/moving_coil.vxc
    example = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "moving_coil.vxc")
    mc = read_vxc(example)
    want = sorted(f"{k}_{o}.vtk" for _, o in _schedule(mc.tran)
                  if o is not None for k in ("field", "src"))
    with tempfile.TemporaryDirectory() as tmp:
        stdout = _cli([example, "-o", "out"], tmp)
        got = sorted(os.listdir(os.path.join(tmp, "out")))
    if got != want or " 0 unconverged step(s)" not in stdout:
        raise AssertionError(f"moving_coil: {len(got)} files of "
                             f"{len(want)}; {_cli_line(stdout, 'solver    : ')}")
    say(f"[18] examples/moving_coil.vxc through the CLI: {len(got)} VTK "
        f"files, every step converged; {_cli_line(stdout, 'Tcalc').strip()}"
        f"; {stdout.splitlines()[-1].strip()}")

    # one output of a large grid: what its user waits for
    big = load_case(case_static(shape_xyz=(256, 256, 64), steps=2))
    sim = Simulation(big, torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        table = _io_table("scale256 x 2 steps, one output", sim, tmp, 1)
    _say_io("scale256 x 2 steps, one output", table, 60 * big.n_cells)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.testing.cases import (case_convection,
                                                          case_static,
                                                          load_case)

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    card = phase_device()
    logs = phase_build()
    grids = [
        ("team7", case_static(shape_xyz=(102, 102, 24), steps=3)),
        ("convection", case_convection(shape_xyz=(48, 24, 16), steps=3)),
        ("scale256", case_static(shape_xyz=(256, 256, 64), steps=5)),
    ]
    recs = phase_kernel_vs_plain(grids, dev)
    split_recs = phase_split_vs_plain([grids[2], grids[1]], dev)
    phase_glue(dev)
    model, matvec_launches = phase_main_path(dev)
    f64_ref = phase_cross_check(model, dev)
    split_counts = phase_scale(recs["scale256"], dev)
    phase_precond(model, dev)
    phase_graph(recs, model, dev)
    phase_scan(model, dev)
    nocond = load_case(_nocond_text((102, 102, 24)))
    field_grids = [(name, recs[name]["model"], recs[name]["system"])
                   for name in ("team7", "convection", "scale256")]
    field_grids.insert(2, ("no-conductor", nocond, assemble_operator(
        nocond, torch.float32, dev)))
    field_recs = phase_field_vs_plain(field_grids, dev)
    field_counts = phase_field_team7(model, dev)
    phase_field_scale(recs["scale256"], dev)
    phase_no_conductor(dev)
    t7 = recs["team7"]
    B, csr, setup, bsr_recs = phase_bsr_vs_plain(t7["model"], t7["system"],
                                                 dev)
    bsr_launches = phase_matrix_solve(model, dev, B, csr, setup)
    del B
    phase_ilu0(model, dev)
    bf16_recs = phase_bf16_kernels(field_grids, dev)
    bf16_lib_ms, bf16_lib = csr_bf16_library(t7["model"], t7["system"], csr,
                                             dev)
    say(f"[15b] library yardstick of the bf16-state field pair at team7: "
        f"its CSR as torch.sparse_csr_tensor(...).to(torch.bfloat16) @ x "
        f"{bf16_lib}")
    bf16_counts = phase_bf16_team7(model, dev)
    phase_bf16_scale(recs["scale256"], dev)
    odd = load_case(case_static(shape_xyz=(101, 101, 24), steps=3))
    f32c_recs, f32c_dev = phase_f32coef_kernels(
        field_grids[:2] + [("odd", odd, assemble_operator(
            odd, torch.float32, dev))], dev)
    dev_times = phase_device_times(recs, dev)
    dev_times.update(f32c_dev)
    phase_march_details(recs, logs,
                        split_recs["scale256"]["launches_per_apply_dots"], dev)
    phase_field_details(logs, dev)
    dev_times["bsr_spmm"] = bsr_recs[1]["device_ms"]
    dev_times["bsr_spmm_tiles"] = bsr_recs[128]["device_ms"]
    s256 = recs["scale256"]
    csr256_ms, t_csr256 = csr_library_ms(s256["model"], s256["system"], dev)
    say(f"[16] library yardstick of the split pair at 256x256x64: its CSR "
        f"(to_csr {t_csr256:.2f} s on the host) as torch.sparse_csr_tensor "
        f"@ x {csr256_ms * 1e3:.2f} us")
    # after every profiled phase: with it before them, later traces
    # dropped kernels' events (not measured; cause not found)
    phase_cli(dev)
    # phase 19, which profiles nothing: float64 and the float32 flat-roll
    # tier on the card, bfloat16 state with float32 coefficients, the
    # per-slab kernels and a mesh of one rank over NCCL
    phase_f64_card(model, dev, f64_ref, csr)
    phase_flat_f32(model, dev)
    f32c_counts = phase_f32coef_team7(model, dev, f64_ref)
    phase_slab_kernels(recs, dev)
    slab_err = phase_slab_coded(recs, dev)
    mesh_rec = phase_mesh_nccl(model, dev, f64_ref)
    phase_cli_mesh(dev)
    mesh_mg = phase_mesh_mg(recs, model, dev, f64_ref)

    # bytes each function must move (inputs read once, outputs written
    # once) and its FP32 operations, at the shapes of its record
    n7 = int(np.prod(t7["model"].shape_zyx))
    c7 = t7["model"].n_cond
    s256 = recs["scale256"]["model"]
    nz, ny, nx = s256.shape_zyx
    zb0, zb1 = recs["scale256"]["op"].cond_z
    slab = (zb1 - zb0) * ny * nx
    own = nz * ny * nx - slab
    f7 = field_recs[("team7", "f32")]
    b7 = bf16_recs[("team7", "paired")]
    fc7 = f32c_recs[("team7", "paired")]
    box7 = t7["system"].op.box
    nbox7 = (box7[1] - box7[0]) * (box7[3] - box7[2]) * (box7[5] - box7[4])
    zc0, zc1 = t7["op"].cond_z
    _, ny7, nx7 = t7["model"].shape_zyx
    bounds = {
        # apply_dots: A, w.A read and yA, yU written on every plane; U,
        # code, cf, w.U read on the conductor's planes only (elsewhere
        # every code is 0, so yU is 0 and w.U adds nothing to the dots)
        "coded_matvec": bound(40 * n7 + 16 * (zc1 - zc0) * ny7 * nx7,
                              2 * (21 * n7 + 31 * c7) + 16 * n7),
        # apply_dots over the planes outside the slab: A, w.A read, yA written
        "coded_stencil": bound(36 * own, 42 * own + 12 * own),
        # apply_dots over the slab: as coded_matvec, on the slab's cells
        "coded_slab": bound(56 * slab, 2 * (21 * slab + 31 * s256.n_cond)
                            + 16 * slab),
        "field_a": bound(f7["field_a"]["bytes"], 2 * 21 * n7),
        "field_u": bound(f7["field_u"]["bytes"], 2 * 31 * nbox7),
        "field_a_bf16": bound(b7["field_a"]["bytes"], 2 * 21 * n7),
        "field_u_bf16": bound(b7["field_u"]["bytes"], 2 * 31 * nbox7),
        "field_a_f32coef": bound(fc7["field_a"]["bytes"], 2 * 21 * n7),
        "field_u_f32coef": bound(fc7["field_u"]["bytes"], 2 * 31 * nbox7),
    }

    def record(name, launches, rec, mode=None, library_ms=None, **extra):
        t = rec["times"] if mode is None else rec["times"][mode]
        b_ms, b_by = rec["bound"] if "bound" in rec else bounds[name]
        return {"name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": t[0], "plain_ms": t[1],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                **extra}

    # the coded and field operators' library call is their exported CSR
    # @ x (csr_library_ms): for the split pair and the field pair, it
    # computes what the pair computes together, and stands in both records
    # coded_matvec on the coded mesh of one rank (phase 19): its launches
    # over the 5-step run and a solver iteration, and the per-slab check's
    # largest error
    kernels = [record("coded_matvec", matvec_launches, recs["team7"],
                      "apply_dots", library_ms=bsr_recs["csr_ms"],
                      mesh={"launches": mesh_rec["launches"],
                            "per_iteration": mesh_rec["per_iteration"],
                            "ms_per_iteration": mesh_rec["ms_per_iteration"],
                            "per_slab_max_err": slab_err})]
    for name in ("coded_stencil", "coded_slab"):
        rec = dict(split_recs["scale256"][name])
        rec["max_abs_err"] = max(r[name]["max_abs_err"]
                                 for r in split_recs.values())
        kernels.append(record(name, split_counts[name], rec, "apply_dots",
                              library_ms=csr256_ms))
    # field_a also carries phase 20's mg on a mesh of one rank: its
    # launches over the 5-step run, a solver iteration and a V-cycle, and
    # the in-process V-cycle's largest error against one device's
    for name in ("field_a", "field_u"):
        rec = dict(field_recs[("team7", "f32")][name])
        rec["max_abs_err"] = max(r[name]["max_abs_err"]
                                 for r in field_recs.values() if name in r)
        extra = {"mesh_mg": mesh_mg} if name == "field_a" else {}
        kernels.append(record(name, field_counts[name], rec,
                              library_ms=bsr_recs["csr_ms"], **extra))
    kernels.append(record("bsr_spmm", bsr_launches, bsr_recs[1],
                          library_ms=bsr_recs[1]["library_ms"],
                          kernel_route="vec"))
    # the tiles route at team7, k = 128: float32, with float64 beside it
    f64 = bsr_recs["128 f64"]
    kernels.append(record(
        "bsr_spmm_tiles", bsr_recs["tiles_launches"], bsr_recs[128],
        library_ms=bsr_recs[128]["library_ms"], kernel_route="tiles",
        f64={"ms": f64["times"][0], "plain_ms": f64["times"][1],
             "device_ms": f64["device_ms"], "bound_ms": f64["bound"][0],
             "bound_by": f64["bound"][1], "max_abs_err": f64["max_abs_err"],
             "library_ms": f64["library_ms"]}))
    # the bfloat16-state pair: the paired route's record (the one the main
    # path takes), the largest error over both routes and every grid, the
    # launches on each route, and the pair's bfloat16 CSR yardstick
    for name in ("field_a", "field_u"):
        rec = dict(b7[name])
        rec["max_abs_err"] = max(r[name]["max_abs_err"]
                                 for r in bf16_recs.values() if name in r)
        kernels.append(record(
            f"{name}_bf16", bf16_counts[f"{name}_bf16"], rec,
            library_ms=bf16_lib_ms, kernel_route="paired",
            launches_by_route={r: bf16_counts[f"{name}_{r}"]
                               for r in FIELD_ROUTES}))
    # bfloat16 state with float32 coefficients: field_a's paired record
    # (field_a_pairs_f32) and field_u's scalar one, the largest error over
    # phase 19's grids and routes, the launches of phase 19's 5-step team7
    # run on each route, and the f32 CSR @ x yardstick
    for name, route in (("field_a", "paired"), ("field_u", "scalar")):
        rec = dict(fc7[name])
        rec["max_abs_err"] = max(r[name]["max_abs_err"]
                                 for r in f32c_recs.values() if name in r)
        kernels.append(record(
            f"{name}_f32coef", f32c_counts[f"{name}_f32coef"], rec,
            library_ms=bsr_recs["csr_ms"], kernel_route=route,
            launches_by_route={r: f32c_counts[f"{name}_{r}"]
                               for r in FIELD_ROUTES}))
    for k in kernels:
        d = dev_times[k["name"]]
        say(f"[16] {k['name']}: events {k['ms'] * 1e3:.2f} us, device "
            + ("not measured" if d is None else f"{d * 1e3:.2f} us")
            + f", bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}, "
            f"plain {k['plain_ms'] * 1e3:.2f} us, library "
            + ("none" if k["library_ms"] is None
               else f"{k['library_ms'] * 1e3:.2f} us")
            + f", launches {k['launches']}")
    say(f"[16] whole run {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
