#!/usr/bin/env python3
"""Smoke run of the PyTorch port (eddy_currents_3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the kernels' three sources (csrc/coded_matvec.cu,
   csrc/coded_split.cu, csrc/field_stencil.cu) with nvcc, all at once, and
   load them;
3. the whole-plane kernel (coded_matvec) against its plain torch version on
   the card, for apply, apply_dots and apply_div, on case_static
   102x102x24, a small case_convection and case_static 256x256x64, with the
   CPU tests' tolerances (3e-6 x output scale; dots 2e-5 relative), and the
   time per call of each;
4. the split route's kernels (coded_stencil, coded_slab) against their plain
   versions the same way, for apply, apply_dots and apply_div, on
   case_static 256x256x64 (its compact U: the conductor's 5 planes) and the
   small case_convection (the slab kernel's convection branch);
5. the main path: Simulation(float32, device="cuda").run(output_dir=...)
   over 20 steps of case_static 102x102x24; every step converges, A and
   the carry are finite, the VTK files exist, and the whole-plane kernel's
   launch count is at least 2 x the solver iterations;
6. the first 5 steps of the same case on the card at float32 against the
   port at float64 on the CPU (flat-roll operator): each float32 step taken
   from the float64 state within 4 tol scale; the free float32 run within
   4 tol scale after the first step and 8 after the fifth (see
   phase_cross_check);
7. the main path at 256x256x64, 5 steps, on the split route (the default
   there: both split kernels launch, the whole-plane kernel never) and on
   the whole-plane kernel with a full-shape U, in turns (split, whole,
   whole, split); every step converges, and the two routes' A agree within
   4 tol scale after one step; ms/step, ms/iteration and iterations of
   each;
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
   least 2 x the solver iterations and no coded kernel launches; then 3 mg
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
   (4, 8) and (8, 16) blocks, k in {1, 4, 128}, float32 and float64; and
   team7's exported operator (to_csr) as (8, 8) float32 blocks at k = 1
   and k = 128.  Tolerance 3e-6 (float32) and 1e-12 (float64) of
   max(|B|·|X|): both sides sum at most width·C products, in other orders.
   For team7: device µs (torch.profiler) and CUDA-event µs over 50 calls,
   the plain version's µs, bytes and bound, and the library call's µs
   (torch.sparse_bsr_tensor of scipy's unpadded BSR @ X; the port never
   calls it);
14. the matrix-form solve at team7: two consecutive main-path solutions
   x_{k-1}, x_k (float32 on the card, warm_start="previous") flattened to
   the reference's [Ax|Ay|Az|U]; bsr_matvec(B, x_k) equals the coded
   operator's apply within 3e-6 of max(|B|·|x|); BiCGSTABwr on
   bsr_matvec solves B x = b (b = B x_k in float64 on the host) from
   x_{k-1}, with the true residual, recomputed in float64 on the host,
   below tol and bsr_spmm launched at least twice per iteration; then
   bicgstab_ilu0 on the CSR on the card (the ELL sweep tier) converges
   too; iterations, ms/iteration and the host setup seconds;
15. team7 with precond="ilu0", 20 steps on the coded route (full-shape U)
   and 20 with use_coded=False: every step converges, A is finite,
   field_a launches at least 8 x the iterations (two preconditioner
   applies per iteration, each 2 + 2 factor sweeps) and no split kernel
   launches; the factor operators' field_a/field_u against their plain
   versions; then 3 ilu0 steps on the card, each from the float64 CPU ilu0
   state, within 4 tol scale;
16. device µs per call (torch.profiler) of the five earlier kernels at
   the shapes of their records, and each kernel's summary: events, device
   time, bound, plain version and main-path launches.

Any failure raises and the exit code is not 0.  The line before the last
is the card's name and power limit; the one before it the kernels' JSON
record, each kernel's launches counted over the main path it serves
(phase 5 for coded_matvec, phase 7's first split run for the split pair,
phase 10's use_coded=False run for field_a and field_u, phase 14's BSR
solve for bsr_spmm), with its bound (bytes over 3.35 TB/s or operations
over 67 TFLOP/s FP32, the larger) and the library call's time where one
PyTorch call computes the same function; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 1
and prints no result.
"""

import contextlib
import dataclasses
import json
import os
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
           "ilu0_host")
HBM_PEAK = 3.35e12  # B/s, H100 SXM data sheet
FP32_PEAK = 67e12   # FLOP/s outside the tensor cores, H100 SXM data sheet
SPMM_TOL = {torch.float32: 3e-6, torch.float64: 1e-12}
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


def _busy(kernels, wall, iters):
    """Device µs per iteration and busy share of a traced run."""
    dev_s = sum(t for t, _ in kernels.values()) / 1e6
    if dev_s <= 0:
        return "device time not measured"
    return (f"device {dev_s / iters * 1e6:.0f} us/iteration, busy "
            f"{dev_s / wall:.1%}")


def bound(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM peak and the FP32 operations over the FP32 peak."""
    t_b, t_o = nbytes / HBM_PEAK * 1e3, ops / FP32_PEAK * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def wrappers():
    """{kernel name: its wrapper}; each wrapper counts its launches."""
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import bsr_spmm
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 coded_stencil)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u
    return {"coded_matvec": coded_matvec, "coded_stencil": coded_stencil,
            "coded_slab": coded_slab, "field_a": field_a, "field_u": field_u,
            "bsr_spmm": bsr_spmm}


def counted(fn):
    """(fn(), {kernel: launches}) with every count set to 0 just before
    ``fn`` and read just after."""
    ws = wrappers()
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
    return card


def phase_build():
    from eddy_currents_3d_tpu_torch.ops._build import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build_library, SOURCES))
    wall = time.perf_counter() - t0
    for w in wrappers().values():
        w._library()
    from eddy_currents_3d_tpu_torch.ops.native import get_lib
    get_lib()
    for name, (path, log, seconds) in zip(SOURCES, built):
        say(f"[2] built {os.path.relpath(path)} in {seconds:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say("    ptxas:", line.strip())
    say(f"[2] the {len(SOURCES)} builds took {wall:.2f} s of wall time")


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


def _f64_dots(parts):
    """dot(y, w) and dot(y, y) in float64 over (y, w) tensor pairs."""
    ref_w = sum(float((y.double() * w.double()).sum()) for y, w in parts)
    ref_y = sum(float((y.double() ** 2).sum()) for y, _ in parts)
    return ref_w, ref_y


def _dot_err(pw, py, ref_w, ref_y):
    return max(abs(float(pw) - ref_w) / max(abs(ref_w), 1.0),
               abs(float(py) - ref_y) / max(abs(ref_y), 1.0))


def _maxabs(a, b):
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
            + f"  dots rel err {dot_err:.2e}")
        bad = {m: e for m, e in errs.items() if not e <= ATOL}
        if bad or not dot_err <= DOT_RTOL:
            raise AssertionError(f"kernel != plain on {name}: {bad}, "
                                 f"dots {dot_err:.3e}")
        out[name] = {"model": model, "system": sysm, "op": op, "times": t,
                     "max_abs_err": abs_err}
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
        dA, pw, py = coded_stencil(op, x.A, w.A)
        dA = dA[:, own]
        st_err = {"apply": _maxabs(yA, rA) / scale,
                  "apply_dots": _maxabs(dA, rA) / scale}
        st_dot = _dot_err(pw, py, *_f64_dots([(dA, w.A[:, own])]))
        st_abs = max(_maxabs(yA, rA), _maxabs(dA, rA))

        # ---- slab kernel: the slab's planes, compact U ----
        sA, sU = plain_sl()
        sscale = sA.abs().max().item()
        uscale = max(sU.abs().max().item(), sscale)
        yS = torch.empty_like(x.A)
        yU = coded_slab(op, x.A, Uc, yS)
        yS = yS[:, zb0:zb1]
        dS = torch.empty_like(x.A)
        dU, pw, py = coded_slab(op, x.A, Uc, dS, wc)
        dS = dS[:, zb0:zb1]
        rD = plain_sl(U=None)
        yD = coded_slab(op, x.A)
        dscale = max(rD.abs().max().item(), 1.0)
        sl_err = {"apply": max(_maxabs(yS, sA) / sscale, _maxabs(yU, sU) / uscale),
                  "apply_dots": max(_maxabs(dS, sA) / sscale,
                                    _maxabs(dU, sU) / uscale),
                  "apply_div": _maxabs(yD, rD) / dscale}
        sl_dot = _dot_err(pw, py, *_f64_dots([(dS, w.A[:, zb0:zb1]),
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
                     "coded_slab": {"times": sl_t, "max_abs_err": sl_abs}}
    return out


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
        f"host blocked on the done read {diag['sync_s'] / solve_s:.1%} of "
        f"the solve; kernel launches {counts}")
    return model, launches


def _to(state, dev, dtype):
    """A SimState's tensors on ``dev`` in ``dtype`` (motion stays on the
    host)."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State

    f = lambda t: t.to(dev, dtype)
    return state._replace(A=f(state.A), U=f(state.U), carry=f(state.carry),
                          prev=State(f(state.prev.A), f(state.prev.U)))


def _per_step_gaps(model, dev, n, **kw):
    """n steps of the float64 CPU run; before each, the float32 card step
    from the float64 state.  Returns (per-step gaps, the free float32 run's
    gaps, f32 iterations, f64 iterations, CPU seconds), gaps as
    max |dA| / (tol scale)."""
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
        if not (i32.converged and i64.converged and if32.converged):
            raise AssertionError(f"cross-check step at t={t} did not converge")
        its32.append(i32.iterations)
        its64.append(i64.iterations)
        scale = tol * s64.A.abs().max().item()
        step_ratios.append((f32.A.cpu().double() - s64.A).abs().max().item()
                           / scale)
        ratios.append((s32.A.cpu().double() - s64.A).abs().max().item() / scale)
    return step_ratios, ratios, its32, its64, t_cpu


def _fmt(rs):
    return " ".join(f"{r:.2f}" for r in rs)


def phase_cross_check(model, dev):
    """The first 5 steps, f32 on the card against f64 on the CPU.

    * Per step: each f32 step starts from the f64 run's state, so it
      measures one solve; A must agree within 4 tol scale at every step.
    * Free run: the f32 run carries its own state.  After one step it must
      agree within 4 tol scale.  The gap then grows as each step's solve
      error feeds the next step's right-hand side: on this grid the JAX
      package's own f32 run (flat-roll operator, CPU) sits 4.04 tol scale
      from its f64 run after 5 steps, so the 5-step bound of the free run
      is twice that gap, 8 tol scale."""
    step_ratios, ratios, its32, its64, t_cpu = _per_step_gaps(model, dev, 5)
    say(f"[6] f32 cuda vs f64 cpu, max |dA| / (tol scale): per step from the "
        f"f64 state {_fmt(step_ratios)} (limit 4); free run {_fmt(ratios)} "
        f"(limits 4 after step 1, 8 after step 5); iterations f32 {its32} "
        f"f64 {its64}; cpu f64 steps {t_cpu:.1f} s")
    if not (max(step_ratios) <= 4.0 and ratios[0] <= 4.0
            and ratios[-1] <= 8.0):
        raise AssertionError(f"f32 cuda vs f64 cpu out of bounds: per step "
                             f"{step_ratios}, free run {ratios}")


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
        if any(counts[k] == 0 for k in must[name]) or any(
                counts[k] for k in counts if k not in must[name]):
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
            f"host blocked on the done read {diag['sync_s'] / wall:.1%}; "
            f"launches {counts}")
    last = {name: st for name, (st, _, _) in runs}
    gap5 = (last["split"].A - last["whole"].A).abs().max().item() / (
        tol * last["whole"].A.abs().max().item())
    say(f"[7] split vs whole max |dA| / (tol scale): {gap1:.3f} after step 1 "
        f"(limit 4), {gap5:.3f} after step 5; compact U planes {zb0}..{zb1 - 1}")
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
            f"blocked on the done read {diag['sync_s'] / wall:.1%}; "
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


def phase_field_vs_plain(grids, dev):
    """field_a and field_u against their plain versions, float32 and
    bfloat16 coefficients.  grids: (name, model, float32 system on dev).
    Returns {(grid name, coefficient name): {kernel: record}}."""
    from eddy_currents_3d_tpu_torch.ops.field import (field_a_reference,
                                                      field_u_reference)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    out = {}
    for name, model, sysm in grids:
        nz, ny, nx = model.shape_zyx
        cells = nz * ny * nx
        x, _ = _inputs(model, dev, 2)
        for cname, coef in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            op = _field_op(sysm, coef)
            cs = op.ka.element_size()
            recs = {}
            # ---- field_a over the grid, the three A components ----
            ra = field_a_reference(op.ka, x.A)
            scale = ra.abs().max().item()
            ya = field_a(op.ka, x.A)
            err = _maxabs(ya, ra)
            recs["field_a"] = {
                "err": err / scale, "max_abs_err": err,
                "bytes": cells * (7 * cs + 2 * 3 * 4),
                "times": (cuda_ms(lambda: field_a(op.ka, x.A), 50),
                          cuda_ms(lambda: field_a_reference(op.ka, x.A), 4))}
            if op.box is not None:
                # ---- field_u over the box, adding into yA ----
                gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box,
                                               x.A, x.U)
                z0, z1, y0, y1, x0, x1 = op.box
                sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
                rA = ya.clone()
                rA[(slice(None),) + sl] += gout
                rU = torch.zeros_like(x.U)
                rU[sl] = uout
                yA = ya.clone()
                yU = field_u(op, x.A, x.U, yA)
                uscale = max(rU.abs().max().item(), scale)
                err = max(_maxabs(yA, rA), _maxabs(yU, rU))
                nbox = (z1 - z0) * (y1 - y0) * (x1 - x0)
                buf = ya.clone()
                recs["field_u"] = {
                    "err": max(_maxabs(yA, rA) / scale, _maxabs(yU, rU) / uscale),
                    "max_abs_err": err,
                    # 31 coefficients, U, A, yA read and written, yU; plus
                    # the wrapper's zero fill of the full-grid yU
                    "bytes": nbox * (31 * cs + 4 + 12 + 24 + 4) + cells * 4,
                    "times": (cuda_ms(lambda: field_u(op, x.A, x.U, buf), 50),
                              cuda_ms(lambda: field_u_reference(
                                  op.gu, op.ku, op.da, op.box, x.A, x.U), 4))}
            torch.cuda.synchronize()
            for kname, r in recs.items():
                k_ms, p_ms = r["times"]
                say(f"[9] {kname} {name} ({nx}x{ny}x{nz}, {cname} "
                    f"coefficients): err {r['err']:.2e} of scale; kernel "
                    f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us; "
                    f"{r['bytes'] / 1e6:.1f} MB/call, "
                    f"{r['bytes'] / (k_ms * 1e-3) / 1e9:.0f} GB/s = "
                    f"{r['bytes'] / (k_ms * 1e-3) / HBM_PEAK:.1%} of 3.35 TB/s")
                if not r["err"] <= ATOL:
                    raise AssertionError(f"{kname} != plain on {name} "
                                         f"{cname}: {r['err']:.3e}")
            out[(name, cname)] = recs
    return out


def _field_run(sim, tag, label):
    """Run ``sim`` with every count at 0; the field kernels must carry it
    (field_a >= 2 x iterations) and no coded kernel may launch."""
    (st, diag), counts = counted(lambda: sim.run())
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
        f"blocked on the done read {diag['sync_s'] / wall:.1%}; "
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
        counts[label] = _field_run(sim, 10, f"team7 {label}")[2]
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
        if any(counts[k] == 0 for k in own) or any(
                counts[k] for k in counts if k not in own):
            raise AssertionError(f"256x256x64 {name} launched {counts}")
        wall = diag["wall_s"]
        say(f"[11] 256x256x64 {name} x 5 steps: {wall / 5 * 1e3:.2f} ms/step, "
            f"iterations {diag['iterations']}, "
            f"{wall / diag['total_iterations'] * 1e3:.3f} ms/iteration, "
            f"host blocked on the done read {diag['sync_s'] / wall:.1%}; "
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


def phase_bsr_vs_plain(model, sysm, dev):
    """bsr_spmm against its plain version, random matrices and team7's
    exported operator.  Returns (team7 BSR, scipy CSR, host setup seconds,
    {k: record})."""
    import scipy.sparse as sp

    from eddy_currents_3d_tpu_torch.assembly.assemble import to_csr
    from eddy_currents_3d_tpu_torch.ops.bsr_cuda import (bsr_spmm,
                                                         bsr_spmm_reference)
    from eddy_currents_3d_tpu_torch.ops.sparse import bsr_from_scipy

    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    rng = np.random.default_rng(13)
    for seed, block_shape in enumerate(((8, 8), (4, 8), (8, 16))):
        a = sp.random(4099, 4099, density=0.002,
                      random_state=np.random.RandomState(seed)).tocsr()
        a.setdiag(1.0)
        for dtype in (torch.float32, torch.float64):
            b = bsr_from_scipy(a, block_shape=block_shape, dtype=dtype,
                               device=dev)
            errs = []
            for k in (1, 4, 128):
                x = torch.from_numpy(rng.standard_normal((b.shape[1], k))).to(
                    dev, dtype)
                err, scale = _spmm_check(f"random {block_shape} k={k}", b, x)
                errs.append(f"k={k} ({bsr_spmm.route(block_shape, k)}) "
                            f"{err / scale:.1e}")
                worst = max(worst, err) if dtype == torch.float32 else worst
            say(f"[13] bsr_spmm random 4099x4099 {block_shape} "
                f"{str(dtype)[6:]}: width {b.blocks.shape[1]}, |kernel - "
                f"plain| / max(|B|·|X|): " + ", ".join(errs))

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
        err, scale = _spmm_check(f"team7 k={k}", B, x)
        worst = max(worst, err)
        nbytes = (B.blocks.numel() + B.block_cols.numel() + x.numel()
                  + B.shape[0] * k) * 4
        ops = 2 * B.blocks.numel() * k
        b_ms, b_by = bound(nbytes, ops)
        ms = cuda_ms(lambda: bsr_spmm(B, x), 50)
        dev_ms = device_ms(lambda: bsr_spmm(B, x), "bsr_")
        plain_ms = cuda_ms(lambda: bsr_spmm_reference(B, x), 5)
        try:
            lib_err = _maxabs(S @ x, bsr_spmm(B, x)) / scale
            lib_ms = cuda_ms(lambda: S @ x, 50)
            lib = (f"{lib_ms * 1e3:.2f} us (|lib - kernel| {lib_err:.2e} of "
                   f"max(|B|·|X|))")
        except Exception as e:  # the yardstick only: report, do not fail
            lib_ms, lib = None, f"refused: {type(e).__name__}: {e}"
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms * 1e3:.2f} us"
        say(f"[13] bsr_spmm team7 k={k} ({bsr_spmm.route((8, 8), k)} route): "
            f"err {err / scale:.2e} of max(|B|·|X|); device {dev_txt}, "
            f"events {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP, bound "
            f"{b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.1%} of it); "
            f"library {lib}")
        recs[k] = {"times": (ms, plain_ms), "max_abs_err": worst,
                   "bound": (b_ms, b_by), "library_ms": lib_ms,
                   "device_ms": dev_ms}
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
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import bicgstab_wr
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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, counts = counted(lambda: bicgstab_wr(lambda v: bsr_matvec(B, v), b,
                                              xk1, tol, itmax))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts["bsr_spmm"]
    rel = true_res(res.x)
    say(f"[14] matrix-form BiCGSTABwr on bsr_matvec (team7, from x_(k-1)): "
        f"{res.iterations} iterations, {wall / max(res.iterations, 1) * 1e3:.3f} "
        f"ms/iteration, true residual {rel:.3e} (tol {tol}), "
        f"launches {counts}")
    if not (res.converged and rel < tol):
        raise AssertionError(f"matrix-form solve: converged {res.converged}, "
                             f"true residual {rel:.3e}")
    if launches < 2 * res.iterations or any(
            v for k_, v in counts.items() if k_ != "bsr_spmm"):
        raise AssertionError(f"matrix-form solve launched {counts} for "
                             f"{res.iterations} iterations")
    r1, kernels, wall1 = trace(lambda: bicgstab_wr(
        lambda v: bsr_matvec(B, v), b, xk1, tol, itmax))
    say(f"[14] the same solve profiled: {r1.iterations} iterations, "
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
        f"{t_it * 1e3:.3f} ms/iteration without it, true residual "
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
            f"ms/iteration, host blocked on the done read "
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


def phase_device_times(recs, dev):
    """Device µs per call (torch.profiler, 20 calls) of the five earlier
    kernels at the shapes their JSON records use."""
    from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
    from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                                 coded_stencil)
    from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u

    out = {}
    t7 = recs["team7"]
    op = t7["op"]
    x, w = _inputs(t7["model"], dev, 0)
    out["coded_matvec"] = device_ms(lambda: coded_matvec(op, x.A, x.U, w),
                                    "coded_matvec_kernel")
    s = recs["scale256"]
    sop = s["op"]
    zb0, zb1 = sop.cond_z
    xs, ws = _inputs(s["model"], dev, 1)
    Uc = xs.U[zb0:zb1]
    from eddy_currents_3d_tpu_torch.assembly.stencil import State
    wc = State(ws.A, ws.U[zb0:zb1])
    buf = torch.empty_like(xs.A)
    out["coded_stencil"] = device_ms(lambda: coded_stencil(sop, xs.A, ws.A),
                                     "stencil_kernel")
    out["coded_slab"] = device_ms(
        lambda: coded_slab(sop, xs.A, Uc, buf, wc), "slab_kernel")
    fop = _field_op(t7["system"], torch.float32)
    yb = field_a(fop.ka, x.A)
    out["field_a"] = device_ms(lambda: field_a(fop.ka, x.A), "field_a")
    out["field_u"] = device_ms(lambda: field_u(fop, x.A, x.U, yb), "field_u")
    say("[16] device us per call (torch.profiler, 20 calls): " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v * 1e3:.2f}'}"
        for k, v in out.items()))
    return out


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
    phase_build()
    grids = [
        ("team7", case_static(shape_xyz=(102, 102, 24), steps=3)),
        ("convection", case_convection(shape_xyz=(48, 24, 16), steps=3)),
        ("scale256", case_static(shape_xyz=(256, 256, 64), steps=5)),
    ]
    recs = phase_kernel_vs_plain(grids, dev)
    split_recs = phase_split_vs_plain([grids[2], grids[1]], dev)
    model, matvec_launches = phase_main_path(dev)
    phase_cross_check(model, dev)
    split_counts = phase_scale(recs["scale256"], dev)
    phase_precond(model, dev)
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
    dev_times = phase_device_times(recs, dev)
    dev_times["bsr_spmm"] = bsr_recs[1]["device_ms"]

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
    box7 = t7["system"].op.box
    nbox7 = (box7[1] - box7[0]) * (box7[3] - box7[2]) * (box7[5] - box7[4])
    bounds = {
        # apply_dots: A, U, code, cf, w.A, w.U read; yA, yU written
        "coded_matvec": bound(56 * n7, 2 * (21 * n7 + 31 * c7) + 16 * n7),
        # apply_dots over the planes outside the slab: A, w.A read, yA written
        "coded_stencil": bound(36 * own, 42 * own + 12 * own),
        # apply_dots over the slab: as coded_matvec, on the slab's cells
        "coded_slab": bound(56 * slab, 2 * (21 * slab + 31 * s256.n_cond)
                            + 16 * slab),
        "field_a": bound(f7["field_a"]["bytes"], 2 * 21 * n7),
        "field_u": bound(f7["field_u"]["bytes"], 2 * 31 * nbox7),
    }

    def record(name, launches, rec, mode=None, library_ms=None):
        t = rec["times"] if mode is None else rec["times"][mode]
        b_ms, b_by = rec["bound"] if "bound" in rec else bounds[name]
        return {"name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": t[0], "plain_ms": t[1],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}

    # no single PyTorch call computes the coded or field operators (their
    # coefficients vary per cell), so those have no library time
    kernels = [record("coded_matvec", matvec_launches, recs["team7"],
                      "apply_dots")]
    for name in ("coded_stencil", "coded_slab"):
        rec = dict(split_recs["scale256"][name])
        rec["max_abs_err"] = max(r[name]["max_abs_err"]
                                 for r in split_recs.values())
        kernels.append(record(name, split_counts[name], rec, "apply_dots"))
    for name in ("field_a", "field_u"):
        rec = dict(field_recs[("team7", "f32")][name])
        rec["max_abs_err"] = max(r[name]["max_abs_err"]
                                 for r in field_recs.values() if name in r)
        kernels.append(record(name, field_counts[name], rec))
    kernels.append(record("bsr_spmm", bsr_launches, bsr_recs[1],
                          library_ms=bsr_recs[1]["library_ms"]))
    for k in kernels:
        d = dev_times[k["name"]]
        say(f"[16] {k['name']}: events {k['ms'] * 1e3:.2f} us, device "
            + ("not measured" if d is None else f"{d * 1e3:.2f} us")
            + f", bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}, "
            f"plain {k['plain_ms'] * 1e3:.2f} us, launches {k['launches']}")
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
