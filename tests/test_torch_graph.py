"""The solve as a device program on the card (``solvers/bicgstab.py``
``DeviceLoop``, ``utils/graph.py``, ``csrc/solve_graph.cu``): the graphed
solve equals the per-iteration host loop bit for bit in every solver form,
one capture serves every later solve of a Simulation, the wrappers' launch
counts add up what the graphs ran, a run's steps make no synchronizing
call but the solves' (done, it) reads, the scratch a captured program's
kernels use dies with its loop, and a checkpoint loads onto the card by
default.  At float32 the iteration's glue runs on the glue kernels
(``csrc/solver_glue.cu``), elsewhere in torch ops.  float64 runs graphed
on the card and equals the CPU's float64 run; a mesh of one rank over
NCCL equals the unsharded field tier on the same (torch) glue bit for bit
with its dots' all-reduce inside the captured solve.  Every test here
needs a CUDA device and nvcc and skips without them; the file imports no
jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph.py
"""

import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch

from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
from eddy_currents_3d_tpu_torch.sim import checkpoint as ckpt
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.solvers.bicgstab import (
    DeviceLoop, bicgstab_wr, bicgstab_wr_reference)
from eddy_currents_3d_tpu_torch.testing import cases
from eddy_currents_3d_tpu_torch.testing.glue import torch_glue

pytestmark = pytest.mark.cuda

CONFIGS = {
    "coded": (torch.float32, {}),
    "jacobi": (torch.float32, {"precond": "jacobi"}),
    "cheb_jacobi": (torch.float32, {"precond": "cheb_jacobi"}),
    "ilu0": (torch.float32, {"precond": "ilu0"}),
    "field": (torch.float32, {"use_coded": False}),
    "mg": (torch.float32, {"precond": "mg"}),
    "bf16": (torch.bfloat16, {"dot_dtype": torch.float32}),
    "bf16_coef_f32": (torch.bfloat16, {"dot_dtype": torch.float32,
                                       "coeff_dtype": torch.float32}),
    "f64": (torch.float64, {"dot_dtype": torch.float64}),
    "f64_mg": (torch.float64, {"precond": "mg"}),
    "flat_f32": (torch.float32, {"use_pallas": False}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(steps=3):
    return cases.load_case(cases.case_static(shape_xyz=(40, 36, 16),
                                             steps=steps))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_steps_equal_plain_loop(cuda, name):
    dtype, kw = CONFIGS[name]
    sim = Simulation(_model(), dtype, device=cuda, **kw)
    s1 = s2 = sim.init_state()
    for t, _ in sim.steps:
        s1, i1 = sim._step(s1, t)
        s2, i2 = sim._step(s2, t, eager=True)
        # the graphed step leaves its counts on the device, unread
        assert i1.reads == 0
        assert (int(i1.iterations), bool(i1.converged)) == (i2.iterations,
                                                            i2.converged)
        assert i2.iterations > 0
        assert torch.equal(i1.relres, i2.relres)
        assert torch.equal(s1.A, s2.A) and torch.equal(s1.U, s2.U)
    assert sim.captures == 1


def test_launch_counts_follow_the_graph(cuda):
    """coded_matvec's count over a run of graphed solves: per step the
    RHS's apply_div and setup's apply(x0), two an iteration (apply_dots of
    p and of s), none for the capture; the run reads the iteration counts
    once, after its loop, and counts then."""
    sim = Simulation(_model(), torch.float32, device=cuda)
    sim.run(num_steps=1)                           # captures
    coded_matvec.launches = 0
    _, diag = sim.run()
    assert diag["reads"] == [0] * len(sim.steps)
    assert coded_matvec.launches == (2 * len(sim.steps)
                                     + 2 * diag["total_iterations"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_glue_kernels_take_the_float32_loops(cuda, name):
    """The iteration's glue runs on the three glue kernels in every
    float32 configuration (DeviceLoop.glue "fused", 3 launches an
    iteration, graphed and eager alike) and on the torch glue, with no
    glue launch, at bfloat16 and float64 state."""
    from eddy_currents_3d_tpu_torch.ops.glue_cuda import solver_glue

    dtype, kw = CONFIGS[name]
    sim = Simulation(_model(), dtype, device=cuda, **kw)
    sim.run(num_steps=1)                           # captures
    want = "fused" if dtype == torch.float32 else "torch"
    assert {loop.glue for loop in sim._loops.values()} == {want}
    solver_glue.launches = 0
    _, diag = sim.run()
    st = sim.init_state()
    eager = 0
    for t, _ in sim.steps:
        st, info = sim._step(st, t, eager=True)
        eager += info.iterations
    per = 3 if want == "fused" else 0
    assert solver_glue.launches == per * (diag["total_iterations"] + eager)


_PROFILED_RUN = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
from eddy_currents_3d_tpu_torch.ops.glue_cuda import solver_glue
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases

def session(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]

x = torch.ones(1 << 12, device="cuda")
session(lambda: x.mul(2.0))
sim = Simulation(cases.load_case(cases.case_static(shape_xyz=(40, 36, 16),
                                                   steps=6)),
                 torch.float32, device="cuda")
sim.run()
before = (coded_matvec.launches, solver_glue.launches)
names = session(sim.run)
counted = [coded_matvec.launches - before[0], solver_glue.launches - before[1]]
traced = [sum("whole_march" in n for n in names),
          sum(any(k in n for k in ("glue_s", "glue_xr", "glue_p"))
              for n in names)]
print(json.dumps([counted, traced]))
"""


def test_profiled_run_traces_every_counted_launch(cuda):
    """One torch.profiler session over a graphed run() holds an event for
    every launch the wrappers counted: coded_matvec's and the glue
    kernels'.  A session loses records of the first WHILE body it sees
    run; the run's WhilePrimer takes that loss.  In a fresh process, its
    graphs captured after its first session: what a process's earlier
    sessions leave decides what later ones see (PERF.md)."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _PROFILED_RUN], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    counted, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert counted[1] > 0 and traced == counted


@pytest.mark.parametrize("case", ["static", "moving"])
def test_steps_make_no_sync_but_the_reads(cuda, case):
    """run_scan under set_sync_debug_mode("error"): no synchronizing call
    (the moving coil's cells go up through pinned memory; the final read
    of the counts waits on an event, which the mode does not flag)."""
    if case == "static":
        model = _model(steps=4)
    else:
        model = cases.load_case(cases.case_moving(shape_xyz=(32, 32, 16),
                                                  steps=4))
    sim = Simulation(model, torch.float32, device=cuda)
    sim.run_scan(num_steps=1)                      # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, diag = sim.run_scan()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(diag["converged"].all()) and sim.captures == 1


def test_program_scratch_dies_with_its_loop(cuda):
    """A one-shot solve captures programs of its own; the march kernels'
    scratch made for them lives in their graphs, not in the wrapper, and is
    freed with the loop.  The one-shot solver equals the plain loop."""
    sim = Simulation(_model(steps=1), torch.float32, device=cuda)
    sim.run()
    (loop,) = sim._loops.values()
    b = State(loop._s.b.A.clone(), loop._s.b.U.clone())
    x0 = State(loop._s.x0.A.clone(), loop._s.x0.U.clone())
    op, itmax = sim.coded_op, sim.model.solver.itmax
    kept = len(coded_matvec._scratch_of.get(op, {}))
    one = DeviceLoop(sim.op.apply, itmax, mv_dot=op.apply_dots)
    one.solve(b, x0, sim._tol)
    body = one._graphs[1]._scratch
    assert body and len(coded_matvec._scratch_of.get(op, {})) == kept
    parts = weakref.ref(next(iter(body.values()))[1])
    del one, body
    gc.collect()
    assert parts() is None
    for _ in range(2):
        got = bicgstab_wr(sim.op.apply, b, x0, sim._tol, itmax,
                          mv_dot=op.apply_dots)
    ref = bicgstab_wr_reference(sim.op.apply, b, x0, sim._tol, itmax,
                                mv_dot=op.apply_dots)
    assert (got.iterations, got.converged) == (ref.iterations,
                                               ref.converged)
    assert torch.equal(got.relres, ref.relres)
    assert torch.equal(got.x.A, ref.x.A) and torch.equal(got.x.U, ref.x.U)
    assert len(coded_matvec._scratch_of.get(op, {})) == kept


def test_checkpoint_loads_onto_the_card(cuda, tmp_path):
    """load_checkpoint's default device is the card, and the next step
    from what it loads equals the uninterrupted run's."""
    model = _model(steps=2)
    cdir = str(tmp_path / "ck")
    sim = Simulation(model, torch.float32, device=cuda)
    full, _ = sim.run(checkpoint_dir=cdir, checkpoint_every=1)
    state, step, _ = ckpt.load_checkpoint(os.path.join(cdir, "ckpt_1.npz"),
                                          ckpt.model_fingerprint(model))
    assert step == 1 and state.A.device == full.A.device
    nxt, _ = sim._step(state, sim.steps[1][0])
    assert torch.equal(nxt.A, full.A) and torch.equal(nxt.U, full.U)


def test_float64_on_the_card_matches_the_cpu(cuda):
    """float64 on the card (flat-roll operator, graphed) against the CPU's
    float64 run: within 1e-9 of scale, the same iterations."""
    f64 = torch.float64
    st, d = Simulation(_model(), f64, f64, device=cuda).run()
    sc, dc = Simulation(_model(), f64, f64, device="cpu").run()
    assert d["iterations"] == dc["iterations"]
    assert max(d["reads"]) == 0
    scale = sc.A.abs().max().item()
    assert (st.A.cpu() - sc.A).abs().max().item() <= 1e-9 * scale


def test_mesh_of_one_rank_over_nccl(cuda, tmp_path):
    """Simulation(mesh=make_mesh(1)) over NCCL, each solve captured once
    with the all-reduce of its dots inside (the all-reduce's Python calls
    stop after the capture), and a run makes no synchronizing call: with
    use_coded=False the sharded field tier at world size 1 equals the
    unsharded use_coded=False run bit for bit; the float32 default, the
    per-slab coded tier, converges and lies within 4 tol of scale of the
    float64 run after step 1."""
    import torch.distributed as dist

    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        calls = []
        real = mesh.all_reduce
        object.__setattr__(mesh, "all_reduce",
                           lambda t: calls.append(1) or real(t))
        for kw in ({"use_coded": False}, {}):
            sim = Simulation(_model(), torch.float32, mesh=mesh, **kw)
            assert sim.shard_op.use_coded == (not kw)
            s1, _ = sim.run(num_steps=1)          # captures the solve
            n = len(calls)
            torch.cuda.set_sync_debug_mode("error")
            try:
                st, d = sim.run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert len(calls) == n and sim.captures == 1
            assert not d["unconverged_steps"]
            if kw:
                # the unsharded run on the mesh's glue, the torch ops (the
                # glue kernels sum the dots in another order)
                ref = Simulation(_model(), torch.float32, device=cuda, **kw)
                with torch_glue():
                    sr, dr = ref.run()
                assert {l.glue for l in ref._loops.values()} == {"torch"}
                assert {l.glue for l in sim._loops.values()} == {"torch"}
                assert d["iterations"] == dr["iterations"]
                assert (torch.equal(st.A, sr.A)
                        and torch.equal(st.carry, sr.carry))
                continue
            model = _model()
            s64, _ = Simulation(model, torch.float64, device="cpu").run(
                num_steps=1)
            scale = model.solver.tolerance * s64.A.abs().max().item()
            assert (s1.A.cpu().double() - s64.A).abs().max().item() <= \
                4 * scale
    finally:
        dist.destroy_process_group()


def test_batched_programs_equal_the_while_graph(cuda):
    """The batched form a mesh of several ranks takes (setup, a batch of K
    gated iterations and finish, each a graph of its own, one read of
    (done, it) a batch) equals the WHILE-node graph bit for bit, both on
    the torch glue (the batched form's own: its stores are gated)."""
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import K

    runs = {}
    for batched in (False, True):
        sim = Simulation(_model(), torch.float32, device=cuda,
                         use_coded=False)
        nz, ny, nx = sim.model.shape_zyx
        loop = DeviceLoop(itmax=sim.model.solver.itmax, pool=sim._pool,
                          batched=batched, **sim._solve_form())
        sim._loops[((3, nz, ny, nx), (nz, ny, nx))] = loop
        with torch_glue():
            runs[batched] = sim.run()
        assert sim.captures == 1 and loop.glue == "torch"
        # without the patch the WHILE graph's float32 loop takes the
        # glue kernels, and the batched form keeps the torch glue
        want = "torch" if batched else "fused"
        assert loop._route(loop._s.b, loop._s.x0, sim._tol) == want
    (s0, d0), (s1, d1) = runs[False], runs[True]
    assert d1["iterations"] == d0["iterations"]
    assert torch.equal(s1.A, s0.A) and torch.equal(s1.U, s0.U)
    assert max(d0["reads"]) == 0
    assert d1["reads"] == [max(1, -(-n // K)) for n in d1["iterations"]]
