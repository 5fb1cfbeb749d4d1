"""The solve as a device program on the card (``solvers/bicgstab.py``
``DeviceLoop``, ``utils/graph.py``, ``csrc/solve_graph.cu``): the graphed
solve equals the per-iteration host loop bit for bit in every solver form,
one capture serves every later solve of a Simulation, the wrappers' launch
counts add up what the graphs ran, a run's steps make no synchronizing
call but the solves' (done, it) reads, the scratch a captured program's
kernels use dies with its loop, and a checkpoint loads onto the card by
default.  Every test here needs a CUDA
device and nvcc and skips without them; the file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph.py
"""

import gc
import os
import weakref

import pytest
import torch

from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
from eddy_currents_3d_tpu_torch.sim import checkpoint as ckpt
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.solvers.bicgstab import (
    DeviceLoop, bicgstab_wr, bicgstab_wr_reference)
from eddy_currents_3d_tpu_torch.testing import cases

pytestmark = pytest.mark.cuda

CONFIGS = {
    "coded": (torch.float32, {}),
    "jacobi": (torch.float32, {"precond": "jacobi"}),
    "cheb_jacobi": (torch.float32, {"precond": "cheb_jacobi"}),
    "ilu0": (torch.float32, {"precond": "ilu0"}),
    "field": (torch.float32, {"use_coded": False}),
    "mg": (torch.float32, {"precond": "mg"}),
    "bf16": (torch.bfloat16, {"dot_dtype": torch.float32}),
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
