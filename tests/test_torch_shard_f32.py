"""float32 on the port's z-slab mesh at team7's size, held to the reference's
stopping rule and to an accuracy bound.

team7 (``case_static`` 102x102x24, tol 5e-3) step 1 from rest, solved at
float32 on 2 and 4 gloo ranks (``tests/_torch_mesh.py``) and on one device,
against the float64 run on one device and the converged solution (the same
system solved to 1e-6 at float64):

* every float32 solution meets the reference's stopping rule by its true
  residual ``||b - A x|| / ||b||``, recomputed at float64 on the host with
  the float64 operator (not the solver's recursively updated relres);
* every float32 solution lies no farther from the converged solution than
  the float64 run does, plus the one-device float32 bound: ``max |A -
  A_conv| <= max |A_f64 - A_conv| + 4 tol scale`` (scale: ``max |A_f64|``).
  That is what the one-device bound ``max |A - A_f64| <= 4 tol scale``
  says about accuracy, by the triangle inequality.  The float64 run itself
  stops ~6 tol scale from the converged solution, and float32 solves of
  this step stop at either of two answers ~6.7 tol scale apart, both under
  the stopping rule; which one depends on the order in which the float32
  dots are summed, on one device too (``mesh_smoke.py --cpu``, whose
  one-device runs sum on one thread), so the distance to the float64 run
  alone cannot tell a fault from rounding.

The float32 operator, right-hand side and dots of a mesh are held to the
single-device ones in ``tests/test_torch_shard_op.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_mesh import TEAM7, spawn

from eddy_currents_3d_tpu_torch import Simulation
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.solvers.bicgstab import tree_norm
from eddy_currents_3d_tpu_torch.testing.cases import case_static, load_case

CPU = torch.device("cpu")
ONE_DEVICE_BOUND = 4.0      # tol scale: the one-device float32 step-1 bound


@pytest.fixture(scope="module")
def reference():
    """Step 1's system and its float64 and converged solutions, the
    float64 operator, and a function of a solution that returns (true
    residual, max |A - A_f64| and max |A - A_conv| in tol scale)."""
    model = load_case(case_static(shape_xyz=TEAM7, steps=2))
    tol = model.solver.tolerance
    sim = Simulation(model, torch.float64, device=CPU)
    b, x0 = sim.step_system(sim.init_state(), sim.steps[0][0])
    x64 = sim.solve(b, x0).x
    tight = dataclasses.replace(
        model, solver=dataclasses.replace(model.solver, tolerance=1e-6))
    conv = Simulation(tight, torch.float64, device=CPU,
                      precond="jacobi").solve(b, x0)
    assert conv.converged
    op, bnd = sim.system.op, sim.system.bnd_a

    def surface(A):
        # the step zeroes A on the surface after its solve
        return torch.where(bnd, 0.0, A)

    A64, Ac = surface(x64.A), surface(conv.x.A)
    scale = A64.abs().max().item()

    def measure(A, U):
        x = State(torch.as_tensor(A).double(), torch.as_tensor(U).double())
        y = op.apply(x)
        rel = (tree_norm(State(b.A - y.A, b.U - y.U)) / tree_norm(b)).item()
        A = surface(x.A)
        gap = lambda ref: (A - ref).abs().max().item() / (tol * scale)
        return rel, gap(A64), gap(Ac)

    return {"tol": tol, "measure": measure, "model": model,
            "f64_to_conv": (A64 - Ac).abs().max().item() / (tol * scale),
            "f64_relres": measure(x64.A, x64.U)[0]}


def _hold(reference, A, U, label):
    tol = reference["tol"]
    rel, to_f64, to_conv = reference["measure"](A, U)
    bound = reference["f64_to_conv"] + ONE_DEVICE_BOUND
    assert rel < tol, f"{label}: true residual {rel} >= tol {tol}"
    assert to_conv <= bound, (
        f"{label}: {to_conv:.3f} tol scale from the converged solution, "
        f"bound {bound:.3f} (the float64 run's {reference['f64_to_conv']:.3f}"
        f" + {ONE_DEVICE_BOUND}); {to_f64:.3f} from the float64 run")


def test_float64_reference_meets_the_stopping_rule(reference):
    """The float64 run's own answer: its true residual under tol, and
    several tol scale from the converged solution (what the bound adds the
    one-device bound to)."""
    assert reference["f64_relres"] < reference["tol"]
    assert 0 < reference["f64_to_conv"] < 2 * ONE_DEVICE_BOUND


@pytest.mark.parametrize("world", [2, 4])
def test_team7_f32_on_the_mesh_meets_the_bound(reference, world, tmp_path):
    out = spawn("team7", world, tmp_path)[0]
    assert out["iterations"] > 0 and out["relres"] < reference["tol"]
    _hold(reference, out["A"], out["U"], f"{world} ranks")


@pytest.mark.parametrize("threads", [1, 0], ids=["one-thread", "default"])
def test_team7_f32_on_one_device_meets_the_bound(reference, threads):
    """The control: one device's float32 field tier under the same checks,
    its dots summed on one thread (as a gloo rank sums them) and on the
    process's default threads."""
    before = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        sim = Simulation(reference["model"], torch.float32, device=CPU,
                         use_coded=False)
        res = sim.solve(*sim.step_system(sim.init_state(), sim.steps[0][0]))
    finally:
        torch.set_num_threads(before)
    assert res.converged
    _hold(reference, res.x.A, res.x.U, f"one device, {threads} threads")
