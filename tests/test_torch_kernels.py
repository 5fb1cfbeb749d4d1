"""The hand-written CUDA kernels against their plain torch versions, on
the card.  Every test here needs a CUDA device and nvcc and skips without
them.  The file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances are those of the CPU parity tests (tests/test_torch_coded.py):
3e-6 of the output scale for the matvec, 2e-5 relative for the fused dots.
"""

import numpy as np
import pytest
import torch

from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.ops.coded import (coded_apply_reference,
                                                  from_assembled_coded)
from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
from eddy_currents_3d_tpu_torch.testing import cases

pytestmark = pytest.mark.cuda

ATOL = 3e-6
DOT_RTOL = 2e-5

CASES = {
    "static": lambda: cases.case_static(shape_xyz=(40, 36, 20), steps=2),
    "convection": lambda: cases.case_convection(shape_xyz=(24, 12, 10), steps=2),
    "inertia_on_faces": lambda: cases.case_static(shape_xyz=(33, 17, 12), steps=2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(name, dev, seed=0):
    model = cases.load_case(CASES[name]())
    iof = name == "inertia_on_faces"
    sysm = assemble_operator(model, torch.float32, dev, inertia_on_faces=iof)
    op = from_assembled_coded(sysm, model, dev, inertia_on_faces=iof)
    rng = np.random.default_rng(seed)
    shape = model.shape_zyx
    cm = np.asarray(model.cond_mask)
    f = lambda a: torch.from_numpy(a).to(dev, torch.float32)
    x = State(f(rng.standard_normal((3,) + shape)), f(rng.standard_normal(shape) * cm))
    w = State(f(rng.standard_normal((3,) + shape)), f(rng.standard_normal(shape) * cm))
    return op, x, w


def _ref(op, A, U, w=None):
    return coded_apply_reference(A, U, op.code, op.cf, op.conv, op.consts,
                                 op.inertia_on_faces, w)


def _close(got, ref, scale):
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= ATOL * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_matches_plain(cuda, name):
    op, x, _ = _setup(name, cuda)
    n0 = coded_matvec.launches
    yA, yU = coded_matvec(op, x.A, x.U)
    torch.cuda.synchronize()
    assert coded_matvec.launches == n0 + 1
    rA, rU = _ref(op, x.A, x.U)
    scale = rA.abs().max().item()
    _close(yA, rA, scale)
    _close(yU, rU, max(rU.abs().max().item(), scale))
    assert not torch.any(yU[op.code == 0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_dots_matches_plain(cuda, name):
    op, x, w = _setup(name, cuda)
    yA, yU, pw, py = coded_matvec(op, x.A, x.U, w)
    zA, zU = coded_matvec(op, x.A, x.U)
    assert torch.equal(yA, zA) and torch.equal(yU, zU)
    rA, rU, _, _ = _ref(op, x.A, x.U, w)
    _close(yA, rA, rA.abs().max().item())
    ref_w = float((yA.double() * w.A.double()).sum() + (yU.double() * w.U.double()).sum())
    ref_y = float((yA.double() ** 2).sum() + (yU.double() ** 2).sum())
    assert abs(float(pw) - ref_w) < DOT_RTOL * max(abs(ref_w), 1.0)
    assert abs(float(py) - ref_y) < DOT_RTOL * max(abs(ref_y), 1.0)
    # no atomics: the partials repeat bit for bit
    _, _, pw2, py2 = coded_matvec(op, x.A, x.U, w)
    assert float(pw2) == float(pw) and float(py2) == float(py)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_div_matches_plain(cuda, name):
    op, x, _ = _setup(name, cuda)
    d = coded_matvec(op, x.A)
    r = _ref(op, x.A, None)[1]
    _close(d, r, max(r.abs().max().item(), 1.0))


def test_wrapper_rejects_bad_inputs(cuda):
    op, x, _ = _setup("static", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        coded_matvec(op, x.A.transpose(2, 3).contiguous().transpose(2, 3), x.U)
    with pytest.raises(ValueError, match="float32"):
        coded_matvec(op, x.A.double(), x.U)
    with pytest.raises(ValueError, match="is on"):
        coded_matvec(op, x.A, x.U.cpu())


def test_simulation_runs_through_the_kernel(cuda):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(20, 20, 12), steps=3))
    sim = Simulation(model, torch.float32, device=cuda)
    n0 = coded_matvec.launches
    st, diag = sim.run()
    assert not diag["unconverged_steps"]
    assert coded_matvec.launches - n0 >= 2 * diag["total_iterations"]
    assert torch.isfinite(st.A).all() and torch.isfinite(st.carry).all()
    with pytest.raises(ValueError, match="not ported to CUDA"):
        Simulation(model, torch.float64, device=cuda)
