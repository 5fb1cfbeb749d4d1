"""The hand-written CUDA kernels against their plain torch versions, on
the card: the whole-plane coded matvec, the split route's stencil and
conductor-slab kernels, the field tier's field_a and field_u (float32
and bfloat16 coefficients, float32 and bfloat16 state), and the
block-sparse SpMM (float32 and float64, each of its routes).  The coded
kernels finish their dots inside the kernel: one launch per whole-plane
apply_dots, two per split one, the same bits on every call and on two
streams at once.  Every test here needs a CUDA device and nvcc and skips without
them.  The file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances are those of the CPU parity tests (tests/test_torch_coded.py):
3e-6 of the output scale for the matvec, 2e-5 relative for the fused dots.
At bfloat16 state (bfloat16 coefficients) the field kernels and their
plain versions both sum in float32 in one order, with no FMA contraction,
and round once to bfloat16: they must agree bit for bit.  One FMA in the
kernel would move a cell by at most one bfloat16 ulp, 2^-8 of the output
scale, which a tolerance of that size could not see.
The SpMM sums at most width*C products per output in another order than
the plain einsum: 3e-6 (float32) and 1e-12 (float64) of max(|B|·|X|).
"""

import dataclasses

import numpy as np
import pytest
import torch

from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.ops import coded
from eddy_currents_3d_tpu_torch.ops.coded import (CodedUnsupported,
                                                  coded_apply_reference,
                                                  coded_slab_reference,
                                                  coded_stencil_reference,
                                                  from_assembled_coded)
from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (coded_slab,
                                                             coded_stencil)
from eddy_currents_3d_tpu_torch.ops.field import (FieldStencilOperator,
                                                  field_a_reference,
                                                  field_u_reference)
from eddy_currents_3d_tpu_torch.ops.field_cuda import (aligned4, field_a,
                                                       field_u, pair_route,
                                                       pairs_aligned)
from eddy_currents_3d_tpu_torch.ops.bsr_cuda import (bsr_matvec, bsr_spmm,
                                                     bsr_spmm_reference)
from eddy_currents_3d_tpu_torch.ops.coded_cuda import whole_plan
from eddy_currents_3d_tpu_torch.ops.sparse import BSRMatrix, bsr_from_scipy
from eddy_currents_3d_tpu_torch.testing import cases

pytestmark = pytest.mark.cuda

ATOL = 3e-6
DOT_RTOL = 2e-5


def _z_through():
    """A conductor through every z plane: the split route's stencil kernel
    owns no plane (tests/_torch_parity.py z_through_case, which this file
    cannot import: it needs jax)."""
    nx, ny, nz = 20, 14, 8
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[:, 3:ny - 3, 6:nx - 3] = 1
    geo[2:6, 3:ny - 3, 2] = 2
    names = ["plast D=1 C='mu0*35e6'", "coil D=1 SRCy=F",
             "param tran stop=0.002 step=1e-3",
             "p2 solver tol=5e-3 itmax=10000 dir=out",
             "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t"]
    return cases.make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel())


def _one_plane_runs():
    """The conductor on planes 1..6 of 8, nx = 33: the stencil kernel owns
    two runs of one plane, each next to the slab, and nx is a multiple
    neither of 4 nor of a tile."""
    nx, ny, nz = 33, 14, 8
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[1:7, 3:ny - 3, 6:nx - 3] = 1
    geo[2:6, 3:ny - 3, 2] = 2
    names = ["plast D=1 C='mu0*35e6'", "coil D=1 SRCy=F",
             "param tran stop=0.002 step=1e-3",
             "p2 solver tol=5e-3 itmax=10000 dir=out",
             "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t"]
    return cases.make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel())


CASES = {
    "static": lambda: cases.case_static(shape_xyz=(40, 36, 20), steps=2),
    "convection": lambda: cases.case_convection(shape_xyz=(24, 12, 10), steps=2),
    "inertia_on_faces": lambda: cases.case_static(shape_xyz=(33, 17, 12), steps=2),
    "z_through": _z_through,
}
# the split pair's cases: CASES, nx = 50, runs of one plane, and 21 owned
# planes above the slab, which the stencil kernel's runs of <= 8 planes cut
# at 14 and 21, so run boundaries fall next to the slab and inside the
# owned range (tests/test_torch_split.py checks the plans)
SPLIT_CASES = dict(
    CASES,
    nx50=lambda: cases.case_static(shape_xyz=(50, 20, 16), steps=2),
    one_plane_runs=_one_plane_runs,
    short_runs=lambda: cases.case_static(shape_xyz=(40, 24, 28), steps=2),
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(name, dev, seed=0):
    model = cases.load_case(SPLIT_CASES[name]())
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


def _device_kernels(fn):
    """{device kernel: launches} of one call of ``fn`` after a warm-up,
    counted by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def test_apply_dots_is_one_launch(cuda):
    """apply_dots on the whole-plane route: the kernel and no other device
    work (the dots are finished in the kernel)."""
    op, x, w = _setup("static", cuda)
    assert not op.split
    kernels = _device_kernels(lambda: op.apply_dots(x, w))
    assert sum(kernels.values()) == 1, kernels
    assert any("whole_march" in k for k in kernels)
    _, pw, py = op.apply_dots(x, w)
    assert pw.data_ptr() + 4 == py.data_ptr()      # views of one tensor


def test_whole_dots_repeat_across_operators(cuda):
    """100 whole-plane apply_dots back to back, alternating between two
    operators: each operator's dots keep their bits (the counter
    resets)."""
    pairs = [_setup(name, cuda, seed) for name, seed in (("static", 0),
                                                        ("convection", 1))]
    first = [torch.stack(coded_matvec(op, x.A, x.U, w)[2:])
             for op, x, w in pairs]
    got = [[] for _ in pairs]
    for _ in range(50):
        for j, (op, x, w) in enumerate(pairs):
            got[j].append(torch.stack(coded_matvec(op, x.A, x.U, w)[2:]))
    for ref, runs in zip(first, got):
        assert all(torch.equal(r, ref) for r in runs)


@pytest.mark.parametrize("route", ["whole", "split"])
def test_dots_on_two_streams_at_once(cuda, route, monkeypatch):
    """One operator's apply_dots on two streams at once: each stream keeps
    its own partials and counter, so every call's dots are those of a
    one-stream run, bit for bit."""
    if route == "split":
        monkeypatch.setattr(coded, "_WHOLE_PLANE_BUDGET", 0)
    op, x, w = _setup("static", cuda)
    assert op.split == (route == "split")
    xs, ws = op.pad_state(x), op.pad_state(w)
    ref = torch.stack(op.apply_dots(xs, ws)[1:])
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = {j: [] for j in range(2)}
    for _ in range(50):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[j].append(torch.stack(op.apply_dots(xs, ws)[1:]))
    torch.cuda.synchronize()
    for runs in got.values():
        assert all(torch.equal(r, ref) for r in runs)


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_whole_route_equals_split_pair(cuda, name):
    """The whole-plane kernel (conducting runs decoded, the others
    stencil only) and the split pair give the same yA and yU, bit for bit,
    on every plan shape of the card cases."""
    op, x, _ = _setup(name, cuda)
    zb0, zb1 = op.cond_z
    flags = [c for _, _, c in whole_plan(op.shape_zyx, op.cond_z).runs]
    assert flags == sorted(flags, reverse=True)     # conducting runs first
    yA, yU = coded_matvec(op, x.A, x.U)
    sA = coded_stencil(op, x.A)
    sU = coded_slab(op, x.A, x.U[zb0:zb1], sA)
    assert torch.equal(yA, sA) and torch.equal(yU[zb0:zb1], sU)
    assert not torch.any(yU[:zb0]) and not torch.any(yU[zb1:])


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
    # float64 runs on the card too, on the flat-roll operator: no kernel
    n1 = coded_matvec.launches
    sim64 = Simulation(model, torch.float64, device=cuda)
    assert sim64.op is sim64.system.op and not sim64.use_pallas
    _, d64 = sim64.run()
    assert not d64["unconverged_steps"] and coded_matvec.launches == n1


# ---- the split route: stencil kernel + conductor-slab kernel ----

@pytest.fixture
def split_case(request, cuda):
    """(name, op, x, w) of a SPLIT_CASES case."""
    name = request.param
    return (name,) + _setup(name, cuda)


def _split_ref(op, x, w=None):
    """The split pair's plain versions: (yA, compact yU[, dots])."""
    zb0, zb1 = op.cond_z
    Uc = x.U[zb0:zb1]
    rA = coded_stencil_reference(x.A, op.consts, op.cond_z)
    out = coded_slab_reference(x.A, Uc, op.code, op.cf, op.conv, op.consts,
                               op.inertia_on_faces, op.cond_z,
                               None if w is None else State(w.A, w.U[zb0:zb1]))
    rA[:, zb0:zb1] = out[0]
    return (rA,) + tuple(out[1:])


@pytest.mark.parametrize("split_case", sorted(SPLIT_CASES), indirect=True)
def test_split_apply_matches_plain(cuda, split_case):
    name, op, x, _ = split_case
    zb0, zb1 = op.cond_z
    n_st, n_sl, n_mv = coded_stencil.launches, coded_slab.launches, coded_matvec.launches
    yA = coded_stencil(op, x.A)
    yU = coded_slab(op, x.A, x.U[zb0:zb1], yA)
    torch.cuda.synchronize()
    # the stencil kernel launches only when it owns a plane
    owns = op.shape_zyx[0] > zb1 - zb0
    assert (coded_stencil.launches, coded_slab.launches) == (n_st + owns, n_sl + 1)
    assert coded_matvec.launches == n_mv
    rA, rU = _split_ref(op, x)
    scale = rA.abs().max().item()
    _close(yA, rA, scale)
    _close(yU, rU, max(rU.abs().max().item(), scale))
    # the pair computes the whole-plane kernel's matvec, bit for bit: one
    # copy of each cell's arithmetic (coded_cell.cuh)
    mA, mU = coded_matvec(op, x.A, x.U)
    assert torch.equal(yA, mA) and torch.equal(yU, mU[zb0:zb1])


@pytest.mark.parametrize("split_case", sorted(SPLIT_CASES), indirect=True)
def test_split_apply_dots_matches_plain(cuda, split_case):
    name, op, x, w = split_case
    zb0, zb1 = op.cond_z
    Uc, wc = x.U[zb0:zb1], State(w.A, w.U[zb0:zb1])
    yA, dots_a = coded_stencil(op, x.A, w.A)
    yU, dots_b = coded_slab(op, x.A, Uc, yA, wc)
    zA = coded_stencil(op, x.A)
    zU = coded_slab(op, x.A, Uc, zA)
    assert torch.equal(yA, zA) and torch.equal(yU, zU)
    rA, rU = _split_ref(op, x)
    _close(yA, rA, rA.abs().max().item())
    own = torch.cat([torch.arange(0, zb0), torch.arange(zb1, op.shape_zyx[0])])
    own = own.to(cuda)
    for dots, parts in (
            (dots_a, [(yA[:, own], w.A[:, own])]),
            (dots_b, [(yA[:, zb0:zb1], w.A[:, zb0:zb1]), (yU, wc.U)])):
        ref_w = sum(float((a.double() * b.double()).sum()) for a, b in parts)
        ref_y = sum(float((a.double() ** 2).sum()) for a, _ in parts)
        assert abs(float(dots[0]) - ref_w) < DOT_RTOL * max(abs(ref_w), 1.0)
        assert abs(float(dots[1]) - ref_y) < DOT_RTOL * max(abs(ref_y), 1.0)
    # the slab kernel adds prior dots first: stencil + slab
    _, tot = coded_slab(op, x.A, Uc, torch.empty_like(x.A), wc, dots_a)
    assert torch.equal(tot, dots_a + dots_b)
    # no atomics in the sums: the dots repeat bit for bit
    _, dots2 = coded_stencil(op, x.A, w.A)
    _, dots3 = coded_slab(op, x.A, Uc, torch.empty_like(x.A), wc)
    assert torch.equal(dots2, dots_a) and torch.equal(dots3, dots_b)


@pytest.mark.parametrize("split_case", sorted(SPLIT_CASES), indirect=True)
def test_split_apply_div_matches_plain(cuda, split_case):
    name, op, x, _ = split_case
    zb0, zb1 = op.cond_z
    d = coded_slab(op, x.A)
    r = coded_slab_reference(x.A, None, op.code, op.cf, op.conv, op.consts,
                             op.inertia_on_faces, op.cond_z)
    _close(d, r, max(r.abs().max().item(), 1.0))
    assert torch.equal(d, coded_matvec(op, x.A)[zb0:zb1])


def _split_op(name, dev, seed, monkeypatch):
    monkeypatch.setattr(coded, "_WHOLE_PLANE_BUDGET", 0)
    op, x, w = _setup(name, dev, seed)
    assert op.split
    return op, op.pad_state(x), op.pad_state(w)


def test_split_apply_dots_is_two_launches(cuda, monkeypatch):
    """apply_dots on the split route: the two kernels and no other device
    work (the dots are finished in the kernels), counted by the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    op, x, w = _split_op("static", cuda, 0, monkeypatch)
    op.apply_dots(x, w)              # makes the wrappers' scratch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y, pw, py = op.apply_dots(x, w)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    assert sum(kernels.values()) == 2, kernels
    assert any("stencil_march" in k for k in kernels)
    assert any("slab_march" in k for k in kernels)
    assert pw.data_ptr() + 4 == py.data_ptr()      # views of one tensor


def test_split_dots_repeat_across_operators(cuda, monkeypatch):
    """100 apply_dots back to back, alternating between two operators:
    each operator's dots keep their bits (the counter resets)."""
    pairs = [_split_op(name, cuda, seed, monkeypatch)
             for name, seed in (("static", 0), ("convection", 1))]
    first = [torch.stack(op.apply_dots(x, w)[1:]) for op, x, w in pairs]
    got = [[] for _ in pairs]
    for _ in range(50):
        for j, (op, x, w) in enumerate(pairs):
            got[j].append(torch.stack(op.apply_dots(x, w)[1:]))
    for ref, runs in zip(first, got):
        assert all(torch.equal(r, ref) for r in runs)


def test_split_wrappers_reject_bad_inputs(cuda, monkeypatch):
    op, x, w = _setup("static", cuda)
    zb0, zb1 = op.cond_z
    Uc = x.U[zb0:zb1]
    yA = torch.empty_like(x.A)
    with pytest.raises(ValueError, match="shape"):
        coded_slab(op, x.A, x.U, yA)                      # full-shape U
    with pytest.raises(ValueError, match="float32"):
        coded_stencil(op, x.A.double())
    with pytest.raises(ValueError, match="contiguous"):
        coded_slab(op, x.A, Uc.transpose(1, 2).contiguous().transpose(1, 2),
                   yA)
    with pytest.raises(ValueError, match="is on"):
        coded_slab(op, x.A, Uc.cpu(), yA)
    with pytest.raises(ValueError, match="yA"):
        coded_slab(op, x.A, Uc)
    wc = State(w.A, w.U[zb0:zb1])
    with pytest.raises(ValueError, match="prior"):
        coded_slab(op, x.A, Uc, yA, wc, torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="prior"):
        coded_slab(op, x.A, Uc, yA, None, torch.zeros(2, device=cuda))
    import dataclasses
    bad = dataclasses.replace(op, cond_z=(zb1, zb0))
    with pytest.raises(ValueError, match="conductor planes"):
        coded_stencil(bad, x.A)
    # a plan made for another tile than the source's is refused
    from eddy_currents_3d_tpu_torch.ops import coded_split_cuda
    monkeypatch.setattr(coded_split_cuda, "STENCIL_TILE", (1, 4, 4))
    other, _, _ = _setup("static", cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        coded_stencil(other, x.A)


def test_simulation_runs_through_the_split_kernels(cuda, monkeypatch):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(20, 20, 12), steps=3))
    whole, _ = Simulation(model, torch.float32, device=cuda).run()
    monkeypatch.setattr(coded, "_WHOLE_PLANE_BUDGET", 0)
    for precond in (None, "jacobi", "cheb_jacobi"):
        sim = Simulation(model, torch.float32, device=cuda, precond=precond,
                         cheb_order=8)
        assert sim.coded_op.split
        n = (coded_stencil.launches, coded_slab.launches, coded_matvec.launches)
        st, diag = sim.run()
        assert not diag["unconverged_steps"]
        assert coded_stencil.launches > n[0] and coded_slab.launches > n[1]
        assert coded_matvec.launches == n[2]          # no whole-plane fallback
        tol = model.solver.tolerance
        scale = whole.A.abs().max().item()
        assert (st.A - whole.A).abs().max().item() <= 4 * tol * scale
        assert not torch.any(st.U[~sim.system.cond_mask])


def _nocond_text():
    return cases.case_static(shape_xyz=(12, 12, 12), steps=2).replace(
        "C='mu0*35260000.0'", "C=0")


def test_unported_cuda_options_raise(cuda):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(12, 12, 12), steps=2))
    sim = Simulation(model, torch.bfloat16, device=cuda)   # bf16 state runs
    assert sim.coded_op is None and sim.field_op.ka.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype=torch.bfloat16"):
        Simulation(model, torch.bfloat16, device=cuda, use_coded=True)
    with pytest.raises(ValueError, match="precond='mg'"):
        Simulation(model, torch.float32, device=cuda, precond="mg",
                   use_coded=True)
    with pytest.raises(ValueError, match="take no float64"):
        Simulation(model, torch.float64, device=cuda, use_pallas=True)
    with pytest.raises(CodedUnsupported, match="no conducting"):
        Simulation(cases.load_case(_nocond_text()), torch.float32,
                   device=cuda, use_coded=True)


# ---- the field tier: field_a + field_u, float32 and bfloat16 coefficients ----

FIELD_CASES = {
    "static": lambda: cases.case_static(shape_xyz=(40, 36, 20), steps=2),
    "convection": lambda: cases.case_convection(shape_xyz=(24, 12, 10), steps=2),
    "nocond": _nocond_text,
    "odd": lambda: cases.case_static(shape_xyz=(21, 19, 11), steps=2),
}
COEF = {"f32": torch.float32, "bf16": torch.bfloat16}


def _field_setup(name, coef, dev, seed=0):
    model = cases.load_case(FIELD_CASES[name]())
    sysm = assemble_operator(model, torch.float32, dev)
    if COEF[coef] != torch.float32:
        sysm = dataclasses.replace(sysm, op=sysm.op.astype(COEF[coef]))
    op = FieldStencilOperator.from_assembled(sysm)
    rng = np.random.default_rng(seed)
    shape = model.shape_zyx
    cm = np.asarray(model.cond_mask)
    f = lambda a: torch.from_numpy(a).to(dev, torch.float32)
    x = State(f(rng.standard_normal((3,) + shape)),
              f(rng.standard_normal(shape) * cm))
    return op, x


def _box(op):
    z0, z1, y0, y1, x0, x1 = op.box
    return (slice(None), slice(z0, z1), slice(y0, y1), slice(x0, x1))


@pytest.mark.parametrize("coef", sorted(COEF))
@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_field_a_matches_plain(cuda, name, coef):
    op, x = _field_setup(name, coef, cuda)
    assert op.ka.dtype == COEF[coef]
    n0 = field_a.launches
    y = field_a(op.ka, x.A)
    torch.cuda.synchronize()
    assert field_a.launches == n0 + 1
    r = field_a_reference(op.ka, x.A)
    assert y.dtype == r.dtype == torch.float32
    _close(y, r, r.abs().max().item())
    assert torch.equal(field_a(op.ka, x.A), y)        # repeats bit for bit


@pytest.mark.parametrize("coef", sorted(COEF))
@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_field_u_matches_plain(cuda, name, coef):
    op, x = _field_setup(name, coef, cuda, seed=1)
    yA = field_a(op.ka, x.A)
    if op.box is None:
        with pytest.raises(ValueError, match="box"):
            field_u(op, x.A, x.U, yA)
        return
    rA = yA.clone()
    n0 = field_u.launches
    yU = field_u(op, x.A, x.U, yA)
    torch.cuda.synchronize()
    assert field_u.launches == n0 + 1
    gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, x.A, x.U)
    rA[_box(op)] += gout
    rU = torch.zeros_like(x.U)
    rU[_box(op)[1:]] = uout
    scale = rA.abs().max().item()
    _close(yA, rA, scale)
    _close(yU, rU, max(rU.abs().max().item(), scale))
    again = field_a(op.ka, x.A)
    assert torch.equal(field_u(op, x.A, x.U, again), yU) and torch.equal(again, yA)
    # the whole apply against the same operator's plain apply on the CPU
    cpu = dataclasses.replace(op, **{f: getattr(op, f).cpu()
                                     for f in ("ka", "gu", "ku", "da")})
    ref = cpu.apply(State(x.A.cpu(), x.U.cpu()))
    y = op.apply(x)
    _close(y.A.cpu(), ref.A, scale)
    _close(y.U.cpu(), ref.U, max(ref.U.abs().max().item(), scale))


def _bf16_state(x):
    return State(x.A.to(torch.bfloat16), x.U.to(torch.bfloat16))


def _equal_bf16(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.double() - ref.double()).abs().max().item()
    assert torch.equal(got, ref), (err, ref.double().abs().max().item())


# How a bfloat16-state test launches: "auto" as pair_route chooses (the
# paired route where the width is even: static's box starts at x0 = 1,
# convection's at 0); "scalar" forced onto the one-cell kernels, also on
# the even grids; "unaligned" as chosen for a copy 2 bytes off a word
# boundary, which takes the scalar route.
BF16_ROUTES = ("auto", "scalar", "unaligned")


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a word."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert not aligned4(out)
    return out


def _route_counts(w):
    return (w.launches, w.bf16_state.launches, w.paired.launches,
            w.scalar.launches)


def _stepped(w, before, route):
    """The counts of wrapper ``w`` rose by one launch on ``route``."""
    step = (1, 1, 1, 0) if route == "paired" else (1, 1, 0, 1)
    assert _route_counts(w) == tuple(a + b for a, b in zip(before, step))


def _expected_route(route, shape_zyx, box=None, fields=3):
    if route != "auto":
        return "scalar"
    return pair_route(shape_zyx, box, True, fields)


@pytest.mark.parametrize("fields", [3, 1])
@pytest.mark.parametrize("route", BF16_ROUTES)
@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_field_a_bf16_state_matches_plain(cuda, name, route, fields):
    op, x = _field_setup(name, "bf16", cuda)
    xb = _bf16_state(x)
    A = xb.A if fields == 3 else xb.A[1].contiguous()
    if route == "unaligned":
        A = _unaligned(A)
    took = _expected_route(route, op.shape_zyx, fields=fields)
    assert took == ("paired" if route == "auto" and op.shape_zyx[2] % 2 == 0
                    else "scalar")
    asked = "scalar" if route == "scalar" else None
    n0 = _route_counts(field_a)
    y = field_a(op.ka, A, route=asked)
    torch.cuda.synchronize()
    _stepped(field_a, n0, took)
    r = field_a_reference(op.ka, A)
    _equal_bf16(y, r)
    assert torch.equal(field_a(op.ka, A, route=asked), y)   # repeats
    # the other route gives the same bits
    assert torch.equal(field_a(op.ka, A, route="scalar"), y)
    # a float32 state launch is not counted as a bfloat16-state one
    n1 = _route_counts(field_a)
    field_a(op.ka, x.A)
    assert _route_counts(field_a) == (n1[0] + 1,) + n1[1:]


@pytest.mark.parametrize("route", BF16_ROUTES)
@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_field_u_bf16_state_matches_plain(cuda, name, route):
    op, x = _field_setup(name, "bf16", cuda, seed=1)
    xb = _bf16_state(x)
    yA = field_a(op.ka, xb.A)
    if op.box is None:
        with pytest.raises(ValueError, match="box"):
            field_u(op, xb.A, xb.U, yA)
        return
    if route == "unaligned":
        yA = _unaligned(yA)
    took = _expected_route(route, op.shape_zyx, op.box)
    assert took == ("paired" if route == "auto" and name != "odd"
                    else "scalar")
    asked = "scalar" if route == "scalar" else None
    rA = yA.clone()
    yA_scalar = yA.clone()
    n0 = _route_counts(field_u)
    yU = field_u(op, xb.A, xb.U, yA, route=asked)
    torch.cuda.synchronize()
    _stepped(field_u, n0, took)
    gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, xb.A, xb.U)
    rA[_box(op)] += gout                    # float32 terms, one rounding
    rU = torch.zeros_like(xb.U)
    rU[_box(op)[1:]] = uout
    _equal_bf16(yA, rA)
    _equal_bf16(yU, rU)
    # the other route gives the same bits
    assert torch.equal(field_u(op, xb.A, xb.U, yA_scalar, route="scalar"), yU)
    assert torch.equal(yA_scalar, yA)
    # the whole apply against the same operator's plain apply on the CPU
    cpu = dataclasses.replace(op, **{f: getattr(op, f).cpu()
                                     for f in ("ka", "gu", "ku", "da")})
    ref = cpu.apply(State(xb.A.cpu(), xb.U.cpu()))
    y = op.apply(xb)
    assert y.A.dtype == y.U.dtype == torch.bfloat16
    _equal_bf16(y.A.cpu(), ref.A)
    _equal_bf16(y.U.cpu(), ref.U)


def _off_pair(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    boundary of two (float32: 4 bytes off 8)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert not pairs_aligned(out)
    return out


@pytest.mark.parametrize("route", BF16_ROUTES)
@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_f32_coef_bf16_state_matches_plain(cuda, name, route):
    """float32 coefficients at bfloat16 state (``coeff_dtype=float32``):
    field_a on the paired route (field_a_pairs_f32) where the width is
    even, on the one-cell (float, bf16) kernel asked for by name, on odd
    widths and for an unaligned state or ka; field_u on its one-cell kernel.
    Each equals its plain version bit for bit, both field_a routes give the
    same bits, and each launch is counted on its route and as a
    float32-coefficient one."""
    op, x = _field_setup(name, "f32", cuda, seed=2)
    xb = _bf16_state(x)
    assert op.ka.dtype == torch.float32
    ka, A = op.ka, xb.A
    if route == "unaligned":
        ka, A = _off_pair(ka), _unaligned(A)
    took = ("paired" if route == "auto" and op.shape_zyx[2] % 2 == 0
            else "scalar")
    if route != "scalar":
        assert pair_route(op.shape_zyx, None, pairs_aligned(ka, A),
                          coef_bf16=False) == took
    asked = "scalar" if route == "scalar" else None
    n0 = _route_counts(field_a) + (field_a.f32_coef.launches,)
    y = field_a(ka, A, route=asked)
    torch.cuda.synchronize()
    step = (1, 1, 1, 0, 1) if took == "paired" else (1, 1, 0, 1, 1)
    assert _route_counts(field_a) + (field_a.f32_coef.launches,) == tuple(
        a + b for a, b in zip(n0, step))
    _equal_bf16(y, field_a_reference(op.ka, xb.A))
    assert torch.equal(field_a(ka, A, route=asked), y)      # repeats
    assert torch.equal(field_a(ka, A, route="scalar"), y)   # the other route
    if route == "unaligned":           # each misaligned operand alone
        assert torch.equal(field_a(op.ka, A), y)
        assert torch.equal(field_a(ka, xb.A), y)
    if op.box is None:
        return
    yA, rA = y.clone(), y.clone()
    n0 = _route_counts(field_u) + (field_u.f32_coef.launches,)
    yU = field_u(op, A, xb.U, yA, route=asked)
    torch.cuda.synchronize()
    assert _route_counts(field_u) + (field_u.f32_coef.launches,) == tuple(
        a + b for a, b in zip(n0, (1, 1, 0, 1, 1)))
    gout, uout = field_u_reference(op.gu, op.ku, op.da, op.box, xb.A, xb.U)
    rA[_box(op)] += gout                    # float32 terms, one rounding
    rU = torch.zeros_like(xb.U)
    rU[_box(op)[1:]] = uout
    _equal_bf16(yA, rA)
    _equal_bf16(yU, rU)
    if route != "auto":
        return
    # the whole apply against the same operator's plain apply on the CPU
    cpu = dataclasses.replace(op, **{f: getattr(op, f).cpu()
                                     for f in ("ka", "gu", "ku", "da")})
    ref = cpu.apply(State(xb.A.cpu(), xb.U.cpu()))
    yy = op.apply(xb)
    _equal_bf16(yy.A.cpu(), ref.A)
    _equal_bf16(yy.U.cpu(), ref.U)


def test_field_wrappers_take_bf16_state_on_the_card(cuda, monkeypatch):
    """A bfloat16 CUDA tensor launches the bfloat16-state kernel and gets
    bfloat16 back: no upcast, no plain version; mixed state dtypes are
    refused, and float32 coefficients with bfloat16 state take the paired
    route in field_a (field_a_pairs_f32) and the scalar (float, bf16)
    kernel in field_u, which refuses the paired route by name."""
    from eddy_currents_3d_tpu_torch.ops import field_cuda
    op, x = _field_setup("static", "bf16", cuda)
    xb = _bf16_state(x)
    calls = []
    real = field_cuda.field_a_reference
    monkeypatch.setattr(field_cuda, "field_a_reference",
                        lambda *a: calls.append(a) or real(*a))
    y = field_a(op.ka, xb.A)
    assert y.dtype == torch.bfloat16 and y.is_cuda and not calls
    with pytest.raises(ValueError, match="bfloat16"):
        field_u(op, xb.A, x.U, y)                   # float32 U, bf16 A
    op32, _ = _field_setup("static", "f32", cuda)
    n0 = _route_counts(field_a) + (field_a.f32_coef.launches,)
    y32 = field_a(op32.ka, xb.A)
    assert y32.dtype == torch.bfloat16 and not calls
    assert _route_counts(field_a) + (field_a.f32_coef.launches,) == tuple(
        a + b for a, b in zip(n0, (1, 1, 1, 0, 1)))
    assert torch.equal(field_a(op32.ka, xb.A, route="paired"), y32)
    with pytest.raises(ValueError, match="field_u, bfloat16 coefficients"):
        field_u(op32, xb.A, xb.U, y32, route="paired")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        field_a(op.ka, x.A.half())
    # the route: the paired one only where it applies, bfloat16 state only
    with pytest.raises(ValueError, match="route must be"):
        field_a(op.ka, xb.A, route="pairs")
    with pytest.raises(ValueError, match="bfloat16 state only"):
        field_a(op32.ka, x.A, route="scalar")
    odd, xo = _field_setup("odd", "bf16", cuda)
    xo = _bf16_state(xo)
    with pytest.raises(ValueError, match="paired route needs"):
        field_a(odd.ka, xo.A, route="paired")
    with pytest.raises(ValueError, match="paired route needs"):
        field_u(odd, xo.A, xo.U, field_a(odd.ka, xo.A), route="paired")


BF16_RUNS = {
    "none_dot_f32": {"dot_dtype": torch.float32},
    "none_dot_none": {},
    "jacobi": {"dot_dtype": torch.float32, "precond": "jacobi"},
    "cheb_jacobi": {"dot_dtype": torch.float32, "precond": "cheb_jacobi",
                    "cheb_order": 8},
    "mg": {"dot_dtype": torch.float32, "precond": "mg"},
    "ilu0": {"dot_dtype": torch.float32, "precond": "ilu0"},
}


@pytest.mark.parametrize("run", sorted(BF16_RUNS))
def test_bf16_simulation_runs_through_the_field_kernels(cuda, run):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(20, 20, 12), steps=3))
    sim = Simulation(model, torch.bfloat16, device=cuda, **BF16_RUNS[run])
    assert sim.coded_op is None and sim.field_op.ka.dtype == torch.bfloat16
    ks = (field_a, field_u, coded_matvec, coded_stencil, coded_slab,
          field_a.bf16_state, field_u.bf16_state, field_a.paired,
          field_u.paired, field_a.scalar, field_u.scalar)
    n = [k.launches for k in ks]
    st, diag = sim.run()
    d = [k.launches - n0 for k, n0 in zip(ks, n)]
    assert not diag["unconverged_steps"]
    assert st.A.dtype == st.U.dtype == st.carry.dtype == torch.bfloat16
    assert torch.isfinite(st.A.float()).all()
    assert d[0] >= 2 * diag["total_iterations"] and d[1] > 0
    assert d[2:5] == [0, 0, 0]                        # no coded kernel
    assert d[5:7] == d[:2]                            # all at bf16 state
    # each counted on one route: 20 x 20 takes the paired one
    assert [d[7] + d[9], d[8] + d[10]] == d[5:7] and d[7] > 0 and d[8] > 0


def test_simulation_defaults_to_the_card(cuda):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(12, 12, 12), steps=2))
    sim = Simulation(model)
    assert sim.device.type == "cuda" and sim.system.inert.is_cuda
    assert assemble_operator(model, torch.float32).inert.is_cuda
    st, diag = sim.run()
    assert st.A.is_cuda and not diag["unconverged_steps"]


def test_field_a_on_a_coarse_multigrid_level(cuda):
    from eddy_currents_3d_tpu_torch.solvers.multigrid import (build_mg,
                                                               stencil7_apply)
    op, _ = _field_setup("odd", "f32", cuda)
    mg = build_mg(op.ka, dtype=torch.float32, device=cuda)
    assert len(mg.levels) >= 3
    rng = np.random.default_rng(2)
    for lvl in mg.levels[1:]:
        v = torch.from_numpy(rng.standard_normal((3,) + lvl.shape)).to(
            cuda, torch.float32)
        n0 = field_a.launches
        y = stencil7_apply(lvl.ka, v)
        assert field_a.launches == n0 + 1
        r = stencil7_apply(lvl.ka.cpu(), v.cpu())    # the flat-roll form
        _close(y.cpu(), r, r.abs().max().item())


def test_field_wrappers_reject_bad_inputs(cuda):
    op, x = _field_setup("static", "f32", cuda)
    with pytest.raises(ValueError, match="float32"):
        field_a(op.ka, x.A.double())
    with pytest.raises(ValueError, match="contiguous"):
        field_a(op.ka, x.A.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        field_a(op.ka.half(), x.A)
    with pytest.raises(ValueError, match="shape"):
        field_a(op.ka, x.A[:, :-1].contiguous())
    yA = field_a(op.ka, x.A)
    with pytest.raises(ValueError, match="share memory"):
        field_u(op, x.A, x.U, x.A)
    with pytest.raises(ValueError, match="float32"):
        field_u(op, x.A, x.U.double(), yA)
    with pytest.raises(ValueError, match="is on"):
        field_u(op, x.A, x.U.cpu(), yA)


FIELD_RUNS = {
    "use_coded_false": {"use_coded": False},
    "bf16_cheb_jacobi": {"coeff_dtype": torch.bfloat16,
                         "precond": "cheb_jacobi", "cheb_order": 8},
    "mg": {"precond": "mg"},
}


@pytest.mark.parametrize("run", sorted(FIELD_RUNS))
def test_simulation_runs_through_the_field_kernels(cuda, run):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(20, 20, 12), steps=3))
    coded_run, _ = Simulation(model, torch.float32, device=cuda).run()
    sim = Simulation(model, torch.float32, device=cuda, **FIELD_RUNS[run])
    assert sim.coded_op is None and sim.field_op is not None
    ks = (field_a, field_u, coded_matvec, coded_stencil, coded_slab)
    n = [k.launches for k in ks]
    st, diag = sim.run()
    d = [k.launches - n0 for k, n0 in zip(ks, n)]
    assert not diag["unconverged_steps"]
    assert d[0] >= 2 * diag["total_iterations"] and d[1] > 0
    assert d[2:] == [0, 0, 0]                         # no coded kernel
    assert torch.isfinite(st.A).all()
    if run != "bf16_cheb_jacobi":                      # same operator
        tol = model.solver.tolerance
        scale = coded_run.A.abs().max().item()
        assert (st.A - coded_run.A).abs().max().item() <= 4 * tol * scale


def test_no_conductor_model_runs_on_cuda(cuda):
    from eddy_currents_3d_tpu_torch import Simulation
    sim = Simulation(cases.load_case(_nocond_text()), torch.float32,
                     device=cuda)
    assert sim.coded_op is None and sim.field_op.box is None
    n = (field_a.launches, field_u.launches)
    st, diag = sim.run()
    assert not diag["unconverged_steps"] and torch.isfinite(st.A).all()
    assert field_a.launches > n[0] and field_u.launches == n[1]


# ---- ILU(0): its factors run the field kernels ----

@pytest.mark.parametrize("use_coded", [None, False], ids=["coded", "field"])
def test_simulation_runs_ilu0_through_the_field_kernels(cuda, use_coded):
    from eddy_currents_3d_tpu_torch import Simulation
    model = cases.load_case(cases.case_static(shape_xyz=(20, 20, 12), steps=3))
    plain, _ = Simulation(model, torch.float32, device=cuda).run()
    sim = Simulation(model, torch.float32, device=cuda, precond="ilu0",
                     use_coded=use_coded)
    assert sim._ilu.padded and sim._ilu.L_op.ka.is_cuda
    if use_coded is None:
        assert not sim.coded_op.compact_u
    ks = (field_a, field_u, coded_matvec, coded_stencil, coded_slab)
    n = [k.launches for k in ks]
    st, diag = sim.run()
    d = [k.launches - n0 for k, n0 in zip(ks, n)]
    its = diag["total_iterations"]
    assert not diag["unconverged_steps"] and torch.isfinite(st.A).all()
    # two preconditioner applies per iteration, each 2 + 2 factor sweeps
    assert d[0] >= 8 * its and d[1] >= 8 * its
    assert d[3:] == [0, 0]                            # no split kernel
    assert (d[2] >= 2 * its) == (use_coded is None)
    tol = model.solver.tolerance
    scale = plain.A.abs().max().item()
    assert (st.A - plain.A).abs().max().item() <= 4 * tol * scale


# ---- the block-sparse SpMM ----

SPMM_TOL = {torch.float32: 3e-6, torch.float64: 1e-12}


def _rand_bsr(block_shape, dtype, dev, n=203, density=0.05, seed=0):
    """A scipy random matrix on a grid that is not a multiple of the block
    size, as block-ELL on ``dev``."""
    from scipy import sparse
    a = sparse.random(n, n, density=density,
                      random_state=np.random.RandomState(seed)).tocsr()
    a.setdiag(1.0)
    return bsr_from_scipy(a, block_shape=block_shape, dtype=dtype, device=dev)


def _spmm_close(b, x, y, ref):
    bound = torch.einsum("rwij,rwjk->rik", b.blocks.abs(),
                         x.abs().reshape(-1, b.block_shape[1], x.shape[1])[
                             b.block_cols]).max().item()
    err = (y - ref).abs().max().item()
    assert err <= SPMM_TOL[b.blocks.dtype] * bound, (err, bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 4, 32, 100, 128, 256])
@pytest.mark.parametrize("block_shape", [(8, 8), (4, 8), (8, 16), (3, 12)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_bsr_spmm_matches_plain(cuda, block_shape, k, dtype):
    """Every route: vec and warp below k = 32, tiles from k = 32 (one
    chunk of 32, 100 and 128 columns; two at 256); each repeats bit for
    bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = _rand_bsr(block_shape, dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b.shape[1], k))).to(cuda, dtype)
    n0 = bsr_spmm.launches
    y = bsr_spmm(b, x)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == n0 + 1 and y.dtype == dtype
    _spmm_close(b, x, y, bsr_spmm_reference(b, x))
    assert torch.equal(bsr_spmm(b, x), y)           # repeats bit for bit
    R, C = block_shape
    pow2 = C & (C - 1) == 0
    vec = k == 1 and block_shape != (3, 12) and not (
        dtype == torch.float64 and block_shape == (8, 16))
    assert bsr_spmm.route(block_shape, k, dtype,
                          width=b.blocks.shape[1]) == (
        "vec" if vec else "warp" if k < 32 and pow2
        else "tiles" if k >= 32 else "lanes")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_bsr_tiles_info_fits_the_sm(cuda, dtype):
    """The tiles kernel at team7's shape (width 17, (8, 8) blocks, k =
    128) is resident at least once an SM, within its shared memory, with
    a window of one x block at least; a shape the route does not take is
    refused."""
    from eddy_currents_3d_tpu_torch.ops import bsr_cuda
    info = bsr_spmm.tiles_info(17, (8, 8), 128, dtype, cuda)
    assert info["ctas_per_sm"] >= 1 and info["window_blocks"] >= 1
    assert info["registers"] > 0
    assert info["threads"] == 32 * bsr_cuda.TILE_ROWS
    assert info["smem_bytes"] <= bsr_cuda.SMEM_MAX
    with pytest.raises(RuntimeError, match="bsr_tiles_info"):
        bsr_spmm.tiles_info(17, (8, 8), 33, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_bsr_spmm_unaligned_x_takes_lanes(cuda, dtype):
    """k = 128: an x 4 or 8 bytes off 16 takes the lanes route and gives
    the plain version's result; the aligned x the tiles route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = _rand_bsr((8, 8), dtype, cuda, seed=5)
    m, k = b.shape[1], 128
    vals = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (m, k))).to(cuda, dtype)
    buf = torch.zeros(m * k + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(m, k)
    shifted.copy_(vals)
    assert shifted.data_ptr() % 16 != 0 and vals.data_ptr() % 16 == 0
    width = b.blocks.shape[1]
    ref = bsr_spmm_reference(b, vals)
    for x, route in ((vals, "tiles"), (shifted, "lanes")):
        assert bsr_spmm.route((8, 8), k, dtype, x.data_ptr() % 16 == 0,
                              width) == route
        n0 = bsr_spmm.launches
        y = bsr_spmm(b, x)
        torch.cuda.synchronize()
        assert bsr_spmm.launches == n0 + 1
        _spmm_close(b, vals, y, ref)
        assert torch.equal(bsr_spmm(b, x), y)


def _banded_bsr(nbr, width, block_shape, dtype, dev, seed=0):
    """nbr block rows, each naming ``width`` distinct block columns in
    ascending order from a band of 4 x width about its own, with random
    blocks: rows wider than a stencil's."""
    rng = np.random.default_rng(seed)
    R, C = block_shape
    lo = np.clip(np.arange(nbr) - 2 * width, 0, nbr - 4 * width)
    cols = np.sort(np.stack([rng.choice(4 * width, width, replace=False)
                             for _ in range(nbr)]), axis=1) + lo[:, None]
    blocks = rng.standard_normal((nbr, width, R, C))
    return BSRMatrix(
        block_cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
        blocks=torch.from_numpy(blocks).to(dev, dtype),
        shape=(nbr * R, nbr * C))


@pytest.mark.parametrize("width, k, route", [
    (60, 32, "lanes"), (60, 128, "tiles"), (100, 256, "tiles"),
    (120, 128, "lanes")])
def test_bsr_spmm_wide_rows_route_by_width(cuda, width, k, route):
    """Block rows past TILES_WIDTH slots take lanes below a full chunk of
    columns, and past TILES_WIDTH_FULL at any k; each route matches the
    plain version and repeats bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = _banded_bsr(4 * width + 8, width, (8, 8), torch.float32, cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b.shape[1], k))).to(cuda, torch.float32)
    assert bsr_spmm.route((8, 8), k, torch.float32, True, width) == route
    n0 = bsr_spmm.launches
    y = bsr_spmm(b, x)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == n0 + 1
    _spmm_close(b, x, y, bsr_spmm_reference(b, x))
    assert torch.equal(bsr_spmm(b, x), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("block_shape", [(8, 8), (4, 8)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_bsr_spmm_vector_and_scalar_paths(cuda, block_shape, dtype):
    """k = 1: 16-byte aligned operands take the vec route, an x that is
    not 16-byte aligned the scalar warp route; both match the plain
    version and repeat bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = _rand_bsr(block_shape, dtype, cuda, seed=3)
    m = b.shape[1]
    vals = torch.from_numpy(np.random.default_rng(4).standard_normal(m))
    aligned = vals.to(cuda, dtype)[:, None]
    buf = torch.zeros(m + 1, dtype=dtype, device=cuda)
    buf[1:] = vals.to(cuda, dtype)
    shifted = buf[1:][:, None]                      # 4 or 8 bytes off
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 != 0
    ref = bsr_spmm_reference(b, aligned)
    for x, route in ((aligned, "vec"), (shifted, "warp")):
        assert bsr_spmm.route(block_shape, 1, dtype,
                              x.data_ptr() % 16 == 0) == route
        n0 = bsr_spmm.launches
        y = bsr_spmm(b, x)
        torch.cuda.synchronize()
        assert bsr_spmm.launches == n0 + 1
        _spmm_close(b, aligned, y, ref)
        assert torch.equal(bsr_spmm(b, x), y)


def test_bsr_matvec_runs_the_kernel_at_k1(cuda):
    b = _rand_bsr((8, 8), torch.float32, cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        b.shape[1])).to(cuda, torch.float32)
    n0 = bsr_spmm.launches
    y = bsr_matvec(b, x)
    assert bsr_spmm.launches == n0 + 1 and y.shape == (b.shape[0],)
    _spmm_close(b, x[:, None], y[:, None], b.matvec(x)[:, None])


def test_bsr_wrapper_rejects_bad_inputs(cuda):
    b = _rand_bsr((8, 8), torch.float32, cuda)
    x = torch.ones((b.shape[1], 4), device=cuda)
    with pytest.raises(ValueError, match="float32 or float64"):
        bsr_spmm(dataclasses.replace(b, blocks=b.blocks.half()), x.half())
    with pytest.raises(ValueError, match="float32"):
        bsr_spmm(b, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm(b, x.t().contiguous().t())
    with pytest.raises(ValueError, match="int32"):
        bsr_spmm(dataclasses.replace(b, block_cols=b.block_cols.long()), x)
    with pytest.raises(ValueError, match="x has shape"):
        bsr_spmm(b, x[:-1])


def test_matrix_form_solve_through_the_kernel(cuda):
    """The exported operator as (8, 8) blocks: bsr_matvec gives the coded
    operator's apply, and BiCGSTABwr on it converges."""
    from eddy_currents_3d_tpu_torch.assembly.assemble import to_csr
    from eddy_currents_3d_tpu_torch.solvers.bicgstab import bicgstab_wr
    op, x, _ = _setup("static", cuda)
    model = cases.load_case(CASES["static"]())
    sysm = assemble_operator(model, torch.float64, "cpu")
    csr = to_csr(sysm, model)
    b = bsr_from_scipy(csr, block_shape=(8, 8), dtype=torch.float32,
                       device=cuda)
    condno = model.cond_number.ravel()
    order = np.nonzero(condno)[0]
    u_cells = torch.from_numpy(order[np.argsort(condno[order])]).to(cuda)
    flat = lambda A, U: torch.cat([A.reshape(-1), U.reshape(-1)[u_cells]])
    pad = b.shape[1] - csr.shape[0]
    v = torch.nn.functional.pad(flat(x.A, x.U), (0, pad))
    y = bsr_matvec(b, v)[:csr.shape[0]]
    yA, yU = coded_matvec(op, x.A, x.U)
    _spmm_close(b, v[:, None], y[:, None], flat(yA, yU)[:, None])
    rhs = torch.nn.functional.pad(y, (0, pad))
    n0 = bsr_spmm.launches
    res = bicgstab_wr(lambda u: bsr_matvec(b, u), rhs, torch.zeros_like(rhs),
                      5e-3, 10000)
    assert res.converged and bsr_spmm.launches - n0 >= 2 * res.iterations
