"""The hand-written CUDA kernels against their plain torch versions, on
the card: the whole-plane coded matvec, the split route's stencil and
conductor-slab kernels, the field tier's field_a and field_u (float32
and bfloat16 coefficients), and the block-sparse SpMM (float32 and
float64).  Every test here needs a CUDA device and nvcc and skips without
them.  The file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances are those of the CPU parity tests (tests/test_torch_coded.py):
3e-6 of the output scale for the matvec, 2e-5 relative for the fused dots.
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
from eddy_currents_3d_tpu_torch.ops.field_cuda import field_a, field_u
from eddy_currents_3d_tpu_torch.ops.bsr_cuda import (bsr_matvec, bsr_spmm,
                                                     bsr_spmm_reference)
from eddy_currents_3d_tpu_torch.ops.sparse import bsr_from_scipy
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


CASES = {
    "static": lambda: cases.case_static(shape_xyz=(40, 36, 20), steps=2),
    "convection": lambda: cases.case_convection(shape_xyz=(24, 12, 10), steps=2),
    "inertia_on_faces": lambda: cases.case_static(shape_xyz=(33, 17, 12), steps=2),
    "z_through": _z_through,
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


# ---- the split route: stencil kernel + conductor-slab kernel ----

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


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_apply_matches_plain(cuda, name):
    op, x, _ = _setup(name, cuda)
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
    # the pair computes the whole-plane kernel's matvec
    mA, mU = coded_matvec(op, x.A, x.U)
    _close(yA, mA, scale)
    _close(yU, mU[zb0:zb1], max(rU.abs().max().item(), scale))


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_apply_dots_matches_plain(cuda, name):
    op, x, w = _setup(name, cuda)
    zb0, zb1 = op.cond_z
    Uc, wc = x.U[zb0:zb1], State(w.A, w.U[zb0:zb1])
    yA, pw_a, py_a = coded_stencil(op, x.A, w.A)
    yU, pw_b, py_b = coded_slab(op, x.A, Uc, yA, wc)
    zA = coded_stencil(op, x.A)
    zU = coded_slab(op, x.A, Uc, zA)
    assert torch.equal(yA, zA) and torch.equal(yU, zU)
    rA, rU = _split_ref(op, x)
    _close(yA, rA, rA.abs().max().item())
    own = torch.cat([torch.arange(0, zb0), torch.arange(zb1, op.shape_zyx[0])])
    own = own.to(cuda)
    for (pw, py), parts in (
            ((pw_a, py_a), [(yA[:, own], w.A[:, own])]),
            ((pw_b, py_b), [(yA[:, zb0:zb1], w.A[:, zb0:zb1]), (yU, wc.U)])):
        ref_w = sum(float((a.double() * b.double()).sum()) for a, b in parts)
        ref_y = sum(float((a.double() ** 2).sum()) for a, _ in parts)
        assert abs(float(pw) - ref_w) < DOT_RTOL * max(abs(ref_w), 1.0)
        assert abs(float(py) - ref_y) < DOT_RTOL * max(abs(ref_y), 1.0)
    # no atomics: the partials repeat bit for bit
    _, pw2, py2 = coded_stencil(op, x.A, w.A)
    _, pw3, py3 = coded_slab(op, x.A, Uc, torch.empty_like(x.A), wc)
    assert (float(pw2), float(py2)) == (float(pw_a), float(py_a))
    assert (float(pw3), float(py3)) == (float(pw_b), float(py_b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_apply_div_matches_plain(cuda, name):
    op, x, _ = _setup(name, cuda)
    zb0, zb1 = op.cond_z
    d = coded_slab(op, x.A)
    r = coded_slab_reference(x.A, None, op.code, op.cf, op.conv, op.consts,
                             op.inertia_on_faces, op.cond_z)
    _close(d, r, max(r.abs().max().item(), 1.0))
    _close(d, coded_matvec(op, x.A)[zb0:zb1], max(r.abs().max().item(), 1.0))


def test_split_wrappers_reject_bad_inputs(cuda):
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
    import dataclasses
    bad = dataclasses.replace(op, cond_z=(zb1, zb0))
    with pytest.raises(ValueError, match="conductor planes"):
        coded_stencil(bad, x.A)


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
    with pytest.raises(ValueError, match="dtype must be float32 or float64"):
        Simulation(model, torch.bfloat16, device=cuda)   # bf16 state
    with pytest.raises(ValueError, match="precond='mg'"):
        Simulation(model, torch.float32, device=cuda, precond="mg",
                   use_coded=True)
    with pytest.raises(ValueError, match="not ported to CUDA"):
        Simulation(model, torch.float64, device=cuda, precond="jacobi")
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
@pytest.mark.parametrize("k", [1, 4, 128])
@pytest.mark.parametrize("block_shape", [(8, 8), (4, 8), (8, 16), (3, 12)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_bsr_spmm_matches_plain(cuda, block_shape, k, dtype):
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
    assert bsr_spmm.route(block_shape, k) == (
        "warp" if k < 32 and pow2 else "lanes")


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
