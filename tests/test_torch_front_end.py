"""Front end of the PyTorch port against the JAX package: .vxc parsing,
expressions, assembly and the step schedule must agree bit for bit."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread cap)
from _torch_parity import CPU, host

from eddy_currents_3d_tpu.assembly import assemble as jas
from eddy_currents_3d_tpu.models import vxc as jvxc
from eddy_currents_3d_tpu.sim.simulate import _schedule as j_schedule
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch.assembly import assemble as tas
from eddy_currents_3d_tpu_torch.models import vxc as tvxc
from eddy_currents_3d_tpu_torch.sim.simulate import _schedule as t_schedule
from eddy_currents_3d_tpu_torch.testing import cases as tcases

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(14, 12, 10), steps=3),
    "moving": lambda c: c.case_moving(shape_xyz=(16, 16, 10), steps=3),
    "lim": lambda c: c.case_lim(shape_xyz=(20, 11, 10), steps=3),
    "convection": lambda c: c.case_convection(shape_xyz=(18, 12, 10), steps=3),
}


def _both(name):
    text_j = CASES[name](jcases)
    text_t = CASES[name](tcases)
    assert text_j == text_t
    return jcases.load_case(text_j), tcases.load_case(text_t)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches(name):
    mj, mt = _both(name)
    assert mj.shape_xyz == mt.shape_xyz
    np.testing.assert_array_equal(mj.delta, mt.delta)
    np.testing.assert_array_equal(mj.geo, mt.geo)
    np.testing.assert_array_equal(mj.cond_mask, mt.cond_mask)
    np.testing.assert_array_equal(mj.cond_number, mt.cond_number)
    assert mj.n_cond == mt.n_cond
    assert [(d.ident, d.name, d.typ, d.D, d.C, d.Ve) for d in mj.domains] == \
        [(d.ident, d.name, d.typ, d.D, d.C, d.Ve) for d in mt.domains]
    np.testing.assert_array_equal(mj.solver.BND, mt.solver.BND)
    assert (mj.solver.tolerance, mj.solver.itmax) == \
        (mt.solver.tolerance, mt.solver.itmax)
    assert vars(mj.tran) == vars(mt.tran)
    assert len(mj.functions) == len(mt.functions)
    for fj, ft in zip(mj.functions, mt.functions):
        assert (fj.name, fj.direction, fj.domain, fj.move, fj.vmech_index,
                fj.vmech_const) == (ft.name, ft.direction, ft.domain, ft.move,
                                    ft.vmech_index, ft.vmech_const)
        np.testing.assert_array_equal(fj.cells, ft.cells)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expression_values_match(name):
    """Source and motion-velocity values at 5 times, equal at f64."""
    mj, mt = _both(name)
    times = [0.0, 1.3e-4, 7.7e-4, 2.5e-3, 1.0e-2]
    for fj, ft in zip(mj.functions + mj.vmech, mt.functions + mt.vmech):
        for t in times:
            vj, vt = fj(t), ft(t)
            assert type(vt) is float
            assert vj == vt, (fj.name, t, vj, vt)


@pytest.mark.parametrize("inertia_on_faces", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_assembly_matches(name, inertia_on_faces):
    mj, mt = _both(name)
    sj = jas.assemble_operator(mj, np.float64, inertia_on_faces=inertia_on_faces)
    st = tas.assemble_operator(mt, torch.float64, CPU,
                               inertia_on_faces=inertia_on_faces)
    for f in ("np_ka", "np_gu", "np_ku", "np_da"):
        np.testing.assert_array_equal(getattr(sj, f), getattr(st, f), err_msg=f)
    for f in ("cond_mask", "inert", "bnd_a", "bnd_u", "bnd_u_any"):
        a, b = host(getattr(sj, f)), host(getattr(st, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert sj.gershgorin == st.gershgorin
    assert sj.op.box == st.op.box
    for f in ("ka", "gu", "ku", "da"):
        np.testing.assert_array_equal(host(getattr(sj.op, f)),
                                      host(getattr(st.op, f)), err_msg=f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_assembly_f32_device_tensors(name):
    """The f32 device tensors are the f64 host fields rounded once, as
    jnp.asarray rounds them."""
    mj, mt = _both(name)
    sj = jas.assemble_operator(mj, np.float32)
    st = tas.assemble_operator(mt, torch.float32, CPU)
    assert st.op.ka.dtype == torch.float32 and st.inert.dtype == torch.float32
    np.testing.assert_array_equal(host(sj.op.ka), host(st.op.ka))
    np.testing.assert_array_equal(host(sj.op.gu), host(st.op.gu))
    np.testing.assert_array_equal(host(sj.inert), host(st.inert))


@pytest.mark.parametrize("tran", [(0.1, 1e-3, 0.0), (0.1, 1e-3, 0.01),
                                  (4.0e-3, 1e-3, 0.0), (2.4e-3, 4e-4, 8e-4),
                                  (1e-3, 3e-4, 6e-4)])
def test_schedule_matches(tran):
    from eddy_currents_3d_tpu.models.model import TranConfig
    cfg = TranConfig(stop=tran[0], step=tran[1], jump=tran[2])
    assert j_schedule(cfg) == t_schedule(cfg)


_GOOD = jcases.case_static(shape_xyz=(14, 12, 12), steps=2)
_BAD_VXC = {
    "no_lattice": _GOOD.replace("<Lattice>", "<Lattic>").replace(
        "</Lattice>", "</Lattic>"),
    "layer_count": _GOOD.replace("<Z_Voxels>12</Z_Voxels>",
                                 "<Z_Voxels>13</Z_Voxels>"),
    "short_layer": _GOOD.replace("<X_Voxels>14</X_Voxels>",
                                 "<X_Voxels>15</X_Voxels>"),
    "missing_func": _GOOD.replace("f1 func Fp=", "f1 func Fq="),
    "bad_boundary": _GOOD.replace("p2 solver", "bb boundary bqq=1 p2 solver"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_VXC))
def test_vxc_errors_match(bad):
    text = _BAD_VXC[bad]
    with pytest.raises(jvxc.VxcError) as ej:
        jcases.load_case(text)
    with pytest.raises(tvxc.VxcError) as et:
        tcases.load_case(text)
    assert str(ej.value) == str(et.value)


def _thin_conductor(thickness):
    nx, ny, nz = 14, 12, 10
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[3:3 + thickness, 3:9, 3:11] = 1
    geo[8, 4, 5:9] = 2
    names = [
        "plast D=1 C='mu0*35e6'",
        "coil D=1 SRCx=F",
        "param tran stop=0.002 step=1e-3",
        "p2 solver tol=5e-3 itmax=100 dir=out",
        "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t",
    ]
    return jcases.make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel())


@pytest.mark.parametrize("thickness", [1, 2])
def test_assembly_errors_match(thickness):
    text = _thin_conductor(thickness)
    with pytest.raises(jas.AssemblyError) as ej:
        jas.assemble_operator(jcases.load_case(text), np.float64)
    with pytest.raises(tas.AssemblyError) as et:
        tas.assemble_operator(tcases.load_case(text), torch.float64, CPU)
    assert str(ej.value) == str(et.value)
