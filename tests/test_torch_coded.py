"""The port's case-coded operator against the JAX package's.

* The encoded fields equal JAX's after cropping its lane/sublane padding,
  and the f64 proof rejects what JAX's rejects.
* The plain torch version (the CPU side of the kernel's wrapper) matches
  the JAX coded operator in Pallas interpret mode at f32 within
  3e-6·scale (tests/test_coded.py:32) and the port's own flat-roll
  operator at f64 within the same bound; the fused dots match f64 sums
  within 2e-5 relative (tests/test_coded.py:300).
"""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, pallas_interpret, rand_fields

import jax
import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.ops import pallas_coded as jpc
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.ops import coded as tc
from eddy_currents_3d_tpu_torch.ops.coded_cuda import coded_matvec
from eddy_currents_3d_tpu_torch.testing import cases as tcases

ATOL = 3e-6      # x output scale: f32 in-kernel evaluation vs assembled f64
DOT_RTOL = 2e-5  # f32 accumulation of the fused dots


def _z_face_case(c):
    nx, ny, nz = 20, 14, 12
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[0:5, 3:ny - 3, 3:nx - 3] = 1          # slab ON the z- face
    geo[8, 4, 5:nx - 5] = 2                   # one x-directed coil run
    names = [
        "plast D=1 C='mu0*35e6'",
        "coil D=1 SRCx=F",
        "param tran stop=0.002 step=1e-3",
        "p2 solver tol=5e-3 itmax=10000 dir=out",
        "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t",
    ]
    return c.make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel())


CASES = {
    "static": (lambda c: c.case_static(shape_xyz=(18, 16, 14), steps=2), {}),
    "convection": (lambda c: c.case_convection(shape_xyz=(20, 12, 10), steps=2), {}),
    "inertia_on_faces": (lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=2),
                         {"inertia_on_faces": True}),
    "custom_bnd": (lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=2),
                   {"bnd": [[-1.0, -0.5], [0.25, -0.95], [0.0, -0.7]]}),
    "z_face": (_z_face_case, {}),
}


def _build(name):
    make, opts = CASES[name]
    mj = jcases.load_case(make(jcases))
    mt = tcases.load_case(make(tcases))
    if "bnd" in opts:
        mj.solver.BND = np.array(opts["bnd"])
        mt.solver.BND = np.array(opts["bnd"])
    iof = opts.get("inertia_on_faces", False)
    sj = j_assemble(mj, jnp.float32, inertia_on_faces=iof)
    st = t_assemble(mt, torch.float32, CPU, inertia_on_faces=iof)
    cj = jpc.from_assembled_coded(sj, mj, inertia_on_faces=iof)
    ct = tc.from_assembled_coded(st, mt, CPU, inertia_on_faces=iof)
    st64 = t_assemble(mt, torch.float64, CPU, inertia_on_faces=iof)
    return mt, cj, ct, st64


def _scale_close(got, ref, scale):
    np.testing.assert_allclose(host(got).astype(np.float64), host(ref),
                               rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoding_matches_jax(name):
    _, cj, ct, _ = _build(name)
    nz, ny, nx = ct.shape_zyx
    np.testing.assert_array_equal(host(cj.code_p)[:, :ny, :nx], host(ct.code))
    np.testing.assert_array_equal(host(cj.cf_p)[:, :ny, :nx], host(ct.cf))
    assert cj.has_conv == ct.has_conv
    if ct.has_conv:
        np.testing.assert_array_equal(host(cj.conv_p)[..., :ny, :nx],
                                      host(ct.conv))
    assert tuple(cj.consts) == ct.consts
    assert cj.inertia_on_faces == ct.inertia_on_faces
    # the JAX operator's padded arrays carried across give the same operator
    cc = convert.coded_from_jax_arrays(
        host(cj.code_p), host(cj.cf_p), host(cj.conv_p), cj.shape_zyx,
        consts=cj.consts,
        inertia_on_faces=cj.inertia_on_faces, device=CPU)
    for f in ("code", "cf"):
        assert torch.equal(getattr(cc, f), getattr(ct, f))
    assert (cc.conv is None) == (ct.conv is None)
    if ct.conv is not None:
        assert torch.equal(cc.conv, ct.conv)


def _jax_coded(cj, A, U, w=None):
    x = cj.pad_state(JState(jnp.asarray(A, jnp.float32), jnp.asarray(U, jnp.float32)))
    with pallas_interpret():
        if w is None:
            y = cj.unpad_state(jax.jit(cj.apply)(x))
            return y.A, y.U
        ww = cj.pad_state(JState(jnp.asarray(w[0], jnp.float32),
                                 jnp.asarray(w[1], jnp.float32)))
        y, pw, py = jax.jit(cj.apply_dots)(x, ww)
        y = cj.unpad_state(y)
        return y.A, y.U, pw, py


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_apply_matches(name):
    model, cj, ct, st64 = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=4)
    yA_j, yU_j = _jax_coded(cj, A, U)
    y = ct.apply(TState(torch.from_numpy(A).float(), torch.from_numpy(U).float()))
    y64 = st64.op.apply(TState(torch.from_numpy(A), torch.from_numpy(U)))
    scale = np.abs(host(y64.A)).max()
    uscale = max(np.abs(host(y64.U)).max(), scale)
    _scale_close(y.A, yA_j, scale)
    _scale_close(y.U, yU_j, uscale)
    _scale_close(y.A, y64.A, scale)
    _scale_close(y.U, y64.U, uscale)
    # U stays exactly zero off the conductor
    assert not torch.any(y.U[~torch.from_numpy(model.cond_mask)])


@pytest.mark.parametrize("name", ["static", "convection", "z_face"])
def test_plain_apply_dots_matches(name):
    model, cj, ct, _ = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=5)
    wA, wU = rand_fields(model.shape_zyx, model.cond_mask, seed=7)
    f = lambda a: torch.from_numpy(a).float()
    y, pw, py = ct.apply_dots(TState(f(A), f(U)), TState(f(wA), f(wU)))
    yA_j, yU_j, pw_j, py_j = _jax_coded(cj, A, U, (wA, wU))
    yy = ct.apply(TState(f(A), f(U)))
    assert torch.equal(y.A, yy.A) and torch.equal(y.U, yy.U)
    scale = np.abs(host(yA_j)).max()
    _scale_close(y.A, yA_j, scale)
    _scale_close(y.U, yU_j, max(np.abs(host(yU_j)).max(), scale))
    yA64, yU64 = host(y.A).astype(np.float64), host(y.U).astype(np.float64)
    ref_w = float(np.vdot(yA64, wA.astype(np.float32).astype(np.float64))
                  + np.vdot(yU64, wU.astype(np.float32).astype(np.float64)))
    ref_y = float(np.vdot(yA64, yA64) + np.vdot(yU64, yU64))
    for got, ref in ((pw, ref_w), (py, ref_y), (pw_j, ref_w), (py_j, ref_y)):
        assert abs(float(got) - ref) < DOT_RTOL * max(abs(ref), 1.0)


@pytest.mark.parametrize("name", ["static", "convection", "z_face"])
def test_plain_apply_div_matches(name):
    model, cj, ct, st64 = _build(name)
    A, _ = rand_fields(model.shape_zyx, model.cond_mask, seed=6)
    with pallas_interpret():
        d_j = jax.jit(cj.apply_div)(jnp.asarray(A, jnp.float32))
    d_t = ct.apply_div(torch.from_numpy(A).float())
    d_64 = st64.op.apply_div(torch.from_numpy(A))
    scale = max(np.abs(host(d_64)).max(), 1.0)
    _scale_close(d_t, d_j, scale)
    _scale_close(d_t, d_64, scale)


def test_proof_rejects_tampered_fields():
    model = tcases.load_case(tcases.case_static(shape_xyz=(14, 12, 10), steps=2))
    sysm = t_assemble(model, torch.float32, CPU)
    sysm.np_ku[0][sysm.np_ku[0] != 0] *= 1.5
    with pytest.raises(tc.CodedUnsupported, match="U-coupling"):
        tc.from_assembled_coded(sysm, model, CPU)
    sysm = t_assemble(model, torch.float32, CPU)
    sysm.np_ka[0][0, 0, 0] += 1.0
    with pytest.raises(tc.CodedUnsupported, match="A-stencil"):
        tc.from_assembled_coded(sysm, model, CPU)


def test_f64_and_no_conductor_unsupported():
    model = tcases.load_case(tcases.case_static(shape_xyz=(14, 12, 10), steps=2))
    with pytest.raises(tc.CodedUnsupported, match="float32"):
        tc.from_assembled_coded(t_assemble(model, torch.float64, CPU), model, CPU)
    text = tcases.case_static(shape_xyz=(14, 12, 10), steps=2).replace(
        "C='mu0*35260000.0'", "C=0")
    bare = tcases.load_case(text)
    assert bare.n_cond == 0
    with pytest.raises(tc.CodedUnsupported, match="no conducting"):
        tc.from_assembled_coded(t_assemble(bare, torch.float32, CPU), bare, CPU)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper routes CPU tensors to coded_apply_reference and counts
    no kernel launch for them."""
    model, _, ct, _ = _build("static")
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=8)
    A, U = torch.from_numpy(A).float(), torch.from_numpy(U).float()
    before = coded_matvec.launches
    yA, yU = coded_matvec(ct, A, U)
    ref = tc.coded_apply_reference(A, U, ct.code, ct.cf, ct.conv, ct.consts,
                                   ct.inertia_on_faces)
    assert torch.equal(yA, ref[0]) and torch.equal(yU, ref[1])
    div = tc.coded_apply_reference(A, None, ct.code, ct.cf, ct.conv,
                                   ct.consts, ct.inertia_on_faces)[1]
    assert torch.equal(coded_matvec(ct, A), div)
    assert coded_matvec.launches == before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from eddy_currents_3d_tpu_torch.ops import _build as b
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(b, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        b.build_library("coded_matvec")
    assert not (tmp_path / "build").exists()
