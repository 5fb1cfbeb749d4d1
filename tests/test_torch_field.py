"""The port's field-kernel tier (``ops/field.py``) against the JAX package's
``PallasStencilOperator``, whose kernels run in Pallas interpret mode.

* ``FieldStencilOperator.apply`` against JAX ``unpad(apply(pad(x)))`` on the
  static, lim, no-conductor, convection (the moving conductor's terms in
  ``ka``) and odd-dims cases: float64 within rtol = 1e-12 and atol = 1e-12
  of the output scale (summation order only: an absolute 1e-12 is below
  one ulp of outputs of order 1e5), float32 within 3e-6 of the output
  scale.
* bfloat16 coefficients: the port's tensors equal the JAX operator's
  (cropped) bit for bit, and the bfloat16-coefficient apply agrees within
  3e-6 of the output scale.
* ``convert.field_from_jax_arrays`` undoes the JAX operator's padding and
  shifted box origin exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, pallas_interpret, rand_fields

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.ops import pallas_stencil as ps
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.ops.field import FieldStencilOperator
from eddy_currents_3d_tpu_torch.testing import cases as tcases

F32_ATOL = 3e-6     # x output scale, as tests/test_torch_coded.py


def _nocond(c):
    """No conducting cell: one coil voxel in air (tests/test_pallas.py)."""
    geo = np.zeros((6, 8, 9), np.int64)
    geo[4, 4, 4] = 1
    names = ["coil D=1 SRCx=F1", "param tran stop=2m step=1m",
             "p solver tol=5m itmax=9 dir=o", "f1 func F1=a a=1 t=t"]
    return c.make_vxc_text((9, 8, 6), 0.01, names, geo.ravel())


CASES = {
    "static": lambda c: c.case_static(shape_xyz=(14, 13, 11), steps=2),
    "lim": lambda c: c.case_lim(shape_xyz=(24, 11, 10), steps=2),
    "nocond": _nocond,
    "convection": lambda c: c.case_convection(shape_xyz=(24, 12, 10), steps=2),
    "odd": lambda c: c.case_static(shape_xyz=(21, 19, 11), steps=2),
}

JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _systems(name, dtype, coeff_dtype=None):
    """(JAX system, port system, model) at ``dtype``, their operators'
    coefficients rounded to ``coeff_dtype`` when given."""
    mj = jcases.load_case(CASES[name](jcases))
    mt = tcases.load_case(CASES[name](tcases))
    sj = j_assemble(mj, JDT[dtype])
    st = t_assemble(mt, dtype, CPU)
    if coeff_dtype is not None:
        sj = dataclasses.replace(sj, op=sj.op.astype(jnp.bfloat16))
        st = dataclasses.replace(st, op=st.op.astype(coeff_dtype))
    return sj, st, mt


def _applies(sj, st, mt, dtype, seed=0):
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, seed)
    pop = ps.from_assembled(sj)
    with pallas_interpret():
        x = pop.pad_state(JState(jnp.asarray(A, JDT[dtype]),
                                 jnp.asarray(U, JDT[dtype])))
        yj = pop.unpad_state(pop.apply(x))
    op = FieldStencilOperator.from_assembled(st)
    yt = op.apply(TState(torch.from_numpy(A).to(dtype),
                         torch.from_numpy(U).to(dtype)))
    return yj, yt, op


def _scaled_close(got, ref, atol):
    got, ref = host(got).astype(np.float64), host(ref).astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol * scale)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_field_apply_matches_jax(name, dtype):
    sj, st, mt = _systems(name, dtype)
    yj, yt, op = _applies(sj, st, mt, dtype)
    assert yt.A.dtype == dtype and yt.U.dtype == dtype
    assert (op.box is None) == (name == "nocond")
    scale = max(np.abs(host(yj.A)).max(), np.abs(host(yj.U)).max())
    if dtype == torch.float64:
        for got, ref in ((yt.A, yj.A), (yt.U, yj.U)):
            np.testing.assert_allclose(host(got), host(ref), rtol=1e-12,
                                       atol=1e-12 * scale)
    else:
        for got, ref in ((yt.A, yj.A), (yt.U, yj.U)):
            np.testing.assert_allclose(host(got), host(ref), rtol=0,
                                       atol=F32_ATOL * scale)
    # the flat-roll operator computes the same product
    flat = st.op.apply(TState(*(torch.from_numpy(a).to(dtype) for a in
                                rand_fields(mt.shape_zyx, mt.cond_mask, 0))))
    _scaled_close(yt.A, flat.A, 1e-12 if dtype == torch.float64 else F32_ATOL)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_coefficients_bit_equal_to_jax(name):
    """The port rounds each bfloat16 field as the JAX package does: the
    field tier from the float64 host copies, like ``from_assembled``;
    ``system.op.astype`` from the float32 operator, like simulate.py."""
    sj, st, mt = _systems(name, torch.float32, torch.bfloat16)
    pop = ps.from_assembled(sj)
    assert pop.ka_p.dtype == jnp.bfloat16
    jop = convert.field_from_jax_arrays(
        host(pop.ka_p), host(pop.gu_p), host(pop.ku_p), host(pop.da_p),
        pop.shape_zyx, pop.box, sj.op.box, CPU)
    op = FieldStencilOperator.from_assembled(st)
    for f in ("ka", "gu", "ku", "da"):
        got, ref = getattr(op, f), getattr(jop, f)
        assert got.dtype == ref.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        # and the astype'd flat operator, which feeds apply_div and Jacobi
        np.testing.assert_array_equal(
            _bits(getattr(st.op, f)), host(getattr(sj.op, f)).view(np.int16))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_coefficient_apply_matches_jax(name):
    sj, st, mt = _systems(name, torch.float32, torch.bfloat16)
    yj, yt, op = _applies(sj, st, mt, torch.float32, seed=3)
    assert op.dtype == torch.bfloat16
    assert yt.A.dtype == torch.float32 and yt.U.dtype == torch.float32
    scale = max(np.abs(host(yj.A)).max(), np.abs(host(yj.U)).max())
    for got, ref in ((yt.A, yj.A), (yt.U, yj.U)):
        np.testing.assert_allclose(host(got), host(ref).astype(np.float64),
                                   rtol=0, atol=F32_ATOL * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_coefficient_bf16_state_apply_matches_jax(name):
    """float32 coefficients at bfloat16 state (the ``(float, bf16)``
    kernels' plain versions) against the JAX package's jnp stencil apply on
    the same bfloat16 inputs.  JAX promotes each product to float32 and
    sums in float32; its result rounded once to bfloat16 lies within one
    bfloat16 ulp of scale of the port's."""
    sj, st, mt = _systems(name, torch.float32)
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, 5)
    x = TState(torch.from_numpy(A).to(torch.bfloat16),
               torch.from_numpy(U).to(torch.bfloat16))
    op = FieldStencilOperator.from_assembled(st)
    assert op.dtype == torch.float32
    yt = op.apply(x)
    assert yt.A.dtype == yt.U.dtype == torch.bfloat16
    yj = sj.op.apply(JState(*(jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16) for v in (x.A, x.U))))
    assert yj.A.dtype == jnp.float32
    ref = [host(v).astype(np.float64) for v in (yj.A, yj.U)]
    scale = max(np.abs(r).max() for r in ref)
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)    # bfloat16's at scale
    for got, r in zip((yt.A, yt.U), ref):
        got = host(got).astype(np.float64)
        rounded = host(jnp.asarray(r, jnp.float32).astype(
            jnp.bfloat16)).astype(np.float64)
        np.testing.assert_allclose(got, rounded, rtol=0, atol=ulp)
        # and most values are the same bfloat16: the port rounds the
        # conductor box's A rows twice (field_a's store, then field_u's
        # add), as JAX's kernels do; bfloat16 coefficients would move ~30%
        assert (got != rounded).mean() < 0.1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_field_from_jax_arrays_round_trip(dtype):
    """A JAX operator whose box origin was shifted back (the padded box
    window would overrun the padded grid) crops to the port's operator."""
    sj, st, mt = _systems("odd", dtype)
    pop = ps.from_assembled(sj)
    z0, z1, y0, y1, x0, x1 = sj.op.box
    assert (pop.box[2], pop.box[4]) != (y0, x0)      # origin shifted
    got = convert.field_from_jax_arrays(
        host(pop.ka_p), host(pop.gu_p), host(pop.ku_p), host(pop.da_p),
        pop.shape_zyx, pop.box, sj.op.box, CPU)
    ref = FieldStencilOperator.from_assembled(st)
    assert got.box == ref.box and got.shape_zyx == ref.shape_zyx
    for f in ("ka", "gu", "ku", "da"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    nocond = _systems("nocond", dtype)[0]
    pn = ps.from_assembled(nocond)
    gn = convert.field_from_jax_arrays(
        host(pn.ka_p), host(pn.gu_p), host(pn.ku_p), host(pn.da_p),
        pn.shape_zyx, pn.box, None, CPU)
    assert gn.box is None and tuple(gn.ka.shape[1:]) == tuple(pn.shape_zyx)


def test_pad_state_is_identity():
    _, st, mt = _systems("static", torch.float32)
    op = FieldStencilOperator.from_assembled(st)
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, 5)
    x = TState(torch.from_numpy(A).float(), torch.from_numpy(U).float())
    assert op.pad_state(x) is x and op.unpad_state(x) is x
    y = op.apply(x)
    # U rows off the conductor box stay exactly zero
    z0, z1, y0, y1, x0, x1 = op.box
    mask = torch.ones_like(y.U, dtype=torch.bool)
    mask[z0:z1, y0:y1, x0:x1] = False
    assert not torch.any(y.U[mask])
