"""The split route of the port's coded operator against the JAX package's.

On 256x256-class planes both packages run the coded matvec as a stencil
kernel over the air planes and a conductor-slab kernel, with the solver's
U held z-compact.  Here both are forced onto that route on small grids:
JAX with ``_WHOLE_PLANE_BUDGET = 0`` and ``_YT_BLOCK_BUDGET = 150_000``
(y tiles smaller than the plane, so its cross-tile stitching runs) in
Pallas interpret mode, as tests/test_compact_u.py does; the port with its
own ``_WHOLE_PLANE_BUDGET = 0``.

* The route gate is the JAX package's, shape for shape.
* The plain stencil and slab versions (the CPU side of the kernels'
  wrappers) match JAX's apply/apply_dots/apply_div, unpadded, within
  3e-6·scale (tests/test_coded.py:32) and the f64 flat-roll operator too;
  the dots match f64 sums within 2e-5 relative.
* Split == whole-plane (kernel #1's plain version) on the same inputs, bit
  for bit; pad_state/unpad_state round-trip.
* Compact U is exact: the operator's U columns off the conductor are zero,
  and U is exactly 0 off the conductor in every solver vector of a
  transient.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, rand_fields, z_face_case, z_through_case

import jax
import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.ops import pallas_coded as jpc
from eddy_currents_3d_tpu.ops import pallas_stencil as ps
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.ops import coded as tc
from eddy_currents_3d_tpu_torch.testing import cases as tcases

ATOL = 3e-6      # x output scale: f32 in-kernel evaluation vs assembled f64
DOT_RTOL = 2e-5  # f32 accumulation of the fused dots

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(18, 16, 14), steps=2),
    "convection": lambda c: c.case_convection(shape_xyz=(20, 12, 10), steps=2),
    "z_face": z_face_case,
    "z_through": z_through_case,
}


@pytest.fixture
def split(monkeypatch):
    monkeypatch.setattr(jpc, "_WHOLE_PLANE_BUDGET", 0)
    monkeypatch.setattr(jpc, "_YT_BLOCK_BUDGET", 150_000)   # TY < NYp
    monkeypatch.setattr(ps, "INTERPRET", True)
    monkeypatch.setattr(tc, "_WHOLE_PLANE_BUDGET", 0)


def _build(name):
    mj = jcases.load_case(CASES[name](jcases))
    mt = tcases.load_case(CASES[name](tcases))
    cj = jpc.from_assembled_coded(j_assemble(mj, jnp.float32), mj)
    ct = tc.from_assembled_coded(t_assemble(mt, torch.float32, CPU), mt, CPU)
    st64 = t_assemble(mt, torch.float64, CPU)
    return mt, cj, ct, st64


def _t(a):
    return torch.from_numpy(np.asarray(a)).float()


def _scale_close(got, ref, scale):
    np.testing.assert_allclose(host(got).astype(np.float64), host(ref),
                               rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("shape_zyx, has_conv", [
    ((24, 102, 102), False),     # team7: whole plane
    ((64, 256, 256), False),     # scale256: split
    ((64, 256, 256), True),
    ((16, 208, 200), False),     # 208x256 padded: whole without convection,
    ((16, 208, 200), True),      # split with it
])
def test_route_gate_matches_jax(shape_zyx, has_conv):
    jop = SimpleNamespace(shape_zyx=shape_zyx, has_conv=has_conv,
                          padded_yx=(-(-shape_zyx[1] // 8) * 8,
                                     -(-shape_zyx[2] // 128) * 128),
                          cond_z=(2, 7))
    assert tc.split_route(shape_zyx, has_conv) == (jpc._yt_plan(jop) is not None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_follows_jax_operator(name, split):
    model, cj, ct, _ = _build(name)
    assert ct.split and cj._uplan() is not None
    assert ct.cond_z == tuple(cj.cond_z) and ct.compact_u == cj.compact_u
    full = tc.from_assembled_coded(t_assemble(model, torch.float32, CPU),
                                   model, CPU, compact_u=False)
    assert not full.split


def _jax_split(cj, A, U, w=None):
    x = cj.pad_state(JState(jnp.asarray(A, jnp.float32),
                            jnp.asarray(U, jnp.float32)))
    if w is None:
        y = cj.unpad_state(jax.jit(cj.apply)(x))
        return y.A, y.U
    ww = cj.pad_state(JState(jnp.asarray(w[0], jnp.float32),
                             jnp.asarray(w[1], jnp.float32)))
    y, pw, py = jax.jit(cj.apply_dots)(x, ww)
    y = cj.unpad_state(y)
    return y.A, y.U, pw, py


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_apply_matches_jax(name, split):
    model, cj, ct, st64 = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=4)
    yA_j, yU_j = _jax_split(cj, A, U)
    y = ct.unpad_state(ct.apply(ct.pad_state(TState(_t(A), _t(U)))))
    y64 = st64.op.apply(TState(torch.from_numpy(A), torch.from_numpy(U)))
    scale = np.abs(host(y64.A)).max()
    uscale = max(np.abs(host(y64.U)).max(), scale)
    _scale_close(y.A, yA_j, scale)
    _scale_close(y.U, yU_j, uscale)
    _scale_close(y.A, y64.A, scale)
    _scale_close(y.U, y64.U, uscale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_apply_dots_matches_jax(name, split):
    model, cj, ct, _ = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=5)
    wA, wU = rand_fields(model.shape_zyx, model.cond_mask, seed=7)
    x = ct.pad_state(TState(_t(A), _t(U)))
    yc, pw, py = ct.apply_dots(x, ct.pad_state(TState(_t(wA), _t(wU))))
    yy = ct.apply(x)
    assert torch.equal(yc.A, yy.A) and torch.equal(yc.U, yy.U)
    y = ct.unpad_state(yc)
    yA_j, yU_j, pw_j, py_j = _jax_split(cj, A, U, (wA, wU))
    scale = np.abs(host(yA_j)).max()
    _scale_close(y.A, yA_j, scale)
    _scale_close(y.U, yU_j, max(np.abs(host(yU_j)).max(), scale))
    yA64, yU64 = host(y.A).astype(np.float64), host(y.U).astype(np.float64)
    ref_w = float(np.vdot(yA64, wA.astype(np.float32).astype(np.float64))
                  + np.vdot(yU64, wU.astype(np.float32).astype(np.float64)))
    ref_y = float(np.vdot(yA64, yA64) + np.vdot(yU64, yU64))
    for got, ref in ((pw, ref_w), (py, ref_y), (pw_j, ref_w), (py_j, ref_y)):
        assert abs(float(got) - ref) < DOT_RTOL * max(abs(ref), 1.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_apply_div_matches_jax(name, split):
    model, cj, ct, st64 = _build(name)
    A, _ = rand_fields(model.shape_zyx, model.cond_mask, seed=6)
    d_j = jax.jit(cj.apply_div)(jnp.asarray(A, jnp.float32))
    d_t = ct.apply_div(_t(A))
    assert d_t.shape == model.shape_zyx
    d_64 = st64.op.apply_div(torch.from_numpy(A))
    scale = max(np.abs(host(d_64)).max(), 1.0)
    _scale_close(d_t, d_j, scale)
    _scale_close(d_t, d_64, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_pad_unpad_roundtrip(name, split):
    model, cj, ct, _ = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=3)
    x = TState(_t(A), _t(U))
    p = ct.pad_state(x)
    zb0, zb1 = ct.cond_z
    assert p.U.shape == (zb1 - zb0,) + model.shape_zyx[1:]
    # JAX's compact range is chunk-aligned: it holds the port's
    assert zb1 - zb0 <= cj._uplan().nzc
    back = ct.unpad_state(p)
    assert torch.equal(back.A, x.A) and torch.equal(back.U, x.U)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_equals_whole_plane(name, monkeypatch):
    """The split pair's plain versions give the whole-plane plain version's
    values bit for bit (one copy of the arithmetic); only the dots'
    summation order differs."""
    model, _, ct, _ = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=11)
    wA, wU = rand_fields(model.shape_zyx, model.cond_mask, seed=12)
    x, w = TState(_t(A), _t(U)), TState(_t(wA), _t(wU))
    assert not ct.split
    whole = ct.apply(x), ct.apply_dots(x, w), ct.apply_div(x.A)
    monkeypatch.setattr(tc, "_WHOLE_PLANE_BUDGET", 0)
    assert ct.split
    xs, ws = ct.pad_state(x), ct.pad_state(w)
    y = ct.unpad_state(ct.apply(xs))
    yd, pw, py = ct.apply_dots(xs, ws)
    assert torch.equal(y.A, whole[0].A) and torch.equal(y.U, whole[0].U)
    assert torch.equal(ct.unpad_state(yd).U, whole[0].U)
    assert torch.equal(ct.apply_div(x.A), whole[2])
    for got, ref in ((pw, whole[1][1]), (py, whole[1][2])):
        assert abs(float(got) - float(ref)) < DOT_RTOL * max(abs(float(ref)), 1.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_u_columns_off_conductor_are_zero(name):
    """Column locality, which compact U rests on: U values off the
    conductor (outside [zb0, zb1) in particular) feed no row of the
    operator."""
    model, _, ct, _ = _build(name)
    rng = np.random.default_rng(2)
    U_off = _t(rng.standard_normal(model.shape_zyx) * ~model.cond_mask)
    yA, yU = tc.coded_apply_reference(
        torch.zeros((3,) + model.shape_zyx), U_off, ct.code, ct.cf, ct.conv,
        ct.consts, ct.inertia_on_faces)
    assert not torch.any(yA) and not torch.any(yU)


@pytest.mark.parametrize("precond", [None, "cheb_jacobi"])
def test_u_zero_off_conductor_in_every_solver_vector(precond, split,
                                                     monkeypatch):
    """Every vector the solver hands the operator, and every product it
    gets back, over 3 steps on the split route: U is exactly 0 off the
    conductor."""
    model = tcases.load_case(tcases.case_static(shape_xyz=(18, 16, 14), steps=3))
    seen = []
    op_cls = tc.CodedStencilOperator
    apply, apply_dots = op_cls.apply, op_cls.apply_dots

    def spy_apply(self, x):
        y = apply(self, x)
        seen.extend((x.U, y.U))
        return y

    def spy_dots(self, x, w):
        y, pw, py = apply_dots(self, x, w)
        seen.extend((x.U, w.U, y.U))
        return y, pw, py

    monkeypatch.setattr(op_cls, "apply", spy_apply)
    monkeypatch.setattr(op_cls, "apply_dots", spy_dots)
    sim = ect.Simulation(model, torch.float32, device=CPU, precond=precond,
                         cheb_order=8)
    assert sim.coded_op.split
    st, diag = sim.run()
    assert not diag["unconverged_steps"] and min(diag["iterations"]) > 0
    zb0, zb1 = sim.coded_op.cond_z
    off = ~sim.system.cond_mask[zb0:zb1]
    assert len(seen) > 3 * 2 * sum(diag["iterations"])
    for u in seen:
        assert u.shape == off.shape and not torch.any(u[off])
    assert not torch.any(st.U[~sim.system.cond_mask])
