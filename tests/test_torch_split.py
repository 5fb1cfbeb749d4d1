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
* The kernels' plan covers every plane the stencil kernel owns exactly
  once and no slab plane, at scale256 and at the card tests' shapes; the
  wrappers' CPU path adds the stencil's dots to the slab's as the kernels
  do.
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
from eddy_currents_3d_tpu_torch.ops.coded_split_cuda import (
    CHUNK, SLAB_CHUNK, SLAB_TILE, STENCIL_TILE, coded_slab, coded_stencil,
    split_plan)
from eddy_currents_3d_tpu_torch.testing import cases as tcases

from test_torch_kernels import SPLIT_CASES

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


# ---- the split kernels' plan and dots, on the CPU ----

H100_SMS = 132


def _cond_z(model):
    zz = np.nonzero(np.asarray(model.cond_mask))[0]
    return int(zz.min()), int(zz.max()) + 1


def _plan_shapes():
    """(shape, cond_z) of scale256 and of every split card test."""
    out = [((64, 256, 256), (2, 7))]
    for name in sorted(SPLIT_CASES):
        model = tcases.load_case(SPLIT_CASES[name]())
        out.append((model.shape_zyx, _cond_z(model)))
    return out


_PLAN_IDS = lambda v: str(v).replace(" ", "")


@pytest.mark.parametrize("shape_zyx, cond_z", _plan_shapes(), ids=_PLAN_IDS)
def test_split_plan_covers_owned_planes_once(shape_zyx, cond_z):
    nz, ny, nx = shape_zyx
    zb0, zb1 = cond_z
    plan = split_plan(shape_zyx, cond_z)
    covered = [z for z0, z1 in plan.chunks for z in range(z0, z1)]
    assert all(0 < z1 - z0 <= CHUNK for z0, z1 in plan.chunks)
    assert sorted(covered) == [z for z in range(nz) if not zb0 <= z < zb1]
    vx, ty, _ = STENCIL_TILE
    assert plan.stencil_tiles * 32 * vx * ty >= nx * ny
    assert plan.stencil_ctas == plan.stencil_tiles * len(plan.chunks)


@pytest.mark.parametrize("shape_zyx, cond_z", _plan_shapes(), ids=_PLAN_IDS)
def test_split_plan_covers_slab_planes_once(shape_zyx, cond_z):
    """The slab kernel's runs cover the slab's compact planes once, in
    order."""
    nz, ny, nx = shape_zyx
    zb0, zb1 = cond_z
    plan = split_plan(shape_zyx, cond_z)
    assert [p for p0, p1 in plan.slab_chunks for p in range(p0, p1)] == \
        list(range(zb1 - zb0))
    assert all(0 < p1 - p0 <= SLAB_CHUNK for p0, p1 in plan.slab_chunks)
    vx, ty, _ = SLAB_TILE
    assert plan.slab_tiles * 32 * vx * ty >= nx * ny
    assert plan.slab_ctas == plan.slab_tiles * len(plan.slab_chunks)


def test_split_plan_fills_an_h100_at_scale256():
    """At 256x256x64 (59 owned planes) every SM gets at least two stencil
    CTAs, and the slab kernel's CTAs fit one wave at two per SM."""
    plan = split_plan((64, 256, 256), (2, 7))
    assert plan.stencil_ctas >= 2 * H100_SMS
    assert plan.slab_ctas <= 2 * H100_SMS
    assert [c for c in plan.chunks if c[1] == 2 or c[0] == 7]


def test_split_card_cases_cut_runs_where_intended():
    """The card tests' short_runs case: runs start next to the slab and end
    inside the owned planes above it; one_plane_runs: runs of one plane."""
    plans = {}
    for name in ("short_runs", "one_plane_runs"):
        model = tcases.load_case(SPLIT_CASES[name]())
        plans[name] = (split_plan(model.shape_zyx, _cond_z(model)),
                       _cond_z(model), model.shape_zyx[0])
    plan, (_, zb1), nz = plans["short_runs"]
    above = [c for c in plan.chunks if c[0] >= zb1]
    assert above[0][0] == zb1 and len(above) >= 3 and above[-1][1] == nz
    assert all(z1 - z0 == 1 for z0, z1 in plans["one_plane_runs"][0].chunks)


@pytest.mark.parametrize("name", ["static", "z_through"])
def test_slab_wrapper_adds_prior_dots_on_cpu(name, split):
    """The wrappers' CPU path: the slab's dots with the stencil's passed in
    equal the plain sums plus those dots; apply_dots returns that sum."""
    model, _, ct, _ = _build(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=8)
    wA, wU = rand_fields(model.shape_zyx, model.cond_mask, seed=9)
    zb0, zb1 = ct.cond_z
    x = ct.pad_state(TState(_t(A), _t(U)))
    w = ct.pad_state(TState(_t(wA), _t(wU)))
    yA, dots_a = coded_stencil(ct, x.A, w.A)
    _, pw_a, py_a = tc.coded_stencil_reference(x.A, ct.consts, ct.cond_z, w.A)
    assert torch.equal(dots_a, torch.stack((pw_a, py_a)))
    _, yU, pw, py = tc.coded_slab_reference(
        x.A, x.U, ct.code, ct.cf, ct.conv, ct.consts, ct.inertia_on_faces,
        ct.cond_z, w)
    yU0, dots_b = coded_slab(ct, x.A, x.U, yA, w)
    assert torch.equal(yU0, yU) and torch.equal(dots_b, torch.stack((pw, py)))
    yU1, tot = coded_slab(ct, x.A, x.U, yA.clone(), w, dots_a)
    assert torch.equal(yU1, yU)
    assert torch.equal(tot, torch.stack((dots_a[0] + pw, dots_a[1] + py)))
    y, pw2, py2 = ct.apply_dots(x, w)
    assert torch.equal(torch.stack((pw2, py2)), tot)
    assert pw2.data_ptr() + 4 == py2.data_ptr()      # views of one tensor
