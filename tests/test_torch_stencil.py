"""The port's flat-roll stencil operator against the JAX package's at f64:
apply, apply_div and diagonal within 1e-12 of the output scale (the two
differ only in floating-point summation order)."""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, rand_fields

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.assembly.stencil import shift as j_shift
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.assembly.stencil import shift as t_shift
from eddy_currents_3d_tpu_torch.testing import cases as tcases

TOL = 1e-12

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=2),
    "lim": lambda c: c.case_lim(shape_xyz=(20, 11, 10), steps=2),
    "convection": lambda c: c.case_convection(shape_xyz=(18, 12, 10), steps=2),
    "moving": lambda c: c.case_moving(shape_xyz=(16, 16, 10), steps=2),
}


def _systems(name):
    mj = jcases.load_case(CASES[name](jcases))
    mt = tcases.load_case(CASES[name](tcases))
    return (mj, j_assemble(mj, jnp.float64),
            t_assemble(mt, torch.float64, CPU))


def _close(a, b):
    a, b = host(a), host(b)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_matches(name):
    model, sj, st = _systems(name)
    A, U = rand_fields(model.shape_zyx, model.cond_mask, seed=1)
    yj = sj.op.apply(JState(jnp.asarray(A), jnp.asarray(U)))
    yt = st.op.apply(TState(torch.from_numpy(A), torch.from_numpy(U)))
    _close(yt.A, yj.A)
    _close(yt.U, yj.U)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_div_matches(name):
    model, sj, st = _systems(name)
    A, _ = rand_fields(model.shape_zyx, model.cond_mask, seed=2)
    _close(st.op.apply_div(torch.from_numpy(A)), sj.op.apply_div(jnp.asarray(A)))


@pytest.mark.parametrize("name", ["static", "convection"])
def test_diagonal_matches(name):
    _, sj, st = _systems(name)
    dj, dt = sj.op.diagonal(), st.op.diagonal()
    np.testing.assert_array_equal(host(dt.A), host(dj.A))
    np.testing.assert_array_equal(host(dt.U), host(dj.U))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("d", [-2, -1, 1, 2, 30])
def test_shift_matches(axis, d):
    f = np.random.default_rng(3).standard_normal((3, 5, 6, 7))
    np.testing.assert_array_equal(host(t_shift(torch.from_numpy(f), axis, d)),
                                  host(j_shift(jnp.asarray(f), axis, d)))
