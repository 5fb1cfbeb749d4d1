"""The port's host-side motion (numpy float64) against the JAX package's
advance_function under x64: distances, Kahan compensations, the latch and
the displaced cells must be equal to the bit."""

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread cap)

import jax.numpy as jnp

from eddy_currents_3d_tpu.sim import motion as jm
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.testing import cases as jcases
from eddy_currents_3d_tpu_torch.sim import motion as tm


def _pair(ijk0, shape, const_shift=(0.0, 0.0, 0.0), vmech=(0, 0, 0)):
    kw = dict(index=0, ijk0=np.asarray(ijk0, np.int32),
              const_shift=np.asarray(const_shift, float),
              vmech_index=vmech, shape_xyz=shape)
    return jm.FunctionMotion(**kw), tm.FunctionMotion(**kw)


def _run(fmj, fmt, vmech_seq, dt, delta):
    dj = jnp.zeros(3); cj = jnp.zeros(3); msj = jnp.ones(3, jnp.int32)
    dt_ = np.zeros(3); ct = np.zeros(3); mst = np.ones(3, np.int32)
    for v in vmech_seq:
        dj, cj, msj, fj = jm.advance_function(fmj, dj, cj, msj, jnp.asarray(v),
                                              dt, delta)
        dt_, ct, mst, ft = tm.advance_function(fmt, dt_, ct, mst,
                                               np.asarray(v, np.float64), dt,
                                               delta)
        np.testing.assert_array_equal(dt_, np.asarray(dj))
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_array_equal(mst, np.asarray(msj))
        np.testing.assert_array_equal(ft, np.asarray(fj))
    return mst


def test_case_moving_ten_steps_bit_exact():
    """The moving-coil case's own functions over 10 steps, with the
    velocity values of its Vmx/Vmy expressions."""
    model = jcases.load_case(jcases.case_moving(shape_xyz=(20, 20, 12), steps=10))
    sim = JSimulation(model, dtype=jnp.float64)
    times = [t for t, _ in sim.steps]
    assert len(times) == 10
    vals = [[float(vm(t)) for vm in model.vmech] for t in times]
    dt = float(model.tran.step)
    for _, _, _, fmj in sim._funs:
        fmt = tm.FunctionMotion(index=fmj.index, ijk0=fmj.ijk0,
                                const_shift=fmj.const_shift,
                                vmech_index=fmj.vmech_index,
                                shape_xyz=fmj.shape_xyz)
        _run(fmj, fmt, vals, dt, model.delta)


@pytest.mark.parametrize("shift,steps", [(0.6, 5), (-1.4, 8), (3.2, 6), (0.7, 20)])
def test_constant_velocity_latch_bit_exact(shift, steps):
    """Constant-velocity axes: the movestop(1) gate, the wall clamp and the
    frozen Kahan accumulator while latched."""
    shape = (14, 12, 10)
    ijk0 = np.array([[x, y, 4] for x in range(5, 8) for y in range(4, 6)])
    fmj, fmt = _pair(ijk0, shape, const_shift=(shift, 0.3, 0.0))
    _run(fmj, fmt, [[0.0]] * steps, 1.0, np.ones(3))


def test_clamp_and_rearm_bit_exact():
    """A function-driven axis runs into the wall and back: the latch drops
    and re-arms."""
    shape = (12, 10, 10)
    fmj, fmt = _pair([[8, 4, 4], [7, 5, 4]], shape, vmech=(1, 0, 0))
    seq = [[0.9]] * 6 + [[-1.3]] * 8
    ms = _run(fmj, fmt, seq, 1.0, np.ones(3))
    assert ms.dtype == np.int32
