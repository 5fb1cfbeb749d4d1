"""The port's field tier on (z, y) meshes (``parallel/mesh.py``
``make_mesh(n_z, n_y)``, ``parallel/shard_op.py``) against the flat operator,
one device and the JAX package's 2-D shard tier, at the contract of the JAX
package's tests/test_shard_op.py:129-233.

The applies run every block in this process, each block's ghosts handed
over from its neighbours' messages (``parallel/shard_op.py``
``in_process_blocks``, ``handover_apply``); the JAX package runs ``ShardedStencilOperator(
make_mesh(n_z, n_y))`` on its 8 fake devices (``tests/conftest.py``) on the
same numpy inputs.  The Simulations run on spawned gloo ranks: one group of 4
ranks as (2, 2), one of 8 as (4, 2) and (2, 4).

* Apply at float64 within 1e-13 of the output scale of the flat operator
  and of JAX's 2-D tier, on (4, 2), (2, 4) and (2, 2), and on the uneven
  12x13x11 grid (a rank off the conductor box in y); ``apply_div`` and the
  Jacobi diagonal likewise; at float32 on the field kernels' plain versions
  within 3e-6 of scale.
* Simulation at float64 within 1e-9 of scale of one device with the same
  iterations: 16x16x14 on (2, 2) and (4, 2), 12x13x11 on (2, 4).  float32
  within 4 tol of scale of the single-device field tier; bfloat16 state and
  float32 coefficients at bfloat16 state within twice the single-device
  port's own gap to float64 after step 1.
* Halos: an apply posts its exchange before the local field functions and
  waits after; two moving-coil steps run with every collective that moves
  whole fields made to raise.
"""

import numpy as np
import pytest
import torch

from _torch_mesh import (STATIC, UNEVEN_YZ, handover_div, random_fields,
                         spawn)
from _torch_parity import CPU, host

import jax
import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from eddy_currents_3d_tpu.parallel.shard_op import ShardedStencilOperator as JSharded
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch import Simulation
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.parallel.shard_op import (
    handover_apply, in_process_blocks)
from eddy_currents_3d_tpu_torch.testing import cases as tcases

SEED = 7
APPLY_TOL = 1e-13
SIM_TOL = 1e-9
F32_TOL = 3e-6
MESHES = [(4, 2), (2, 4), (2, 2)]


def _model(pkg, shape, steps=3, moving=False):
    case = pkg.case_moving if moving else pkg.case_static
    return pkg.load_case(case(shape_xyz=shape, steps=steps))


def _close(got, ref, tol, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * scale)


def _flat(shape):
    mt = _model(tcases, shape)
    s64 = assemble_operator(mt, torch.float64, CPU)
    A, U = random_fields(mt, SEED)
    x = State(torch.from_numpy(A), torch.from_numpy(U))
    return mt, s64, x, s64.op.apply(x)


@pytest.mark.parametrize("dims", MESHES + [(2, 4, "uneven")],
                         ids=["4x2", "2x4", "2x2", "2x4-uneven"])
def test_yz_apply_matches_flat_and_jax(dims):
    n_z, n_y = dims[:2]
    shape = UNEVEN_YZ if len(dims) > 2 else STATIC
    mt, s64, x, ref = _flat(shape)
    sops = in_process_blocks(s64, n_z, n_y, torch.float64)
    nx, ny, nz = shape
    NZl, NYl = max(2, -(-nz // n_z)), max(2, -(-ny // n_y))
    assert sops[0].padded_zyx == (n_z * NZl, n_y * NYl, nx)
    yA, yU = handover_apply(sops, x)
    scale = ref.A.abs().max().item()
    _close(yA, ref.A.numpy(), APPLY_TOL, scale)
    _close(yU, ref.U.numpy(), APPLY_TOL, scale)
    if len(dims) > 2:
        # a rank whose rows miss the conductor box holds no box
        assert any(s.box is None for s in sops)
    mj = _model(jcases, shape)
    jop = JSharded(j_assemble(mj, jnp.float64), j_make_mesh(n_z, n_y),
                   jnp.float64, use_pallas=False)
    y = jop.unpad_state(jax.jit(jop.apply)(jop.pad_state(
        JState(jnp.asarray(x.A.numpy()), jnp.asarray(x.U.numpy())))))
    _close(yA, host(y.A), APPLY_TOL, scale)
    _close(yU, host(y.U), APPLY_TOL, scale)


@pytest.mark.parametrize("dims", MESHES, ids=["4x2", "2x4", "2x2"])
def test_yz_apply_f32_on_the_plain_kernels(dims):
    mt, s64, x, ref = _flat(STATIC)
    sops = in_process_blocks(assemble_operator(mt, torch.float32, CPU),
                             *dims, torch.float32)
    assert sops[0].use_pallas and not sops[0].use_coded
    yA, yU = handover_apply(sops, State(x.A.float(), x.U.float()))
    scale = ref.A.abs().max().item()
    _close(yA, ref.A.numpy(), F32_TOL, scale)
    _close(yU, ref.U.numpy(), F32_TOL, scale)


def test_yz_apply_div_matches_flat_and_jax():
    mt, s64, x, _ = _flat(STATIC)
    ref = s64.op.apply_div(x.A).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    for dims in MESHES:
        d = handover_div(in_process_blocks(s64, *dims, torch.float64), x.A)
        _close(d, ref, APPLY_TOL, scale)
    jop = JSharded(j_assemble(_model(jcases, STATIC), jnp.float64),
                   j_make_mesh(4, 2), jnp.float64)
    _close(d, host(jax.jit(jop.apply_div)(jnp.asarray(x.A.numpy()))),
           APPLY_TOL, scale)


def test_yz_diagonal():
    mt, s64, _, _ = _flat(UNEVEN_YZ)
    sops = in_process_blocks(s64, 2, 4, torch.float64)
    d = [s.diagonal_padded() for s in sops]
    flat = s64.op.diagonal()
    one = lambda t: torch.where(t == 0, 1.0, t).numpy()
    np.testing.assert_array_equal(sops[0]._join([v.A for v in d]).numpy(),
                                  one(flat.A))
    np.testing.assert_array_equal(sops[0]._join([v.U for v in d]).numpy(),
                                  one(flat.U))


@pytest.fixture(scope="module")
def yz4(tmp_path_factory):
    return spawn("yz4", 4, tmp_path_factory.mktemp("yz4"))


@pytest.fixture(scope="module")
def yz8(tmp_path_factory):
    return spawn("yz8", 8, tmp_path_factory.mktemp("yz8"))


def _single(shape, steps=3, num_steps=None, **kw):
    return Simulation(_model(tcases, shape, steps), device=CPU, **kw).run(
        num_steps=num_steps)


@pytest.mark.parametrize("run", ["2x2", "4x2", "2x4-uneven"])
def test_yz_simulation_matches_one_device(yz4, yz8, run):
    f64 = torch.float64
    res, shape, steps, kw = {
        "2x2": (yz4[0]["f64"], STATIC, 3, dict(dot_dtype=f64)),
        "4x2": (yz8[0]["static"], STATIC, 3, dict(dot_dtype=f64)),
        "2x4-uneven": (yz8[0]["uneven"], UNEVEN_YZ, 2, {}),
    }[run]
    assert not res["coded"] and not res["unconverged"]
    st, diag = _single(shape, steps, dtype=f64, **kw)
    _close(res["A"], st.A.numpy(), SIM_TOL, np.abs(st.A.numpy()).max())
    _close(res["carry"], st.carry.numpy(), SIM_TOL,
           np.abs(st.carry.numpy()).max())
    assert res["iterations"] == diag["iterations"]


def test_yz_f32_matches_the_field_tier(yz4):
    res = yz4[0]["f32"]
    assert not res["coded"] and not res["unconverged"]
    st, _ = _single(STATIC, dtype=torch.float32, use_coded=False)
    _close(res["A"], st.A.numpy().astype(np.float64), 4 * 5e-3,
           np.abs(st.A.numpy()).max())


@pytest.mark.parametrize("name", ["bf16", "bf16_f32coef"])
def test_yz_bf16_state(yz4, name):
    """bfloat16 state (bfloat16 or float32 coefficients) on (2, 2): step 1
    within twice the single-device port's own gap to float64 step 1."""
    res = yz4[0][name]
    coef = "torch.float32" if name == "bf16_f32coef" else "torch.bfloat16"
    assert res["coef"] == coef and not res["unconverged"]
    kw = {"coeff_dtype": torch.float32} if name == "bf16_f32coef" else {}
    t64, _ = _single(STATIC, num_steps=1, dtype=torch.float64)
    t1, _ = _single(STATIC, num_steps=1, dtype=torch.bfloat16, **kw)
    ref = t64.A.numpy()
    gap = lambda a: np.abs(np.asarray(a, np.float64) - ref).max() / (
        5e-3 * np.abs(ref).max())
    assert gap(res["A"]) <= 2.0 * gap(host(t1.A)), (gap(res["A"]),
                                                     gap(host(t1.A)))


def test_yz_halos_are_posted_before_the_local_kernels(yz4):
    """Each rank of (2, 2) has one z and one y neighbour: one exchange
    posted, field_a and field_u, then 4 waits (a send and a receive each
    way)."""
    for rank in yz4:
        assert rank["order"] == (["post", "field_a", "field_u"]
                                 + ["wait"] * 4), rank["order"]


def test_yz_step_moves_no_whole_field(yz4):
    """Two moving-coil steps on (2, 2) with all_gather, broadcast, gather,
    scatter, all_to_all and reduce_scatter raising: ghosts move point to
    point and the dots are all-reduced, nothing else."""
    for rank in yz4:
        its = rank["no_gather_iterations"]
        assert len(its) == 2 and min(its) > 0
