"""The port's coded tier on z slabs (``parallel/shard_op.py`` ``use_coded=True``,
the default of a float32 ``Simulation`` on a z-only mesh) against the JAX
package's coded shard tier and the float64 flat operator, at the contract of
the JAX package's tests/test_shard_op.py:306-408.

The applies run every slab in this process, each slab's ghosts handed over
from its neighbours' messages (``parallel/shard_op.py``
``in_process_blocks``, ``handover_apply``), on the coded kernel's plain
version.  The JAX
package runs ``ShardedStencilOperator(..., use_coded=True, interpret=True)``
on its 8 fake devices (``tests/conftest.py``) on the same numpy inputs.  The
Simulations run on 4 spawned gloo ranks (``_torch_mesh.spawn``).

* Apply, float32, within 3e-6 of the output scale of the float64 flat
  operator and of JAX's coded shard tier: 16x16x14 on 8 slabs (NZl = 2),
  nz = 13 on 4 (a padding plane, and the grid's +z face mid-slab),
  12x12x16 on 8 (tiny slabs), the convection case on 4; ``apply_div`` and
  the Jacobi diagonal likewise.  Padding planes and off-conductor U stay
  exactly 0.
* The Simulation takes the coded tier by default, and its 3-step run is
  within 4 tol of scale of the unsharded coded run; ``jacobi`` converges.
  An apply posts its exchange before the local coded kernel.
* ``use_coded=True`` with a y decomposition raises, naming it.
"""

import numpy as np
import pytest
import torch

from _torch_mesh import CODED, handover_div, random_fields, spawn
from _torch_parity import CPU, host, pallas_interpret

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
from eddy_currents_3d_tpu_torch.ops.coded import CodedUnsupported
from eddy_currents_3d_tpu_torch.ops.coded_cuda import whole_plan
from eddy_currents_3d_tpu_torch.parallel.mesh import Mesh
from eddy_currents_3d_tpu_torch.parallel.shard_op import (
    ShardedStencilOperator, handover_apply, in_process_blocks)
from eddy_currents_3d_tpu_torch.testing import cases as tcases

SEED = 5
TOL = 3e-6          # float32 apply, x output scale (JAX's coded shard tests)

CASES = {
    "static": ("case_static", (16, 16, 14), 8),
    "uneven": ("case_static", (12, 12, 13), 4),
    "tiny": ("case_static", (12, 12, 16), 8),
    "convection": ("case_convection", (16, 12, 12), 4),
}


def _model(pkg, name):
    case, shape, _ = CASES[name]
    return pkg.load_case(getattr(pkg, case)(shape_xyz=shape, steps=2))


def _port(name):
    """(model, slabs of the coded tier, float64 flat system, numpy A, U)."""
    mt = _model(tcases, name)
    sops = in_process_blocks(assemble_operator(mt, torch.float32, CPU),
                             CASES[name][2], 1, torch.float32, model=mt,
                             use_coded=True)
    return (mt, sops, assemble_operator(mt, torch.float64, CPU),
            random_fields(mt, SEED))


def _jax(name):
    """JAX's coded shard tier of the case, interpret mode."""
    mj = _model(jcases, name)
    return JSharded(j_assemble(mj, jnp.float32), j_make_mesh(CASES[name][2],
                                                             1),
                    jnp.float32, use_pallas=True, interpret=True, model=mj,
                    use_coded=True)


def _close(got, ref, scale, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_coded_slabs_apply_matches_flat_and_jax(name):
    mt, sops, s64, (A, U) = _port(name)
    assert all(s.use_coded for s in sops)
    x = State(torch.from_numpy(A).float(), torch.from_numpy(U).float())
    yA, yU = handover_apply(sops, x)
    ref = s64.op.apply(State(torch.from_numpy(A), torch.from_numpy(U)))
    scale = ref.A.abs().max().item()
    uscale = max(ref.U.abs().max().item(), scale)
    _close(yA, ref.A.numpy(), scale)
    _close(yU, ref.U.numpy(), uscale)
    jop = _jax(name)
    with pallas_interpret():
        y = jop.unpad_state(jax.jit(jop.apply)(jop.pad_state(JState(
            jnp.asarray(A, jnp.float32), jnp.asarray(U, jnp.float32)))))
    _close(yA, host(y.A), scale)
    _close(yU, host(y.U), uscale)
    # the JAX tier's own layout choices, which the port shares
    assert jop._NZl == sops[0].NZl
    assert jop._z_deltas_face_only == (mt.shape_zyx[0] % sops[0].NZl == 0)
    if name == "convection":
        assert jop._coded_meta[2] and sops[0].local.has_conv


def test_padding_and_off_conductor_stay_zero():
    """nz = 13 on 4 slabs of 4 planes: the last slab's 3 padding planes of
    yA and yU are exactly 0, and so is yU off the conductor, on every
    slab."""
    mt, sops, _, (A, U) = _port("uneven")
    x = State(torch.from_numpy(A).float(), torch.from_numpy(U).float())
    ys = handover_apply(sops, x, blocks_out=True)
    last = sops[-1]
    pad = mt.shape_zyx[0] - last.z0
    assert pad == 1 and last.NZl == 4
    yA, yU = ys[-1]
    assert torch.count_nonzero(yA[:, pad:]) == 0
    assert torch.count_nonzero(yU[pad:]) == 0
    assert torch.count_nonzero(yA[:, :pad]) > 0
    for s, (_, yU) in zip(sops, ys):
        cond = s.shard(torch.from_numpy(np.asarray(mt.cond_mask)))
        assert torch.count_nonzero(yU[~cond]) == 0
        assert torch.count_nonzero(yU[cond]) > 0 or not cond.any()


def test_coded_slabs_apply_div_matches():
    mt, sops, s64, (A, _) = _port("static")
    d = handover_div(sops, torch.from_numpy(A).float())
    ref = s64.op.apply_div(torch.from_numpy(A)).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    _close(d, ref, scale)
    jop = _jax("static")
    with pallas_interpret():
        dj = host(jax.jit(jop.apply_div)(jnp.asarray(A, jnp.float32)))
    _close(d, dj, scale)


@pytest.mark.parametrize("name", ["static", "uneven"])
def test_coded_slabs_diagonal(name):
    """The host-built Jacobi diagonal: the flat operator's (1 where it is
    0), and JAX's coded tier's, bit for bit, padding planes 1."""
    mt, sops, s64, _ = _port(name)
    d = [s.diagonal_padded() for s in sops]
    dA = sops[0]._join([x.A for x in d]).numpy()
    dU = sops[0]._join([x.U for x in d]).numpy()
    flat = s64.op.diagonal()
    one = lambda t: np.where(t == 0, 1.0, t).astype(np.float32)
    np.testing.assert_array_equal(dA, one(flat.A.numpy()))
    np.testing.assert_array_equal(dU, one(flat.U.numpy()))
    jop = _jax(name)
    jd = jop.unpad_state(jop.diagonal_padded())
    np.testing.assert_array_equal(dA, host(jd.A))
    np.testing.assert_array_equal(dU, host(jd.U))
    pad = sops[-1].shape_zyx[0] - sops[-1].z0
    assert (d[-1].A[:, pad:] == 1).all() and (d[-1].U[pad:] == 1).all()


def test_slab_off_the_conductor_runs_air_only():
    """A slab with no conducting plane gets the empty conductor range, and
    the whole-plane kernel's plan covers it with air runs alone."""
    _, sops, _, _ = _port("static")
    empty = [s for s in sops if s.local.cond_z == (0, 0)]
    assert empty and len(empty) < len(sops)
    plan = whole_plan(empty[0].local.shape_zyx, (0, 0))
    assert plan.runs == ((0, 2, 0),) and plan.ctas >= 1
    with pytest.raises(ValueError, match="do not fit"):
        whole_plan((4, 8, 8), (3, 2))


def test_coded_refuses_a_y_decomposition():
    mt = tcases.load_case(tcases.case_static(shape_xyz=(14, 14, 12), steps=2))
    mesh = Mesh(n_z=2, index=0, device=CPU, hi=2, n_y=2, iy=0, yhi=1)
    with pytest.raises(CodedUnsupported, match="y decomposition"):
        ShardedStencilOperator(assemble_operator(mt, torch.float32, CPU),
                               mesh, torch.float32, model=mt, use_coded=True)
    with pytest.raises(ValueError, match="mesh has a y decomposition"):
        Simulation(mt, torch.float32, mesh=mesh, use_coded=True)
    # without use_coded the y decomposition takes the field tier
    sim = Simulation(mt, torch.float32, mesh=mesh)
    assert not sim.shard_op.use_coded and sim.shard_op.use_pallas


@pytest.fixture(scope="module")
def coded(tmp_path_factory):
    return spawn("coded", 4, tmp_path_factory.mktemp("coded4"))


def test_coded_simulation_matches_the_unsharded_coded_run(coded):
    res = coded[0]["f32"]
    assert res["coded"] and res["padded_zyx"] == (12, 14, 16)
    assert not res["unconverged"]
    mt = tcases.load_case(tcases.case_static(shape_xyz=CODED, steps=3))
    sim = Simulation(mt, torch.float32, device=CPU)
    assert sim.coded_op is not None
    st, diag = sim.run()
    tol = mt.solver.tolerance
    scale = np.abs(st.A.numpy()).max()
    _close(res["A"], st.A.numpy(), scale, 4 * tol)
    for other in coded[1:]:
        np.testing.assert_array_equal(other["f32"]["A"], res["A"])


def test_coded_jacobi_converges(coded):
    res = coded[0]["jacobi"]
    assert res["coded"] and not res["unconverged"]
    assert min(res["iterations"]) > 0


def test_coded_halos_are_posted_before_the_local_kernel(coded):
    """Slab 1 of 4 posts one exchange with both neighbours, runs the coded
    kernel, then waits on its 4 requests."""
    assert coded[1]["order"] == ["post", "coded_matvec"] + ["wait"] * 4
    assert coded[0]["order"] == ["post", "coded_matvec"] + ["wait"] * 2
