"""The port's multi-device tier on z slabs (``parallel/mesh.py``,
``parallel/shard_op.py``, ``Simulation(mesh=...)``) against the single-device
port and the JAX package's shard_map tier, at the contract of the JAX
package's tests/test_shard_op.py.

The ranks are gloo processes on the CPU, started with torch.multiprocessing's
spawn start method (``tests/_torch_mesh.py``: they import no jax, and meet
through a file store under ``tmp_path``).  Two groups run, each once for the
file: 4 ranks (the operator on the JAX tests' 16x16x14 grid and on nz = 13,
and the Simulations) and 2 ranks (the operator, and the mixed-precision
runs).  The JAX package runs in this process on its 8 fake host devices
(``tests/conftest.py``).

* Apply at float64: within 1e-13 of the output scale of the port's flat
  float64 apply, and of JAX's ``ShardedStencilOperator(make_mesh(4, 1))``
  on the same numpy inputs; ``apply_div`` and ``diagonal_padded`` likewise.
  At float32 on the field kernels' plain versions: within 3e-6 of scale,
  the stencil kernels' bound against float64 (tests/test_torch_field.py).
* Simulation at float64 with float64 dots: within 1e-9 of scale of the
  single-device port with the same iterations, and of JAX's own sharded
  run; nz = 13 over 4 ranks too; ``jacobi`` converges; at float32 (the
  coded tier, the default on a z-only mesh as in JAX) within 4 tol of scale
  of the single-device field tier.
* The moving coil over 5 steps: the motion state bit for bit, A within
  1e-6 of scale.
* Halos: a step runs with every collective that moves whole fields made to
  raise (point-to-point ghosts and all-reduced dots only), and an apply
  posts its exchange before the local field functions and waits after.
* Outputs: rank 0 writes the VTK of the global fields (one gather an
  output): the source files equal the single-device run's byte for byte,
  the fields within float32's resolution (1e-6 of scale); ``on_output``
  sees the global fields on every rank.
* bfloat16 state on the mesh: step 1 within twice JAX's own bfloat16 gap
  to the port's float64 step 1, as the single-device port is held
  (tests/test_torch_bf16.py); bfloat16 coefficients at float32 state
  within 4 tol of scale of the single-device run.
"""

import numpy as np
import pytest
import torch

from _torch_mesh import MOVING, STATIC, UNEVEN, random_fields, spawn
from _torch_parity import CPU, host

import jax
import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.assembly.stencil import State as JState
from eddy_currents_3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from eddy_currents_3d_tpu.parallel.shard_op import ShardedStencilOperator as JSharded
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch import Simulation
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh
from eddy_currents_3d_tpu_torch.parallel.shard_mg import ShardedMG
from eddy_currents_3d_tpu_torch.testing import cases as tcases

SEED = 3
APPLY_TOL = 1e-13
SIM_TOL = 1e-9
F32_TOL = 3e-6


@pytest.fixture(scope="module")
def vtk_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh4_vtk")


@pytest.fixture(scope="module")
def four(tmp_path_factory, vtk_dir):
    return spawn("four", 4, tmp_path_factory.mktemp("mesh4"), seed=SEED,
                 vtk_dir=str(vtk_dir / "out"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn("two", 2, tmp_path_factory.mktemp("mesh2"), seed=SEED)


def _model(pkg, shape, steps=3, moving=False):
    case = pkg.case_moving if moving else pkg.case_static
    return pkg.load_case(case(shape_xyz=shape, steps=steps))


def _flat(shape):
    """(port model, its flat f64 apply, apply_div and diagonal on the seed's
    inputs, the inputs as numpy)."""
    mt = _model(tcases, shape)
    op = assemble_operator(mt, torch.float64, CPU).op
    A, U = random_fields(mt, SEED)
    y = op.apply(State(torch.from_numpy(A), torch.from_numpy(U)))
    d = op.diagonal()
    one = lambda t: torch.where(t == 0, torch.ones_like(t), t).numpy()
    return (mt, (y.A.numpy(), y.U.numpy()),
            op.apply_div(torch.from_numpy(A)).numpy(),
            (one(d.A), one(d.U)), (A, U))


def _close(got, ref, tol, scale=None):
    scale = scale or np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("world,shape", [(4, STATIC), (4, UNEVEN),
                                         (2, STATIC)],
                         ids=["4-static", "4-nz13", "2-static"])
def test_sharded_apply_matches_flat(four, two, world, shape):
    res = (four if world == 4 else two)[0]["apply"][shape]
    _, (yA, yU), div, (dA, dU), _ = _flat(shape)
    assert not res["f64_kernels"] and res["f32_kernels"]
    nz = shape[2]
    NZl = max(2, -(-nz // world))
    assert res["padded_zyx"] == (world * NZl, shape[1], shape[0])
    scale = np.abs(yA).max()
    _close(res["f64"][0], yA, APPLY_TOL, scale)
    _close(res["f64"][1], yU, APPLY_TOL, scale)
    # the float32 apply on the field kernels' plain versions
    _close(res["f32"][0], yA, F32_TOL, scale)
    _close(res["f32"][1], yU, F32_TOL, scale)
    _close(res["div"], div, APPLY_TOL, max(np.abs(div).max(), 1.0))
    np.testing.assert_array_equal(res["diag"][0], dA)
    np.testing.assert_array_equal(res["diag"][1], dU)
    # every rank holds the same global result
    for other in (four if world == 4 else two)[1:]:
        np.testing.assert_array_equal(other["apply"][shape]["f64"][0],
                                      res["f64"][0])


def test_sharded_apply_matches_jax(four):
    """The port's 4-rank apply and JAX's 4-device one on the same numpy
    inputs, and their apply_div and Jacobi diagonal."""
    res = four[0]["apply"][STATIC]
    mj = _model(jcases, STATIC)
    sj = j_assemble(mj, jnp.float64)
    _, _, _, _, (A, U) = _flat(STATIC)
    sop = JSharded(sj, j_make_mesh(4, 1), jnp.float64, use_pallas=False)
    y = sop.unpad_state(jax.jit(sop.apply)(sop.pad_state(
        JState(jnp.asarray(A), jnp.asarray(U)))))
    scale = np.abs(host(y.A)).max()
    _close(res["f64"][0], host(y.A), APPLY_TOL, scale)
    _close(res["f64"][1], host(y.U), APPLY_TOL, scale)
    div = host(jax.jit(sop.apply_div)(jnp.asarray(A)))
    _close(res["div"], div, APPLY_TOL, max(np.abs(div).max(), 1.0))
    d = sop.unpad_state(sop.diagonal_padded())
    np.testing.assert_array_equal(res["diag"][0], host(d.A))
    np.testing.assert_array_equal(res["diag"][1], host(d.U))


def test_halos_are_posted_before_the_local_kernels(four):
    """Rank 1 of 4 has both neighbours: it posts one exchange, runs
    field_a and field_u, then waits on its 4 requests (a send and a
    receive each way)."""
    calls = four[1]["apply"]["order"]
    assert calls == ["post", "field_a", "field_u"] + ["wait"] * 4, calls
    # the end ranks have one neighbour each
    assert four[0]["apply"]["order"][-2:] == ["wait"] * 2
    assert four[3]["apply"]["order"].count("wait") == 2


def _single(shape, steps=3, moving=False, num_steps=None, **kw):
    mt = _model(tcases, shape, steps, moving)
    return Simulation(mt, device=CPU, **kw).run(num_steps=num_steps)


def test_sharded_simulation_matches_single_device(four):
    res = four[0]["sim"]["f64"]
    f64 = torch.float64
    st, diag = _single(STATIC, dtype=f64, dot_dtype=f64)
    scale = np.abs(st.A.numpy()).max()
    _close(res["A"], st.A.numpy(), SIM_TOL, scale)
    _close(res["carry"], st.carry.numpy(), SIM_TOL,
           np.abs(st.carry.numpy()).max())
    assert res["iterations"] == diag["iterations"]
    assert not res["unconverged"]


def test_sharded_simulation_matches_jax(four):
    """JAX's own 4-device sharded run on the same model."""
    res = four[0]["sim"]["f64"]
    mj = _model(jcases, STATIC)
    jsim = JSimulation(mj, dtype=jnp.float64, dot_dtype=jnp.float64,
                       mesh=j_make_mesh(4, 1))
    assert jsim.shard_op is not None
    sj, dj = jsim.run()
    scale = np.abs(host(sj.A)).max()
    _close(res["A"], host(sj.A), SIM_TOL, scale)
    assert res["iterations"] == dj["iterations"]


def test_sharded_sim_uneven_z(four):
    """nz = 13 over 4 slabs of 4 planes: one inert padding plane."""
    res = four[0]["sim"]["uneven"]
    assert res["slab"] == (16, 12, 12)
    st, diag = _single(UNEVEN, steps=2, dtype=torch.float64)
    _close(res["A"], st.A.numpy(), SIM_TOL)
    assert res["iterations"] == diag["iterations"]


def test_sharded_jacobi_converges(four):
    res = four[0]["sim"]["jacobi"]
    assert not res["unconverged"] and min(res["iterations"]) > 0


def test_sharded_f32_matches_the_field_tier(four):
    """float32 on the mesh, the coded tier's plain version per slab,
    against the single-device field tier."""
    res = four[0]["sim"]["f32"]
    st, diag = _single(STATIC, dtype=torch.float32, use_coded=False)
    assert res["coded"] and not four[0]["sim"]["f64"]["coded"]
    assert not res["unconverged"]
    _close(res["A"], st.A.numpy().astype(np.float64),
           4 * 5e-3, np.abs(st.A.numpy()).max())


def test_moving_source_on_the_mesh_matches(four):
    res = four[0]["sim"]["moving"]
    f64 = torch.float64
    st, _ = _single(MOVING, steps=6, moving=True, num_steps=5, dtype=f64,
                    dot_dtype=f64)
    np.testing.assert_array_equal(res["movestop"],
                                  np.asarray(st.motion.movestop))
    np.testing.assert_array_equal(res["distance"],
                                  np.asarray(st.motion.distance))
    assert np.abs(np.asarray(st.motion.distance)).max() > 0
    _close(res["A"], st.A.numpy(), 1e-6)


def test_a_step_moves_no_whole_field(four):
    """Two moving-coil steps on every rank with all_gather, broadcast,
    gather, scatter, all_to_all and reduce_scatter raising: the step only
    exchanges ghost planes and all-reduces dots."""
    for rank in four:
        its = rank["sim"]["no_gather_iterations"]
        assert len(its) == 2 and min(its) > 0


def test_bf16_state_on_the_mesh(two):
    """bfloat16 state on 2 slabs: step 1 within twice JAX's own bfloat16
    gap to the port's float64 step 1."""
    res = two[0]["mixed"]["bf16"]
    assert res["dtype"] == "torch.bfloat16" and res["coef"] == "torch.bfloat16"
    assert not res["unconverged"]
    t64, _ = _single(STATIC, num_steps=1, dtype=torch.float64)
    j1, _ = JSimulation(_model(jcases, STATIC), dtype=jnp.bfloat16).run(
        num_steps=1)
    ref = t64.A.numpy()
    gap = lambda a: np.abs(np.asarray(a, np.float64) - ref).max() / (
        5e-3 * np.abs(ref).max())
    assert gap(res["A"]) <= 2.0 * gap(host(j1.A)), (gap(res["A"]),
                                                     gap(host(j1.A)))


def test_bf16_coefficients_on_the_mesh(two):
    res = two[0]["mixed"]["coeff_bf16"]
    assert res["dtype"] == "torch.float32" and res["coef"] == "torch.bfloat16"
    st, _ = _single(STATIC, num_steps=1, dtype=torch.float32,
                    coeff_dtype=torch.bfloat16)
    assert not res["unconverged"]
    _close(res["A"], st.A.numpy().astype(np.float64), 4 * 5e-3)


def test_mesh_run_writes_the_global_vtk(four, vtk_dir, tmp_path):
    import os

    from eddy_currents_3d_tpu.io.vtk import read_vtk_vectors

    mt = _model(tcases, STATIC)
    ref = tmp_path / "one"
    Simulation(mt, torch.float64, torch.float64, device=CPU).run(
        output_dir=str(ref))
    names = sorted(os.listdir(ref))
    assert names and sorted(os.listdir(vtk_dir / "out")) == names
    for n in names:
        got, want = vtk_dir / "out" / n, ref / n
        if n.startswith("src_"):
            assert got.read_bytes() == want.read_bytes(), n
            continue
        fg, fw = read_vtk_vectors(str(got)), read_vtk_vectors(str(want))
        for key in fw:
            if key != "dims":
                _close(fg[key], fw[key], 1e-6,
                       max(np.abs(fw[key]).max(), 1e-30))
    shape = (3,) + tuple(mt.shape_zyx)
    for rank in four:
        shown = rank["sim"]["on_output"]
        assert [n for n, _, _ in shown] == list(range(1, len(names) // 2 + 1))
        assert all(a == c == shape for _, a, c in shown)


def test_mesh_options_raise():
    """What the port's mesh does not take raises by name (one rank, gloo
    on a file store); make_mesh checks the group and the mesh shape.  What
    it has come to take runs: precond="mg" builds on the field tier with
    the V-cycle on the rank's block (parallel/shard_mg.py), and
    use_shard_map=False on the field tier, never coded (the JAX package's
    GSPMD tier); use_coded=True takes the coded tier, the
    float32 default does too (as in JAX, coded_op stays None: the tier is
    the shard operator's), checkpoints are written on a mesh, and a mesh
    of one rank has no neighbour along y either."""
    import os
    import tempfile

    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(1)
    mt = _model(tcases, (12, 12, 12), steps=2)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            with pytest.raises(ValueError, match="n_z=2, n_y=1 but"):
                make_mesh(2)
            with pytest.raises(ValueError, match="n_y=2 but"):
                make_mesh(1, 2)
            mesh = make_mesh(1)
            assert mesh.device == CPU and mesh.lo is None and mesh.hi is None
            assert mesh.n_y == 1 and mesh.ylo is None and mesh.yhi is None
            with pytest.raises(ValueError, match="single-device only"):
                Simulation(mt, mesh=mesh, precond="ilu0")
            # the JAX package's GSPMD tier: the per-block field tier, with
            # the V-cycle on the rank's block under "mg"
            sim = Simulation(mt, mesh=mesh, precond="mg")
            assert not sim.shard_op.use_coded
            assert isinstance(sim._mg, ShardedMG)
            sim = Simulation(mt, mesh=mesh, use_shard_map=False)
            assert not sim.shard_op.use_coded and sim.precond is None
            assert Simulation(mt, mesh=mesh, use_coded=True).shard_op.use_coded
            sim = Simulation(mt, mesh=mesh)
            assert sim.coded_op is None and sim.shard_op.use_coded
            ck = os.path.join(tmp, "ck")
            sim.run(checkpoint_dir=ck, checkpoint_every=1)
            assert sorted(os.listdir(ck)) == ["ckpt_1.npz", "ckpt_2.npz"]
        finally:
            dist.destroy_process_group()
