"""The multigrid V-cycle on a (z, y) mesh (``parallel/shard_mg.py``) and the
mesh options that take the JAX package's GSPMD tier (``precond="mg"``,
``use_shard_map=False``), against JAX's ``build_mg(...).apply_scalar`` and
JAX's GSPMD Simulations on its 8 fake devices (``tests/conftest.py``).

The distributed V-cycle runs two ways: every block in this process, the
ghosts and the gather handed over locally (``in_process_mg``,
``handover_vcycle``), and on spawned gloo ranks (``tests/_torch_mesh.py``:
one group of 2 ranks and one of 4), where the ghosts move by
``batch_isend_irecv`` and the gather is an all-gather.

* The level plan: the level count is JAX's, from the global shapes; a mesh
  holds a level while its block extents along the cut axes are even and
  gathers at the first odd one (team7 on 4 z slabs at level 1, on 2x2 at
  level 0), or holds every level.
* The V-cycle at float64 within 1e-13 of the output scale of JAX's: 16^3
  on (2, 1) (distributed to the coarsest level), STATIC on (2, 1) (NZl = 7
  gathers at level 0), UNEVEN_YZ on (2, 2) and (2, 4), 16^3 on (4, 1) and
  (4, 2); the padding cells of every block stay exactly 0; the replicated
  levels' correction is the same on every rank bit for bit.
* ``Simulation(precond="mg")`` on (2, 1) and (2, 2) at float64 within
  1e-9 of scale of JAX's ``Simulation(precond="mg", mesh=make_mesh(4, 2))``
  and of the single-device port, with the same iterations; at float32 step
  1's true residual, recomputed at float64, under the tolerance.
* ``use_shard_map=False`` on the moving coil (the setup of JAX's
  ``test_moving_source_gspmd_matches_single_device``) on (2, 2): the
  distances within 4e-16 relative (ROADMAP Queue 3 item 5), A within 1e-9
  of scale of JAX's run on (4, 2).
* ``mg`` with ``use_shard_map=True``, and ``use_shard_map=False`` with
  ``use_coded=True``, raise ``ValueError``.
"""

import numpy as np
import pytest
import torch

from _torch_mesh import (MOVING, STATIC, UNEVEN_YZ, spawn, vcycle_input)
from _torch_parity import CPU, host

import jax
import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.solvers.multigrid import build_mg as j_build_mg
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch import Simulation
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.parallel.mesh import Mesh
from eddy_currents_3d_tpu_torch.parallel.shard_mg import (
    handover_vcycle, in_process_mg, level_plan)
from eddy_currents_3d_tpu_torch.parallel.shard_op import in_process_blocks
from eddy_currents_3d_tpu_torch.solvers.bicgstab import tree_norm
from eddy_currents_3d_tpu_torch.solvers.multigrid import hierarchy
from eddy_currents_3d_tpu_torch.testing import cases as tcases

SEED = 11
VCYCLE_TOL = 1e-13
SIM_TOL = 1e-9
CUBE = (16, 16, 16)
TEAM7 = (102, 102, 24)


def _model(pkg, shape, steps=3, moving=False):
    case = pkg.case_moving if moving else pkg.case_static
    return pkg.load_case(case(shape_xyz=shape, steps=steps))


def _close(got, ref, tol, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * scale)


def _jax_vcycle(shape, seed=SEED):
    """JAX's V-cycle of ``vcycle_input`` on ``shape`` at float64."""
    mj = _model(jcases, shape)
    mg = j_build_mg(j_assemble(mj, jnp.float64).op.ka, dtype=jnp.float64)
    r = jnp.asarray(vcycle_input(mj, seed))
    return host(jax.jit(mg.apply_scalar)(r))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return spawn("mg_four", 4, tmp_path_factory.mktemp("mg4"), seed=SEED)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn("mg_two", 2, tmp_path_factory.mktemp("mg2"), seed=SEED)


@pytest.fixture(scope="module")
def jax_mg():
    """JAX's GSPMD mg run on (4, 2) at float64 with float64 dots (STATIC,
    3 steps): (A, carry, iterations)."""
    sim = JSimulation(_model(jcases, STATIC), dtype=jnp.float64,
                      dot_dtype=jnp.float64, precond="mg",
                      mesh=j_make_mesh(4, 2))
    st, diag = sim.run()
    return host(st.A), host(st.carry), list(diag["iterations"])


# (grid, mesh, block extents of the levels the blocks hold, gathers)
PLANS = [
    (TEAM7, (4, 1), [(6, 102, 102), (3, 51, 51)], True),
    (TEAM7, (2, 2), [(12, 51, 102)], True),
    (CUBE, (2, 1), [(8, 16, 16), (4, 8, 8), (2, 4, 4), (1, 2, 2)], False),
    (STATIC, (2, 1), [(7, 16, 16)], True),
    (CUBE, (1, 1), [(16, 16, 16), (8, 8, 8), (4, 4, 4), (2, 2, 2)], False),
]


@pytest.mark.parametrize("shape,dims,blocks,gathers", PLANS,
                         ids=["team7-4x1", "team7-2x2", "cube-2x1",
                              "static-2x1", "cube-1x1"])
def test_level_plan(shape, dims, blocks, gathers):
    mt = _model(tcases, shape)
    shapes = [tuple(h.shape[1:])
              for h in hierarchy(np.zeros((7,) + tuple(mt.shape_zyx)))]
    nx, ny, nz = shape
    n_z, n_y = dims
    block = (max(2, -(-nz // n_z)) if n_z > 1 else nz,
             max(2, -(-ny // n_y)) if n_y > 1 else ny, nx)
    assert level_plan(shapes, block, (n_z > 1, n_y > 1, False)) == (
        blocks, gathers)


IN_PROCESS = [(CUBE, (2, 1)), (STATIC, (2, 1)), (UNEVEN_YZ, (2, 2)),
              (UNEVEN_YZ, (2, 4)), (CUBE, (4, 2)), ((20, 20, 14), (4, 1))]


@pytest.mark.parametrize("shape,dims", IN_PROCESS,
                         ids=["cube-2x1", "static-2x1", "uneven-2x2",
                              "uneven-2x4", "cube-4x2", "padded-4x1"])
def test_in_process_vcycle_matches_jax(shape, dims):
    """Every block in this process: the V-cycle within VCYCLE_TOL of
    scale of JAX's, and every block's padding cells exactly 0 (the
    20x20x14 grid on 4 slabs pads z to 16: its last slab holds padding on
    three distributed levels)."""
    mt = _model(tcases, shape)
    s64 = assemble_operator(mt, torch.float64, CPU)
    sops = in_process_blocks(s64, *dims, torch.float64)
    mg = in_process_mg(s64.op.ka, sops, dtype=torch.float64)
    r = torch.from_numpy(vcycle_input(mt, SEED))
    ref = _jax_vcycle(shape)
    _close(handover_vcycle(mg, sops, r), ref, VCYCLE_TOL, np.abs(ref).max())
    blocks = handover_vcycle(mg, sops, r, blocks_out=True)
    cells = torch.stack([s.shard(torch.ones(tuple(mt.shape_zyx),
                                            dtype=torch.float64))
                         for s in sops])[:, None]
    assert (blocks * (1 - cells)).abs().max().item() == 0.0


def _rank_vcycles(four, two):
    out = {}
    for group in (four, two):
        for key in group[0]["vcycle"]:
            out[key] = [rank["vcycle"][key] for rank in group]
    return out


RANK_CASES = [(CUBE, (2, 1)), (STATIC, (2, 1)), (UNEVEN_YZ, (2, 2)),
              (CUBE, (4, 1))]


@pytest.mark.parametrize("shape,dims", RANK_CASES,
                         ids=["cube-2x1", "static-2x1", "uneven-2x2",
                              "cube-4x1"])
def test_rank_vcycle_matches_jax(four, two, shape, dims):
    """On gloo ranks: every rank's global result within VCYCLE_TOL of
    scale of JAX's V-cycle, its padding cells exactly 0, the replicated
    levels' correction equal on every rank bit for bit."""
    ranks = _rank_vcycles(four, two)[(shape, dims)]
    ref = _jax_vcycle(shape)
    gathers = {(CUBE, (2, 1)): False, (STATIC, (2, 1)): True,
               (UNEVEN_YZ, (2, 2)): True, (CUBE, (4, 1)): True}
    for rank in ranks:
        _close(rank["y"], ref, VCYCLE_TOL, np.abs(ref).max())
        assert rank["padding"] == 0.0
        assert rank["gathers"] == gathers[(shape, dims)]
        if rank["gathers"]:
            np.testing.assert_array_equal(rank["replicated"],
                                          ranks[0]["replicated"])


@pytest.mark.parametrize("group,dims", [("two", (2, 1)), ("four", (2, 2))],
                         ids=["2x1", "2x2"])
def test_mesh_mg_matches_jax_gspmd(four, two, jax_mg, group, dims):
    """Simulation(precond="mg") on the mesh at float64 with float64 dots:
    within SIM_TOL of scale of JAX's GSPMD run on (4, 2) and of the
    single-device port, with the same iterations."""
    run = {"two": two, "four": four}[group][0]["mg_f64"]
    assert not run["coded"] and run["unconverged"] == []
    sim = Simulation(_model(tcases, STATIC), torch.float64, torch.float64,
                     device=CPU, precond="mg")
    st, diag = sim.run()
    ja, jc, jits = jax_mg
    assert run["iterations"] == diag["iterations"] == jits
    scale = np.abs(ja).max()
    for got in (run["A"], st.A.numpy()):
        _close(got, ja, SIM_TOL, scale)
    _close(run["carry"], jc, SIM_TOL, np.abs(jc).max())


def test_use_shard_map_false_moving_matches_jax(four):
    """use_shard_map=False on the moving coil over 5 steps: the field tier,
    never coded; the distances within 4e-16 relative and the stops equal
    to JAX's GSPMD run on (4, 2), A within SIM_TOL of scale."""
    mj = _model(jcases, MOVING, 6, moving=True)
    sim = JSimulation(mj, dtype=jnp.float64, dot_dtype=jnp.float64,
                      mesh=j_make_mesh(4, 2), use_shard_map=False,
                      donate=False)
    st, diag = sim.run(num_steps=5)
    for rank in four:
        run = rank["gspmd_moving"]
        assert not run["coded"] and run["unconverged"] == []
        assert run["iterations"] == list(diag["iterations"])
        np.testing.assert_array_equal(run["movestop"],
                                      np.asarray(st.motion.movestop))
        np.testing.assert_allclose(run["distance"],
                                   np.asarray(st.motion.distance),
                                   rtol=4e-16, atol=0)
        ja = host(st.A)
        _close(run["A"], ja, SIM_TOL, np.abs(ja).max())


def test_f32_mesh_mg_true_residual(four):
    """float32 mg on (2, 2): step 1's solution has a true residual,
    recomputed at float64 with the float64 operator, under the
    tolerance."""
    run = four[0]["mg_f32"]
    assert not run["coded"] and run["iterations"] > 0
    assert all(r["mg_f32"]["iterations"] == run["iterations"] for r in four)
    mt = _model(tcases, STATIC)
    op = assemble_operator(mt, torch.float64, CPU).op
    bA, bU, xA, xU = (torch.from_numpy(a).double() for a in run["step1"])
    b = State(bA, bU)
    y = op.apply(State(xA, xU))
    rel = (tree_norm(State(b.A - y.A, b.U - y.U)) / tree_norm(b)).item()
    assert rel < mt.solver.tolerance, rel


@pytest.mark.parametrize("kw,msg", [
    ({"precond": "mg", "use_shard_map": True}, "use_shard_map=True"),
    ({"use_shard_map": False, "use_coded": True}, "use_shard_map=False"),
], ids=["mg-shard-map", "gspmd-coded"])
def test_mesh_mg_refusals(kw, msg):
    """Refused before any communication: a one-block mesh needs no group."""
    mt = _model(tcases, (12, 12, 12), steps=2)
    mesh = Mesh(n_z=1, index=0, device=CPU)
    with pytest.raises(ValueError, match=msg):
        Simulation(mt, mesh=mesh, **kw)
