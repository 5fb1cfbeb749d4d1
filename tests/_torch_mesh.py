"""Ranks of the port's (z, y) mesh on the CPU, for the tests of the
multi-device tier (tests/test_torch_shard_*.py).

:func:`spawn` starts ``world`` processes with torch.multiprocessing's spawn
start method, each a gloo rank of one process group whose store is a file
under the caller's directory (so concurrent test workers never share a
port), runs one task of :data:`TASKS` on every rank, and returns every
rank's results.  The ranks import torch and the port, never jax: the JAX
package's runs stay in the parent test process, and the two sides meet as
numpy arrays.  A task groups several checks, so that a file of tests
spawns few groups.

:func:`handover_div` runs the sharded ``apply_div`` of every block of a
mesh in one process (``parallel/shard_op.py`` ``in_process_blocks``), each
block's ghosts taken straight from its neighbours' messages, as
``handover_apply`` does the apply.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

STATIC = (16, 16, 14)       # the JAX package's tests/test_shard_op.py grid
UNEVEN = (12, 12, 13)       # nz = 13 over 4 ranks: one padding plane
MOVING = (16, 16, 12)
TEAM7 = (102, 102, 24)      # chip_smoke.py's team7 grid
CODED = (16, 14, 12)        # the JAX package's coded shard Simulation grid
UNEVEN_YZ = (12, 13, 11)    # ny = 13, nz = 11 over (2, 4): both axes pad


def handover_div(sops, A):
    """The sharded apply_div of the global ``A`` over ``sops``
    (``in_process_blocks``), each block's ghosts handed over as
    ``handover_apply`` hands them over: the global yU."""
    from eddy_currents_3d_tpu_torch.parallel.shard_op import OPPOSITE

    As = [s.shard(A) for s in sops]
    out = []
    for s, a in zip(sops, As):
        yU = s.local_div(a)
        ghosts = {}
        for side, back in OPPOSITE.items():
            peer = getattr(s.mesh, side)
            if peer is not None:
                g = sops[peer].div_message(As[peer], back)
                if g is not None:
                    ghosts[side] = g
        s.fold_div(yU, ghosts)
        out.append(yU)
    return sops[0]._join(out)


def _rank(rank, world, tmp, task, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = TASKS[task](**kw)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(task, world, tmp, **kw):
    """[rank 0's results, rank 1's, ...] of ``TASKS[task](**kw)``."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_rank, args=(world, tmp, task, kw), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def random_state(model, seed, dtype=torch.float64):
    """Random A and conductor-masked U from a seed, as torch tensors (the
    parent makes the same with numpy for the JAX package)."""
    from eddy_currents_3d_tpu_torch.assembly.stencil import State

    A, U = random_fields(model, seed)
    return State(torch.from_numpy(A).to(dtype), torch.from_numpy(U).to(dtype))


def random_fields(model, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(model.shape_zyx)
    A = rng.standard_normal((3,) + shape)
    U = rng.standard_normal(shape) * np.asarray(model.cond_mask)
    return A, U


def _model(shape, steps=3, moving=False):
    from eddy_currents_3d_tpu_torch.testing import cases

    case = cases.case_moving if moving else cases.case_static
    return cases.load_case(case(shape_xyz=shape, steps=steps))


class _Recorder:
    """Records, in order, the exchange's posts and waits and the local
    field functions of a sharded apply."""

    def __init__(self, shard_op, monkey,
                 names=("field_a_reference", "field_u_reference")):
        self.calls = []
        real_post = shard_op.dist.batch_isend_irecv
        rec = self

        class Req:
            def __init__(self, r):
                self.r = r

            def wait(self):
                rec.calls.append("wait")
                return self.r.wait()

        def post(ops):
            rec.calls.append("post")
            return [Req(r) for r in real_post(ops)]

        monkey(shard_op.dist, "batch_isend_irecv", post)
        for name in names:
            real = getattr(shard_op, name)
            monkey(shard_op, name, self._wrap(name.replace("_reference", ""),
                                              real))

    def _wrap(self, name, fn):
        def run(*a, **k):
            self.calls.append(name)
            return fn(*a, **k)
        return run


def _patched():
    """(set(obj, name, value), undo()) for the ranks' monkeypatches."""
    undo = []

    def put(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore():
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    return put, restore


def task_apply(shapes, seed):
    """The sharded operator's global results on each grid of ``shapes``,
    for the parent to compare: the f64 apply, apply_div and Jacobi
    diagonal, the f32 apply on the field kernels' plain versions, and, on
    the first grid, the order of one f64 apply's exchange and local
    functions."""
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.parallel import shard_op
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size())
    out = {}
    for shape in shapes:
        model = _model(shape)
        res = out[tuple(shape)] = {}
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            sysm = assemble_operator(model, dtype, "cpu")
            sop = shard_op.ShardedStencilOperator(sysm, mesh, dtype)
            x = random_state(model, seed, dtype)
            y = sop.unpad_state(sop.apply(sop.pad_state(x)))
            res[name] = (y.A.numpy(), y.U.numpy())
            res[f"{name}_kernels"] = sop.use_pallas
            if dtype == torch.float64:
                res["div"] = sop.gather(sop.apply_div(sop.shard(x.A))).numpy()
                d = sop.diagonal_padded()
                res["diag"] = (sop.gather(d.A).numpy(),
                               sop.gather(d.U).numpy())
                res["padded_zyx"] = sop.padded_zyx
        if "order" not in out:
            put, undo = _patched()
            rec = _Recorder(shard_op, put)
            try:
                sop64 = shard_op.ShardedStencilOperator(
                    assemble_operator(model, torch.float64, "cpu"), mesh,
                    torch.float64)
                sop64.apply(sop64.pad_state(random_state(model, seed)))
            finally:
                undo()
            out["order"] = rec.calls
    return out


def _no_gather(put):
    """Make every collective that moves whole fields raise."""
    def refuse(name):
        def fail(*a, **k):
            raise AssertionError(f"dist.{name} called inside a step")
        return fail
    for name in ("all_gather", "all_gather_into_tensor", "broadcast",
                 "gather", "scatter", "all_to_all", "reduce_scatter"):
        if hasattr(dist, name):
            put(dist, name, refuse(name))


def task_sim(vtk_dir):
    """Sharded Simulations, each run's global results: f64 with f64 dots
    (STATIC, 3 steps), jacobi (STATIC), f64 on UNEVEN (2 steps), f32
    (STATIC), the moving coil over 5 steps (MOVING) with its motion state,
    and two moving-coil steps with every field-moving collective made to
    raise (the step exchanges ghosts and all-reduces dots only); then the
    f64 STATIC run with its VTK written to ``vtk_dir`` (by rank 0), and
    with an ``on_output`` callback (the shapes it is shown)."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size())
    f64 = torch.float64
    out = {}
    runs = {
        "f64": (STATIC, 3, False, dict(dtype=f64, dot_dtype=f64)),
        "jacobi": (STATIC, 3, False, dict(dtype=f64, precond="jacobi")),
        "uneven": (UNEVEN, 2, False, dict(dtype=f64)),
        "f32": (STATIC, 3, False, dict(dtype=torch.float32)),
        "moving": (MOVING, 6, True, dict(dtype=f64, dot_dtype=f64)),
    }
    for name, (shape, steps, moving, kw) in runs.items():
        sim = Simulation(_model(shape, steps, moving), mesh=mesh, **kw)
        st, diag = sim.run(num_steps=5 if moving else None)
        out[name] = {"A": st.A.numpy(), "carry": st.carry.numpy(),
                     "iterations": diag["iterations"],
                     "unconverged": diag["unconverged_steps"],
                     "distance": np.asarray(st.motion.distance),
                     "movestop": np.asarray(st.motion.movestop),
                     "slab": tuple(sim.shard_op.padded_zyx),
                     "coded": sim.shard_op.use_coded}
    sim = Simulation(_model(MOVING, 6, True), f64, f64, mesh=mesh)
    state = sim.shard_state(sim.init_state())
    put, undo = _patched()
    _no_gather(put)
    its = []
    try:
        for t, _ in sim.steps[:2]:
            state, info = sim._step(state, t)
            its.append(int(info.iterations))
    finally:
        undo()
    out["no_gather_iterations"] = its
    sim = Simulation(_model(STATIC, 3), f64, f64, mesh=mesh)
    sim.run(output_dir=vtk_dir)
    shown = []
    sim.run(on_output=lambda n, st, info: shown.append(
        (n, tuple(st.A.shape), tuple(st.carry.shape))))
    out["on_output"] = shown
    return out


def task_mixed():
    """bfloat16 state, and bfloat16 coefficients at float32 state, on the
    mesh: one step of each (STATIC), global A."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size())
    model = _model(STATIC, 3)
    out = {}
    for name, kw in (("bf16", dict(dtype=torch.bfloat16)),
                     ("coeff_bf16", dict(dtype=torch.float32,
                                         coeff_dtype=torch.bfloat16))):
        sim = Simulation(model, mesh=mesh, **kw)
        st, diag = sim.run(num_steps=1)
        out[name] = {"A": st.A.float().numpy(), "dtype": str(st.A.dtype),
                     "coef": str(sim.shard_op.local.ka.dtype),
                     "unconverged": diag["unconverged_steps"]}
    return out


def task_four(seed, vtk_dir):
    """The 4-rank group: the operator on STATIC and UNEVEN, and the
    Simulations."""
    return {"apply": task_apply([STATIC, UNEVEN], seed),
            "sim": task_sim(vtk_dir)}


def task_two(seed):
    """The 2-rank group: the operator on STATIC, and the mixed-precision
    runs."""
    return {"apply": task_apply([STATIC], seed), "mixed": task_mixed()}


def task_team7():
    """Step 1 of team7 (TEAM7) at float32 on the mesh: its solve's global
    solution before the surface zeroing, iterations and relres (rank 0;
    None on the others)."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    sim = Simulation(_model(TEAM7, 2), torch.float32,
                     mesh=make_mesh(dist.get_world_size()))
    b, x0 = sim.step_system(sim.shard_state(sim.init_state()),
                            sim.steps[0][0])
    res = sim.solve(b, x0)
    x = sim.shard_op.unpad_state(res.x)
    if dist.get_rank() != 0:
        return None
    return {"A": x.A.numpy(), "U": x.U.numpy(),
            "iterations": int(res.iterations), "relres": float(res.relres)}


def _sim_out(st, diag, sim):
    """A run's global fields (bfloat16 widened to float32, exactly),
    diagnostics and layout, as numpy and plain values."""
    host = lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {"A": host(st.A), "carry": host(st.carry),
            "iterations": diag["iterations"],
            "unconverged": diag["unconverged_steps"],
            "coded": sim.shard_op.use_coded,
            "padded_zyx": tuple(sim.shard_op.padded_zyx)}


def task_coded():
    """The coded tier on 4 z slabs (CODED): the float32 Simulation's
    default run over 3 steps and a jacobi run over 2, and the order of one
    coded apply's exchange and local kernel."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel import shard_op
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size())
    out = {}
    for name, steps, kw in (("f32", 3, {}), ("jacobi", 2,
                                            {"precond": "jacobi"})):
        sim = Simulation(_model(CODED, steps), torch.float32, mesh=mesh,
                         **kw)
        out[name] = _sim_out(*sim.run(), sim)
    put, undo = _patched()
    rec = _Recorder(shard_op, put, ("coded_matvec",))
    try:
        sim.shard_op.apply(sim.shard_op.pad_state(
            random_state(sim.model, 3, torch.float32)))
    finally:
        undo()
    out["order"] = rec.calls
    return out


def task_yz4():
    """A (2, 2) mesh: float64 with float64 dots (STATIC, 3 steps), the
    float32 default (the field tier on a y decomposition), bfloat16 state
    and float32 coefficients at bfloat16 state (one step each), the order
    of one apply's exchange and local field functions, and two moving-coil
    steps with every field-moving collective made to raise."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.parallel import shard_op
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    f64 = torch.float64
    out = {}
    runs = {"f64": (3, None, dict(dtype=f64, dot_dtype=f64)),
            "f32": (3, None, dict(dtype=torch.float32)),
            "bf16": (3, 1, dict(dtype=torch.bfloat16)),
            "bf16_f32coef": (3, 1, dict(dtype=torch.bfloat16,
                                        coeff_dtype=torch.float32))}
    for name, (steps, n, kw) in runs.items():
        sim = Simulation(_model(STATIC, steps), mesh=mesh, **kw)
        out[name] = _sim_out(*sim.run(num_steps=n), sim)
        out[name]["coef"] = str(sim.shard_op.local.ka.dtype)
    model = _model(STATIC)
    sop = shard_op.ShardedStencilOperator(
        assemble_operator(model, f64, "cpu"), mesh, f64)
    put, undo = _patched()
    rec = _Recorder(shard_op, put)
    try:
        sop.apply(sop.pad_state(random_state(model, 3)))
    finally:
        undo()
    out["order"] = rec.calls
    sim = Simulation(_model(MOVING, 6, True), f64, f64, mesh=mesh)
    state = sim.shard_state(sim.init_state())
    put, undo = _patched()
    _no_gather(put)
    its = []
    try:
        for t, _ in sim.steps[:2]:
            state, info = sim._step(state, t)
            its.append(int(info.iterations))
    finally:
        undo()
    out["no_gather_iterations"] = its
    return out


def task_yz8():
    """Float64 Simulations on 8 ranks: STATIC on (4, 2) with float64 dots
    (3 steps), and UNEVEN_YZ on (2, 4) (2 steps)."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    f64 = torch.float64
    out = {}
    for name, shape, steps, dims, kw in (
            ("static", STATIC, 3, (4, 2), dict(dot_dtype=f64)),
            ("uneven", UNEVEN_YZ, 2, (2, 4), {})):
        sim = Simulation(_model(shape, steps), f64, mesh=make_mesh(*dims),
                         **kw)
        out[name] = _sim_out(*sim.run(), sim)
    return out


def vcycle_input(model, seed):
    """The random A-shaped fields a V-cycle check applies M^-1 to."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3,) + tuple(model.shape_zyx))


def _mg_vcycles(cases, seed):
    """The distributed V-cycle at float64 on each (shape, (n_z, n_y)) of
    ``cases``: its global result, whether it gathers, each level's block
    extents, the largest |value| of the rank's block output on padding
    cells, and the replicated levels' correction (the global one at the
    gather level, None where nothing gathers)."""
    from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh
    from eddy_currents_3d_tpu_torch.parallel.shard_mg import build_shard_mg
    from eddy_currents_3d_tpu_torch.parallel.shard_op import (
        ShardedStencilOperator)

    f64 = torch.float64
    out = {}
    for shape, dims in cases:
        model = _model(shape)
        sysm = assemble_operator(model, f64, "cpu")
        sop = ShardedStencilOperator(sysm, make_mesh(*dims), f64)
        mg = build_shard_mg(sysm.op.ka, sop, dtype=f64)
        seen = []
        if mg.rep is not None:
            real = mg.rep.correction
            object.__setattr__(mg.rep, "correction",
                               lambda li, r: seen.append(real(li, r))
                               or seen[-1])
        r = torch.from_numpy(vcycle_input(model, seed))
        y = mg.apply_scalar(sop.shard(r)[None])[0]
        cells = sop.shard(torch.ones(tuple(model.shape_zyx), dtype=f64))
        out[(tuple(shape), tuple(dims))] = {
            "y": sop.gather(y).numpy(), "gathers": mg.rep is not None,
            "blocks": [lvl.shape for lvl in mg.levels],
            "padding": (y * (1 - cells)).abs().max().item(),
            "replicated": seen[-1].numpy() if seen else None}
    return out


def task_mg_four(seed):
    """The 4-rank group of tests/test_torch_shard_mg.py: the distributed
    V-cycle on (2, 2) UNEVEN_YZ and (4, 1) 16^3; on (2, 2) the float64
    mg Simulation (STATIC, 3 steps, float64 dots), use_shard_map=False on
    the moving coil over 5 steps (MOVING), and step 1 of the float32 mg
    Simulation (STATIC): its global b and solution before the surface
    zeroing (rank 0; None on the others) and iterations."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    f64 = torch.float64
    mesh = make_mesh(2, 2)
    out = {"vcycle": _mg_vcycles([(UNEVEN_YZ, (2, 2)), ((16, 16, 16), (4, 1))],
                                 seed)}
    sim = Simulation(_model(STATIC, 3), f64, f64, mesh=mesh, precond="mg")
    out["mg_f64"] = _sim_out(*sim.run(), sim)
    out["mg_f64"]["mg"] = type(sim._mg).__name__
    sim = Simulation(_model(MOVING, 6, True), f64, f64, mesh=mesh,
                     use_shard_map=False)
    st, diag = sim.run(num_steps=5)
    out["gspmd_moving"] = dict(_sim_out(st, diag, sim),
                               distance=np.asarray(st.motion.distance),
                               movestop=np.asarray(st.motion.movestop))
    sim = Simulation(_model(STATIC, 3), torch.float32, mesh=mesh,
                     precond="mg")
    b, x0 = sim.step_system(sim.shard_state(sim.init_state()),
                            sim.steps[0][0])
    res = sim.solve(b, x0)
    b, x = sim.shard_op.unpad_state(b), sim.shard_op.unpad_state(res.x)
    out["mg_f32"] = {"iterations": int(res.iterations),
                     "coded": sim.shard_op.use_coded,
                     "step1": ((b.A.numpy(), b.U.numpy(), x.A.numpy(),
                                x.U.numpy()) if dist.get_rank() == 0
                               else None)}
    return out


def task_mg_two(seed):
    """The 2-rank group of tests/test_torch_shard_mg.py: the distributed
    V-cycle on (2, 1) 16^3 (distributed to the coarsest level) and STATIC
    (NZl = 7: it gathers at level 0), and the float64 mg Simulation on
    (2, 1) (STATIC, 3 steps, float64 dots)."""
    from eddy_currents_3d_tpu_torch import Simulation
    from eddy_currents_3d_tpu_torch.parallel.mesh import make_mesh

    f64 = torch.float64
    out = {"vcycle": _mg_vcycles([((16, 16, 16), (2, 1)), (STATIC, (2, 1))],
                                 seed)}
    sim = Simulation(_model(STATIC, 3), f64, f64, mesh=make_mesh(2),
                     precond="mg")
    out["mg_f64"] = _sim_out(*sim.run(), sim)
    return out


TASKS = {"four": task_four, "two": task_two, "team7": task_team7,
         "coded": task_coded, "yz4": task_yz4, "yz8": task_yz8,
         "mg_four": task_mg_four, "mg_two": task_mg_two}
