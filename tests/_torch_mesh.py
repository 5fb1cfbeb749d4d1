"""Ranks of the port's z-slab mesh on the CPU, for tests/test_torch_shard_op.py.

:func:`spawn` starts ``world`` processes with torch.multiprocessing's spawn
start method, each a gloo rank of one process group whose store is a file
under the caller's directory (so concurrent test workers never share a
port), runs one task of :data:`TASKS` on every rank, and returns every
rank's results.  The ranks import torch and the port, never jax: the JAX
package's runs stay in the parent test process, and the two sides meet as
numpy arrays.  A task groups several checks, so that a file of tests
spawns few groups.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

STATIC = (16, 16, 14)       # the JAX package's tests/test_shard_op.py grid
UNEVEN = (12, 12, 13)       # nz = 13 over 4 ranks: one padding plane
MOVING = (16, 16, 12)
TEAM7 = (102, 102, 24)      # chip_smoke.py's team7 grid


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

    def __init__(self, shard_op, monkey):
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
        for name in ("field_a_reference", "field_u_reference"):
            real = getattr(shard_op, name)
            monkey(shard_op, name, self._wrap(name[:7], real))

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
                     "slab": tuple(sim.shard_op.padded_zyx)}
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


TASKS = {"four": task_four, "two": task_two, "team7": task_team7}
