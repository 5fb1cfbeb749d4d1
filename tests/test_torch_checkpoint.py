"""The port's checkpoint / resume (``sim/checkpoint.py``, ``Simulation.run``
and ``run_scan`` with ``checkpoint_dir``, ``checkpoint_every``, ``resume``),
case for case with tests/test_checkpoint.py: a split run reproduces an
uninterrupted one bit for bit, motion state included.  Then the two
packages against each other: ``model_fingerprint`` gives JAX's hex digest
for the same model, a checkpoint written by either package loads in the
other with equal arrays, and a port run resumed from a JAX checkpoint
stays within the float64 parity tolerance of tests/test_torch_sim.py
(1e-9 of the scale) of the port's uninterrupted run."""

import os

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host

import jax.numpy as jnp

from eddy_currents_3d_tpu.sim import checkpoint as jckpt
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch.sim import checkpoint as ckpt
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases as tcases
from eddy_currents_3d_tpu_torch.testing.cases import (case_moving,
                                                      case_static, load_case)

F64 = torch.float64
F64_TOL = 1e-9


def _sim(model, dtype=F64, **kw):
    return Simulation(model, dtype, device=CPU, **kw)


def _equal(a, b):
    np.testing.assert_array_equal(host(a), host(b))


def test_split_run_matches_uninterrupted(tmp_path):
    model = load_case(case_static(shape_xyz=(14, 13, 11), steps=4))
    full_state, _ = _sim(model, dot_dtype=F64).run()
    cdir = str(tmp_path / "ck")
    _sim(model, dot_dtype=F64).run(num_steps=2, checkpoint_dir=cdir,
                                   checkpoint_every=1)
    assert os.path.exists(os.path.join(cdir, "ckpt_2.npz"))
    state, diag = _sim(model, dot_dtype=F64).run(checkpoint_dir=cdir,
                                                 resume=True)
    assert diag["start_step"] == 2 and diag["steps"] == 2
    _equal(state.A, full_state.A)
    _equal(state.carry, full_state.carry)


def test_moving_case_motion_state_restored(tmp_path):
    model = load_case(case_moving(shape_xyz=(16, 16, 10), steps=4))
    full_state, _ = _sim(model, dot_dtype=F64).run()
    cdir = str(tmp_path / "ck")
    _sim(model, dot_dtype=F64).run(num_steps=2, checkpoint_dir=cdir,
                                   checkpoint_every=2)
    state, _ = _sim(model, dot_dtype=F64).run(checkpoint_dir=cdir,
                                              resume=True)
    _equal(state.motion.distance, full_state.motion.distance)
    _equal(state.motion.comp, full_state.motion.comp)
    _equal(state.A, full_state.A)


def test_fingerprint_mismatch_rejected(tmp_path):
    m1 = load_case(case_static(shape_xyz=(14, 13, 11), steps=3))
    m2 = load_case(case_static(shape_xyz=(14, 13, 11), steps=3, tol=1e-4))
    cdir = str(tmp_path / "ck")
    _sim(m1).run(num_steps=1, checkpoint_dir=cdir, checkpoint_every=1)
    path = ckpt.latest_checkpoint(cdir)
    with pytest.raises(ValueError, match="different model"):
        ckpt.load_checkpoint(path, ckpt.model_fingerprint(m2), device=CPU)


def test_load_checkpoint_device(tmp_path):
    """load_checkpoint puts the fields where it is told (the CPU here), and
    by default on the card: where there is none, it refuses rather than
    fall back to the CPU."""
    model = load_case(case_static(shape_xyz=(14, 13, 11), steps=3))
    cdir = str(tmp_path / "ck")
    _sim(model).run(num_steps=1, checkpoint_dir=cdir, checkpoint_every=1)
    path = ckpt.latest_checkpoint(cdir)
    fp = ckpt.model_fingerprint(model)
    state, step, _ = ckpt.load_checkpoint(path, fp, device="cpu")
    assert step == 1
    assert all(t.device.type == "cpu"
               for t in (state.A, state.U, state.carry))
    if torch.cuda.is_available():
        state, _, _ = ckpt.load_checkpoint(path, fp)
        assert state.A.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_checkpoint(path, fp)


def test_latest_checkpoint_selection(tmp_path):
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    model = load_case(case_static(shape_xyz=(14, 13, 11), steps=3))
    _sim(model).run(checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_3.npz")


def test_scan_checkpoint_resume_bit_identical(tmp_path):
    """An interrupted run_scan resumed from its checkpoint reproduces the
    uninterrupted run_scan bit for bit, iteration counts included."""
    model = load_case(case_moving(shape_xyz=(16, 16, 10), steps=8))
    ckdir = str(tmp_path / "ck")
    ref_state, ref_diag = _sim(model, torch.float32).run_scan()
    _sim(model, torch.float32).run_scan(num_steps=5, checkpoint_dir=ckdir,
                                        checkpoint_every=3)
    state, diag = _sim(model, torch.float32).run_scan(
        checkpoint_dir=ckdir, checkpoint_every=3, resume=True)
    assert int(diag["start_step"]) == 5
    for f in ("A", "U", "carry"):
        _equal(getattr(state, f), getattr(ref_state, f))
    _equal(state.motion.distance, ref_state.motion.distance)
    assert int(ref_diag["iterations"].sum()) > 0
    _equal(diag["iterations"], ref_diag["iterations"][5:])


def test_scan_checkpoint_with_output_matches_run(tmp_path):
    """run_scan with both VTK output and checkpointing writes run's files."""
    model = load_case(case_static(shape_xyz=(14, 14, 10), steps=6,
                                  jump=2e-3))
    out1, out2 = str(tmp_path / "a"), str(tmp_path / "b")
    _sim(model, torch.float32).run(output_dir=out1)
    _sim(model, torch.float32).run_scan(
        output_dir=out2, checkpoint_dir=str(tmp_path / "ck2"),
        checkpoint_every=4)
    names = sorted(os.listdir(out1))
    assert names == sorted(os.listdir(out2)) and names
    for n in names:
        with open(os.path.join(out1, n), "rb") as f1, \
                open(os.path.join(out2, n), "rb") as f2:
            assert f1.read() == f2.read(), n
    assert os.path.exists(os.path.join(str(tmp_path / "ck2"), "ckpt_4.npz"))


def test_resume_without_checkpoint_keeps_initial_state(tmp_path):
    """resume=True on an empty checkpoint dir runs from initial_state."""
    model = load_case(case_static(shape_xyz=(14, 12, 10), steps=3))
    sim = _sim(model, torch.float32)
    warm = sim.init_state()._replace(A=sim.init_state().A + 0.5)
    st, _ = sim.run(num_steps=1, initial_state=warm,
                    checkpoint_dir=str(tmp_path / "empty"),
                    checkpoint_every=5, resume=True)
    ref, _ = _sim(model, torch.float32).run(num_steps=1, initial_state=warm)
    _equal(st.A, ref.A)


def test_scan_checkpoint_resume_past_horizon(tmp_path):
    """Resuming with a horizon at/below the stored step runs no step and
    writes no checkpoint."""
    model = load_case(case_static(shape_xyz=(14, 12, 10), steps=8))
    ckdir = str(tmp_path / "ck")
    _sim(model, torch.float32).run_scan(num_steps=6, checkpoint_dir=ckdir,
                                        checkpoint_every=3)
    before = sorted(os.listdir(ckdir))
    state, diag = _sim(model, torch.float32).run_scan(
        num_steps=4, checkpoint_dir=ckdir, checkpoint_every=3, resume=True)
    assert int(diag["start_step"]) == 6
    assert len(diag["iterations"]) == 0
    assert sorted(os.listdir(ckdir)) == before


def test_resume_without_dir_raises():
    model = load_case(case_static(shape_xyz=(12, 12, 10), steps=2))
    sim = _sim(model)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        sim.run(resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        sim.run_scan(resume=True)


def test_no_duplicate_final_checkpoint_write(tmp_path, monkeypatch):
    model = load_case(case_static(shape_xyz=(12, 12, 10), steps=4))
    calls = []
    real = ckpt.save_checkpoint

    def spy(path, *a, **kw):
        calls.append(os.path.basename(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    _sim(model).run(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    assert calls.count("ckpt_4.npz") == 1
    calls.clear()
    _sim(model).run_scan(checkpoint_dir=str(tmp_path / "ck2"),
                         checkpoint_every=2)
    assert calls.count("ckpt_4.npz") == 1


def test_empty_horizon_relres_dtype_matches_live_run(tmp_path):
    model = load_case(case_static(shape_xyz=(12, 12, 10), steps=3))
    cdir = str(tmp_path / "ck")
    _, live = _sim(model, dot_dtype=F64).run_scan(checkpoint_dir=cdir,
                                                  checkpoint_every=1)
    _, empty = _sim(model, dot_dtype=F64).run_scan(checkpoint_dir=cdir,
                                                   resume=True)
    assert len(empty["iterations"]) == 0
    assert empty["relres"].dtype == live["relres"].dtype
    assert empty["iterations"].dtype == live["iterations"].dtype


# ---------------------------------------------------------------------------
# the two packages
# ---------------------------------------------------------------------------

CASES = {
    "static": lambda c: c.case_static(shape_xyz=(14, 13, 11), steps=4),
    "moving": lambda c: c.case_moving(shape_xyz=(16, 16, 10), steps=4),
}


def _models(name):
    return (jcases.load_case(CASES[name](jcases)),
            tcases.load_case(CASES[name](tcases)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fingerprint_equals_jax(name):
    mj, mt = _models(name)
    assert ckpt.model_fingerprint(mt) == jckpt.model_fingerprint(mj)


_FIELDS = ("A", "U", "carry")


def _assert_same_checkpoint(st_a, st_b):
    for f in _FIELDS:
        _equal(getattr(st_a, f), getattr(st_b, f))
    _equal(st_a.prev.A, st_b.prev.A)
    _equal(st_a.prev.U, st_b.prev.U)
    for f in ("distance", "movestop", "comp"):
        _equal(getattr(st_a.motion, f), getattr(st_b.motion, f))


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_moves_from_jax_to_port(name, tmp_path):
    """A JAX checkpoint loads in the port with equal arrays, and the port
    resumed from it stays within the f64 parity tolerance of its own
    uninterrupted run."""
    mj, mt = _models(name)
    jdir = str(tmp_path / "jax")
    JSimulation(mj, dtype=jnp.float64, dot_dtype=jnp.float64).run(
        num_steps=2, checkpoint_dir=jdir, checkpoint_every=2)
    path = ckpt.latest_checkpoint(jdir)
    fp = ckpt.model_fingerprint(mt)
    st_t, step, npoint = ckpt.load_checkpoint(path, fp, F64, CPU)
    st_j, step_j, npoint_j = jckpt.load_checkpoint(
        path, jckpt.model_fingerprint(mj), jnp.float64)
    assert (step, npoint) == (step_j, npoint_j) and step == 2
    _assert_same_checkpoint(st_t, st_j)

    full, full_diag = _sim(mt, dot_dtype=F64).run()
    resumed, diag = _sim(mt, dot_dtype=F64).run(checkpoint_dir=jdir,
                                                resume=True)
    assert diag["start_step"] == 2
    assert diag["iterations"] == full_diag["iterations"][2:]
    for f in _FIELDS:
        ref = host(getattr(full, f))
        np.testing.assert_allclose(host(getattr(resumed, f)), ref, rtol=0,
                                   atol=F64_TOL * max(np.abs(ref).max(),
                                                      1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_moves_from_port_to_jax(name, tmp_path):
    """A port checkpoint loads in the JAX package with equal arrays and
    resumes there."""
    mj, mt = _models(name)
    tdir = str(tmp_path / "port")
    _sim(mt, dot_dtype=F64).run(num_steps=2, checkpoint_dir=tdir,
                                checkpoint_every=2)
    path = ckpt.latest_checkpoint(tdir)
    st_j, step, _ = jckpt.load_checkpoint(path, jckpt.model_fingerprint(mj),
                                          jnp.float64)
    st_t, _, _ = ckpt.load_checkpoint(path, ckpt.model_fingerprint(mt), F64,
                                      CPU)
    assert step == 2
    _assert_same_checkpoint(st_t, st_j)
    _, diag = JSimulation(mj, dtype=jnp.float64, dot_dtype=jnp.float64).run(
        checkpoint_dir=tdir, resume=True)
    assert diag["start_step"] == 2 and len(diag["iterations"]) == 2
