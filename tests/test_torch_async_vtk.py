"""The port's overlapped VTK writer (``sim/simulate.py`` ``_AsyncVtkWriter``)
against a synchronous write of the same states.

``run(output_dir)`` and ``run_scan(output_dir)`` write through the writer
(one device-to-host copy per output, encoding on writer threads); the
reference is the same Simulation run with ``on_output`` writing each
state as it comes, through the numpy writers (``EC3D_NATIVE_IO=0``).  The
files must be equal byte for byte, on a static and a moving case, at
float32 and at bfloat16 state, with the writer's byte bound at one buffer
too; a writer's error surfaces from ``run``.  The card test (marker
``cuda``) holds the same on the card.  This file imports no jax, so the
card test runs where jax is absent."""

import os

import pytest
import torch

from eddy_currents_3d_tpu_torch.io import vtk
from eddy_currents_3d_tpu_torch.sim import simulate
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases

torch.set_num_threads(2)

CPU = torch.device("cpu")
CASES = {
    "static": lambda: cases.case_static(shape_xyz=(14, 12, 10), steps=3),
    "moving": lambda: cases.case_moving(shape_xyz=(16, 16, 10), steps=3),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _files_equal(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    assert any(n.startswith("field_") for n in names)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), f"{n} differs"


def _sync_reference(sim, out, monkeypatch):
    """The run written synchronously, state by state, by the numpy
    writers; returns its final state."""
    with monkeypatch.context() as m:
        m.setenv("EC3D_NATIVE_IO", "0")
        st, _ = sim.run(on_output=lambda n, s, i: vtk.write_outputs(
            sim, s, i, n, out))
    return st


def _overlapped_equals_sync(dev, name, dtype, entry, tmp_path, monkeypatch):
    sim = Simulation(cases.load_case(CASES[name]()), DTYPES[dtype],
                     device=dev)
    ref = str(tmp_path / "sync")
    st_ref = _sync_reference(sim, ref, monkeypatch)
    out = str(tmp_path / "overlapped")
    st, diag = getattr(sim, entry)(output_dir=out)
    _files_equal(ref, out)
    assert torch.equal(st.A, st_ref.A) and torch.equal(st.carry,
                                                       st_ref.carry)
    assert diag["io_s"] >= 0.0


@pytest.mark.parametrize("entry", ["run", "run_scan"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_overlapped_files_equal_sync(name, dtype, entry, tmp_path,
                                     monkeypatch):
    _overlapped_equals_sync(CPU, name, dtype, entry, tmp_path, monkeypatch)


def test_byte_bound_of_one_buffer(tmp_path, monkeypatch):
    """Below one output's bytes the writer holds one pinned buffer, and
    submit waits for it to be written: the same files."""
    monkeypatch.setattr(simulate, "_PIN_BYTES", 1)
    made = []
    init = simulate._AsyncVtkWriter.__init__

    def spy(self, *a):
        init(self, *a)
        made.append(self)

    monkeypatch.setattr(simulate._AsyncVtkWriter, "__init__", spy)
    _overlapped_equals_sync(CPU, "moving", "f32", "run", tmp_path,
                            monkeypatch)
    assert [(w.depth, w._made) for w in made] == [(1, 1)]


@pytest.mark.parametrize("encoder", ["native", "numpy"])
def test_writer_error_surfaces_from_run(encoder, tmp_path, monkeypatch):
    """A write that fails on a writer thread (field_1.vtk is a directory)
    is raised by run; that output's src file, written after its field
    file, is never written."""
    if encoder == "numpy":
        monkeypatch.setenv("EC3D_NATIVE_IO", "0")
    sim = Simulation(cases.load_case(CASES["static"]()), torch.float32,
                     device=CPU)
    out = tmp_path / "out"
    (out / "field_1.vtk").mkdir(parents=True)
    with pytest.raises(OSError):
        sim.run(output_dir=str(out))
    assert not (out / "src_1.vtk").exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run", "run_scan"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_overlapped_files_equal_sync_on_card(cuda, name, dtype, entry,
                                             tmp_path, monkeypatch):
    _overlapped_equals_sync(cuda, name, dtype, entry, tmp_path, monkeypatch)
