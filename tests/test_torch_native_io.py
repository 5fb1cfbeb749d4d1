"""The port's native VTK encoder (``io/native.py``, ``csrc/ecio.cpp``)
against the numpy writers: byte-identical files, following
tests/test_native_io.py case for case, with the JAX package's numpy writers
as a third side; ``write_outputs`` on the native path unless
``EC3D_NATIVE_IO=0``; and a failed build raises instead of falling back."""

import os

import numpy as np
import pytest
import torch

from _torch_parity import CPU

from eddy_currents_3d_tpu.io import vtk as jvtk

from eddy_currents_3d_tpu_torch.io import native
from eddy_currents_3d_tpu_torch.io import vtk as tvtk
from eddy_currents_3d_tpu_torch.ops import _build
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases as tcases


def _field_all(tmp_path, delta, A, carry, cond):
    """field files from the native encoder and both packages' numpy
    writers; asserts the three are the same bytes."""
    native.write_field_native(str(tmp_path / "cc.vtk"), delta, A, carry,
                              cond, tvtk.EDDY_SCALE)
    tvtk.write_field(str(tmp_path / "np.vtk"), delta, A, carry, cond)
    jvtk.write_field(str(tmp_path / "jax.vtk"), delta, A, carry, cond)
    cc = (tmp_path / "cc.vtk").read_bytes()
    assert cc == (tmp_path / "np.vtk").read_bytes()
    assert cc == (tmp_path / "jax.vtk").read_bytes()


def test_field_bytes_identical(tmp_path, rng):
    nz, ny, nx = 6, 13, 17
    A = rng.standard_normal((3, nz, ny, nx))
    carry = rng.standard_normal((3, nz, ny, nx))
    cond = np.zeros((nz, ny, nx), bool)
    cond[2:4, 3:7, 4:9] = True
    _field_all(tmp_path, (0.0123, 0.045, 0.0067), A, carry, cond)


def test_field_no_conductors(tmp_path, rng):
    A = rng.standard_normal((3, 4, 5, 6))
    _field_all(tmp_path, (1, 1, 1), A, A * 2, None)


def test_field_large_dims_header(tmp_path, rng):
    # multi-digit dims exercise the Fortran-style header spacing
    A = rng.standard_normal((3, 3, 24, 120))
    _field_all(tmp_path, (1e-3, 2e-3, 3e-3), A, A, None)


def test_src_bytes_identical(tmp_path):
    shape_xyz = (10, 8, 6)
    cells = [np.array([3 + 10 * 2 + 80, 4 + 10 * 2 + 80]),
             np.array([5 + 40 + 160])]
    vals = [2.5, -1.5]
    dirs = ["X", "Z"]
    delta = (0.1, 0.2, 0.3)
    native.write_src_native(str(tmp_path / "cc.vtk"), delta, shape_xyz, cells,
                            vals, dirs)
    tvtk.write_src(str(tmp_path / "np.vtk"), delta, shape_xyz, cells, vals,
                   dirs)
    jvtk.write_src(str(tmp_path / "jax.vtk"), delta, shape_xyz, cells, vals,
                   dirs)
    cc = (tmp_path / "cc.vtk").read_bytes()
    assert cc == (tmp_path / "np.vtk").read_bytes()
    assert cc == (tmp_path / "jax.vtk").read_bytes()


def test_sim_output_path_uses_native(tmp_path, monkeypatch):
    """run(output_dir) on the native path (a spy sees every file) equals a
    run with EC3D_NATIVE_IO=0 byte for byte."""
    model = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 10),
                                                steps=3, jump=0.001))
    seen = []
    field, src = native.write_field_native, native.write_src_native
    monkeypatch.setattr(native, "write_field_native",
                        lambda path, *a: (seen.append(path), field(path, *a)))
    monkeypatch.setattr(native, "write_src_native",
                        lambda path, *a: (seen.append(path), src(path, *a)))
    out_native = tmp_path / "nat"
    Simulation(model, torch.float64, device=CPU).run(
        output_dir=str(out_native))
    names = sorted(os.listdir(out_native))
    assert names and sorted(os.path.basename(p) for p in seen) == names
    seen.clear()
    monkeypatch.setenv("EC3D_NATIVE_IO", "0")
    out_np = tmp_path / "np"
    Simulation(model, torch.float64, device=CPU).run(output_dir=str(out_np))
    assert not seen                       # EC3D_NATIVE_IO=0: numpy only
    assert sorted(os.listdir(out_np)) == names
    for name in names:
        assert (out_native / name).read_bytes() == \
            (out_np / name).read_bytes(), name


def test_failed_build_raises(tmp_path, monkeypatch):
    """No g++: the encoder raises RuntimeError, from the binding and from a
    run with outputs, and writes nothing through numpy instead."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.get_lib()
    model = tcases.load_case(tcases.case_static(shape_xyz=(12, 12, 10),
                                                steps=2))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        Simulation(model, torch.float32, device=CPU).run(output_dir=str(out))
    assert not out.exists() or not os.listdir(out)
    # the numpy writers need no build
    monkeypatch.setenv("EC3D_NATIVE_IO", "0")
    Simulation(model, torch.float32, device=CPU).run(output_dir=str(out))
    assert sorted(os.listdir(out)) == ["field_1.vtk", "src_1.vtk"]


def test_failed_write_raises(tmp_path):
    """A file the encoder cannot open raises OSError, never returns."""
    A = np.zeros((3, 2, 2, 2))
    with pytest.raises(OSError, match="could not open"):
        native.write_field_native(str(tmp_path / "no" / "f.vtk"), (1, 1, 1),
                                  A, A, None, tvtk.EDDY_SCALE)
    with pytest.raises(OSError, match="could not open"):
        native.write_src_native(str(tmp_path / "no" / "s.vtk"), (1, 1, 1),
                                (2, 2, 2), [np.array([0])], [1.0], ["X"])


def test_encoder_source_is_the_jax_packages():
    """csrc/ecio.cpp is a copy of native/ecio.cpp: past the header comment
    (the leading // lines) the two sources are the same text, so the two
    encoders write the same bytes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def body(*parts):
        with open(os.path.join(root, *parts)) as f:
            lines = f.read().splitlines()
        i = next(k for k, ln in enumerate(lines) if not ln.startswith("//"))
        return lines[i:]

    port = body("eddy_currents_3d_tpu_torch", "csrc", "ecio.cpp")
    assert len(port) > 200
    assert port == body("native", "ecio.cpp")


def test_ilu0_engine_source_is_the_jax_packages():
    """csrc/ilu0_host.cpp is a copy of native/ecsparse.cpp: with every
    ``//`` comment and blank line taken out, the two sources are the same
    code, so the two ILU(0) factorizations are the same program."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def code(*parts):
        with open(os.path.join(root, *parts)) as f:
            lines = (ln.split("//")[0].rstrip() for ln in f)
            return [ln for ln in lines if ln]

    port = code("eddy_currents_3d_tpu_torch", "csrc", "ilu0_host.cpp")
    assert len(port) > 40
    assert any("ec3d_ilu0" in ln for ln in port)
    assert port == code("native", "ecsparse.cpp")
