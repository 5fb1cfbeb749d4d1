"""The port's CLI on a mesh (``python -m eddy_currents_3d_tpu_torch in.vxc
--mesh Z[,Y]``) under torchrun on gloo ranks (``--device cpu``), and
checkpoints on a mesh.

Each mesh run is ``python -m torch.distributed.run --standalone
--nproc-per-node Z*Y -m eddy_currents_3d_tpu_torch ...`` in a directory of
its own, at float64, on the static case over 3 steps:

* ``--mesh 2`` and ``--mesh 2,2`` against the one-device CLI: every printed
  line the same but the backend line (which names the world size) and the
  wall times; the field files within 1e-9 of each field's scale, the source
  files byte for byte.  ``--mesh 1`` outside torchrun starts a group of one
  rank itself and runs in this process.
* ``--mesh 2 --precond mg`` against the JAX CLI's ``--mesh 2 --precond
  mg``: the same lines, the field files within one float32 rounding plus
  1e-9 of scale, the source files' values within 4e-16 relative.
* A mesh run checkpointed at step 1 and resumed writes a last checkpoint
  equal to the uninterrupted mesh run's bit for bit; the mesh's step-1
  checkpoint resumes on one device within 1e-9 of scale of the mesh run.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import CPU

from eddy_currents_3d_tpu.__main__ import main as jmain
from eddy_currents_3d_tpu.io.vtk import read_vtk_vectors

from eddy_currents_3d_tpu_torch.__main__ import main
from eddy_currents_3d_tpu_torch.sim.checkpoint import (load_checkpoint,
                                                       model_fingerprint)
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases as tcases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = ["--dtype", "f64", "--device", "cpu"]
TOL = 1e-9


def _torchrun(cwd, n, args):
    """(exit code, stdout, stderr) of the CLI on ``n`` gloo ranks."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "eddy_currents_3d_tpu_torch",
         "../in.vxc"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    return p.returncode, p.stdout, p.stderr


def _main(cwd, args):
    """(exit code, stdout) of the CLI's main() in this process."""
    old = os.getcwd()
    out = io.StringIO()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = main(["../in.vxc"] + args)
    finally:
        os.chdir(old)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mesh")
    (root / "in.vxc").write_text(tcases.case_static(
        shape_xyz=(16, 14, 12), steps=3, jump=0.001))
    out = {}
    for name in ("one", "m1", "m2", "m22", "k", "mg2", "jax_mg2"):
        (root / name).mkdir()
    out["one"] = _main(root / "one", ["-o", "out"] + F64)
    out["m1"] = _main(root / "m1", ["-o", "out", "--mesh", "1"] + F64)
    ck = ["--checkpoint-dir", "ck", "--checkpoint-every", "1"]
    out["m2"] = _torchrun(root / "m2", 2, ["-o", "out", "--mesh", "2"]
                          + ck + F64)
    out["m22"] = _torchrun(root / "m22", 4, ["-o", "out", "--mesh", "2,2"]
                           + F64)
    out["mg2"] = _torchrun(root / "mg2", 2, ["-o", "out", "--mesh", "2",
                                             "--precond", "mg"] + F64)
    out["k1"] = _torchrun(root / "k", 2, ["-o", "-", "-q", "--mesh", "2",
                                          "--steps", "1"] + ck + F64)
    shutil.copytree(root / "k" / "ck", root / "k1_ck")
    out["k"] = _torchrun(root / "k", 2, ["-o", "-", "-q", "--mesh", "2",
                                         "--resume"] + ck + F64)
    out["root"] = root
    return out


def _prints(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith(("backend", "Tcalc"))]


@pytest.mark.parametrize("name,world", [("m1", 1), ("m2", 2), ("m22", 4)],
                         ids=["mesh-1", "mesh-2", "mesh-2x2"])
def test_cli_mesh_matches_one_device(runs, name, world):
    rc, text = runs[name][:2]
    assert rc == 0, runs[name][2:]
    rc1, text1 = runs["one"]
    assert rc1 == 0
    assert _prints(text) == _prints(text1)
    backend = [ln for ln in text.splitlines() if ln.startswith("backend")]
    assert len(backend) == 1 and f"(cpu) x{world}," in backend[0]
    assert "per block of" in backend[0]
    one, mesh = runs["root"] / "one" / "out", runs["root"] / name / "out"
    names = sorted(os.listdir(one))
    assert names and sorted(os.listdir(mesh)) == names
    for n in names:
        if n.startswith("src_"):
            assert (mesh / n).read_bytes() == (one / n).read_bytes(), n
            continue
        fo, fm = read_vtk_vectors(str(one / n)), read_vtk_vectors(str(mesh / n))
        for key in fo:
            if key != "dims":
                scale = max(np.abs(fo[key]).max(), 1e-30)
                np.testing.assert_allclose(fm[key], fo[key], rtol=0,
                                           atol=TOL * scale, err_msg=n)


def test_mesh_checkpoint_resumes_bit_for_bit(runs):
    for key in ("k1", "k"):
        assert runs[key][0] == 0, runs[key][2]
    root = runs["root"]
    assert sorted(os.listdir(root / "k1_ck")) == ["ckpt_1.npz"]
    a = np.load(root / "m2" / "ck" / "ckpt_3.npz")
    b = np.load(root / "k" / "ck" / "ckpt_3.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    # the step-1 checkpoint of the resumed run is the uninterrupted one's
    c = np.load(root / "k1_ck" / "ckpt_1.npz")
    d = np.load(root / "m2" / "ck" / "ckpt_1.npz")
    for f in c.files:
        np.testing.assert_array_equal(c[f], d[f], err_msg=f)


def test_mesh_checkpoint_resumes_on_one_device(runs):
    root = runs["root"]
    model = tcases.load_case(tcases.case_static(shape_xyz=(16, 14, 12),
                                                steps=3, jump=0.001))
    fp = model_fingerprint(model)
    st1, step, _ = load_checkpoint(str(root / "k1_ck" / "ckpt_1.npz"), fp,
                                   device=CPU)
    assert step == 1 and st1.A.shape == (3,) + tuple(model.shape_zyx)
    sim = Simulation(model, torch.float64, device=CPU)
    st, diag = sim.run(checkpoint_dir=str(root / "k1_ck"), resume=True)
    assert diag["start_step"] == 1 and not diag["unconverged_steps"]
    mesh, _, _ = load_checkpoint(str(root / "m2" / "ck" / "ckpt_3.npz"), fp,
                                 device=CPU)
    scale = mesh.A.abs().max().item()
    np.testing.assert_allclose(st.A.numpy(), mesh.A.numpy(), rtol=0,
                               atol=TOL * scale)
    np.testing.assert_allclose(st.carry.numpy(), mesh.carry.numpy(), rtol=0,
                               atol=TOL * mesh.carry.abs().max().item())


def test_cli_mesh_mg_matches_jax_cli(runs):
    """``--mesh 2 --precond mg`` at float64 on 2 gloo ranks against the JAX
    CLI's ``--mesh 2 --precond mg`` (its GSPMD tier on 2 of its fake
    devices): every printed line the same but the backend line and the
    wall times; the field files within 1e-9 of each field's scale beyond
    one float32 rounding (two float64 answers that close can round to
    neighbouring float32 values); the source files hold the same cells and
    values within 4e-16 relative (tests/test_torch_cli.py's moving-case
    rule: here step 2's values differ by an ulp on one device too)."""
    rc, text = runs["mg2"][:2]
    assert rc == 0, runs["mg2"][2:]
    root = runs["root"]
    old = os.getcwd()
    out = io.StringIO()
    os.chdir(root / "jax_mg2")
    try:
        with contextlib.redirect_stdout(out):
            assert jmain(["../in.vxc", "-o", "out", "--dtype", "f64",
                          "--mesh", "2", "--precond", "mg"]) == 0
    finally:
        os.chdir(old)
    assert _prints(text) == _prints(out.getvalue())
    backend = [ln for ln in text.splitlines() if ln.startswith("backend")]
    assert "field plain per block of 2x1" in backend[0]
    assert "precond=mg" in backend[0]
    ref, mesh = root / "jax_mg2" / "out", root / "mg2" / "out"
    names = sorted(os.listdir(ref))
    assert names and sorted(os.listdir(mesh)) == names
    for n in names:
        fr = read_vtk_vectors(str(ref / n))
        fm = read_vtk_vectors(str(mesh / n))
        if n.startswith("src_"):
            # the same cells; JAX evaluates the source expressions inside
            # its jitted step, where XLA's folding moves them by an ulp
            # against the host float64 evaluation (ROADMAP Queue 3), on
            # one device as on the mesh
            bm, br = (mesh / n).read_bytes(), (ref / n).read_bytes()
            head = br.index(b"CELL_DATA")
            assert bm[:head] == br[:head], n
            np.testing.assert_allclose(fm["Vector_field_SRC"],
                                       fr["Vector_field_SRC"], rtol=4e-16,
                                       atol=0, err_msg=n)
            continue
        for key in fr:
            if key == "dims":
                continue
            a, b = fr[key].astype(np.float64), fm[key].astype(np.float64)
            ulp = np.spacing(np.maximum(np.abs(fr[key]), np.abs(fm[key]))
                             .astype(np.float32)).astype(np.float64)
            scale = max(np.abs(a).max(), 1e-30)
            assert (np.abs(b - a) - ulp).max() <= TOL * scale, (n, key)
