"""The port's CLI (``python -m eddy_currents_3d_tpu_torch``) on the CPU
(``--device cpu``), following tests/test_cli.py, and against the JAX
package's CLI.

* Behaviour: end to end, the SOLVER DIR default with ``-q``, a missing
  input (rc 2), ``--scan``'s bytes equal the loop's; the refusals (rc 2):
  ``--mesh`` with a world size other than its blocks' (here 1, outside
  torchrun; tests/test_torch_cli_mesh.py runs it under torchrun), the
  checkpoint-flag misuses.  ``--dtype f64`` runs on the
  card (a card test) as on the CPU.
* Parity: ``AssembledSystem.matrix_stats()`` equals JAX's exactly on the
  static, moving, LIM and no-conductor cases; the f64 CLI's field files,
  read back with ``read_vtk_vectors``, equal the JAX CLI's f64 run within
  1e-12 relative to each field's scale (both solve in float64 and differ
  in summation order only; the files hold float32, whose rounding the two
  runs reach from within that gap); the src files are byte-identical on
  the static case and, on the moving case, to the source values, which
  JAX's jitted step moves by an ulp (ROADMAP Queue 3: within 4e-16
  relative); every print but the backend line and the wall times is the
  same text.
* ``Simulation(coeff_dtype=torch.float32)`` runs the field tier at float32
  coefficients, as JAX does (no cast; any ``coeff_dtype`` turns off the
  coded tier), within 4 tol of JAX's ``coeff_dtype=jnp.float32`` run.  At
  bfloat16 state (``Simulation(coeff_dtype=torch.float32)``, ``--dtype
  bf16 --coeff-dtype f32``) the gap of A to the port's float64 run is at
  most twice JAX's own bfloat16 gap.  JAX's run of that very pair does not
  run on the CPU: its flat-roll operator promotes the carry to float32
  (``lax.while_loop`` refuses it) and its Pallas kernels in interpret mode
  store a float32 sum into a bfloat16 output ("Invalid dtype for swap",
  ``ops/pallas_stencil.py:145``); so JAX's gap is that of its
  bfloat16-coefficient run, whose operator is the coarser of the two.
"""

import os

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host

import jax.numpy as jnp

from eddy_currents_3d_tpu.__main__ import main as jmain
from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.io.vtk import read_vtk_vectors
from eddy_currents_3d_tpu.sim.simulate import Simulation as JSimulation
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch.__main__ import main
from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.sim.simulate import Simulation
from eddy_currents_3d_tpu_torch.testing import cases as tcases

F64_RTOL = 1e-12


@pytest.fixture()
def case_file(tmp_path):
    path = tmp_path / "in.vxc"
    path.write_text(tcases.case_static(steps=3, jump=0.001))
    return str(path)


def _files(out):
    return sorted(os.listdir(out))


def test_cli_end_to_end(case_file, tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = main([case_file, "-o", out, "--dtype", "f64", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Tcalc" in text and "unconverged" in text
    assert "route=flat-roll" in text
    # output files at the jump cadence, like the reference (EC3D.f90:436-444)
    assert os.path.exists(os.path.join(out, "field_1.vtk"))
    assert os.path.exists(os.path.join(out, "src_1.vtk"))


def test_cli_defaults_to_solver_dir_and_quiet(case_file, tmp_path, capsys,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = main([case_file, "--steps", "2", "-q", "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out == ""
    # the case's SOLVER DIR line names the output directory
    assert _files(tmp_path / "OUT") == ["field_1.vtk", "src_1.vtk"]


def test_cli_missing_input(tmp_path, capsys):
    rc = main([str(tmp_path / "nope.vxc"), "--device", "cpu"])
    assert rc == 2
    assert "not found" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cli_scan_outputs_match_host_loop(case_file, tmp_path, dtype):
    out1, out2 = str(tmp_path / "loop"), str(tmp_path / "scan")
    args = [case_file, "--dtype", dtype, "-q", "--device", "cpu"]
    assert main(args + ["-o", out1]) == 0
    assert main(args + ["-o", out2, "--scan"]) == 0
    files = _files(out1)
    assert files == _files(out2) and files
    for f in files:
        with open(os.path.join(out1, f), "rb") as a, \
                open(os.path.join(out2, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("argv, message", [
    (["--mesh", "4"], "but the world size is 1"),
    (["--mesh", "4,2", "--device", "cpu"], "takes 8 ranks"),
    (["--resume"], "--resume requires --checkpoint-dir"),
    (["--checkpoint-dir", "ck"], "without --checkpoint-every"),
], ids=["mesh", "mesh-cpu", "resume", "checkpoint-dir"])
def test_cli_refusals(case_file, tmp_path, capsys, argv, message):
    out = tmp_path / "out"
    assert main([case_file, "-o", str(out)] + argv) == 2
    assert message in capsys.readouterr().err
    assert not out.exists()


def _nocond(c):
    """No conducting cell: one coil voxel in air (tests/test_pallas.py)."""
    geo = np.zeros((6, 8, 9), np.int64)
    geo[4, 4, 4] = 1
    names = ["coil D=1 SRCx=F1", "param tran stop=2m step=1m",
             "p solver tol=5m itmax=9 dir=o", "f1 func F1=a a=1 t=t"]
    return c.make_vxc_text((9, 8, 6), 0.01, names, geo.ravel())


STATS_CASES = {
    "static": lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=2),
    "moving": lambda c: c.case_moving(shape_xyz=(18, 18, 12), steps=2),
    "lim": lambda c: c.case_lim(shape_xyz=(24, 11, 10), steps=2),
    "nocond": _nocond,
}


@pytest.mark.parametrize("name", sorted(STATS_CASES))
def test_matrix_stats_match_jax(name):
    mj = jcases.load_case(STATS_CASES[name](jcases))
    mt = tcases.load_case(STATS_CASES[name](tcases))
    sj = j_assemble(mj, jnp.float64).matrix_stats()
    st = t_assemble(mt, torch.float64, CPU).matrix_stats()
    assert st == sj
    assert all(type(st[k]) is type(sj[k]) for k in sj)
    assert st["nnz"] > 0


def _prints(text):
    """The CLI's print lines, but the backend line and the wall times."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("backend", "Tcalc"))]


@pytest.mark.parametrize("name", ["static", "moving"])
def test_cli_f64_outputs_match_jax(name, tmp_path, capsys, monkeypatch):
    (tmp_path / "in.vxc").write_text(STATS_CASES[name](tcases))
    outj, outt = tmp_path / "jax" / "out", tmp_path / "port" / "out"
    texts = []
    for cli, cwd, extra in ((jmain, outj.parent, []),
                            (main, outt.parent, ["--device", "cpu"])):
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert cli(["../in.vxc", "-o", "out", "--dtype", "f64"] + extra) == 0
        texts.append(capsys.readouterr().out)
    text_j, text_t = texts
    assert _prints(text_t) == _prints(text_j)
    names = _files(outj)
    assert names and _files(outt) == names
    for n in names:
        if n.startswith("src_"):
            bt, bj = (outt / n).read_bytes(), (outj / n).read_bytes()
            if name == "static":
                assert bt == bj, n
                continue
            # moving: the same cells; JAX evaluates the source expressions
            # inside its jitted step, where XLA's folding moves them by an
            # ulp against the host float64 evaluation (ROADMAP Queue 3)
            head = bj.index(b"CELL_DATA")
            assert bt[:head] == bj[:head], n
            np.testing.assert_allclose(
                read_vtk_vectors(str(outt / n))["Vector_field_SRC"],
                read_vtk_vectors(str(outj / n))["Vector_field_SRC"],
                rtol=4e-16, atol=0, err_msg=n)
            continue
        fj = read_vtk_vectors(str(outj / n))
        ft = read_vtk_vectors(str(outt / n))
        assert sorted(ft) == sorted(fj)
        for key in fj:
            if key == "dims":
                assert ft[key] == fj[key]
                continue
            scale = max(np.abs(fj[key]).max(), 1e-30)
            np.testing.assert_allclose(ft[key], fj[key], rtol=0,
                                       atol=F64_RTOL * scale,
                                       err_msg=f"{n} {key}")


def test_coeff_dtype_f32_matches_jax():
    mj = jcases.load_case(jcases.case_static(shape_xyz=(16, 14, 12), steps=2))
    mt = tcases.load_case(tcases.case_static(shape_xyz=(16, 14, 12), steps=2))
    jsim = JSimulation(mj, dtype=jnp.float32, coeff_dtype=jnp.float32)
    assert jsim.coded_op is None
    sj, dj = jsim.run()
    tsim = Simulation(mt, torch.float32, device=CPU,
                      coeff_dtype=torch.float32)
    assert tsim.coded_op is None and tsim.field_op is not None
    assert tsim.system.op.ka.dtype == torch.float32
    st, dt = tsim.run()
    assert not dj["unconverged_steps"] and not dt["unconverged_steps"]
    assert all(i > 0 for i in dt["iterations"])
    scale = np.abs(host(sj.A)).max()
    np.testing.assert_allclose(host(st.A), host(sj.A), rtol=0,
                               atol=4 * mt.solver.tolerance * scale)
    # no cast: the field tier of use_coded=False, bit for bit
    sf, df = Simulation(mt, torch.float32, device=CPU, use_coded=False).run()
    assert dt["iterations"] == df["iterations"]
    assert torch.equal(st.A, sf.A) and torch.equal(st.carry, sf.carry)
    # float32 coefficients at bfloat16 state run too, on the field tier
    sb = Simulation(mt, torch.bfloat16, device=CPU, coeff_dtype=torch.float32)
    assert sb.field_op.dtype == torch.float32 and sb.dtype == torch.bfloat16


def _step1_gap(A, A64, tol):
    """max |dA| / (tol * max |A_f64|)."""
    A, A64 = host(A).astype(np.float64), host(A64).astype(np.float64)
    return np.abs(A - A64).max() / (tol * np.abs(A64).max())


BF16_CASE = lambda c: c.case_static(shape_xyz=(16, 14, 12), steps=2)


def test_bf16_coeff_f32_matches_jax():
    """Simulation(dtype=bfloat16, coeff_dtype=float32): the field tier at
    float32 coefficients and bfloat16 state; step 1 within twice JAX's own
    bfloat16 step-1 gap to the port's float64 step 1."""
    mj = jcases.load_case(BF16_CASE(jcases))
    mt = tcases.load_case(BF16_CASE(tcases))
    tol = mt.solver.tolerance
    j1, _ = JSimulation(mj, dtype=jnp.bfloat16).run(num_steps=1)
    t64, _ = Simulation(mt, torch.float64, device=CPU).run(num_steps=1)
    tsim = Simulation(mt, torch.bfloat16, device=CPU,
                      coeff_dtype=torch.float32)
    assert tsim.coded_op is None
    assert tsim.field_op.dtype == torch.float32
    t1, d1 = tsim.run(num_steps=1)
    assert t1.A.dtype == t1.U.dtype == t1.carry.dtype == torch.bfloat16
    assert not d1["unconverged_steps"] and d1["iterations"][0] > 0
    gap_t, gap_j = _step1_gap(t1.A, t64.A, tol), _step1_gap(j1.A, t64.A, tol)
    assert gap_t <= 2.0 * gap_j, (gap_t, gap_j)


def test_cli_bf16_coeff_f32_matches_jax(tmp_path, capsys, monkeypatch):
    """``--dtype bf16 --coeff-dtype f32``: the first output's A within
    twice the JAX CLI's ``--dtype bf16`` gap to the port's float64 CLI
    run."""
    (tmp_path / "in.vxc").write_text(tcases.case_static(
        shape_xyz=(16, 14, 12), steps=2, jump=0.001))
    runs = {"jax": (jmain, ["--dtype", "bf16"]),
            "port": (main, ["--dtype", "bf16", "--coeff-dtype", "f32",
                            "--device", "cpu"]),
            "f64": (main, ["--dtype", "f64", "--device", "cpu"])}
    A = {}
    for name, (cli, extra) in runs.items():
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert cli(["../in.vxc", "-o", "out", "-q"] + extra) == 0
        A[name] = read_vtk_vectors(str(tmp_path / name / "out" /
                                       "field_1.vtk"))["Field_A"]
    capsys.readouterr()
    tol = 5e-3
    gap_t, gap_j = (_step1_gap(A[k], A["f64"], tol) for k in ("port", "jax"))
    assert 0 < gap_t <= 2.0 * gap_j, (gap_t, gap_j)


def test_use_pallas_false_matches_jax():
    """use_pallas=False: the flat-roll tier at float32, as JAX's; with
    use_coded=True it raises with JAX's wording."""
    mj = jcases.load_case(BF16_CASE(jcases))
    mt = tcases.load_case(BF16_CASE(tcases))
    jsim = JSimulation(mj, dtype=jnp.float32, use_pallas=False)
    assert jsim.pallas_op is None and jsim.coded_op is None
    sj, dj = jsim.run()
    tsim = Simulation(mt, torch.float32, device=CPU, use_pallas=False)
    assert tsim.coded_op is None and tsim.field_op is None
    assert tsim.op is tsim.system.op
    st, dt = tsim.run()
    assert not dj["unconverged_steps"] and not dt["unconverged_steps"]
    assert st.A.dtype == torch.float32
    scale = np.abs(host(sj.A)).max()
    np.testing.assert_allclose(host(st.A), host(sj.A), rtol=0,
                               atol=4 * mt.solver.tolerance * scale)
    with pytest.raises(ValueError, match="incompatible with use_pallas=False"):
        Simulation(mt, torch.float32, device=CPU, use_pallas=False,
                   use_coded=True)
