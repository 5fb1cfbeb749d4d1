"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; without a card the harness fails
and prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "ecbench"
JAX = {"jax", "jaxlib", "flax", "eddy_currents_3d_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"):
            out |= {a.value.split(".")[0] for a in node.args
                    if isinstance(a, ast.Constant)}
    return out


def test_no_module_of_the_benchmark_imports_jax():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not _imports(p) & JAX, p
    # the kernel lists name the program's counters, never the JAX package
    for p in (HERE / "kernels").glob("*.json"):
        top = json.loads(p.read_text())["counter"].split(".")[0]
        assert top == "eddy_currents_3d_tpu_torch", p


PLAIN = {"__future__", "numpy", "scipy", "math", "dataclasses"}


def _harness_imports(path: Path) -> set[str]:
    """Every module of the benchmark ``path`` imports, relative imports
    resolved against its package."""
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = pkg[:len(pkg) - node.level + 1]
            out.add(".".join(base + ((node.module,) if node.module else ())))
        elif node.module.split(".")[0] == "ecbench":
            out.add(node.module)
    return out


@pytest.mark.parametrize("part", ["reference", "cases"])
def test_the_reference_imports_nothing_of_the_program(part):
    """The reference and every case module, which gives the reference its
    data, import numpy, scipy and the standard library, and of the
    benchmark only the reference and the .vxc writer."""
    files = sorted((HERE / part).rglob("*.py"))
    assert files
    for p in files + [HERE / "vxc.py"]:
        assert _imports(p) <= PLAIN | {"ecbench"}, p
        assert all(m == "ecbench.vxc" or m.startswith("ecbench.reference")
                   for m in _harness_imports(p)), p


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "ecbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_without_a_card_no_result():
    proc = _run(ROOT, "--workload", "team7.static", "--seed", "3000000001",
                "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, "--workload", "team7.static", "--seed", "1",
                "--seconds", "1", "--trace", "1")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[0] = %r; import ecbench.run, ecbench.check,"
            " ecbench.reference.step, ecbench.control; "
            "import eddy_currents_3d_tpu_torch; from ecbench.run import "
            "forbidden_modules; print(forbidden_modules())" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
