"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic; each has a file of
its own (``configs/<config>.json``, ``workloads/<traffic>.json``), each
configuration's case a module (``cases/<case>.py``, named by the
configuration's ``"case"``), each per-layer or end-to-end metric a reader
(``metrics/<name>.py``, with an ``install`` where it times the window
itself), each operator route a kernel list
(``kernels/*.json``) and each cell its limits (``limits/<cell>.json``).  A
later cell, configuration, metric or route is a new file; nothing here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["Cell", "load_cell", "load_case", "load_reader", "load_install",
           "kernel_lists", "NAME", "UNIT", "DEFAULT_CASE"]

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DEFAULT_CASE = "coil_over_plate"    # a configuration without "case"


class Cell:
    """One entry of ``workloads`` with its configuration, traffic, case,
    metrics and limits."""

    def __init__(self, bench: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(cells: {', '.join(sorted(cells))})")
        self.entry = w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        self.config = _json(here / "configs" / f"{w['config']}.json")
        self.traffic = _json(here / "workloads" / f"{w['traffic']}.json")
        self.case = load_case(here, self.config)
        self.limits = _json(here / "limits" / f"{name}.json")["limits"]
        applies = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]
        self.here = here


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    return Cell(_json(root / "BENCHMARK.json"), name, here)


def _module(here: Path, kind: str, name: str):
    """The module ``<kind>/<name>.py`` under ``here``, loaded from its
    file."""
    if not NAME.match(name):
        raise ValueError(f"{kind}: {name!r} is not a name")
    spec = importlib.util.spec_from_file_location(
        f"ecbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        here / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_case(here: Path, config: dict):
    """The case module ``cases/<case>.py`` that ``config`` names under
    ``"case"``, ``DEFAULT_CASE`` without it: its ``vxc_text(config,
    traffic, phase)`` gives the ``.vxc`` text the program reads, its
    ``reference_case(config, traffic)`` the ``reference.case.Case`` the
    float64 reference builds its system from."""
    return _module(here, "cases", config.get("case", DEFAULT_CASE))


def load_reader(here: Path, metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _module(here, "metrics", metric).read


def load_install(here: Path, metric: str):
    """The ``install(sim)`` function of ``metrics/<metric>.py``, None where
    it has none.  The harness calls it just before the window; what it
    returns reaches the reader as ``ctx["installed"][metric]``."""
    return getattr(_module(here, "metrics", metric), "install", None)


def kernel_lists(here: Path) -> list[dict]:
    """Every ``kernels/*.json``: the operator's kernels on one route, each
    with the wrapper that counts its launches (``counter``, a dotted path
    into the program), the substrings that name its device kernels in a
    profiler trace (``names``) and whether one launch is one operator apply
    (``apply``)."""
    return [dict(_json(p), file=p.name)
            for p in sorted((here / "kernels").glob("*.json"))]
