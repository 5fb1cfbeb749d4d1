"""A configuration's case, found by name: team7's ``.vxc`` text and its
reference system held to what they were before the case became a module
of its own (sha256 recorded then), and a second case, a small
linear-induction-machine-like one, added with new files alone."""

import hashlib
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ecbench import cellspec  # noqa: E402
from ecbench.reference.motion import Motion  # noqa: E402
from ecbench.reference.system import assemble  # noqa: E402
from ecbench.vxc import PHASES  # noqa: E402

HERE = ROOT / "ecbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
GRID = [float(f"{2.0 * np.pi * j / PHASES:.12f}") for j in range(PHASES)]

# sha256 of team7's texts at the full grid, all PHASES phases in order,
# each followed by a zero byte
TEXT = {
    "static": "77b2fdf13c6e9d9a0f21cc971a3e7bacfe04d51352b18e480433d72348f4dff0",
    "moving": "c7fb14c7692cbbcdf8eac8e1d47be57e7b9e99e6a874bf7af5e61ac0d2537c11",
}
# sha256 of the reference's case and system at 20 x 20 x 12 (_digest)
REFERENCE = {
    "static": {
        "M": "03a7e887b98554d7c509686bf0d8e429b1dc605176a09cdc7f2d47c75647ebc6",
        "rows": "5164c50984aea557f8ac96842560f615001e902d5442ca4060089d65061b523a",
        "cells": "6fb5cabb668db8fbddc7f910a6eeee1a9999b9b9199d59a508c83bbe0a1ca406",
        "values": "8d3f748b08fab84c2c8806b076d6f5913ed3761c5ea58a02a5102fe7ff03407f",
        "moved": "fb82634ce60ad16915addbee9a0e7dda5649ca740336db33e7f9e76bd9ae326f",
        "times": "ead112781a9981bc8c65df791a375ea260bc53af2f33412e58ac265ba5805c08",
    },
    "moving": {
        "M": "42a4a258bf8425cc0ef2b640bb10b6c124a20c7653dc63ba880cfc0dc546e3db",
        "rows": "2c8573383c967549a28d1cc548807af846ff530c06a5322c1d960afc7257f767",
        "cells": "f4ca281239870d2ebfa1fcef175bc19ff92663c09fefa64d90907fc4402eed08",
        "values": "16bc831ddeda8cef935479a77e5cb3e65b34e59c47d13269e87627b5fb22ebc2",
        "moved": "801ad55a514e54f368664829adf36e32404ab78eda58e18680a143d564e017d8",
        "times": "365358ddc29d358bd94f1e508615754cb3ee6731d801f6f2139e04ddc52557ab",
    },
}


def _team7(traffic, grid=None):
    cfg = json.loads((HERE / "configs/team7.json").read_text())
    if grid:
        cfg["grid_xyz"] = grid
    trf = json.loads((HERE / f"workloads/{traffic}.json").read_text())
    return cfg, trf


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(a.dtype.str.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def test_team7_takes_the_default_case():
    cfg, _ = _team7("static")
    assert "case" not in cfg
    case = cellspec.load_case(HERE, cfg)
    assert Path(case.__file__).name == f"{cellspec.DEFAULT_CASE}.py"
    assert cellspec.Cell(BENCH, "team7.moving").case.__file__ == case.__file__
    with pytest.raises(ValueError):
        cellspec.load_case(HERE, {"case": "../run"})


@pytest.mark.parametrize("traffic", ["static", "moving"])
def test_team7_text_is_pinned(traffic):
    """The program reads the same bytes as before, at every phase."""
    cfg, trf = _team7(traffic)
    case = cellspec.load_case(HERE, cfg)
    h = hashlib.sha256()
    for ph in GRID:
        h.update(case.vxc_text(cfg, trf, ph).encode("latin-1"))
        h.update(b"\0")
    assert h.hexdigest() == TEXT[traffic]


@pytest.mark.parametrize("traffic", ["static", "moving"])
def test_team7_reference_is_pinned(traffic):
    """The reference builds the same system, source cells, source values
    and moving coil as before."""
    cfg, trf = _team7(traffic, [20, 20, 12])
    case = cellspec.load_case(HERE, cfg).reference_case(cfg, trf)
    s = assemble(case)
    mo = Motion(case)
    times = [case.times[i] for i in (0, 1, 7, 50, len(case.times) - 1)]
    got = {
        "M": _digest(s.M.data, s.M.indices, s.M.indptr),
        "rows": _digest(s.cond, s.inert, s.bnd_a, s.bnd_u),
        "cells": _digest(*[np.array([src.axis, src.sign])
                           for src in case.sources],
                         *[src.cells for src in case.sources]),
        "values": _digest(np.array([[src.value(t, ph) for src in case.sources]
                                    for t in times
                                    for ph in (0.0, GRID[5], GRID[27])])),
        "moved": _digest(*[c for st in (0, 1, 10, 60, len(case.times) - 1)
                           for c in mo.at(st)]),
        "times": _digest(np.array(case.times), case.C, case.geo, case.bnd,
                         np.array([case.dt, case.tol])),
    }
    assert got == REFERENCE[traffic]


# A case module, as a later configuration brings one: six windings of
# three phases 120 degrees apart across a conducting bar, all sliding along
# x with a reciprocating Vsx = v impl2(sind(360 f t)), in cosd as the
# upstream LIM.vxc writes its phases.
LIM_LIKE = '''"""A small linear-induction-machine-like case."""

import math

import numpy as np

from ecbench.reference.case import BND_DEFAULT, MU0, PI, Case, Source, schedule
from ecbench.vxc import make_vxc_text

# winding: name, sign of its current, phase in degrees
WINDINGS = (("ap", 1, 0), ("bp", 1, 120), ("cp", 1, -120),
            ("am", -1, 0), ("bm", -1, 120), ("cm", -1, -120))


def layout(config):
    nx, ny, nz = config["grid_xyz"]
    geo = np.zeros((nz, ny, nx), np.int64)
    bz, by, bx = config["bar"]["z"], config["bar"]["margin_y"], config["bar"]["margin_x"]
    geo[bz[0]:bz[1], by:ny - by, bx:nx - bx] = 1
    w = config["windings"]
    for k, x in enumerate(w["x"]):
        geo[w["z"][0]:w["z"][1], w["margin_y"]:ny - w["margin_y"], x] = 2 + k
    return geo


def vxc_text(config, traffic, phase):
    dt, steps = traffic["dt_s"], traffic["steps"]
    amp = f"{traffic['current_A']}/(1*dx*2*dz)"
    m = traffic["motion"]
    names = [f"plast D=1 C='mu0*{config['sigma_S_per_m']!r}'"]
    names += [f"{n} D=1 SRCy=I{n} Vsx=Vx" for n, _, _ in WINDINGS]
    names += [f"param tran stop={steps * dt} step={dt} jump={traffic['jump_s']}",
              f"p2 solver tol={config['tol']} itmax={config['itmax']} dir=out"]
    for k, (n, sign, deg) in enumerate(WINDINGS, start=1):
        names.append(f"f{k} func I{n}={'-' if sign < 0 else ''}a*cosd(360*f*t+o+ph*r)"
                     f" a='{amp}' f={traffic['freq_hz']} t=t o={deg} ph={phase:.12f}"
                     " r='180/pi'")
    names.append(f"f7 func Vx=a*impl2(sind(360*f*t)) a={m['speed_m_per_s']!r}"
                 f" f={m['freq_hz']} t=t")
    return make_vxc_text(config["grid_xyz"], config["cell_m"], names, layout(config))


def reference_case(config, traffic):
    nx, ny, nz = (int(v) for v in config["grid_xyz"])
    h = float(config["cell_m"])
    dt = float(traffic["dt_s"])
    geo = layout(config)
    flat = geo.reshape(-1)
    C = np.zeros(len(WINDINGS) + 2)
    C[1] = MU0 * config["sigma_S_per_m"]
    amp = traffic["current_A"] / (1 * h * 2 * h)
    omega = 2 * PI * traffic["freq_hz"]
    sources = [Source(axis=1, cells=np.flatnonzero(flat == 2 + k).astype(np.int64),
                      sign=sign, amp=amp, omega=omega, offset=deg * PI / 180)
               for k, (_, sign, deg) in enumerate(WINDINGS)]
    v, w = traffic["motion"]["speed_m_per_s"], 2 * PI * traffic["motion"]["freq_hz"]

    def velocity(t):
        return (v * (1.0 if math.sin(w * t) >= 0 else -1.0), None, None)
    stop = float(repr(traffic["steps"] * dt))
    return Case(shape_xyz=(nx, ny, nz), delta=np.full(3, h), geo=geo, C=C,
                dt=dt, times=schedule(stop, dt), tol=float(config["tol"]),
                bnd=np.full((3, 2), BND_DEFAULT), sources=sources,
                velocity=velocity)
'''

# the same case with one winding's phase off by 120 degrees in the
# reference alone
LIM_LIKE_OFF = LIM_LIKE + '''

_reference_case = reference_case


def reference_case(config, traffic):
    case = _reference_case(config, traffic)
    case.sources[0].offset += 2 * PI / 3
    return case
'''

LIM_CONFIG = {"grid_xyz": [24, 10, 10], "cell_m": 0.005,
              "bar": {"z": [2, 5], "margin_y": 3, "margin_x": 2},
              "windings": {"x": [5, 7, 9, 11, 13, 15], "z": [6, 8],
                           "margin_y": 3},
              "sigma_S_per_m": 37260000.0, "tol": 0.005, "itmax": 10000,
              "dtype": "float32"}
# 1.2 cells a step, forwards for 4 steps and back for 2
LIM_TRAFFIC = {"name": "recip", "steps": 6, "dt_s": 0.001, "jump_s": 0.0,
               "current_A": 800, "freq_hz": 50,
               "motion": {"speed_m_per_s": 6.0, "freq_hz": 150}}


def _lim_here(tmp: Path) -> dict:
    """A copy of the benchmark's data with the LIM-like case added as new
    files only; returns the BENCHMARK.json that names its cells."""
    for d in ("cases", "metrics", "kernels", "workloads", "limits",
              "configs"):
        shutil.copytree(HERE / d, tmp / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp): p.read_bytes()
              for p in tmp.rglob("*") if p.is_file()}
    (tmp / "cases/lim_like.py").write_text(LIM_LIKE)
    (tmp / "cases/lim_like_off.py").write_text(LIM_LIKE_OFF)
    (tmp / "workloads/recip.json").write_text(json.dumps(LIM_TRAFFIC))
    bench = json.loads(json.dumps(BENCH))
    for name in ("limlike", "limlike_off"):
        cfg = dict(LIM_CONFIG, name=name, case=name.replace("limlike",
                                                            "lim_like"))
        (tmp / f"configs/{name}.json").write_text(json.dumps(cfg))
        (tmp / f"limits/{name}.recip.json").write_text(
            (HERE / "limits/team7.static.json").read_text())
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"ecbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": f"{name}.recip", "config": name,
                                   "traffic": "recip", "chips": 1,
                                   "why": "test"})
    after = {p.relative_to(tmp): p.read_bytes()
             for p in tmp.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    return bench


def _run(cell):
    from ecbench.run import run_cell
    return run_cell(cell, 2**31 + 77, 0.0, False, device="cpu",
                    t0=time.perf_counter(), warm_s=0.0)


def test_the_lim_like_windings_reciprocate(tmp_path):
    """The reference's windings move forwards, then back."""
    bench = _lim_here(tmp_path)
    cell = cellspec.Cell(bench, "limlike.recip", tmp_path)
    case = cell.case.reference_case(cell.config, cell.traffic)
    mo = Motion(case)
    x = [int(mo.at(s)[0].min() % 24) for s in range(len(case.times))]
    assert x == [6, 7, 9, 10, 9, 7], x
    assert [round(s.offset * 180 / np.pi) for s in case.sources] == [
        0, 120, -120, 0, 120, -120]


def test_a_second_case_with_files_only_is_correct(tmp_path):
    bench = _lim_here(tmp_path)
    cell = cellspec.Cell(bench, "limlike.recip", tmp_path)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["checks"]["relres"]["value"] < 5e-3 + 1e-6


def test_a_winding_off_by_120_degrees_is_not_correct(tmp_path):
    bench = _lim_here(tmp_path)
    cell = cellspec.Cell(bench, "limlike_off.recip", tmp_path)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["relres"]["value"] > out["checks"]["relres"]["limit"]
