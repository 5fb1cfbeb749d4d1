"""The yardstick's arithmetic against hand computations."""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ecbench import cellspec, work  # noqa: E402
from ecbench.reference.system import assemble  # noqa: E402


def test_operator_bytes_by_hand():
    # team7: 102 x 102 x 24 cells, the plate 5 planes of 96 x 96
    n, nc = 102 * 102 * 24, 5 * 96 * 96
    assert (n, nc) == (249_696, 46_080)
    assert work.vector_bytes((24, 102, 102), nc, 4) == 4 * 795_168
    assert work.operator_bytes((24, 102, 102), nc, 4, 10) == 6_361_344 + 40
    # 256 x 256 x 64, the plate 5 planes of 250 x 250: past the L2
    n, nc = 256 * 256 * 64, 5 * 250 * 250
    assert work.vector_bytes((64, 256, 256), nc, 4) == 4 * (3 * n + nc)
    nbytes = work.operator_bytes((64, 256, 256), nc, 4, 10)
    assert nbytes == 103_163_296 + 40 > work.L2_BYTES
    t, by = work.bound(nbytes, 0.0)
    assert by == "bytes" and abs(t - nbytes / 3.35e12) < 1e-15
    assert work.bound(1.0, 67e12) == (1.0, "operations")


def test_conductor_count_and_coefficients_of_the_team7_case():
    cfg = json.loads((ROOT / "ecbench/configs/team7.json").read_text())
    trf = json.loads((ROOT / "ecbench/workloads/static.json").read_text())
    sys_ = assemble(cellspec.load_case(ROOT / "ecbench", cfg)
                    .reference_case(cfg, trf))
    assert sys_.cond.size == 46_080
    assert sys_.M.shape == (795_168, 795_168)
    n = work.distinct_coefficients(sys_.M.data)
    # the 7-point stencil's face and interior values, the inertia, the
    # grad-U and div couplings: a table of a few dozen values
    assert 5 <= n <= 200
    assert work.distinct_coefficients(np.array([0.0, 2.0, 2.0, -1.0])) == 2
