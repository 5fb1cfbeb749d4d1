"""The whole-plane route's launch plan and the SpMM's route choice, on the
CPU, and the whole-plane apply_dots against the JAX package's.

* The whole-plane kernel's plan (``ops/coded_cuda.py`` ``whole_plan``)
  covers every cell of the grid exactly once, walked as the kernel walks
  it (CTA b takes items b, b + ctas, ...; item (t, j): segment t of
  consecutive columns, run j; each thread one column over the run's
  planes),
  for team7's shape, odd nx and ny, nz = 1 and 2 and the card tests'
  grids; the conducting runs come first and cover the conductor's planes,
  and no run marked not conducting holds a cell whose code is not 0.
* ``spmm_route`` takes the vec route only at k = 1 with 16-byte aligned
  operands and C a multiple of the 16-byte vector, and the tiles route at
  k >= 32 only with 16-byte rows of x and of a block, R <= 8, R*C <= 256,
  aligned operands and a CTA's shared memory within the SM's (its
  constants read from csrc/bsr_spmm.cu).
* The whole-plane ``apply_dots`` through the wrapper on CPU tensors (its
  plain version) matches JAX's coded operator in Pallas interpret mode on
  grids with odd nx and ny, within 3e-6·scale, and its dots the float64
  sums within 2e-5 relative (tests/test_torch_coded.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import CPU, host, rand_fields

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator as j_assemble
from eddy_currents_3d_tpu.ops import pallas_coded as jpc
from eddy_currents_3d_tpu.testing import cases as jcases

from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator as t_assemble
from eddy_currents_3d_tpu_torch.assembly.stencil import State as TState
from eddy_currents_3d_tpu_torch.ops import coded as tc
from eddy_currents_3d_tpu_torch.ops import coded_cuda
from eddy_currents_3d_tpu_torch.ops import bsr_cuda
from eddy_currents_3d_tpu_torch.ops.bsr_cuda import (bsr_spmm, spmm_route,
                                                     tiles_smem)
from eddy_currents_3d_tpu_torch.ops.coded_cuda import (AIR_CHUNK, COND_CHUNK,
                                                       WHOLE_CTAS_PER_SM,
                                                       WHOLE_TY, whole_plan)
from eddy_currents_3d_tpu_torch.testing import cases as tcases

from test_torch_coded import _jax_coded
from test_torch_kernels import SPLIT_CASES

ATOL = 3e-6
DOT_RTOL = 2e-5


def _cond_z(model):
    zz = np.nonzero(np.asarray(model.cond_mask))[0]
    return int(zz.min()), int(zz.max()) + 1


def _plan_shapes():
    """(shape, cond_z): team7, odd nx and ny, nz = 1 and 2, and the card
    tests' grids."""
    out = [((24, 102, 102), (2, 7)), ((12, 17, 33), (3, 9)),
           ((9, 31, 65), (0, 9)), ((1, 20, 40), (0, 1)),
           ((2, 15, 37), (0, 2)), ((2, 15, 37), (1, 2)),
           ((64, 256, 256), (2, 7))]
    for name in sorted(SPLIT_CASES):
        model = tcases.load_case(SPLIT_CASES[name]())
        out.append((model.shape_zyx, _cond_z(model)))
    return out


def _cover_counts(shape_zyx, plan):
    """How many times the kernel's CTAs reach each cell of the grid: CTA b
    takes items b, b + ctas, ...; item j segments + t is run j of segment
    t; thread k of the CTA walks column f = 32 WHOLE_TY t + k, at
    (f % nx, f // nx), when f < nx ny."""
    nz, ny, nx = shape_zyx
    nt = 32 * WHOLE_TY
    count = np.zeros((nz, ny * nx), np.int64)
    for b in range(plan.ctas):
        for item in range(b, plan.items, plan.ctas):
            j, t = divmod(item, plan.segments)
            f = t * nt + np.arange(nt)
            f = f[f < nx * ny]
            assert ((f % nx) + nx * (f // nx) == f).all()
            z0, z1, _ = plan.runs[j]
            count[z0:z1, f] += 1
    return count.reshape(shape_zyx)


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("shape_zyx, cond_z", _plan_shapes(),
                         ids=lambda v: str(v).replace(" ", ""))
def test_whole_plan_covers_every_cell_once(shape_zyx, cond_z, sms):
    nz, ny, nx = shape_zyx
    zb0, zb1 = cond_z
    plan = whole_plan(shape_zyx, cond_z, sms)
    assert plan.segments == -(-(nx * ny) // (32 * WHOLE_TY))
    assert plan.items == plan.segments * len(plan.runs)
    assert 1 <= plan.ctas <= min(plan.items, WHOLE_CTAS_PER_SM * sms)
    assert (_cover_counts(shape_zyx, plan) == 1).all()
    flags = [c for _, _, c in plan.runs]
    assert flags == sorted(flags, reverse=True)     # conducting runs first
    for z0, z1, c in plan.runs:
        assert 0 < z1 - z0 <= (COND_CHUNK if c else AIR_CHUNK)
        if c:
            assert zb0 <= z0 and z1 <= zb1
        else:
            assert z1 <= zb0 or z0 >= zb1
    cond_planes = [z for z0, z1, c in plan.runs if c for z in range(z0, z1)]
    assert cond_planes == list(range(zb0, zb1))


def test_whole_plan_at_team7():
    """team7: 41 segments of 256 columns, the plate's 5 planes in short
    runs listed first, 369 items, one CTA each on an H100's 132 SMs."""
    plan = whole_plan((24, 102, 102), (2, 7))
    assert plan.segments == 41 and plan.items == 369 and plan.ctas == 369
    assert plan.runs[:3] == ((2, 3, 1), (3, 5, 1), (5, 7, 1))


def test_whole_plan_refuses_a_slab_off_the_grid():
    with pytest.raises(ValueError, match="conductor planes"):
        whole_plan((8, 10, 10), (6, 9))
    with pytest.raises(ValueError, match="conductor planes"):
        whole_plan((8, 10, 10), (3, 3))


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_runs_off_the_conductor_hold_no_code(name):
    """What the kernel skips on a run marked not conducting (the decode, U,
    cf, conv, wU) is exactly what a cell with code 0 never reads."""
    model = tcases.load_case(SPLIT_CASES[name]())
    iof = name == "inertia_on_faces"
    op = tc.from_assembled_coded(
        t_assemble(model, torch.float32, CPU, inertia_on_faces=iof), model,
        CPU, inertia_on_faces=iof)
    code = host(op.code)
    for z0, z1, c in whole_plan(op.shape_zyx, op.cond_z).runs:
        if not c:
            assert not code[z0:z1].any()


@pytest.mark.parametrize("block_shape, k, itemsize, aligned, route", [
    ((8, 8), 1, 4, True, "vec"),      # team7's exported operator
    ((8, 8), 1, 4, False, "warp"),    # an x, blocks or y off 16 bytes
    ((4, 8), 1, 4, True, "vec"),
    ((8, 16), 1, 4, True, "vec"),     # one block per warp load
    ((8, 16), 1, 8, True, "warp"),    # f64: 64 vectors a block
    ((8, 8), 1, 8, True, "vec"),
    ((4, 8), 1, 8, False, "warp"),
    ((3, 12), 1, 4, True, "lanes"),   # C % 4 == 0 but 9 vectors a block
    ((8, 6), 1, 4, True, "lanes"),    # C not a multiple of 4
    ((8, 8), 4, 4, True, "warp"),
    ((8, 8), 128, 4, True, "tiles"),  # team7 at k = 128, f32
    ((8, 8), 128, 8, True, "tiles"),  # and f64
    ((4, 8), 128, 8, True, "tiles"),
    ((8, 8), 32, 4, True, "tiles"),   # the narrowest k it takes
    ((3, 12), 100, 4, True, "tiles"),  # 400-byte rows of x
    ((8, 8), 34, 8, True, "tiles"),   # f64: 272-byte rows
    ((8, 8), 33, 4, True, "lanes"),   # ragged rows of x
    ((8, 8), 31, 4, True, "warp"),
    ((8, 8), 128, 4, False, "lanes"),  # an x view off 16 bytes
    ((8, 6), 128, 4, True, "lanes"),  # 24-byte rows of a block
    ((16, 16), 128, 4, True, "lanes"),  # R > 8 rows a lane holds
    ((16, 32), 128, 4, True, "lanes"),  # R*C > 256
    ((16, 32), 1, 4, True, "lanes"),  # 128 vectors a block, R*C > 256
])
def test_spmm_route_choice(block_shape, k, itemsize, aligned, route):
    assert spmm_route(block_shape, k, itemsize, aligned) == route
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    assert bsr_spmm.route(block_shape, k, dtype, aligned) == route


@pytest.mark.parametrize("block_shape, itemsize, width, route", [
    ((8, 8), 4, 17, "tiles"),         # team7's exported operator
    ((8, 8), 8, 17, "tiles"),
    ((8, 32), 4, 47, "tiles"),        # 188 KB of blocks, two 16 KB x blocks
    ((8, 32), 4, 48, "lanes"),        # past the SM's shared memory
    ((8, 32), 8, 20, "tiles"),        # 160 KB of blocks, two 32 KB x blocks
    ((8, 32), 8, 21, "lanes"),
])
def test_spmm_tiles_needs_a_ctas_shared_memory(block_shape, itemsize, width,
                                               route):
    """The tiles route stages a CTA's blocks and two x blocks at least:
    where that passes the SM's 227 KB the lanes route serves the shape."""
    assert spmm_route(block_shape, 128, itemsize, True, width) == route
    fits = tiles_smem(width, block_shape, 128, itemsize) <= bsr_cuda.SMEM_MAX
    assert fits == (route == "tiles")


@pytest.mark.parametrize("block_shape, k, itemsize, width, route", [
    ((8, 8), 32, 4, 50, "tiles"),     # measured level with lanes at k = 32
    ((8, 8), 32, 4, 51, "lanes"),
    ((4, 8), 64, 4, 51, "lanes"),     # a chunk of 128 columns not full
    ((8, 8), 128, 4, 100, "tiles"),   # measured 1.5x faster than lanes
    ((8, 8), 128, 4, 101, "lanes"),
    ((4, 8), 256, 4, 100, "tiles"),   # two full chunks
    ((8, 8), 128, 8, 100, "tiles"),   # f64: 200 KB of blocks still fit
    ((8, 8), 128, 4, 200, "lanes"),   # measured slower than lanes
])
def test_spmm_tiles_width_limit(block_shape, k, itemsize, width, route):
    """The tiles route takes block rows up to TILES_WIDTH slots, and up to
    TILES_WIDTH_FULL where a CTA's chunk of columns is full: past them
    lanes measured faster."""
    assert spmm_route(block_shape, k, itemsize, True, width) == route
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    assert bsr_spmm.route(block_shape, k, dtype, True, width) == route


def test_spmm_tiles_constants_are_the_sources():
    """The tiles route's shape rule in ops/bsr_cuda.py reads the CTA of
    csrc/bsr_spmm.cu: rows a CTA, columns, rows a lane and shared memory."""
    src = (Path(bsr_cuda.__file__).parents[1] / "csrc" / "bsr_spmm.cu"
           ).read_text()
    got = {name: int(eval(re.search(pattern, src).group(1)))
           for name, pattern in (
               ("rows", r"constexpr int kTileRows = (\d+);"),
               ("stages", r"constexpr int kStages = (\d+);"),
               ("chunk", r"constexpr int kChunk = (\d+);"),
               ("tr", r"constexpr int kTR = (\d+);"),
               ("smem", r"constexpr int kSmemMax = ([\d *]+);"),
               ("static", r"constexpr int kStaticSmem = (\d+);"))}
    assert (got["rows"], got["chunk"], got["tr"], got["stages"]) == (
        bsr_cuda.TILE_ROWS, bsr_cuda.TILE_CHUNK, bsr_cuda.TILE_ROWS_MAX,
        bsr_cuda.TILE_STAGES)
    assert got["smem"] - got["static"] == bsr_cuda.SMEM_MAX


WHOLE_CASES = {
    "odd": lambda c: c.case_static(shape_xyz=(19, 17, 12), steps=2),
    "odd_convection": lambda c: c.case_convection(shape_xyz=(21, 13, 10),
                                                  steps=2),
}


@pytest.mark.parametrize("name", sorted(WHOLE_CASES))
def test_whole_apply_dots_on_cpu_matches_jax(name):
    mj = jcases.load_case(WHOLE_CASES[name](jcases))
    mt = tcases.load_case(WHOLE_CASES[name](tcases))
    cj = jpc.from_assembled_coded(j_assemble(mj, jnp.float32), mj)
    ct = tc.from_assembled_coded(t_assemble(mt, torch.float32, CPU), mt, CPU)
    assert not ct.split
    A, U = rand_fields(mt.shape_zyx, mt.cond_mask, seed=11)
    wA, wU = rand_fields(mt.shape_zyx, mt.cond_mask, seed=12)
    f = lambda a: torch.from_numpy(a).float()
    n0 = coded_cuda.coded_matvec.launches
    y, pw, py = ct.apply_dots(TState(f(A), f(U)), TState(f(wA), f(wU)))
    assert coded_cuda.coded_matvec.launches == n0      # the plain version
    yA_j, yU_j, _, _ = _jax_coded(cj, A, U, (wA, wU))
    scale = np.abs(host(yA_j)).max()
    np.testing.assert_allclose(host(y.A).astype(np.float64), host(yA_j),
                               rtol=0, atol=ATOL * scale)
    np.testing.assert_allclose(host(y.U).astype(np.float64), host(yU_j),
                               rtol=0, atol=ATOL * max(
                                   np.abs(host(yU_j)).max(), scale))
    yA64, yU64 = host(y.A).astype(np.float64), host(y.U).astype(np.float64)
    ref_w = float(np.vdot(yA64, wA.astype(np.float32).astype(np.float64))
                  + np.vdot(yU64, wU.astype(np.float32).astype(np.float64)))
    ref_y = float(np.vdot(yA64, yA64) + np.vdot(yU64, yU64))
    for got, ref in ((pw, ref_w), (py, ref_y)):
        assert abs(float(got) - ref) < DOT_RTOL * max(abs(ref), 1.0)
