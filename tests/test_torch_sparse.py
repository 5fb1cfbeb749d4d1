"""The port's general sparse tier against the JAX package's.

* ``to_csr``: the same scipy CSR (indptr and indices equal, data equal in
  float64) on case_static, case_convection and a two-domain model.
* The containers (CSR, COO, ELL, BSR): every method against JAX's on the
  same scipy matrices, rtol 1e-12 (float64; the sums run in another order).
* ``bsr_from_scipy`` bit for bit, padding slots included; ``spgemm`` and
  plan reuse.
* ``bsr_spmm`` / ``bsr_matvec`` (on the CPU their plain version) against
  JAX's Pallas kernel in interpret mode, rtol 1e-11.
* ``convert`` carries JAX's containers across unchanged.
"""

import numpy as np
import pytest
import torch
from scipy import sparse

from _torch_parity import CPU, host, pallas_interpret, two_domain_case

import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import (assemble_operator as j_assemble,
                                                    to_csr as j_to_csr)
from eddy_currents_3d_tpu.ops import pallas_sparse as jps
from eddy_currents_3d_tpu.ops import sparse as jsp
from eddy_currents_3d_tpu.testing import cases as jcases

import eddy_currents_3d_tpu_torch as ect
from eddy_currents_3d_tpu_torch import convert
from eddy_currents_3d_tpu_torch.assembly.assemble import (assemble_operator as t_assemble,
                                                          to_csr as t_to_csr)
from eddy_currents_3d_tpu_torch.ops import bsr_cuda
from eddy_currents_3d_tpu_torch.ops import sparse as tsp
from eddy_currents_3d_tpu_torch.testing import cases as tcases

RTOL = 1e-12

MODELS = {
    "static": lambda c: c.case_static(shape_xyz=(14, 12, 10), steps=2),
    "convection": lambda c: c.case_convection(shape_xyz=(24, 12, 10), steps=2),
    "two_domain": two_domain_case,
}


def _rand_csr(n=60, density=0.08, seed=3, m=None):
    a = sparse.random(n, m or n, density=density,
                      random_state=np.random.RandomState(seed)).tocsr()
    if m is None:
        a.setdiag(1.0)
    return a


def _pair(a):
    """The same scipy matrix in both packages, float64."""
    return jsp.from_scipy(a, jnp.float64), tsp.from_scipy(a, torch.float64, CPU)


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(host(got), host(ref), rtol=rtol, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_to_csr_matches_jax(name):
    mj = jcases.load_case(MODELS[name](jcases))
    mt = tcases.load_case(MODELS[name](tcases))
    cj = j_to_csr(j_assemble(mj, jnp.float64), mj)
    ct = t_to_csr(t_assemble(mt, torch.float64, CPU), mt)
    assert ct.shape == cj.shape == (3 * mt.n_cells + mt.n_cond,) * 2
    np.testing.assert_array_equal(ct.indptr, cj.indptr)
    np.testing.assert_array_equal(ct.indices, cj.indices)
    np.testing.assert_array_equal(ct.data, cj.data)


def test_csr_methods_match_jax():
    a = _rand_csr(n=48)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(48)
    X = rng.standard_normal((48, 7))
    cj, ct = _pair(a)
    assert ct.nnz == cj.nnz == a.nnz
    np.testing.assert_array_equal(host(ct.row_lengths()), host(cj.row_lengths()))
    np.testing.assert_array_equal(host(ct.row_ids()), host(cj.row_ids()))
    _close(ct.matvec(torch.from_numpy(x)), cj.matvec(jnp.asarray(x)))
    _close(ct.matmat(torch.from_numpy(X)), cj.matmat(jnp.asarray(X)))
    _close(ct.diagonal(), cj.diagonal())
    np.testing.assert_array_equal(host(ct.todense()), host(cj.todense()))
    _close(ct.matvec(torch.from_numpy(x)), a @ x)


def test_csr_with_empty_rows_matches_jax():
    """Rows with no entry (and a missing diagonal) at the start, middle and
    end: row_ids and the sums still match."""
    a = sparse.random(30, 30, density=0.1,
                      random_state=np.random.RandomState(4)).tolil()
    for r in (0, 13, 29):
        a[r, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    cj, ct = _pair(a)
    np.testing.assert_array_equal(host(ct.row_ids()), host(cj.row_ids()))
    x = np.random.default_rng(1).standard_normal(30)
    _close(ct.matvec(torch.from_numpy(x)), cj.matvec(jnp.asarray(x)))
    _close(ct.diagonal(), cj.diagonal())


def test_coo_methods_match_jax():
    a = _rand_csr(n=30)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(30)
    X = rng.standard_normal((30, 5))
    cj, ct = _pair(a)
    oj, ot = cj.to_coo(), ct.to_coo()
    np.testing.assert_array_equal(host(ot.rows), host(oj.rows))
    np.testing.assert_array_equal(host(ot.cols), host(oj.cols))
    _close(ot.matvec(torch.from_numpy(x)), oj.matvec(jnp.asarray(x)))
    _close(ot.matmat(torch.from_numpy(X)), oj.matmat(jnp.asarray(X)))
    np.testing.assert_array_equal(host(ot.todense()), host(oj.todense()))


@pytest.mark.parametrize("width", [None, 12])
def test_ell_matches_jax(width):
    a = _rand_csr(n=50)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(50)
    X = rng.standard_normal((50, 4))
    cj, ct = _pair(a)
    ej, et = cj.to_ell(width), ct.to_ell(width)
    assert et.cols.dtype == torch.int32
    np.testing.assert_array_equal(host(et.cols), host(ej.cols))
    np.testing.assert_array_equal(host(et.vals), host(ej.vals))
    _close(et.matvec(torch.from_numpy(x)), ej.matvec(jnp.asarray(x)))
    _close(et.matmat(torch.from_numpy(X)), ej.matmat(jnp.asarray(X)))
    with pytest.raises(ValueError, match="longest row"):
        ct.to_ell(et.cols.shape[1] - 3)


BLOCKS = [(8, 8), (4, 8), (8, 16)]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("block_shape", BLOCKS, ids=lambda b: f"{b[0]}x{b[1]}")
def test_bsr_from_scipy_bit_for_bit(block_shape, dtype):
    """A grid that is not a multiple of the block size, rows of different
    block widths: every slot, padding included, equals JAX's."""
    a = _rand_csr(n=50, density=0.1)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.float64, torch.float64))
    bj = jsp.bsr_from_scipy(a, block_shape=block_shape, dtype=jd)
    bt = tsp.bsr_from_scipy(a, block_shape=block_shape, dtype=td, device=CPU)
    assert bt.shape == bj.shape and bt.block_shape == bj.block_shape
    assert bt.nnz == bj.nnz
    assert bt.block_cols.dtype == torch.int32 and bt.blocks.dtype == td
    np.testing.assert_array_equal(host(bt.block_cols), host(bj.block_cols))
    np.testing.assert_array_equal(host(bt.blocks), host(bj.blocks))
    # padding slots (every stored block holds a nonzero): block column 0
    # and an all-zero block
    pad = bt.blocks.abs().sum(dim=(2, 3)) == 0
    assert pad.any() and not torch.any(bt.block_cols[pad])


def test_bsr_methods_match_jax():
    a = _rand_csr(n=50)
    bj = jsp.bsr_from_scipy(a, block_shape=(4, 8), dtype=jnp.float64)
    bt = tsp.bsr_from_scipy(a, block_shape=(4, 8), dtype=torch.float64,
                            device=CPU)
    assert bt.shape == (52, 56)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(56)
    X = rng.standard_normal((56, 5))
    np.testing.assert_array_equal(host(bt.todense()), host(bj.todense()))
    _close(bt.matvec(torch.from_numpy(x)), bj.matvec(jnp.asarray(x)))
    _close(bt.matmat(torch.from_numpy(X)), bj.matmat(jnp.asarray(X)))
    dense = np.zeros(bt.shape)
    dense[:50, :50] = a.toarray()
    _close(bt.matmat(torch.from_numpy(X)), dense @ X)


def test_spgemm_matches_jax():
    a = _rand_csr(n=40, density=0.1, seed=7, m=55)
    b = sparse.random(55, 33, density=0.12,
                      random_state=np.random.RandomState(8)).tocsr()
    cj = jsp.spgemm(jsp.from_scipy(a, jnp.float64), jsp.from_scipy(b, jnp.float64))
    ct = tsp.spgemm(tsp.from_scipy(a, torch.float64, CPU),
                    tsp.from_scipy(b, torch.float64, CPU))
    np.testing.assert_array_equal(host(ct.indptr), host(cj.indptr))
    np.testing.assert_array_equal(host(ct.cols), host(cj.cols))
    _close(ct.vals, cj.vals)
    np.testing.assert_allclose(host(ct.todense()), (a @ b).toarray(),
                               rtol=1e-12, atol=1e-14)


def test_spgemm_plan_reuse():
    """The numeric phase reuses one plan while the values change."""
    a = sparse.random(30, 30, density=0.15,
                      random_state=np.random.RandomState(9)).tocsr()
    b = a.T.tocsr()
    plan = tsp.spgemm_plan(tsp.from_scipy(a, torch.float64, CPU),
                           tsp.from_scipy(b, torch.float64, CPU))
    jplan = jsp.spgemm_plan(jsp.from_scipy(a, jnp.float64),
                            jsp.from_scipy(b, jnp.float64))
    for f in ("a_idx", "b_idx", "out_idx", "indptr", "cols"):
        np.testing.assert_array_equal(host(getattr(plan, f)),
                                      host(getattr(jplan, f)))
    for scale in (1.0, 3.5):
        c = plan.numeric(torch.from_numpy(a.data * scale),
                         torch.from_numpy(b.data))
        np.testing.assert_allclose(host(c.todense()), ((a * scale) @ b).toarray(),
                                   rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError, match="shape mismatch"):
        tsp.spgemm_plan(tsp.from_scipy(a, torch.float64, CPU),
                        tsp.from_scipy(_rand_csr(n=20), torch.float64, CPU))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("block_shape", [(8, 16), (4, 8)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_bsr_spmm_matches_jax_interpret(block_shape, k):
    a = _rand_csr(n=64, density=0.1)
    bj = jsp.bsr_from_scipy(a, block_shape=block_shape, dtype=jnp.float64)
    bt = tsp.bsr_from_scipy(a, block_shape=block_shape, dtype=torch.float64,
                            device=CPU)
    x = np.random.default_rng(6).standard_normal((bt.shape[1], k))
    with pallas_interpret():
        yj = jps.bsr_spmm(bj, jnp.asarray(x))
    n0 = bsr_cuda.bsr_spmm.launches
    yt = ect.bsr_spmm(bt, torch.from_numpy(x))
    assert bsr_cuda.bsr_spmm.launches == n0          # CPU: the plain version
    _close(yt, yj, 1e-11)
    np.testing.assert_array_equal(
        host(yt), host(bsr_cuda.bsr_spmm_reference(bt, torch.from_numpy(x))))


def test_bsr_matvec_matches_jax_interpret():
    a = _rand_csr(n=40, density=0.1)
    bj = jsp.bsr_from_scipy(a, block_shape=(8, 8), dtype=jnp.float64)
    bt = tsp.bsr_from_scipy(a, block_shape=(8, 8), dtype=torch.float64,
                            device=CPU)
    x = np.random.default_rng(7).standard_normal(bt.shape[1])
    with pallas_interpret():
        yj = jps.bsr_matvec(bj, jnp.asarray(x), lane_pad=8)
    yt = ect.bsr_matvec(bt, torch.from_numpy(x))
    _close(yt, yj, 1e-11)
    _close(ect.bsr_matvec(bt, torch.from_numpy(x), lane_pad=128), yj, 1e-11)
    with pytest.raises(ValueError, match="lane_pad"):
        ect.bsr_matvec(bt, torch.from_numpy(x), lane_pad=0)
    with pytest.raises(ValueError, match="bsr_spmm"):
        ect.bsr_spmm(bt, torch.from_numpy(x[:-1, None].copy()))


def test_convert_carries_the_containers_across():
    a = _rand_csr(n=36)
    cj = jsp.from_scipy(a, jnp.float64)
    ct = convert.csr_from_jax(cj, CPU)
    assert ct.shape == cj.shape and ct.cols.dtype == torch.int32
    for f in ("indptr", "cols", "vals"):
        np.testing.assert_array_equal(host(getattr(ct, f)), host(getattr(cj, f)))
    et = convert.ell_from_jax(cj.to_ell(), CPU)
    np.testing.assert_array_equal(host(et.vals), host(cj.to_ell().vals))
    bj = jsp.bsr_from_scipy(a, block_shape=(4, 8), dtype=jnp.float32)
    bt = convert.bsr_from_jax(bj, CPU)
    assert bt.shape == bj.shape and bt.blocks.dtype == torch.float32
    np.testing.assert_array_equal(host(bt.blocks), host(bj.blocks))
    np.testing.assert_array_equal(host(bt.block_cols), host(bj.block_cols))


def test_default_device_is_the_card():
    """With no device named, the containers go to the CUDA device, and
    raise where there is none."""
    a = _rand_csr(n=10)
    if torch.cuda.is_available():
        assert tsp.from_scipy(a).vals.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.from_scipy(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.bsr_from_scipy(a)
