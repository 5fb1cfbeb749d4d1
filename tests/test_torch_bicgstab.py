"""The port's BiCGSTABwr against the JAX package's at f64 on the same
random systems: identical iteration counts and solutions within 1e-10
relative, with and without the fused mv_dot hook."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread cap)

import jax.numpy as jnp

from eddy_currents_3d_tpu.solvers.bicgstab import bicgstab_wr as j_bicgstab
from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.solvers.bicgstab import bicgstab_wr as t_bicgstab

RTOL = 1e-10


def _system(seed, n=60, shift=6.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * 0.3 + np.eye(n) * shift
    return A, rng.standard_normal(n), rng.standard_normal(n) * 0.01


def _jax(A, b, x0, tol, itmax, fused):
    Aj = jnp.asarray(A)
    mv = lambda v: Aj @ v
    mvd = None
    if fused:
        def mvd(v, w):
            y = Aj @ v
            return y, jnp.sum(y * w), jnp.sum(y * y)
    return j_bicgstab(mv, jnp.asarray(b), jnp.asarray(x0), tol, itmax,
                      mv_dot=mvd)


def _torch(A, b, x0, tol, itmax, fused):
    At = torch.from_numpy(A)
    mv = lambda v: At @ v
    mvd = None
    if fused:
        def mvd(v, w):
            y = At @ v
            return y, torch.sum(y * w), torch.sum(y * y)
    return t_bicgstab(mv, torch.from_numpy(b), torch.from_numpy(x0), tol,
                      itmax, mv_dot=mvd)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("seed,tol", [(0, 1e-8), (1, 1e-5), (2, 1e-10),
                                      (3, 1e-3)])
def test_matches_jax(seed, tol, fused):
    A, b, x0 = _system(seed)
    rj = _jax(A, b, x0, tol, 500, fused)
    rt = _torch(A, b, x0, tol, 500, fused)
    assert rt.iterations == int(rj.iterations) > 0
    assert rt.converged == bool(rj.converged) is True
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=RTOL * np.abs(xj).max())
    assert float(rt.relres) == pytest.approx(float(rj.relres), rel=1e-6)
    assert np.linalg.norm(b - A @ rt.x.numpy()) / np.linalg.norm(b) < tol


@pytest.mark.parametrize("itmax", [0, 1, 3])
def test_itmax_budget_matches(itmax):
    """tol = 0 runs the whole itmax + 1 budget without converging."""
    A, b, x0 = _system(4, n=40)
    rj = _jax(A, b, x0, 0.0, itmax, False)
    rt = _torch(A, b, x0, 0.0, itmax, False)
    assert rt.iterations == int(rj.iterations) == itmax + 1
    assert rt.converged is False and not bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=RTOL,
                               atol=1e-14)


def test_zero_rhs_returns_warm_start():
    A, _, _ = _system(5, n=20)
    x0 = np.random.default_rng(6).standard_normal(20)
    rj = _jax(A, np.zeros(20), x0, 1e-6, 100, False)
    rt = _torch(A, np.zeros(20), x0, 1e-6, 100, False)
    assert rt.iterations == int(rj.iterations) == 0
    assert rt.converged and bool(rj.converged)
    np.testing.assert_array_equal(rt.x.numpy(), x0)


@pytest.mark.parametrize("fused", [False, True])
def test_half_step_exit(fused):
    """A = 2I: the first half step lands on the solution (s = 0), so the
    solver must take the half-step exit x = x0 + alpha p, with the 0/0
    omega gated away, in one iteration."""
    n = 16
    A = 2.0 * np.eye(n)
    b = np.random.default_rng(7).standard_normal(n)
    rj = _jax(A, b, np.zeros(n), 1e-8, 50, fused)
    rt = _torch(A, b, np.zeros(n), 1e-8, 50, fused)
    assert rt.iterations == int(rj.iterations) == 1
    assert rt.converged and float(rt.relres) == 0.0
    np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    np.testing.assert_allclose(rt.x.numpy(), b / 2, rtol=1e-15)


def test_state_operands():
    """The port solves over State pairs as the JAX solver does over its
    pytrees: split the random system into an (A, U)-shaped State."""
    A, b, x0 = _system(8, n=60)
    At = torch.from_numpy(A)

    def mv(v):
        y = At @ torch.cat([v.A.reshape(-1), v.U.reshape(-1)])
        return State(y[:48].reshape(3, 2, 2, 4), y[48:].reshape(1, 3, 4))

    def st(x):
        x = torch.from_numpy(x)
        return State(x[:48].reshape(3, 2, 2, 4), x[48:].reshape(1, 3, 4))

    rt = t_bicgstab(mv, st(b), st(x0), 1e-9, 500, dot_dtype=torch.float64)
    rj = _jax(A, b, x0, 1e-9, 500, False)
    assert rt.iterations == int(rj.iterations)
    x = torch.cat([rt.x.A.reshape(-1), rt.x.U.reshape(-1)]).numpy()
    np.testing.assert_allclose(x, np.asarray(rj.x), rtol=0,
                               atol=RTOL * np.abs(x).max())
