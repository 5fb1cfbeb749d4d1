"""Shared helpers of the ``test_torch_*`` parity tests: both packages get the
same inputs, made with numpy from a seed, and are compared as numpy.

Importing this module caps torch at two CPU threads: the suite runs with
several pytest workers on one host."""

import contextlib

import numpy as np
import torch

from eddy_currents_3d_tpu.ops import pallas_stencil as ps

torch.set_num_threads(2)

CPU = torch.device("cpu")


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas kernels in interpret mode, as its own
    tests do on the CPU (tests/test_coded.py), restoring the flag after."""
    prev = ps.INTERPRET
    ps.INTERPRET = True
    try:
        yield
    finally:
        ps.INTERPRET = prev


def host(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rand_fields(shape_zyx, cond_mask, seed):
    """Random A (3, nz, ny, nx) and conductor-masked U (nz, ny, nx), f64."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3,) + tuple(shape_zyx))
    U = rng.standard_normal(tuple(shape_zyx)) * np.asarray(cond_mask)
    return A, U
