"""Shared helpers of the ``test_torch_*`` parity tests: both packages get the
same inputs, made with numpy from a seed, and are compared as numpy.

Importing this module caps torch at two CPU threads: the suite runs with
several pytest workers on one host."""

import contextlib

import numpy as np
import torch

from eddy_currents_3d_tpu.ops import pallas_sparse as psp
from eddy_currents_3d_tpu.ops import pallas_stencil as ps

torch.set_num_threads(2)

CPU = torch.device("cpu")


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas kernels in interpret mode, as its own
    tests do on the CPU (tests/test_coded.py, tests/test_sparse.py),
    restoring the flags after."""
    prev = ps.INTERPRET, psp.INTERPRET
    ps.INTERPRET = psp.INTERPRET = True
    try:
        yield
    finally:
        ps.INTERPRET, psp.INTERPRET = prev


def host(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as a numpy array; a
    bfloat16 tensor as float32 (exact; numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def rand_fields(shape_zyx, cond_mask, seed):
    """Random A (3, nz, ny, nx) and conductor-masked U (nz, ny, nx), f64."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((3,) + tuple(shape_zyx))
    U = rng.standard_normal(tuple(shape_zyx)) * np.asarray(cond_mask)
    return A, U


def z_face_case(c):
    """A case whose conductor slab lies ON the z- face of the grid; ``c``
    is either package's ``testing.cases`` module."""
    nx, ny, nz = 20, 14, 12
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[0:5, 3:ny - 3, 3:nx - 3] = 1          # slab ON the z- face
    geo[8, 4, 5:nx - 5] = 2                   # one x-directed coil run
    names = [
        "plast D=1 C='mu0*35e6'",
        "coil D=1 SRCx=F",
        "param tran stop=0.002 step=1e-3",
        "p2 solver tol=5e-3 itmax=10000 dir=out",
        "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t",
    ]
    return c.make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel())


def z_through_case(c):
    """A case whose conductor runs through every z plane, so the split
    route's slab is the whole grid and its stencil kernel owns no plane.
    For operator checks only: its transient does not converge in either
    package."""
    nx, ny, nz = 20, 14, 8
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[:, 3:ny - 3, 6:nx - 3] = 1            # slab through every z plane
    geo[2:6, 3:ny - 3, 2] = 2                 # one y-directed coil run
    names = [
        "plast D=1 C='mu0*35e6'",
        "coil D=1 SRCy=F",
        "param tran stop=0.002 step=1e-3",
        "p2 solver tol=5e-3 itmax=10000 dir=out",
        "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t",
    ]
    return c.make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel())


def two_domain_case(c):
    """Two touching conducting domains and a coil.  Domain 2 lies below
    domain 1 in z, but the reference's PHYS_C numbering (domain 1's cells,
    then domain 2's; tests/test_assembly.py test_two_conducting_domains)
    numbers it second, so the numbering is not monotone in the flat cell
    index and the +z ku entries across the interface fall below the
    diagonal."""
    nx, ny, nz = 16, 10, 10
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[2:5, 3:7, 3:10] = 2
    geo[5:8, 3:7, 3:10] = 1
    geo[4, 8, 2:nx - 2] = 3                   # one x-directed coil run
    names = [
        "cua D=1 C='mu0*30e6'",
        "cub D=2 C='mu0*10e6'",
        "coil D=3 SRCx=F",
        "param tran stop=0.003 step=1e-3",
        "p2 solver tol=5e-3 itmax=10000 dir=out",
        "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t",
    ]
    return c.make_vxc_text((nx, ny, nz), 0.002, names, geo.ravel())
