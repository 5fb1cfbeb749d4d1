"""Geometric multigrid preconditioner for the A-block stencil operator.

The PyTorch counterpart of ``eddy_currents_3d_tpu/solvers/multigrid.py``,
with the same construction:

* **Cell-centred coarsening with piecewise-constant transfer.**  P copies a
  coarse cell to its 2x2x2 children; R = P^T sums them.  For a 7-point fine
  stencil the Galerkin product R A P is again 7-point, so every level is the
  same coefficient-field stencil apply, :func:`stencil7_apply`: on CUDA the
  hand-written ``field_a`` kernel (``ops/field_cuda.py``), on the CPU the
  flat-roll torch form.  Coarse coefficients are reshape-sums of the fine
  fields on the host (:func:`galerkin_coarsen`, numpy float64).
* **Damped-Jacobi smoothing** (omega = 2/3).
* **Fixed V-cycle** (fixed recursion and sweep counts, zero initial guess),
  so the preconditioner is a constant linear operator, fit for the
  right-preconditioned BiCGSTAB of ``bicgstab.bicgstab_wr_right``.

Restriction, prolongation and the even-size pads are plain torch ops, as
XLA computes them in the JAX package.  The U block is handled by diagonal
scaling in the same State-space preconditioner.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..assembly.stencil import State
from ..utils.device import resolve_device

__all__ = ["build_mg", "MGLevel", "MGPreconditioner", "MgUnsupported",
           "MG_CELL_LIMIT", "galerkin_coarsen", "stencil7_apply"]

_W = 2.0 / 3.0          # damped-Jacobi weight

# The JAX package rejects larger models because XLA's compilation of the
# V-cycle crashed the TPU compile worker at the 256^3-class size (1.05M
# cells compiled and ran; 4.2M cells killed the compile helper).  The port
# keeps the limit and the typed rejection unchanged, so both packages take
# the same models; whether CUDA could lift it is an open question
# (ROADMAP.md).
MG_CELL_LIMIT = 2_500_000


class MgUnsupported(ValueError):
    """The model is too large for the mg V-cycle (see MG_CELL_LIMIT); use
    jacobi/cheb_jacobi or the unpreconditioned coded path at scale."""


def stencil7_apply(ka: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the 7-offset coefficient fields ``ka`` (7, nz, ny, nx)
    and ``x`` (..., nz, ny, nx).  On CUDA the ``field_a`` kernel; on the
    CPU the flat-roll formulation (wrapped entries are killed by zero
    boundary coefficients, the invariant of assembly/stencil.py)."""
    if x.device.type != "cpu":
        from ..ops.field_cuda import field_a
        return field_a(ka, x)
    nz, ny, nx = ka.shape[1:]
    N = nz * ny * nx
    lead = tuple(x.shape[:-3])
    x2 = x.reshape(lead + (N,))
    k2 = ka.reshape(7, N)
    strides = (1, nx, nx * ny)
    y = k2[0] * x2
    # offsets: (axis, direction): 1 -x, 2 +x, 3 -y, 4 +y, 5 -z, 6 +z
    for o, (ax, d) in ((1, (0, -1)), (2, (0, +1)), (3, (1, -1)),
                       (4, (1, +1)), (5, (2, -1)), (6, (2, +1))):
        y = y + k2[o] * torch.roll(x2, -d * strides[ax], dims=-1)
    return y.reshape(x.shape)


def _pad_even(a: np.ndarray) -> np.ndarray:
    """Zero-pad the trailing 3 dims of a coefficient field to even sizes.
    Padding rows have all-zero coefficients: they decouple exactly."""
    pz, py, px = (s % 2 for s in a.shape[-3:])
    if not (pz or py or px):
        return a
    pad = [(0, 0)] * (a.ndim - 3) + [(0, pz), (0, py), (0, px)]
    return np.pad(a, pad)


def galerkin_coarsen(ka: np.ndarray) -> np.ndarray:
    """Coarse 7-point coefficients KA = R A P for piecewise-constant P
    (copy to 2x2x2 children) and R = P^T (sum over children).

    Cross-coarse-cell couplings sum the 4 fine couplings crossing each
    coarse face; the coarse diagonal sums the 8 fine diagonals plus the 12
    internal fine couplings absorbed into the block.
    """
    ka = _pad_even(np.asarray(ka))
    nz, ny, nx = ka.shape[1:]
    Z, Y, X = nz // 2, ny // 2, nx // 2
    v = ka.reshape(7, Z, 2, Y, 2, X, 2)
    # v[o] axes: (Z, z2, Y, y2, X, x2) = (0, 1, 2, 3, 4, 5)

    def child(o, axis, idx):
        """Sum v[o] over the children on one side of a pair axis
        (axis: 1 = z-child, 3 = y-child, 5 = x-child)."""
        w = np.take(v[o], idx, axis=axis)
        # after take, the remaining child axes of (Z,*,Y,*,X,*) sit at:
        remaining = {1: (2, 4), 3: (1, 4), 5: (1, 3)}[axis]
        return w.sum(remaining)

    out = np.zeros((7, Z, Y, X), ka.dtype)
    out[1] = child(1, 5, 0)          # -x: fine -x couplings of x-low children
    out[2] = child(2, 5, 1)          # +x
    out[3] = child(3, 3, 0)          # -y
    out[4] = child(4, 3, 1)          # +y
    out[5] = child(5, 1, 0)          # -z
    out[6] = child(6, 1, 1)          # +z
    # diagonal: all 8 fine diagonals + the 12 internal fine couplings
    out[0] = (v[0].sum((1, 3, 5))
              + child(2, 5, 0) + child(1, 5, 1)      # internal x pairs
              + child(4, 3, 0) + child(3, 3, 1)      # internal y pairs
              + child(6, 1, 0) + child(5, 1, 1))     # internal z pairs
    return out


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """R = P^T: sum 2x2x2 children (trailing dims must be even)."""
    s = tuple(r.shape)
    Z, Y, X = s[-3] // 2, s[-2] // 2, s[-1] // 2
    return r.reshape(s[:-3] + (Z, 2, Y, 2, X, 2)).sum((-5, -3, -1))


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """P: copy each coarse value to its 2x2x2 children."""
    s = tuple(e.shape)
    out = e[..., :, None, :, None, :, None].expand(
        s[:-3] + (s[-3], 2, s[-2], 2, s[-1], 2))
    return out.reshape(s[:-3] + (2 * s[-3], 2 * s[-2], 2 * s[-1]))


@dataclass(frozen=True)
class MGLevel:
    ka: torch.Tensor       # (7, nz, ny, nx)
    inv_d: torch.Tensor    # 1 / diag with zero-diag (decoupled) rows -> 1
    shape: tuple           # unpadded shape
    pshape: tuple          # even-padded


@dataclass(frozen=True)
class MGPreconditioner:
    """V-cycle preconditioner on the shared A-block stencil; the full
    State-space :meth:`apply` adds diagonal scaling for U."""

    levels: tuple          # tuple[MGLevel, ...], fine -> coarse
    inv_du: torch.Tensor   # full-grid 1/diag for the U rows (1 off-conductor)
    pre: int = 1
    post: int = 1
    coarse_sweeps: int = 12

    # -- scalar-field V-cycle ------------------------------------------
    def _smooth(self, lvl: MGLevel, b, x, sweeps):
        for _ in range(sweeps):
            x = x + _W * lvl.inv_d * (b - stencil7_apply(lvl.ka, x))
        return x

    def _vcycle(self, li: int, b):
        lvl = self.levels[li]
        x = _W * lvl.inv_d * b            # first smoother sweep from x = 0
        if li == len(self.levels) - 1:
            return self._smooth(lvl, b, x, self.coarse_sweeps - 1)
        x = self._smooth(lvl, b, x, self.pre - 1)
        r = b - stencil7_apply(lvl.ka, x)
        # pad to even, restrict, recurse, prolong, crop
        pz, py, px = (p - s for p, s in zip(lvl.pshape, lvl.shape))
        rp = F.pad(r, (0, px, 0, py, 0, pz))
        ec = self._vcycle(li + 1, _restrict(rp))
        ep = _prolong(ec)[..., :lvl.shape[0], :lvl.shape[1], :lvl.shape[2]]
        x = x + ep
        return self._smooth(lvl, b, x, self.post)

    def apply_scalar(self, r: torch.Tensor) -> torch.Tensor:
        """M^-1 r for scalar fields on the fine grid (batched over leading
        dims by the stencil apply)."""
        return self._vcycle(0, r)

    def apply(self, v: State) -> State:
        """State-space M^-1: V-cycle on each A component, diagonal on U."""
        return State(self.apply_scalar(v.A), self.inv_du * v.U)


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def build_mg(ka, ku0=None, min_dim: int = 4, max_levels: int = 10,
             pre: int = 1, post: int = 1, coarse_sweeps: int = 12,
             dtype: torch.dtype = None, device=None) -> MGPreconditioner:
    """Build the V-cycle hierarchy from fine A coefficients ``ka``
    (7, nz, ny, nx; a tensor or a numpy array) and the optional U-row
    diagonal field ``ku0`` (nz, ny, nx; zeros off-conductor).  The levels
    are ``dtype`` tensors on ``device`` (default: ``ka``'s when it is a
    tensor, else the CUDA device, which must exist).  Raises
    :class:`MgUnsupported` above MG_CELL_LIMIT cells."""
    n_cells = int(np.prod(tuple(ka.shape)[1:]))
    if n_cells > MG_CELL_LIMIT:
        raise MgUnsupported(
            f"precond='mg' supports up to {MG_CELL_LIMIT:,} cells (model has "
            f"{n_cells:,}), the JAX package's limit: XLA compilation of its "
            "V-cycle at the 256³-class size crashes the TPU compile worker.  "
            "Use precond='jacobi'/'cheb_jacobi' or the unpreconditioned "
            "coded path at scale.")
    if isinstance(ka, torch.Tensor):
        dtype = dtype or ka.dtype
        device = device if device is not None else ka.device
    device = resolve_device(device)
    dtype = dtype or torch.float64
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    levels = []
    cur = _host64(ka)
    for _ in range(max_levels):
        shape = tuple(cur.shape[1:])
        pshape = tuple(s + (s % 2) for s in shape)
        d = cur[0]
        inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        levels.append(MGLevel(ka=dev(cur), inv_d=dev(inv_d), shape=shape,
                              pshape=pshape))
        if min(shape) < min_dim:
            break
        cur = galerkin_coarsen(cur)

    if ku0 is None:
        inv_du = torch.ones(levels[0].shape, dtype=dtype, device=device)
    else:
        ku0 = _host64(ku0)
        inv_du = dev(np.where(ku0 != 0, 1.0 / np.where(ku0 == 0, 1.0, ku0),
                              1.0))
    return MGPreconditioner(levels=tuple(levels), inv_du=inv_du, pre=pre,
                            post=post, coarse_sweeps=coarse_sweeps)
