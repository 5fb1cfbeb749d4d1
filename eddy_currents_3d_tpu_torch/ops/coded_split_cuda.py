"""Wrappers of the split route's hand-written CUDA kernels.

The kernels (``csrc/coded_split.cu``) replace the TPU kernels
``_stencil_kernel_yt`` and ``_slab_kernel_yt``
(``eddy_currents_3d_tpu/ops/pallas_coded.py:602``, ``:658``), which the
coded operator runs on 256x256-class planes with the solver's U held
z-compact: only the conductor's planes ``op.cond_z = (zb0, zb1)``.

* :data:`coded_stencil` fills every plane of yA outside the slab with the
  constant+face A stencil (A in, yA out, nothing else), and with ``wA``
  also returns ``dots = [dot(yA, wA), dot(yA, yA)]`` over those planes.
* :data:`coded_slab` runs the whole coded matvec on the slab's planes: it
  writes them into the same yA, in place, and returns the compact yU (with
  ``w``, also the dots over the slab, plus ``prior``: pass the stencil's
  dots and they are the whole matvec's).  Without ``U_c`` it is
  ``apply_div``'s contraction (U = 0) and returns the compact yU alone.

Both are bound by device-memory bytes.  Each kernel marches (x, y) tiles
through z with the current plane in shared memory and its z-neighbours in
registers, so every A value leaves device memory once; the dots are
finished inside the kernels (the last CTA sums every CTA's pair in a fixed
order), so ``apply_dots`` on this route is two launches and repeats bit for
bit.  See the source note.  :func:`split_plan` is how the kernels cover a
grid: the stencil kernel's CTAs are (x, y) tiles x runs of owned planes
(its table of runs is what the launch passes), the slab kernel's CTAs the
tiles alone.  Each wrapper keeps its partials, counter and run table per
operator, device and stream (:class:`~.coded_cuda.MarchKernel`), so one
operator may run on two streams at once.

A CPU tensor goes to the plain torch version
(:func:`~.coded.coded_stencil_reference`,
:func:`~.coded.coded_slab_reference`); a CUDA tensor launches the kernel or
raises.  Each wrapper's ``launches`` counts its kernel's launches, and only
those.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..assembly.stencil import State
from .coded import coded_slab_reference, coded_stencil_reference
from .coded_cuda import MarchKernel, check_tensors, cuda_only, ptr, runs

__all__ = ["coded_stencil", "coded_slab", "SplitPlan", "split_plan",
           "plan_of", "STENCIL_TILE", "SLAB_TILE"]

_APPLY, _DOTS, _DIV = 0, 1, 2

# The kernels' tiles (vx, ty, stages), as csrc/coded_split.cu's StencilTile
# and SlabTile (its launches refuse a plan whose CTAs are not their grid's):
# 32 vx x ty cells for 32 ty threads (vx cells each), a ring of ``stages``
# z planes in shared memory; and the longest run of planes a CTA marches.
# The fastest measured at 256x256x64 apply_dots on an H100 (PERF.md).
STENCIL_TILE, CHUNK = (4, 4, 4), 8
SLAB_TILE, SLAB_CHUNK = (1, 8, 4), 5


@dataclass(frozen=True)
class SplitPlan:
    """How the split pair's kernels cover a grid."""

    chunks: tuple         # ((z0, z1), ...): the runs of owned planes
    stencil_tiles: int    # (x, y) tiles of a plane at STENCIL_TILE
    slab_chunks: tuple    # ((p0, p1), ...): runs of the slab's compact planes
    slab_tiles: int       # (x, y) tiles of a plane at SLAB_TILE

    @property
    def stencil_ctas(self) -> int:
        return self.stencil_tiles * len(self.chunks)

    @property
    def slab_ctas(self) -> int:
        return self.slab_tiles * len(self.slab_chunks)


def _tiles(ny, nx, tile):
    vx, ty, _ = tile
    return -(-nx // (32 * vx)) * -(-ny // ty)


def split_plan(shape_zyx, cond_z) -> SplitPlan:
    """The split pair's cover of a grid of ``shape_zyx`` whose slab is
    ``cond_z = (zb0, zb1)``.

    The stencil kernel's owned planes, [0, zb0) and [zb1, nz), are cut into
    runs of at most CHUNK planes, each range into runs of near-equal
    length, and the slab's nzc planes into runs of at most SLAB_CHUNK; a
    CTA marches one run of one (x, y) tile.  At 256x256x64 with the slab on
    planes 2..6 that is 128 tiles x 9 runs = 1152 stencil CTAs (3 resident
    per SM of an H100) and 256 slab CTAs, each marching all 5 slab planes:
    one wave at 2 per SM."""
    nz, ny, nx = shape_zyx
    zb0, zb1 = cond_z
    chunks = runs(0, zb0, CHUNK) + runs(zb1, nz, CHUNK)
    return SplitPlan(tuple(chunks), _tiles(ny, nx, STENCIL_TILE),
                     tuple(runs(0, zb1 - zb0, SLAB_CHUNK)),
                     _tiles(ny, nx, SLAB_TILE))


def _slab(op):
    """(zb0, zb1) of ``op``, checked against its grid."""
    nz, ny, nx = op.shape_zyx
    zb0, zb1 = op.cond_z
    if not 0 <= zb0 < zb1 <= nz:
        raise ValueError(f"conductor planes {op.cond_z} do not fit the "
                         f"grid's {nz}")
    if 3 * nz * ny * nx >= 2 ** 31:
        raise ValueError(f"grid {op.shape_zyx} too large for the kernel")
    return zb0, zb1


def plan_of(op) -> SplitPlan:
    """The plan the wrappers launch ``op``'s kernels with."""
    return split_plan(op.shape_zyx, op.cond_z)


def _vec(nx, *tensors) -> int:
    """1 when the kernel may copy planes in 16-byte pieces: nx % 4 == 0
    and every field it streams (None: not streamed) 16-byte aligned."""
    return int(nx % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in tensors if t is not None))


class _SplitKernel(MarchKernel):
    source = "coded_split"
    consts_len = "coded_split_consts_len"
    info_fn = "coded_split_info"
    kernel = None    # coded_split_info's index of this wrapper's kernel

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        lib.coded_stencil_launch.argtypes = (
            [vp] * 4 + [ci] + [vp] * 3 + [ci] * 8 + [fp, vp])
        lib.coded_stencil_launch.restype = ci
        lib.coded_slab_launch.argtypes = (
            [vp] * 10 + [ci] + [vp] * 4 + [ci] * 9 + [fp, vp])
        lib.coded_slab_launch.restype = ci
        lib.coded_split_info.argtypes = [ci] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.coded_split_info.restype = ci

    def _info_args(self, mode, conv):
        return (self.kernel, mode, int(conv))


class _CodedStencil(_SplitKernel):
    kernel = 0

    def _cover(self, op, dev):
        plan = plan_of(op)
        return plan.stencil_ctas, plan.chunks

    def __call__(self, op, A: torch.Tensor, wA: Optional[torch.Tensor] = None):
        """yA (full shape; only the planes outside the slab are written on
        CUDA), or ``(yA, dots)`` with ``dots = [dot(yA, wA), dot(yA, yA)]``
        over those planes."""
        if A.device.type == "cpu":
            out = coded_stencil_reference(A, op.consts, op.cond_z, wA)
            return out if wA is None else (out[0], torch.stack(out[1:]))
        cuda_only("coded_stencil", A)
        zb0, zb1 = _slab(op)
        nz, ny, nx = op.shape_zyx
        dev = A.device
        f32 = torch.float32
        checks = [("A", A, (3, nz, ny, nx), f32)]
        if wA is not None:
            checks.append(("wA", wA, (3, nz, ny, nx), f32))
        check_tensors(dev, checks)
        lib, kc = self._ready(dev, op.consts)
        yA = torch.empty_like(A)
        if nz == zb1 - zb0:
            # the slab covers the grid: the stencil kernel owns no plane
            return yA if wA is None else (yA, torch.zeros(2, dtype=f32,
                                                          device=dev))
        dots = torch.empty(2, dtype=f32, device=dev) if wA is not None else None
        with torch.cuda.device(dev):
            ctas, parts, counter, table = self._scratch(op, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.coded_stencil_launch(
                ptr(A), ptr(wA), ptr(yA), ptr(parts), ctas, ptr(counter),
                ptr(dots), ptr(table), len(table) // 2, _vec(nx, A, wA),
                nx, ny, nz, zb0, zb1 - zb0, int(wA is not None), kc, stream)
        self._raise_on(err)
        return yA if wA is None else (yA, dots)


class _CodedSlab(_SplitKernel):
    kernel = 1

    def _cover(self, op, dev):
        plan = plan_of(op)
        return plan.slab_ctas, plan.slab_chunks

    def __call__(self, op, A: torch.Tensor, U_c: Optional[torch.Tensor] = None,
                 yA: Optional[torch.Tensor] = None, w: Optional[State] = None,
                 prior: Optional[torch.Tensor] = None):
        """With ``U_c`` (the compact U): write the slab's planes of ``yA``
        in place and return the compact yU, or ``(yU_c, dots)`` when ``w``
        is given (``w.A`` full-grid, ``w.U`` compact), ``dots = prior +
        [dot(y, w), dot(y, y)]`` over the slab (``prior``: 2 floats, e.g.
        the stencil kernel's dots, added first).  Without: ``apply_div``
        (U = 0), returns the compact yU."""
        if U_c is None and (yA is not None or w is not None):
            raise ValueError("apply_div takes A alone")
        if U_c is not None and yA is None:
            raise ValueError("apply needs the yA whose slab planes it fills")
        if prior is not None and w is None:
            raise ValueError("prior dots are added to the dots w asks for")
        if A.device.type == "cpu":
            out = coded_slab_reference(A, U_c, op.code, op.cf, op.conv,
                                       op.consts, op.inertia_on_faces,
                                       op.cond_z, w, prior)
            if U_c is None:
                return out
            zb0, zb1 = op.cond_z
            yA[:, zb0:zb1] = out[0]
            return out[1] if w is None else (out[1], torch.stack(out[2:]))
        cuda_only("coded_slab", A)
        return self._launch(op, A, U_c, yA, w, prior)

    def _launch(self, op, A, U_c, yA, w, prior):
        zb0, zb1 = _slab(op)
        nzc = zb1 - zb0
        nz, ny, nx = op.shape_zyx
        mode = _DIV if U_c is None else (_APPLY if w is None else _DOTS)
        dev = A.device
        f32 = torch.float32
        checks = [("A", A, (3, nz, ny, nx), f32),
                  ("code", op.code, (nz, ny, nx), torch.int32),
                  ("cf", op.cf, (nz, ny, nx), f32)]
        if U_c is not None:
            checks += [("U_c", U_c, (nzc, ny, nx), f32),
                       ("yA", yA, (3, nz, ny, nx), f32)]
        if op.conv is not None:
            checks.append(("conv", op.conv, (3, nz, ny, nx), f32))
        if w is not None:
            checks += [("w.A", w.A, (3, nz, ny, nx), f32),
                       ("w.U", w.U, (nzc, ny, nx), f32)]
        if prior is not None:
            checks.append(("prior", prior, (2,), f32))
        check_tensors(dev, checks)
        lib, kc = self._ready(dev, op.consts)
        yU = torch.empty((nzc, ny, nx), dtype=f32, device=dev)
        dots = torch.empty(2, dtype=f32, device=dev) if mode == _DOTS else None
        vec = _vec(nx, A, U_c, op.code, op.cf, op.conv,
                   *((w.A, w.U) if w is not None else ()))
        with torch.cuda.device(dev):
            ctas, parts, counter, table = self._scratch(op, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.coded_slab_launch(
                ptr(A), ptr(U_c), ptr(op.code), ptr(op.cf), ptr(op.conv),
                ptr(w.A if w is not None else None),
                ptr(w.U if w is not None else None),
                ptr(yA), ptr(yU), ptr(parts), ctas, ptr(counter),
                ptr(prior), ptr(dots), ptr(table), len(table) // 2,
                vec, nx, ny, nz, zb0, nzc, mode, int(op.inertia_on_faces),
                kc, stream)
        self._raise_on(err)
        return yU if mode != _DOTS else (yU, dots)


coded_stencil = _CodedStencil()
coded_slab = _CodedSlab()
