"""Wrapper of the hand-written CUDA coded-matvec kernel (whole-plane route).

The kernel (``csrc/coded_matvec.cu``) replaces the TPU kernel
``_fused_kernel_chunk`` and its decode ``_u_body``
(``eddy_currents_3d_tpu/ops/pallas_coded.py:405``, ``:1051``).  It is bound
by device-memory bytes: without convection or dots 40 B per cell of the
conductor's planes (A, U, code and cf read once, yA and yU written once)
and 28 B per other cell (A read, yA and yU written); dots add w.A's 12 B,
and w.U's 4 B on the conductor's planes.  It
is a z-march in registers: each thread walks one (x, y) column of its
segment of the plane (consecutive columns in row-major order) through a
run of planes, carrying A's (and U's) z-neighbours, and the dots are
finished in the kernel, so ``apply_dots`` is one launch.
:func:`whole_plan` cuts the planes at the conductor's z-extent: the
conducting runs (short, listed first) decode the case code, the others
read only A and skip the decode.

:data:`coded_matvec` serves the coded operator's three entry points on the
whole-plane route.  A CPU tensor goes to
:func:`~.coded.coded_apply_reference`, the plain torch version; a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel
launches, and only those.  :class:`CudaKernel`, :class:`MarchKernel`,
:func:`check_tensors` and :func:`cuda_only` are what this wrapper shares
with the split route's (``ops/coded_split_cuda.py``) and, for the first,
third and fourth, the field tier's (``ops/field_cuda.py``) and the sparse
tier's (``ops/bsr_cuda.py``).

The march kernels keep scratch for their dots (a pair of partials per CTA,
the last-CTA counter) and their table of runs per operator, device and
stream, so one operator may run on several streams at once, or per device
program (``utils/graph.py``) while one is warmed up and captured.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from ..assembly.stencil import State
from ..utils.graph import counted, program_scratch
from ._build import load_library
from .coded import coded_apply_reference

__all__ = ["coded_matvec", "CudaKernel", "MarchKernel", "check_tensors",
           "cuda_only", "WholePlan", "whole_plan", "WHOLE_TY"]

_APPLY, _DOTS, _DIV = 0, 1, 2

# The whole-plane kernel's CTA of 32 x WHOLE_TY threads, one (x, y) column
# each, as csrc/coded_matvec.cu's WholeTile (its launch refuses more CTAs
# than it has items); the longest runs of conducting and of
# other planes an item marches; and the CTAs per SM the plan launches at
# most.
WHOLE_TY = 8
COND_CHUNK, AIR_CHUNK = 2, 4
WHOLE_CTAS_PER_SM = 4


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes; None for a missing operand."""
    return None if t is None else t.data_ptr()


@lru_cache(maxsize=16)
def pack_consts(consts) -> ctypes.Array:
    """The kernel's ``Consts`` struct: each constant formed in float64 and
    rounded once to float32, in the struct's field order."""
    s, ds, dt, delta, BND = consts
    vals = (list(s)
            + [BND[a][0] * s[a] for a in range(3)]
            + [BND[a][1] * s[a] for a in range(3)]
            + list(ds)
            + [2.0 / dt, 2.0 * (s[0] + s[1] + s[2])]
            + [2.0 / (dt * delta[a]) for a in range(3)]
            + [0.5 / (dt * delta[a]) for a in range(3)])
    return (ctypes.c_float * len(vals))(*vals)


def runs(lo, hi, chunk):
    """[lo, hi) cut into runs of at most ``chunk`` planes, of near-equal
    length."""
    m = hi - lo
    if m <= 0:
        return []
    k = -(-m // chunk)
    return [(lo + j * m // k, lo + (j + 1) * m // k) for j in range(k)]


@dataclass(frozen=True)
class WholePlan:
    """How the whole-plane kernel covers a grid: item j segments + t
    marches run j of segment t (columns 32 WHOLE_TY t .. 32 WHOLE_TY (t + 1)
    - 1 of the plane in row-major order); CTA b takes items b, b + ctas,
    ..."""

    runs: tuple     # ((z0, z1, conducting), ...): conducting runs first
    segments: int   # segments of 32 x WHOLE_TY columns of a plane
    ctas: int       # CTAs launched

    @property
    def items(self) -> int:
        return self.segments * len(self.runs)


def whole_plan(shape_zyx, cond_z, sms: int = 132) -> WholePlan:
    """The whole-plane kernel's cover of a grid of ``shape_zyx`` whose
    conducting cells lie on planes ``cond_z = (zb0, zb1)``, on a card of
    ``sms`` SMs.

    The conductor's planes are cut into runs of at most COND_CHUNK planes
    and listed first, so that the items that decode the case code start at
    once; the planes below and above it into runs of at most AIR_CHUNK,
    marked not conducting (no cell there has a code other than 0).  At most
    WHOLE_CTAS_PER_SM CTAs an SM take the items in turn, each finishing its
    dots once.  At team7 (102x102x24, conductor on planes 2..6) that is 41
    segments x (3 + 6) runs = 369 items, one CTA each on an H100."""
    nz, ny, nx = shape_zyx
    zb0, zb1 = cond_z
    if not 0 <= zb0 < zb1 <= nz:
        raise ValueError(f"conductor planes {cond_z} do not fit the grid's "
                         f"{nz}")
    air = runs(0, zb0, AIR_CHUNK) + runs(zb1, nz, AIR_CHUNK)
    table = (tuple((z0, z1, 1) for z0, z1 in runs(zb0, zb1, COND_CHUNK))
             + tuple((z0, z1, 0) for z0, z1 in air))
    segments = -(-(nx * ny) // (32 * WHOLE_TY))
    items = segments * len(table)
    return WholePlan(table, segments, min(items, WHOLE_CTAS_PER_SM * sms))


def cuda_only(name, t):
    """Raise unless ``t`` lies on a CUDA device (the wrappers send CPU
    tensors to the plain versions before they call this)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {t.device}")


def check_tensors(dev, checks):
    """Raise unless each ``(name, tensor, shape, dtype)`` of ``checks`` is
    a contiguous tensor of that shape and dtype on ``dev``."""
    for name, t, shape, dtype in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, A on {dev}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class CudaKernel:
    """What the wrappers of the hand-written kernels share: the library of
    ``csrc/<source>.cu``, built at first use; a check, once per device,
    that the card is Hopper and (for the coded kernels) that the library's
    ``Consts`` layout is :func:`pack_consts`'s; and ``launches``, the count
    of kernel launches."""

    source = ""         # csrc/<source>.cu
    consts_len = None   # the library's function giving len(Consts), if any

    def __init__(self):
        self.launches = 0
        counted(self)
        self._lib = None
        self._checked = set()     # devices whose arch was checked

    def _bind(self, lib):
        """Declare the argument and result types of ``lib``'s functions."""
        raise NotImplementedError

    def _library(self):
        if self._lib is None:
            lib = load_library(self.source)
            if self.consts_len:
                getattr(lib, self.consts_len).restype = ctypes.c_int
            self._bind(lib)
            self._lib = lib
        return self._lib

    def _ready(self, dev, consts=None):
        """(library, packed constants or None) for a launch on ``dev``."""
        lib = self._library()
        kc = pack_consts(consts) if consts is not None else None
        if dev not in self._checked:
            cap = torch.cuda.get_device_capability(dev)
            if cap != (9, 0):
                raise RuntimeError(
                    f"the {self.source} kernels are built for sm_90a (Hopper); "
                    f"{torch.cuda.get_device_name(dev)} is sm_{cap[0]}{cap[1]}")
            if kc is not None and len(kc) != getattr(lib, self.consts_len)():
                raise RuntimeError(f"csrc/{self.source}.cu Consts layout "
                                   "differs from pack_consts")
            self._checked.add(dev)
        return lib, kc

    def _raise_on(self, err):
        if err != 0:
            raise RuntimeError(f"{self.source} kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1


class MarchKernel(CudaKernel):
    """A wrapper of a march kernel (``csrc/coded_march.cuh``): its scratch,
    made once per operator, device and stream (or device program), and its
    resources."""

    info_fn = ""    # the library's function reporting a kernel's resources

    def __init__(self):
        super().__init__()
        self._scratch_of = weakref.WeakKeyDictionary()

    def _cover(self, op, dev):
        """(CTAs, its table of runs) of this wrapper's kernel over
        ``op``'s grid on ``dev``."""
        raise NotImplementedError

    def _scratch(self, op, dev):
        """(CTAs, partials, counter, run table) of ``op`` on ``dev`` for
        the current stream, or for the device program being warmed up or
        captured (``utils/graph.py`` :func:`program_scratch`, freed with
        its graph): made at its first launch there, the counter zeroed
        then and left zero by every launch, so graph replays find it zero
        too.  Launches on one stream (or in one graph) follow each other;
        launches on two streams use two sets, so one operator may run on
        both at once."""
        store = program_scratch()
        if store is None:
            store = self._scratch_of.setdefault(op, {})
            key = (dev, torch.cuda.current_stream(dev).cuda_stream)
        else:
            key = (self, op, dev)
        if key not in store:
            ctas, table = self._cover(op, dev)
            flat = torch.tensor(table, dtype=torch.int32).reshape(-1)
            store[key] = (ctas,
                          torch.empty((ctas, 2), dtype=torch.float32,
                                      device=dev),
                          torch.zeros(1, dtype=torch.int32, device=dev),
                          flat.to(dev))
        return store[key]

    def _info_args(self, mode, conv):
        return (mode, int(conv))

    def info(self, mode, conv=False, dev=None):
        """{registers, static/dynamic shared memory per CTA (bytes),
        resident CTAs per SM, local bytes per thread} of the kernel a launch
        in ``mode`` (0 apply, 1 with dots, 2 div) runs."""
        lib = self._library()
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev or torch.device("cuda")):
            err = getattr(lib, self.info_fn)(*self._info_args(mode, conv),
                                             out)
        if err != 0:
            raise RuntimeError(f"{self.info_fn} failed: CUDA error {err}")
        return dict(zip(("registers", "static_smem", "dynamic_smem",
                         "ctas_per_sm", "local_bytes"), out))


class _CodedMatvec(MarchKernel):
    source = "coded_matvec"
    consts_len = "coded_matvec_consts_len"
    info_fn = "coded_matvec_info"

    def _bind(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.coded_matvec_launch.argtypes = (
            [vp] * 10 + [ci] + [vp] * 3 + [ci] * 6
            + [ctypes.POINTER(ctypes.c_float), vp])
        lib.coded_matvec_launch.restype = ci
        lib.coded_matvec_info.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_int)]
        lib.coded_matvec_info.restype = ci

    def _cover(self, op, dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = whole_plan(op.shape_zyx, op.cond_z, sms)
        return plan.ctas, plan.runs

    def __call__(self, op, A: torch.Tensor, U: Optional[torch.Tensor] = None,
                 w: Optional[State] = None):
        """``U is None``: apply_div (returns yU).  ``w`` given: apply_dots
        (returns yA, yU, dot(y, w), dot(y, y)).  Otherwise apply (returns
        yA, yU)."""
        if U is None and w is not None:
            raise ValueError("apply_dots needs U")
        if A.device.type == "cpu":
            out = coded_apply_reference(A, U, op.code, op.cf, op.conv,
                                        op.consts, op.inertia_on_faces, w)
            return out[1] if U is None else out
        cuda_only("coded_matvec", A)
        return self._launch(op, A, U, w)

    def _launch(self, op, A, U, w):
        nz, ny, nx = op.shape_zyx
        if 3 * nz * ny * nx >= 2 ** 31:
            raise ValueError(f"grid {op.shape_zyx} too large for the kernel")
        mode = _DIV if U is None else (_APPLY if w is None else _DOTS)
        dev = A.device
        f32 = torch.float32
        checks = [("A", A, (3, nz, ny, nx), f32),
                  ("code", op.code, (nz, ny, nx), torch.int32),
                  ("cf", op.cf, (nz, ny, nx), f32)]
        if U is not None:
            checks.append(("U", U, (nz, ny, nx), f32))
        if op.conv is not None:
            checks.append(("conv", op.conv, (3, nz, ny, nx), f32))
        if w is not None:
            checks += [("w.A", w.A, (3, nz, ny, nx), f32),
                       ("w.U", w.U, (nz, ny, nx), f32)]
        check_tensors(dev, checks)
        lib, kc = self._ready(dev, op.consts)
        with torch.cuda.device(dev):
            ctas, parts, counter, table = self._scratch(op, dev)
            yA = torch.empty_like(A) if mode != _DIV else None
            yU = torch.empty((nz, ny, nx), dtype=f32, device=dev)
            dots = (torch.empty(2, dtype=f32, device=dev) if mode == _DOTS
                    else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.coded_matvec_launch(
                ptr(A), ptr(U), ptr(op.code), ptr(op.cf), ptr(op.conv),
                ptr(w.A if w is not None else None),
                ptr(w.U if w is not None else None),
                ptr(yA), ptr(yU), ptr(parts), ctas, ptr(counter), ptr(dots),
                ptr(table), len(table) // 3, nx, ny, nz, mode,
                int(op.inertia_on_faces), kc, stream)
        self._raise_on(err)
        if mode == _DIV:
            return yU
        if mode == _APPLY:
            return yA, yU
        return yA, yU, dots[0], dots[1]


coded_matvec = _CodedMatvec()
