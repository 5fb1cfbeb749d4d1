"""Block-sparse SpMM through the hand-written CUDA kernel.

The PyTorch counterpart of ``eddy_currents_3d_tpu/ops/pallas_sparse.py``.
The kernel (``csrc/bsr_spmm.cu``) replaces the TPU kernel ``_kernel``
(``pallas_sparse.py:39``, launched at ``:73``): ``A @ X`` for a padded
block-ELL :class:`~.sparse.BSRMatrix` and a dense ``X`` (n_cols, k), float32
or float64, summed in the blocks' type.  At k = 1 it is bound by the
blocks' bytes, at k = 128 by FMAs (see the source note).  Four thread
mappings serve it; :func:`spmm_route` picks one from the shape, k, the
dtype, the block-row width and the operands' alignment, and the launch
refuses a route that does not fit.

* :data:`bsr_spmm` takes ``(a, x)``; a CPU tensor goes to the plain version
  :func:`bsr_spmm_reference` (``a.matmat(x)``), a CUDA tensor launches the
  kernel or raises (a dtype, shape or layout it does not take, a card that
  is not Hopper, a missing ``nvcc`` or a failed build).  ``launches`` counts
  its kernel's launches, and only those.
* :func:`bsr_matvec` keeps the JAX signature.  JAX pads the vector to a
  lane-aligned (n, lane_pad) SpMM and keeps column 0; that padding is TPU
  layout, so the port computes the same column at k = 1.
"""

from __future__ import annotations

import ctypes

import torch

from .coded_cuda import CudaKernel, check_tensors, cuda_only, ptr
from .sparse import BSRMatrix

__all__ = ["bsr_spmm", "bsr_matvec", "bsr_spmm_reference", "spmm_route",
           "tiles_smem"]

_DTYPES = (torch.float32, torch.float64)
_ROUTES = ("warp", "lanes", "vec", "tiles")

# The tiles route's CTA, as csrc/bsr_spmm.cu has it: TILE_ROWS block rows
# (kTileRows), TILE_CHUNK columns (kChunk), at most TILE_ROWS_MAX rows a
# block (kTR), TILE_STAGES windows of x blocks (kStages), within SMEM_MAX
# bytes of shared memory (kSmemMax less the kernel's static kStaticSmem).
TILE_ROWS = 4
TILE_CHUNK = 128
TILE_ROWS_MAX = 8
TILE_STAGES = 2
SMEM_MAX = 227 * 1024 - 256
# Where tiles beat lanes (split_bench.py --spmm-sweep, PERF.md): block rows
# of at most TILES_WIDTH slots from k = 32, and of at most
# TILES_WIDTH_FULL where a CTA's chunk of TILE_CHUNK columns is full.  A
# CTA's set-up grows as the square of the width and its shared memory
# with it, while lanes' cost does not depend on the width.
TILES_WIDTH = 50
TILES_WIDTH_FULL = 100


def tiles_smem(width: int, block_shape, k: int, itemsize: int = 4) -> int:
    """The least shared memory, in bytes, of a tiles-route CTA over block
    rows of ``width`` slots: csrc/bsr_spmm.cu ``tiles_shape`` at one x
    block a window (4 ints and one block a slot of the group, and
    TILE_STAGES x blocks)."""
    R, C = block_shape
    n = TILE_ROWS * width
    xb = C * min(k, TILE_CHUNK) * itemsize
    return 16 * n + n * R * C * itemsize + TILE_STAGES * xb


def spmm_route(block_shape, k: int, itemsize: int = 4,
               aligned: bool = True, width: int = 1) -> str:
    """The kernel's thread mapping for block rows of ``width`` (R, C)
    blocks of ``itemsize``-byte values and k columns (see the source
    note):

    * ``"vec"``: k = 1 with 16-byte vector loads, where blocks, x and y are
      16-byte aligned (``aligned``), C is a multiple of the vector's
      16 / itemsize values and a block's vectors divide 32;
    * ``"warp"``: otherwise k < 32 with C a power of two <= 32 and
      R * C <= 256;
    * ``"tiles"``: k >= 32 where rows of x and of a block are whole 16-byte
      vectors (k and C times itemsize multiples of 16), R <= 8, R * C <=
      256, the operands 16-byte aligned, a CTA's shared memory
      (:func:`tiles_smem`) within the SM's and the block row at most
      TILES_WIDTH slots wide (TILES_WIDTH_FULL at k >= TILE_CHUNK);
    * ``"lanes"``: everything else: ragged k, unaligned views, large
      blocks, wide block rows."""
    R, C = block_shape
    vl = 16 // itemsize
    p = R * (C // vl)
    if k == 1 and aligned and C % vl == 0 and 0 < p <= 32 and 32 % p == 0:
        return "vec"
    if k < 32 and 0 < C <= 32 and C & (C - 1) == 0 and R * C <= 256:
        return "warp"
    wide = TILES_WIDTH_FULL if k >= TILE_CHUNK else TILES_WIDTH
    if (k >= 32 and aligned and k * itemsize % 16 == 0
            and C * itemsize % 16 == 0 and R <= TILE_ROWS_MAX
            and R * C <= 256 and width <= wide
            and tiles_smem(width, block_shape, k, itemsize) <= SMEM_MAX):
        return "tiles"
    return "lanes"


def bsr_spmm_reference(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``bsr_spmm``: gather + einsum."""
    return a.matmat(x)


class _BsrSpmm(CudaKernel):
    source = "bsr_spmm"

    def _bind(self, lib):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bsr_spmm_launch.argtypes = [vp, vp, vp, vp, ci, cll, ci, ci, ci,
                                        cll, ci, vp]
        lib.bsr_spmm_launch.restype = ci
        lib.bsr_tiles_info.argtypes = [ci, ci, ci, ci, cll,
                                       ctypes.POINTER(ci)]
        lib.bsr_tiles_info.restype = ci

    def tiles_info(self, width: int, block_shape, k: int,
                   dtype=torch.float32, dev=None) -> dict:
        """{registers, ctas_per_sm, smem_bytes, threads, window_blocks} of
        the tiles route's kernel for block rows of ``width`` blocks of
        ``block_shape`` and k columns."""
        lib = self._library()
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev or torch.device("cuda")):
            err = lib.bsr_tiles_info(int(dtype == torch.float64), width,
                                     *block_shape, k, out)
        if err != 0:
            raise RuntimeError(f"bsr_tiles_info failed: CUDA error {err}")
        return dict(zip(("registers", "ctas_per_sm", "smem_bytes",
                         "threads", "window_blocks"), out))

    @staticmethod
    def route(block_shape, k: int, dtype=torch.float32,
              aligned: bool = True, width: int = 1) -> str:
        """The thread mapping a launch takes (:func:`spmm_route`)."""
        return spmm_route(block_shape, k, dtype.itemsize, aligned, width)

    def __call__(self, a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for dense ``X`` of shape (n_cols, k)."""
        nbr, width, R, C = a.blocks.shape
        n, m = a.shape
        if x.dim() != 2 or x.shape[0] != m:
            raise ValueError(f"bsr_spmm: A is {a.shape}, x has shape "
                             f"{tuple(x.shape)}")
        if x.device.type == "cpu":
            return bsr_spmm_reference(a, x)
        cuda_only("bsr_spmm", x)
        if n != nbr * R or m % C:
            raise ValueError(f"bsr_spmm: shape {a.shape} is not a whole number "
                             f"of {(R, C)} blocks over {nbr} block rows")
        dtype = a.blocks.dtype
        if dtype not in _DTYPES:
            raise ValueError(f"blocks must be float32 or float64 on CUDA, "
                             f"got {dtype}")
        k = x.shape[1]
        dev = x.device
        check_tensors(dev, [("block_cols", a.block_cols, (nbr, width),
                             torch.int32),
                            ("blocks", a.blocks, (nbr, width, R, C), dtype),
                            ("x", x, (m, k), dtype)])
        lib, _ = self._ready(dev)
        y = torch.empty((n, k), dtype=dtype, device=dev)
        aligned = all(t.data_ptr() % 16 == 0 for t in (a.blocks, x, y))
        route = self.route((R, C), k, dtype, aligned, width)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bsr_spmm_launch(ptr(a.block_cols), ptr(a.blocks), ptr(x),
                                      ptr(y), int(dtype == torch.float64), nbr,
                                      width, R, C, k, _ROUTES.index(route),
                                      stream)
        self._raise_on(err)
        return y


bsr_spmm = _BsrSpmm()


def bsr_matvec(a: BSRMatrix, x: torch.Tensor, lane_pad: int = 128) -> torch.Tensor:
    """``A @ x`` for a vector: column 0 of JAX's lane-padded SpMM, computed
    at k = 1."""
    if lane_pad < 1:
        raise ValueError(f"lane_pad must be >= 1, got {lane_pad}")
    return bsr_spmm(a, x[:, None])[:, 0]
