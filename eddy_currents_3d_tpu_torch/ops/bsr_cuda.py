"""Block-sparse SpMM through the hand-written CUDA kernel.

The PyTorch counterpart of ``eddy_currents_3d_tpu/ops/pallas_sparse.py``.
The kernel (``csrc/bsr_spmm.cu``) replaces the TPU kernel ``_kernel``
(``pallas_sparse.py:39``, launched at ``:73``): ``A @ X`` for a padded
block-ELL :class:`~.sparse.BSRMatrix` and a dense ``X`` (n_cols, k), float32
or float64, summed in the blocks' type.  At k = 1 it is bound by the
blocks' bytes, at k = 128 by FP32 FMAs (see the source note).

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

__all__ = ["bsr_spmm", "bsr_matvec", "bsr_spmm_reference"]

_DTYPES = (torch.float32, torch.float64)


def bsr_spmm_reference(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``bsr_spmm``: gather + einsum."""
    return a.matmat(x)


class _BsrSpmm(CudaKernel):
    source = "bsr_spmm"

    def _bind(self, lib):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bsr_spmm_launch.argtypes = [vp, vp, vp, vp, ci, cll, ci, ci, ci,
                                        cll, vp]
        lib.bsr_spmm_launch.restype = ci
        lib.bsr_spmm_route.argtypes = [ci, ci, cll]
        lib.bsr_spmm_route.restype = ci

    def route(self, block_shape, k: int) -> str:
        """The kernel's thread mapping for (R, C) blocks and k columns:
        ``"warp"`` or ``"lanes"`` (see the source note)."""
        R, C = block_shape
        return ("warp", "lanes")[self._library().bsr_spmm_route(R, C, k)]

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
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bsr_spmm_launch(ptr(a.block_cols), ptr(a.blocks), ptr(x),
                                      ptr(y), int(dtype == torch.float64), nbr,
                                      width, R, C, k, stream)
        self._raise_on(err)
        return y


bsr_spmm = _BsrSpmm()


def bsr_matvec(a: BSRMatrix, x: torch.Tensor, lane_pad: int = 128) -> torch.Tensor:
    """``A @ x`` for a vector: column 0 of JAX's lane-padded SpMM, computed
    at k = 1."""
    if lane_pad < 1:
        raise ValueError(f"lane_pad must be >= 1, got {lane_pad}")
    return bsr_spmm(a, x[:, None])[:, 0]
