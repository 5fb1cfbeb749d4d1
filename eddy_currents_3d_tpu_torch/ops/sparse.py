"""General sparse containers (CSR / COO / ELL / BSR) and SpGEMM on tensors.

The PyTorch counterpart of ``eddy_currents_3d_tpu/ops/sparse.py``.  The
simulation's operators are stencils (``assembly/stencil.py``,
``ops/coded.py``, ``ops/field.py``); this is the general tier: unstructured
matrices for interop, tests and the global matrix that
``assembly.assemble.to_csr`` exports.  The CSR product has the semantics of
the reference's ``sprsAx`` (solvers.f90:54-61).

The containers are frozen dataclasses of tensors with the JAX package's
fields and methods.  Where JAX sums with ``segment_sum`` the port uses
``index_add_``, and ``x[cols]`` is a plain gather: both are XLA ops there,
so plain torch here.  On CUDA ``index_add_`` adds with atomics, so the CSR,
COO and SpGEMM sums change order from run to run (last-bit differences).

``BSRMatrix.matmat`` (gather + einsum, as JAX leaves it to XLA) is also the
plain version of the block-sparse SpMM kernel (``csrc/bsr_spmm.cu``, wrapper
``ops/bsr_cuda.py``).

Every function that makes tensors places them on the ``device`` it is
given; None means the CUDA device (``utils/device.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "CSRMatrix", "COOMatrix", "ELLMatrix", "BSRMatrix",
    "from_scipy", "bsr_from_scipy", "spgemm", "spgemm_plan", "SpGEMMPlan",
]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add_(0, seg, vals)


@dataclass(frozen=True)
class COOMatrix:
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _segment_sum(self.vals * x[self.cols], self.rows, self.shape[0])

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """SpMM: ``A @ X`` for dense ``X`` of shape (n, k)."""
        return _segment_sum(self.vals[:, None] * x[self.cols], self.rows,
                            self.shape[0])

    def todense(self) -> torch.Tensor:
        out = self.vals.new_zeros(self.shape)
        return out.index_put_((self.rows.long(), self.cols.long()), self.vals,
                              accumulate=True)


@dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse row; ``indptr`` (n+1,), ``cols``/``vals`` (nnz,)."""

    indptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.cols.shape[0]

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def row_ids(self) -> torch.Tensor:
        """The row index of every stored entry."""
        n = self.shape[0]
        rows = torch.arange(n, dtype=torch.int32, device=self.cols.device)
        return torch.repeat_interleave(rows, self.row_lengths().long(),
                                       output_size=self.nnz)

    def to_coo(self) -> COOMatrix:
        return COOMatrix(rows=self.row_ids(), cols=self.cols, vals=self.vals,
                         shape=self.shape)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y[i] = sum_j vals[indptr[i]:indptr[i+1]] * x[cols[...]]
        (sprsAx semantics, solvers.f90:57-60)."""
        return _segment_sum(self.vals * x[self.cols], self.row_ids(),
                            self.shape[0])

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """SpMM: ``A @ X`` for dense ``X`` of shape (n, k)."""
        return _segment_sum(self.vals[:, None] * x[self.cols], self.row_ids(),
                            self.shape[0])

    def diagonal(self) -> torch.Tensor:
        """Main diagonal (rows with no stored diagonal contribute 0)."""
        rows = self.row_ids()
        hit = self.cols == rows
        return _segment_sum(torch.where(hit, self.vals, 0.0), rows,
                            self.shape[0])

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def to_ell(self, width: int | None = None) -> "ELLMatrix":
        indptr = _host(self.indptr).astype(np.int64)
        lens = np.diff(indptr)
        longest = int(lens.max(initial=0))
        w = longest if width is None else width
        if w < longest:
            raise ValueError(f"to_ell: width {w} < longest row {longest}")
        n = self.shape[0]
        dev = self.vals.device
        r = torch.from_numpy(np.repeat(np.arange(n), lens)).to(dev)
        s = torch.from_numpy(np.arange(self.nnz)
                             - np.repeat(indptr[:-1], lens)).to(dev)
        ecols = self.cols.new_zeros((n, w))
        evals = self.vals.new_zeros((n, w))
        ecols[r, s] = self.cols
        evals[r, s] = self.vals
        return ELLMatrix(cols=ecols, vals=evals, shape=self.shape)


@dataclass(frozen=True)
class ELLMatrix:
    """Padded fixed-width rows: cols/vals are (n, width); padding has
    val == 0 (its column index is arbitrary but in range)."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.vals * x[self.cols], dim=1)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """SpMM: ``A @ X`` for dense ``X`` of shape (n, k)."""
        return torch.sum(self.vals[..., None] * x[self.cols], dim=1)


@dataclass(frozen=True)
class BSRMatrix:
    """Block sparse row with padded fixed-width block rows ("block-ELL").

    Each block row holds ``width`` slots of dense (R, C) blocks; padding
    slots carry ``block_cols == 0`` and an all-zero block.

    * ``block_cols``: (nbr, width) int32 block-column index per slot
    * ``blocks``:     (nbr, width, R, C) dense block values
    * ``shape``:      logical (nbr*R, nbc*C) element shape
    """

    block_cols: torch.Tensor
    blocks: torch.Tensor
    shape: tuple

    @property
    def block_shape(self) -> tuple:
        return tuple(self.blocks.shape[2:])

    @property
    def nnz(self) -> int:
        """Stored entries incl. padding (dense storage of each block)."""
        return self.blocks.numel()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat(x[:, None])[:, 0]

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for dense ``X`` (n, k): gather the x-blocks of every
        slot, then contract each (R, C) block with its (C, k) x-block and
        sum the slots.  The plain version of ``bsr_cuda.bsr_spmm``."""
        nbr, w, R, C = self.blocks.shape
        xb = x.reshape(-1, C, x.shape[1])           # (nbc, C, k)
        gx = xb[self.block_cols]                    # (nbr, w, C, k)
        y = torch.einsum("rwij,rwjk->rik", self.blocks, gx)
        return y.reshape(nbr * R, x.shape[1])

    def todense(self) -> torch.Tensor:
        nbr, w, R, C = self.blocks.shape
        n, m = self.shape
        out = self.blocks.new_zeros((nbr, m // C, R, C))
        rows = torch.arange(nbr, device=self.blocks.device)[:, None].expand(
            nbr, w)
        out.index_put_((rows, self.block_cols.long()), self.blocks,
                       accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(n, m)


def bsr_from_scipy(m, block_shape=(8, 8), dtype=torch.float32,
                   device=None) -> BSRMatrix:
    """Convert any scipy matrix to padded block-ELL BSR (host-side, once).

    The element grid is zero-padded up to block multiples; every block row
    is padded to the maximum block-row width.  The same scipy steps as the
    JAX package's, with the per-row copy vectorised: ``block_cols`` and
    ``blocks`` equal JAX's bit for bit."""
    import scipy.sparse as sp

    R, C = block_shape
    n, mcols = m.shape
    npad, mpad = -(-n // R) * R, -(-mcols // C) * C
    mb = sp.csr_matrix(m)
    mb.resize((npad, mpad))
    b = mb.tobsr(blocksize=(R, C))
    nbr = npad // R
    lens = np.diff(b.indptr)
    w = max(int(lens.max()) if nbr else 0, 1)
    rows = np.repeat(np.arange(nbr), lens)
    slot = np.arange(len(b.indices)) - np.repeat(b.indptr[:-1], lens)
    bcols = np.zeros((nbr, w), np.int32)
    blocks = np.zeros((nbr, w, R, C), np.asarray(b.data).dtype)
    bcols[rows, slot] = b.indices
    blocks[rows, slot] = b.data
    dev = resolve_device(device)
    return BSRMatrix(block_cols=torch.from_numpy(bcols).to(dev),
                     blocks=torch.from_numpy(blocks).to(dev, dtype),
                     shape=(npad, mpad))


# ---------------------------------------------------------------------------
# SpGEMM: C = A @ B for CSR A, B.
#
# Two phases, as in the JAX package: the symbolic phase (output structure and
# the multiset of scalar products feeding each output entry) runs on the host
# once; the numeric phase is a gather + index_add_ on the device, reused
# while the values change and the structure does not.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpGEMMPlan:
    """Static product structure for ``C = A @ B``.

    ``a_idx``/``b_idx`` (npairs,): for each elementary product, the index
    into A.vals / B.vals.  ``out_idx`` (npairs,): the output nnz slot the
    product accumulates into.  ``indptr``/``cols``: the CSR structure of C.
    """

    a_idx: torch.Tensor
    b_idx: torch.Tensor
    out_idx: torch.Tensor
    indptr: torch.Tensor
    cols: torch.Tensor
    shape: tuple

    def numeric(self, a_vals: torch.Tensor, b_vals: torch.Tensor) -> CSRMatrix:
        """Device phase: values of C from values of A and B."""
        prod = a_vals[self.a_idx] * b_vals[self.b_idx]
        vals = _segment_sum(prod, self.out_idx, self.cols.shape[0])
        return CSRMatrix(indptr=self.indptr, cols=self.cols, vals=vals,
                         shape=self.shape)


def spgemm_plan(a: CSRMatrix, b: CSRMatrix, device=None) -> SpGEMMPlan:
    """Host symbolic phase (run once per structure).  The plan's tensors go
    to ``device``, by default A's."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {a.shape} @ {b.shape}")
    a_indptr = _host(a.indptr).astype(np.int64)
    a_cols = _host(a.cols)
    b_indptr = _host(b.indptr).astype(np.int64)
    b_cols = _host(b.cols)
    n = a.shape[0]

    # elementary products: for A entry t in row i with column j, pair with
    # every B entry of row j
    a_row = np.repeat(np.arange(n), np.diff(a_indptr))
    seg = b_indptr[a_cols + 1] - b_indptr[a_cols]          # products per A entry
    a_idx = np.repeat(np.arange(a_cols.shape[0]), seg)
    # b indices: for each A entry, the contiguous run b_indptr[j] ...
    starts = np.repeat(b_indptr[a_cols], seg)
    within = np.arange(seg.sum()) - np.repeat(np.cumsum(seg) - seg, seg)
    b_idx = starts + within
    out_row = np.repeat(a_row, seg)
    out_col = b_cols[b_idx]

    # dedupe (row, col) -> output slot, CSR-ordered
    key = out_row.astype(np.int64) * b.shape[1] + out_col
    uniq, out_idx = np.unique(key, return_inverse=True)
    c_rows = (uniq // b.shape[1]).astype(np.int64)
    c_cols = (uniq % b.shape[1]).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr, c_rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)

    dev = a.vals.device if device is None else torch.device(device)
    t = lambda arr: torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(dev)
    return SpGEMMPlan(a_idx=t(a_idx), b_idx=t(b_idx), out_idx=t(out_idx),
                      indptr=t(indptr), cols=t(c_cols),
                      shape=(a.shape[0], b.shape[1]))


def spgemm(a: CSRMatrix, b: CSRMatrix) -> CSRMatrix:
    """One-shot ``A @ B`` (symbolic on host + numeric on A's device)."""
    return spgemm_plan(a, b).numeric(a.vals, b.vals)


def from_scipy(m, dtype=torch.float32, device=None) -> CSRMatrix:
    m = m.tocsr()
    dev = resolve_device(device)
    i32 = lambda arr: torch.from_numpy(np.asarray(arr, np.int32)).to(dev)
    return CSRMatrix(indptr=i32(m.indptr), cols=i32(m.indices),
                     vals=torch.from_numpy(np.asarray(m.data)).to(dev, dtype),
                     shape=tuple(m.shape))
