"""Matrix providers: the storage layer the solvers compute against.

Port of ``singlet_tpu/sparse/matrix.py`` ``DenseMatrix``: the operand held
densified on the fit's device, rows x cols, zero-padded, with

  * ``t_matmul(X)`` -> P^T @ X                       (cols, k)
  * ``nonempty``    -> bool (cols,) columns with any nonzero
  * padding bookkeeping: true row/col counts vs padded shapes.

  * ``mask_tile(seed, ...)`` -> the cross-validation test mask of a column
    block, from the counter RNG (``ops/rngmask.py``).

A is (genes x cells) -> ``cols_are_cells=True``; its transpose At is
(cells x genes) -> ``cols_are_cells=False``.

The JAX package recomputes the mask at every access, because XLA fuses the
hash into the consuming product. Eager PyTorch does not fuse it: the hash
is some 50 elementwise int64 passes per entry. So the port builds the whole
(cells_pad, genes_pad) bool mask once per (seed, inv_density) and serves
every tile of every block, iteration and fit of one search replicate from
it. A and At of one operand share the cache (``mask_cache``), which holds
one mask: cells_pad x genes_pad bytes on the operand's device. The answers
are those of the recomputed mask, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.ops.rngmask import mask_block

# entries of the int64 hash temporaries per chunk of the mask build
_MASK_CHUNK = 1 << 24


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class DenseMatrix:
    """Dense (possibly zero-padded) operand, rows x cols, on one device."""

    data: torch.Tensor               # (rows_pad, cols_pad)
    nonempty: torch.Tensor           # bool (cols_pad,), False for padding
    rows_true: int
    cols_true: int
    cols_are_cells: bool
    # column-block size for masked/blocked updates; divides data.shape[1]
    block: int = 0
    # the test mask of the last (seed, inv_density), shared by A and At
    mask_cache: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- factory
    @classmethod
    def from_array(cls, arr, cols_are_cells: bool = True,
                   pad_rows: int = 8, pad_cols: int = 8,
                   dtype=torch.float32, device=None) -> "DenseMatrix":
        """Provider of a rows x cols array, zero-padded to multiples of
        ``pad_rows`` / ``pad_cols``, on ``device`` (default ``"cuda"``)."""
        device = resolve_device(device)
        arr = np.asarray(arr)
        rows, cols = arr.shape
        rp, cp = _round_up(rows, pad_rows), _round_up(cols, pad_cols)
        buf = np.zeros((rp, cp), dtype=np.float32)
        buf[:rows, :cols] = arr
        nonempty = np.zeros((cp,), dtype=bool)
        nonempty[:cols] = (np.abs(arr) > 0).any(axis=0)
        return cls(
            data=torch.as_tensor(buf, dtype=dtype, device=device),
            nonempty=torch.as_tensor(nonempty, device=device),
            rows_true=rows,
            cols_true=cols,
            cols_are_cells=cols_are_cells,
            block=cp,
        )

    @classmethod
    def pair_from_array(cls, arr, **kw) -> Tuple["DenseMatrix", "DenseMatrix"]:
        """(A, At) providers from a genes x cells array."""
        arr = np.asarray(arr)
        A = cls.from_array(arr, cols_are_cells=True, **kw)
        At = cls.from_array(arr.T, cols_are_cells=False, **kw)
        At.mask_cache = A.mask_cache
        return A, At

    # ----------------------------------------------------------- geometry
    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def rows_pad(self) -> int:
        return self.data.shape[0]

    @property
    def cols_pad(self) -> int:
        return self.data.shape[1]

    @property
    def n_cells(self) -> int:
        return self.cols_true if self.cols_are_cells else self.rows_true

    @property
    def n_genes(self) -> int:
        return self.rows_true if self.cols_are_cells else self.cols_true

    @property
    def device(self) -> torch.device:
        return self.data.device

    # ----------------------------------------------------------- products
    def t_matmul(self, X: torch.Tensor) -> torch.Tensor:
        """P^T @ X: the b-vector gather of the reference's ``predict``
        (reference:src/singlet.cpp:333-347) as one full-f32 matmul."""
        return self.data.T @ X

    def col_block(self, col_start: int, col_block: int) -> torch.Tensor:
        """(rows_pad, col_block) slice of the operand."""
        return self.data[:, col_start:col_start + col_block]

    # ------------------------------------------------------------ masking
    def test_mask(self, seed: torch.Tensor, inv_density: int) -> torch.Tensor:
        """The whole test mask, bool (cells_pad, genes_pad), keyed (cell,
        gene); True = held out. Padding is never masked, so it adds nothing
        to Gram corrections or test counts. Built on the operand's device
        at the first call for (seed, inv_density), then cached."""
        if self.cols_are_cells:
            cells, genes = self.cols_pad, self.rows_pad
            cells_true, genes_true = self.cols_true, self.rows_true
        else:
            cells, genes = self.rows_pad, self.cols_pad
            cells_true, genes_true = self.rows_true, self.cols_true
        key = (int(seed[0]), int(seed[1]), int(inv_density), cells, genes,
               cells_true, genes_true)
        if key not in self.mask_cache:
            self.mask_cache.clear()
            dev = self.device
            full = torch.zeros((cells, genes), dtype=torch.bool, device=dev)
            gene_ids = torch.arange(genes_true, device=dev)
            chunk = max(1, _MASK_CHUNK // max(genes_true, 1))
            for c0 in range(0, cells_true, chunk):
                c1 = min(c0 + chunk, cells_true)
                full[c0:c1, :genes_true] = mask_block(
                    seed, torch.arange(c0, c1, device=dev), gene_ids,
                    inv_density)
            self.mask_cache[key] = full
        return self.mask_cache[key]

    def mask_tile(self, seed: torch.Tensor, col_start: int, col_block: int,
                  inv_density: int) -> torch.Tensor:
        """Test-set mask of a column block, bool (col_block, rows_pad): a
        view of :meth:`test_mask`. True = held out; padding never is."""
        full = self.test_mask(seed, inv_density)
        if self.cols_are_cells:
            return full[col_start:col_start + col_block]
        return full[:, col_start:col_start + col_block].T
