"""Host-side packing of a CSC matrix into blocked-ELL planes.

Port of the numpy path of ``singlet_tpu/native/__init__.py``
``csc_to_bell``. The JAX package's C++ packer (``libsinglet_io``) and its
SVC readers serve the chunk-list and staged-directory ingest, which the
port does not have yet (ROADMAP A.2, streaming ingest); the numpy path packs the same planes
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def csc_to_bell(A: sp.csc_matrix, cols_pad: int, gene_block: int,
                n_gb: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSC -> gb-major blocked-ELL planes, shape (n_gb, cols_pad, width):
    local gene indices (pad -1) and values (pad 0) at one uniform width.
    Raises ValueError if ``width`` under-counts any (column, gene-block)
    run: silent truncation would corrupt the operand. ``A`` is never
    mutated (indices are sorted on a copy)."""
    A = sp.csc_matrix(A)
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    cols = A.shape[1]
    li = np.full((n_gb, cols_pad, width), -1, np.int32)
    lv = np.zeros((n_gb, cols_pad, width), np.float32)
    if A.nnz:
        nnz_col = np.diff(A.indptr)
        gb_of = A.indices.astype(np.int64) // gene_block
        col_of = np.repeat(np.arange(cols, dtype=np.int64), nnz_col)
        pos = np.arange(A.nnz, dtype=np.int64) - np.repeat(
            A.indptr[:-1].astype(np.int64), nnz_col)
        # rank within the (col, gb) run: runs are contiguous because CSC
        # row indices are sorted within a column
        new_run = np.ones(A.nnz, bool)
        new_run[1:] = (col_of[1:] != col_of[:-1]) | (gb_of[1:] != gb_of[:-1])
        run_id = np.cumsum(new_run) - 1
        rank = pos - pos[new_run][run_id]
        over = int(np.sum(rank >= width))
        if over:
            raise ValueError(
                f"csc_to_bell: plane width {width} under-counts a "
                f"(column, gene-block) run; {over} nonzeros would be dropped")
        li[gb_of, col_of, rank] = (A.indices - gb_of * gene_block).astype(
            np.int32)
        lv[gb_of, col_of, rank] = A.data.astype(np.float32)
    return li, lv
