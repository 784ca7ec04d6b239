"""Carry fit state and operands from the JAX package into the port.

Every function takes plain numpy arrays (``np.asarray`` of the JAX package's
device arrays), so this module imports no jax. Shapes and padding are kept
as given, so the port starts from exactly the W0 and operands the JAX
package used.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.parallel.sharded_ell import ShardedEllData
from singlet_tpu_torch.sparse.matrix import DenseMatrix


def _f32(x, device) -> torch.Tensor:
    """A float32 copy on ``device`` (numpy views of JAX arrays are
    read-only, so the port never shares their memory)."""
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def state_from_numpy(W, H, d, *, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The port's (W, H, d) float32 tensors on ``device`` from the JAX
    package's fit state: W (genes_pad, k), H (cells_pad, k), d (k,). For a
    ``FitResult`` pass ``(res.w, res.h.T, res.d)``."""
    device = resolve_device(device)
    return _f32(W, device), _f32(H, device), _f32(d, device)


def providers_from_numpy(A_data, At_data, nonempty_cells, nonempty_genes,
                         rows_true: int, cols_true: int, *, device=None
                         ) -> Tuple[DenseMatrix, DenseMatrix]:
    """The port's (A, At) ``DenseMatrix`` pair on ``device`` from the arrays
    of a JAX ``DenseMatrix`` pair: A_data (genes_pad, cells_pad), At_data
    its transpose, the two nonempty masks, and A's true genes and cells."""
    device = resolve_device(device)
    A = DenseMatrix(
        data=_f32(A_data, device),
        nonempty=torch.tensor(np.asarray(nonempty_cells, bool), device=device),
        rows_true=int(rows_true), cols_true=int(cols_true),
        cols_are_cells=True, block=np.shape(A_data)[1])
    At = DenseMatrix(
        data=_f32(At_data, device),
        nonempty=torch.tensor(np.asarray(nonempty_genes, bool), device=device),
        rows_true=int(cols_true), cols_true=int(rows_true),
        cols_are_cells=False, block=np.shape(At_data)[1],
        mask_cache=A.mask_cache)
    return A, At


def ell_data_from_numpy(b_li, b_val, nonempty, gene_nonempty, geometry, *,
                        device=None) -> ShardedEllData:
    """The port's ``ShardedEllData`` on ``device`` from the arrays of a JAX
    ``ShardedEllData`` (its 2-D planes ``b_li`` int32 / ``b_val`` float32,
    ``nonempty``, ``gene_nonempty``), so that both packages compute on the
    same planes. ``geometry`` maps ``genes_true``, ``cells_true``,
    ``genes_pad``, ``cells_pad``, ``cell_block`` and ``gene_block`` to the
    JAX data's values."""
    device = resolve_device(device)
    g = {key: int(geometry[key]) for key in (
        "genes_true", "cells_true", "genes_pad", "cells_pad", "cell_block",
        "gene_block")}
    b_li = np.asarray(b_li, np.int32)
    n_gb = g["genes_pad"] // g["gene_block"]
    return ShardedEllData(
        b_li=torch.tensor(b_li, device=device),
        b_val=torch.tensor(np.asarray(b_val, np.float32), device=device),
        b_width=b_li.shape[0] // n_gb,
        nonempty=torch.tensor(np.asarray(nonempty, bool), device=device),
        gene_nonempty=torch.tensor(np.asarray(gene_nonempty, bool),
                                   device=device),
        device=device, **g)
