"""Dense helpers: Gram matrix, column rescale, convergence metric, and the
packed per-column Grams of the masked fit.

Port of ``singlet_tpu/ops/linalg.py`` (``gram``, ``scale_columns``,
``cor_distance``, ``triu_pairs``, ``packed_outer_products``, the three
``unpack_sym*`` and ``mask_dot_t``). These are dense ops that XLA ran on the
TPU; no Pallas kernel stood behind them on the dense path, so they stay
plain PyTorch. Float32 products run at full precision
(``device.set_precision_policy``), and so does ``mask_dot_t``: that is what
the JAX package computes on the CPU and under
``SINGLET_TPU_MASK_MM_PRECISION=highest``. Its TPU default for the dense
path (single-pass bf16 with an f32 output) has no torch equivalent, since a
bf16 ``torch.matmul`` rounds its output to bf16. ``triu_pairs_on`` keeps
``triu_pairs``'s index tables on the device, once per (k, device).

Layouts as in the JAX package: W (genes, k), H (cells, k).

``mask_mm_precision`` is the JAX package's ``MASK_MM_PRECISION`` choice,
read from ``SINGLET_TPU_MASK_MM_PRECISION`` when a fit is built, not at
import. At "default" the ELL engine on the card takes its bit-packed
int8/bf16 route (``parallel/sharded_ell.py``); "high" and "highest" keep
the f32 products.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_MASK_MM_PRECISIONS = {"default": "default", "": "default", "high": "high",
                       "highest": "highest"}


def mask_mm_precision() -> str:
    """"default", "high" or "highest", from
    ``SINGLET_TPU_MASK_MM_PRECISION`` (unset or empty: "default"). An unknown
    value raises, as the JAX package's table lookup does."""
    raw = os.environ.get("SINGLET_TPU_MASK_MM_PRECISION", "").lower()
    if raw not in _MASK_MM_PRECISIONS:
        raise ValueError(f"SINGLET_TPU_MASK_MM_PRECISION={raw!r}: expected "
                         "one of default, high, highest")
    return _MASK_MM_PRECISIONS[raw]


def gram(X: torch.Tensor) -> torch.Tensor:
    """X^T X with 1e-15 diagonal jitter (an all-zero factor then gives
    ``1/diag = 1e15`` in the CD solve, not ``inf``)."""
    a = X.T @ X
    return a + 1e-15 * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def scale_columns(X: torch.Tensor):
    """Normalize columns of X to sum to one; return (X_normalized, d) with
    d the pre-normalization column sums + 1e-15."""
    d = X.sum(dim=0) + 1e-15
    return X / d[None, :], d


def cor_distance(x: torch.Tensor, y: torch.Tensor,
                 n_true=None) -> torch.Tensor:
    """1 - Pearson correlation over all entries of two equally-shaped
    matrices, from the five sums. ``n_true`` overrides the element count
    when x/y carry zero padding columns."""
    xf = x.reshape(-1)
    yf = y.reshape(-1)
    n = xf.shape[0] if n_true is None else n_true
    sum_x = xf.sum()
    sum_y = yf.sum()
    sum_xy = torch.dot(xf, yf)
    sum_x2 = torch.dot(xf, xf)
    sum_y2 = torch.dot(yf, yf)
    denom = torch.sqrt((n * sum_x2 - sum_x * sum_x)
                       * (n * sum_y2 - sum_y * sum_y))
    return 1.0 - (n * sum_xy - sum_x * sum_y) / denom


def triu_pairs(k: int):
    """Static upper-triangle index pair (i, j) arrays for k x k, i <= j."""
    return np.triu_indices(k)


_PAIRS_ON: dict = {}


def triu_pairs_on(k: int, device):
    """``triu_pairs(k)`` as int64 tensors on ``device``, copied once per
    (k, device) and reused: a copy from pageable host memory at each call
    would stop the host until the device has drained its queue."""
    key = (int(k), str(torch.device(device)))
    if key not in _PAIRS_ON:
        _PAIRS_ON[key] = tuple(torch.as_tensor(x, device=device)
                               for x in triu_pairs(k))
    return _PAIRS_ON[key]


def _sym_pos(k: int, iu) -> np.ndarray:
    """(k, k) map from matrix position to packed-triangle index."""
    npairs = iu[0].shape[0]
    pos = np.zeros((k, k), np.int64)
    ar = np.arange(npairs, dtype=np.int64)
    pos[iu[0], iu[1]] = ar
    pos[iu[1], iu[0]] = ar
    return pos


def packed_outer_products(X: torch.Tensor, iu) -> torch.Tensor:
    """Columns of all pairwise products X[:, i] * X[:, j] for i <= j.

    For a 0/1 mask tile M (cols x rows) the per-column Gram correction
    sum_{j in mask_c} X_j X_j^T is ``unpack(M @ P)`` with P this matrix: the
    reference's per-column ``submat`` + ``AAt`` loop
    (reference:src/singlet.cpp:447-462) as one matmul.
    """
    i = torch.as_tensor(iu[0], device=X.device)
    j = torch.as_tensor(iu[1], device=X.device)
    return X[:, i] * X[:, j]


def _pos_index(k: int, iu, device) -> torch.Tensor:
    return torch.as_tensor(_sym_pos(k, iu).reshape(-1), device=device)


def unpack_sym(packed: torch.Tensor, k: int, iu) -> torch.Tensor:
    """Inverse of the triangular packing: (..., npairs) -> (..., k, k); the
    (i, j) entry reads the packed position of its sorted pair."""
    up = torch.index_select(packed, -1, _pos_index(k, iu, packed.device))
    return up.reshape(packed.shape[:-1] + (k, k))


def unpack_sym_t(packed: torch.Tensor, k: int, iu,
                 a_full: torch.Tensor) -> torch.Tensor:
    """Per-column Grams ``a_full - unpack(packed_c)`` in the coordinate-tile
    layout ``at[i, j, c] = a_c[j, i]``, shape (k, k, n), from ``packed``
    (n, npairs)."""
    return unpack_sym_from_t(packed.T, k, iu, a_full)


def unpack_sym_from_t(packed_t: torch.Tensor, k: int, iu,
                      a_full: torch.Tensor) -> torch.Tensor:
    """Per-column Grams ``a_full - unpack(packed_c)`` in the coordinate-tile
    layout (k, k, n) from TRANSPOSED packed corrections ``packed_t``
    (npairs, n): a row gather, contiguous over columns, which is the layout
    of kernel B2's tile entry; its packed entry reads ``a_full`` and
    ``packed_t`` themselves."""
    up = torch.index_select(packed_t, 0, _pos_index(k, iu, packed_t.device))
    return (a_full.reshape(k * k, 1) - up).reshape(k, k, packed_t.shape[1])


def mask_dot_t(P: torch.Tensor, m: torch.Tensor,
               m_contract_dim: int) -> torch.Tensor:
    """Contract dim 0 of the packed-product matrix ``P`` (rows, npairs)
    against ``m_contract_dim`` of the 0/1 mask ``m``, giving (npairs, n):
    the orientation ``unpack_sym_from_t`` consumes. One full-f32 matmul."""
    m = m.to(P.dtype)
    return P.T @ (m.T if m_contract_dim == 1 else m)
