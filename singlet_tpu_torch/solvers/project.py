"""NNLS projection of new data onto a frozen factor model (transfer
learning).

Port of ``singlet_tpu/solvers/project.py``: ``project_model``
(reference:R/ProjectData.R:11-19) over ``c_project_model``
(reference:src/singlet.cpp:405-413): normalize the factor columns of w, run
one unmasked NNLS half-update for h from a zero start, rescale. On dense
providers that is one ``solve_nnls`` (kernel B1 on the card); on the
blocked-ELL engine (large scipy input, chunk lists, staged directories, a
prebuilt engine, and any input with ``mesh=``, the cells split over the
mesh's ranks) the engine's ``project`` (B3, B1). The matrix is never
densified on the engine's route.
"""

from __future__ import annotations

import numpy as np
import torch

from singlet_tpu_torch.ops.linalg import gram, scale_columns
from singlet_tpu_torch.ops.nnls import solve_nnls
from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine
from singlet_tpu_torch.solvers.als import _padded
from singlet_tpu_torch.solvers.drivers import _engine_or_providers


def _project_provider(Ap, W: torch.Tensor, L1: float, L2: float):
    """One cold-start h half-update against the column-normalized W over a
    dense provider. W is (rows_pad, k) with zero padded rows. Returns
    (H / d, d)."""
    W, _ = scale_columns(W)
    B = Ap.t_matmul(W)
    H = solve_nnls(gram(W), B, torch.zeros_like(B), L1=L1, L2=L2,
                   update_mask=Ap.nonempty)
    return scale_columns(H)


def project_model(A, w, L1: float = 0.01, L2: float = 0.0, mesh=None,
                  device=None):
    """Project columns of A (genes x cells) onto model w (genes x k).

    Accepts w as (genes, k) or (k, genes) like the reference's transpose
    check (reference:src/singlet.cpp:406). ``A`` and ``device`` are taken
    as ``run_nmf`` takes them (dense, scipy sparse, a chunk list or staged
    directory, or a prebuilt ShardedEllEngine); ``mesh`` (a ``"cells"``
    DeviceMesh) projects the cells split over the mesh's ranks. Returns (h
    (k, cells), d (k,)) as numpy, the whole of them on every rank.
    """
    P = _engine_or_providers(A, mesh, device)
    genes = P.rows_true if isinstance(P, ShardedEllEngine) \
        else P[0].rows_true
    w = np.asarray(w, np.float32)
    if w.shape[0] != genes:
        if w.shape[1] == genes:
            w = w.T
        else:
            raise ValueError("'w' must share a common edge with the rows of "
                             "'A'")

    if isinstance(P, ShardedEllEngine):
        return P.project(w, L1=L1, L2=L2)

    Ap, _ = P
    W = _padded(w, Ap.rows_pad, w.shape[1], Ap.device)
    H, d = _project_provider(Ap, W, float(L1), float(L2))
    return H[: Ap.cols_true].T.cpu().numpy(), d.cpu().numpy()
