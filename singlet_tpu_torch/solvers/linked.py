"""Linked NMF: batch integration by factor-sample linking.

Port of ``singlet_tpu/solvers/linked.py``: ``run_linked_nmf``
(reference:R/RunLNMF.R:18-66) over ``c_linked_nmf``
(reference:src/singlet.cpp:1059-1086), an ALS loop where the NNLS
right-hand side of a column is multiplied elementwise by a 0/1 link vector
before the solve, zeroing unlinked factors for that sample. Factors whose
link is 0 decay to 0 under the L1 clamp, splitting the model into shared
and group-unique factors. The fit is the plain one with ``link_h`` /
``link_w``: ``nmf_fit`` on dense providers (kernel B1), or the blocked-ELL
engine's ``fit`` (B3, B1, B4), with ``mesh=`` cell-split over the ranks of
a mesh (each rank links its own cells). ``build_link_matrix`` is numpy,
copied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from singlet_tpu_torch.model import NMFModel
from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine
from singlet_tpu_torch.solvers.als import nmf_fit
from singlet_tpu_torch.solvers.drivers import _engine_or_providers, _finalize


def run_linked_nmf(
    A,
    w: np.ndarray,
    link_h: Optional[np.ndarray] = None,
    link_w: Optional[np.ndarray] = None,
    tol: float = 1e-4,
    maxit: int = 100,
    verbose: bool = True,
    L1: float = 0.01,
    L2: float = 0.0,
    gene_names=None,
    cell_names=None,
    mesh=None,
    device=None,
) -> NMFModel:
    """Linked NMF initialized from an existing model's w (genes x k).

    link_h: (k, cells) 0/1 linking of factors to samples (reference
    orientation); link_w: (genes, k) linking of factors to features.

    ``A`` and ``device`` are taken as ``run_nmf`` takes them: dense, scipy
    sparse (on the blocked-ELL engine above ``SPARSE_THRESHOLD`` dense
    entries, never densified), a chunk list or staged directory, or a
    prebuilt ``ShardedEllEngine``; ``mesh`` (a ``"cells"`` DeviceMesh) runs
    the fit cell-split on the engine over the mesh's ranks, each rank
    calling with the same arguments and getting the whole model.
    """
    if link_h is None and link_w is None:
        raise ValueError(
            "both link_h and link_w cannot be None. Specify at least one "
            "linking matrix.")
    if L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    P = _engine_or_providers(A, mesh, device)
    shape_of = P if isinstance(P, ShardedEllEngine) else P[0]
    genes, cells = shape_of.rows_true, shape_of.cols_true
    w = np.asarray(w, np.float32)
    if w.shape[0] != genes:
        raise ValueError("number of rows in 'w' must equal the number of "
                         "rows in 'A'")
    k = w.shape[1]
    if link_h is not None:
        link_h = np.asarray(link_h, np.float32)
        if link_h.shape[0] != k:
            raise ValueError("number of rows in 'link_h' must equal the "
                             "number of columns in 'w'")
        if link_h.shape[1] != cells:
            raise ValueError("number of columns in 'link_h' must equal the "
                             "number of columns in 'A'")
        link_h = link_h.T          # solver layout: (cells, k)
    if link_w is not None:
        link_w = np.asarray(link_w, np.float32)
        if link_w.shape != (genes, k):
            raise ValueError("'link_w' must have shape (nrow(A), k)")

    if isinstance(P, ShardedEllEngine):
        out = P.fit(k, tol=tol, maxit=maxit, L1=L1, L2=L2,
                    verbose=bool(verbose), w_init=w,
                    link_h=link_h, link_w=link_w)
        model = _finalize(out["w"], out["d"], out["h"], gene_names,
                          cell_names)
    else:
        Ap, Atp = P
        res = nmf_fit(Ap, k, At=Atp, w_init=w, tol=tol, maxit=maxit, L1=L1,
                      L2=L2, verbose=verbose, link_h=link_h, link_w=link_w)
        model = _finalize(res.w, res.d, res.h, gene_names, cell_names)
    model.misc["link_matrix"] = None if link_h is None else link_h.T
    return model


def build_link_matrix(embeddings: np.ndarray, groups, link_cutoff: float = 0.5):
    """Construct the (k, cells) link_h matrix from a fitted model.

    Reproduces the RunLNMF link rule (reference:R/RunLNMF.R:134-154): compute
    the mean embedding weight of each group per factor, row-normalize and
    scale by the number of groups; where a group's relative contribution to a
    factor falls below ``link_cutoff``, unlink that group's samples from the
    factor.

    Args:
      embeddings: (cells, k) cell embeddings (h^T).
      groups: length-cells array of group labels.
    Returns:
      (link_h (k, cells) float 0/1, unlink (k, n_groups) bool, levels)
    """
    embeddings = np.asarray(embeddings)
    groups = np.asarray(groups)
    levels = list(dict.fromkeys(groups.tolist()))  # unique, appearance order
    k = embeddings.shape[1]
    m = np.zeros((k, len(levels)))
    for li, level in enumerate(levels):
        sel = groups == level
        m[:, li] = embeddings[sel, :].mean(axis=0)
    rel = m / m.sum(axis=1, keepdims=True) * len(levels)
    unlink = rel < link_cutoff
    link_h = np.ones((k, embeddings.shape[0]), np.float32)
    for fi in range(k):
        for li, level in enumerate(levels):
            if unlink[fi, li]:
                link_h[fi, groups == level] = 0.0
    return link_h, unlink, levels
