"""Graph-convolutional NMF.

Port of ``singlet_tpu/solvers/gcnmf.py``, the equivalent of ``c_gcnmf``
(reference:src/singlet.cpp:1668-1730): the h-update right-hand sides are
convolved over a (cells x cells) graph G before the NNLS solve
(``b'_i = sum_j G(j,i) b_j``), and the w-update gathers graph-smoothed
embeddings (``b_gene = sum_c A(gene,c) * (G[:,c] . H)``). In the dense
solver both are plain f32 matmuls, B_h' = G^T B_h and B_w = A (G^T H), and
the NNLS solves are kernel B1 on the card; the scale route is the
blocked-ELL engine's ``gcnmf_fit``, which holds G as planes, and which
``gcnmf(..., mesh=)`` takes with the cells split over the ranks of a
mesh.

Also the edge-cluster utilities ``c_differentiate_model``
(reference:src/singlet.cpp:1733-1752) and ``c_assign_cells_to_edge_clusters``
(:1755-1768), numpy, copied.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.model import NMFModel
from singlet_tpu_torch.ops.linalg import cor_distance, gram, scale_columns
from singlet_tpu_torch.ops.nnls import (CD_MAX_SWEEPS, SweepSettings,
                                        solve_nnls)
from singlet_tpu_torch.parallel.sharded import check_mesh
from singlet_tpu_torch.solvers.als import logged_fit_loop
from singlet_tpu_torch.solvers.batch import _dense_operand, _start_w
from singlet_tpu_torch.solvers.drivers import (_engine_or_providers,
                                               _finalize)


def _gcnmf_step(A, G, W, H, L1, L2, sweep_cap=None,
                max_sweeps: int = CD_MAX_SWEEPS):
    """One iteration. A: (genes, cells); G: dense (cells, cells);
    W: (genes, k); H: (cells, k)."""
    # h-update with graph convolution of the RHS. NO empty-column skip:
    # the reference's convolve+solve loop runs nnls for EVERY column
    # (reference:src/singlet.cpp:1683-1689): a cell with an empty A column
    # but graph neighbors has a nonzero convolved RHS and must be solved.
    kw = dict(sweep_cap=sweep_cap, max_sweeps=max_sweeps)
    B = G.T @ (A.T @ W)                                    # convolve
    H = solve_nnls(gram(W), B, H, L1=L1, L2=L2, **kw)
    H, d = scale_columns(H)
    # w-update over graph-smoothed embeddings
    B_w = A @ (G.T @ H)                                    # (genes, k)
    W_new = solve_nnls(gram(H), B_w, W, L1=L1, L2=L2, **kw)
    W_new, d = scale_columns(W_new)
    return W_new, H, d, cor_distance(W_new, W)


def gcnmf(A, G, k: int, tol: float = 1e-4, maxit: int = 100,
          L1: float = 0.01, L2: float = 0.0, seed: int = 0,
          w_init=None, verbose: bool = False,
          gene_names=None, cell_names=None, mesh=None,
          device=None) -> NMFModel:
    """Fit graph-convolutional NMF; G is a (cells x cells) graph.

    Without ``mesh``: the dense solver on ``device`` (default
    ``"cuda"``): A and G are densified on the device (G takes cells^2
    floats). With ``mesh`` (a ``"cells"`` DeviceMesh): the scale route,
    ``ShardedEllEngine.gcnmf_fit``, A and G sparse as blocked-ELL planes
    of each rank's cells (the graph convolution gathers B and H over the
    ranks once per half-update), every rank calling with the same
    arguments and getting the whole model; ``A`` is then routed as
    ``run_nmf`` routes it (chunk lists, staged directories and an engine
    included)."""
    if check_mesh(mesh) is not None:
        eng = _engine_or_providers(A, mesh, device)
        genes = eng.data.genes_true
        if w_init is not None:
            w_init = np.asarray(w_init, np.float32)
            if w_init.shape == (k, genes) and k != genes:
                w_init = w_init.T
        out = eng.gcnmf_fit(sp.csc_matrix(G), k, tol=tol, maxit=maxit,
                            L1=L1, L2=L2, seed=seed, w_init=w_init,
                            verbose=verbose)
        return _finalize(out["w"], out["d"], out["h"], gene_names,
                         cell_names)
    device = resolve_device(device)
    Aj = _dense_operand(A, device)
    Gd = np.asarray(G.todense(), np.float32) if sp.issparse(G) else \
        np.asarray(G, np.float32)
    if Gd.shape != (Aj.shape[1], Aj.shape[1]):
        raise ValueError("G must be cells x cells")
    genes, cells = Aj.shape
    W = _start_w(genes, k, seed, w_init, device)
    if W.shape == (k, genes):
        W = W.T.contiguous()
    Gj = torch.as_tensor(Gd, device=device)
    H = torch.zeros((cells, k), dtype=torch.float32, device=device)
    settings = SweepSettings.from_env()

    def step(W, H, cap):
        return _gcnmf_step(Aj, Gj, W, H, float(L1), float(L2),
                           sweep_cap=cap, max_sweeps=settings.max_sweeps)

    W, H, d, _ = logged_fit_loop("gcnmf", step, W, H, tol, maxit, settings,
                                 verbose=verbose, genes=genes, cells=cells)
    return _finalize(W.cpu().numpy(), d.cpu().numpy(), H.cpu().numpy().T,
                     gene_names, cell_names)


def differentiate_model(h: np.ndarray, G: sp.spmatrix) -> np.ndarray:
    """Signed per-edge differences of h across graph edges
    (reference:src/singlet.cpp:1733-1752): for each edge (col1 -> row) emit a
    2k-vector with positive diffs in the first k rows and negative diffs in
    the second k."""
    h = np.asarray(h)
    if h.shape[0] == G.shape[1] and h.shape[0] != h.shape[1]:
        h = h.T
    if h.shape[1] != G.shape[1]:
        raise ValueError("dimensions of 'h' and 'G' are not compatible")
    G = sp.csc_matrix(G)
    # Vectorized over all edges at once: CSC structure gives (col, row) per
    # nonzero; the signed split is exactly max(diff, 0) / max(-diff, 0).
    cols = np.repeat(np.arange(G.shape[1]), np.diff(G.indptr))
    diff = h[:, cols] - h[:, G.indices]
    return np.concatenate([np.maximum(diff, 0.0), np.maximum(-diff, 0.0)],
                          axis=0)


def assign_cells_to_edge_clusters(G: sp.spmatrix,
                                  edge_clusters: np.ndarray) -> np.ndarray:
    """Count, per cell, how many incident edges fall in each edge cluster
    (reference:src/singlet.cpp:1755-1768). edge_clusters: 0-based labels per
    edge in CSC order."""
    G = sp.csc_matrix(G)
    edge_clusters = np.asarray(edge_clusters)
    n_clusters = int(edge_clusters.max()) + 1
    out = np.zeros((n_clusters, G.shape[1]), np.int64)
    cols = np.repeat(np.arange(G.shape[1]), np.diff(G.indptr))
    np.add.at(out, (edge_clusters, cols), 1)
    return out
