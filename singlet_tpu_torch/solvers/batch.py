"""Batch-aware L1-matrix NMF (experimental parity feature).

Port of ``singlet_tpu/solvers/batch.py``, the equivalent of ``c_nmf_batch``
(reference:src/singlet.cpp:677-710) with ``calc_L1_matrix`` (:281-311) and
``predict_L1_matrix`` (:314-328): during the h update, each (factor, cell)
coordinate receives an extra L1 penalty equal to the difference between
the factor's mean loading in the cell's batch and its mean loading across
the other batches, penalizing batch-specific factors. The per-(cell,
factor) L1 reaches kernel B1 through ``solve_nnls`` as an (n, k) L1 on the
shared Gram.

Reference quirks not reproduced (its experimental code indexes the penalty
matrix by cell column and leaves batch 0 uninitialized: out-of-bounds /
uninitialized reads in Eigen): as in the JAX package, the documented intent
is implemented, expanding the (k, n_batches) penalty to per-cell columns
via each cell's batch id. ``nmf_batch`` is the dense solver; the scale
route is the blocked-ELL engine's ``batch_fit`` (penalty on the device),
which ``nmf_batch(..., mesh=)`` takes with the cells split over the ranks
of a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from singlet_tpu_torch.device import resolve_device
from singlet_tpu_torch.model import NMFModel
from singlet_tpu_torch.ops.linalg import cor_distance, gram, scale_columns
from singlet_tpu_torch.ops.nnls import SweepSettings, solve_nnls
from singlet_tpu_torch.parallel.sharded import check_mesh
from singlet_tpu_torch.solvers.als import logged_fit_loop
from singlet_tpu_torch.solvers.drivers import (_coerce_dense,
                                               _engine_or_providers,
                                               _finalize)


def calc_l1_matrix(h: np.ndarray, batch_id: np.ndarray) -> np.ndarray:
    """Per-(factor, batch) penalty: mean loading in batch minus mean of the
    per-batch means of the other batches (reference:src/singlet.cpp:281-311,
    intended semantics). h: (k, cells); batch_id: 0-based ints per cell."""
    h = np.asarray(h)
    batch_id = np.asarray(batch_id)
    n_batches = int(batch_id.max()) + 1
    means = np.zeros((h.shape[0], n_batches))
    for b in range(n_batches):
        sel = batch_id == b
        if sel.any():
            means[:, b] = h[:, sel].mean(axis=1)
    out = np.zeros_like(means)
    if n_batches < 2:
        # a single batch has no "other batches" to contrast against: the
        # penalty is zero (the reference never exercises this; its delete+
        # mean would produce NaN)
        return out
    for b in range(n_batches):
        others = np.delete(means, b, axis=1)
        out[:, b] = means[:, b] - others.mean(axis=1)
    return out


def _dense_operand(A, device) -> torch.Tensor:
    """A genes x cells numpy or scipy operand as a dense float32 tensor on
    ``device`` (the JAX package's ``_coerce_dense``)."""
    if hasattr(A, "toarray"):
        A = A.toarray()
    return torch.as_tensor(_coerce_dense(A), device=device)


def _start_w(genes: int, k: int, seed: int, w_init, device) -> torch.Tensor:
    """W (genes, k): ``w_init``, or U(0, 1) from a ``torch.Generator``
    seeded with ``seed``. The JAX package draws from
    ``fold_in(PRNGKey(seed), 0x5117)``, so one seed gives another W than
    ``singlet_tpu``; pass ``w_init`` to start both from the same W."""
    if w_init is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return torch.rand((genes, k), generator=gen, device=device)
    return torch.as_tensor(np.asarray(w_init, np.float32), device=device)


def nmf_batch(A, k: int, batch_id, tol: float = 1e-4, maxit: int = 100,
              L1: float = 0.01, L2: float = 0.0, seed: int = 0,
              verbose: bool = False, gene_names=None,
              cell_names=None, w_init=None, mesh=None,
              device=None) -> NMFModel:
    """ALS NMF with batch-aware per-coordinate L1 on the h update.

    Without ``mesh``: the dense solver on ``device`` (default ``"cuda"``);
    the penalty is computed on the host each iteration from the current H
    (``calc_l1_matrix``), as in the JAX package. With ``mesh`` (a
    ``"cells"`` DeviceMesh): the scale route, ``ShardedEllEngine.batch_fit``
    with the cells split over the mesh's ranks (A stays sparse; the
    penalty is computed on the device each iteration), every rank calling
    with the same arguments and getting the whole model; ``A`` is then
    routed as ``run_nmf`` routes it (chunk lists, staged directories and
    an engine included)."""
    if check_mesh(mesh) is not None:
        out = _engine_or_providers(A, mesh, device).batch_fit(
            batch_id, k, tol=tol, maxit=maxit, L1=L1, L2=L2, seed=seed,
            w_init=w_init, verbose=verbose)
        return _finalize(out["w"], out["d"], out["h"], gene_names,
                         cell_names)
    device = resolve_device(device)
    Aj = _dense_operand(A, device)
    batch_id = np.asarray(batch_id)
    if batch_id.dtype.kind not in "iu":
        _, batch_id = np.unique(batch_id, return_inverse=True)
    genes, cells = Aj.shape
    if batch_id.size != cells:
        raise ValueError("batch_id vector must be of the same length as the "
                         "number of columns in A")
    W = _start_w(genes, k, seed, w_init, device)
    H = torch.zeros((cells, k), dtype=torch.float32, device=device)
    nonempty = (Aj != 0).any(dim=0)
    settings = SweepSettings.from_env()
    kw = dict(max_sweeps=settings.max_sweeps)

    def step(W, H, cap):
        # per-(cell, factor) L1: base scalar + batch penalty from H
        L1m = calc_l1_matrix(H.cpu().numpy().T, batch_id)  # (k, n_batches)
        L1_cells = torch.as_tensor(L1m.T[batch_id].astype(np.float32),
                                   device=device) + np.float32(L1)
        H = solve_nnls(gram(W), Aj.T @ W, H, L1=L1_cells, L2=L2,
                       update_mask=nonempty, sweep_cap=cap, **kw)
        H, d = scale_columns(H)
        W_new = solve_nnls(gram(H), Aj @ H, W, L1=L1, L2=L2, sweep_cap=cap,
                           **kw)
        W_new, d = scale_columns(W_new)
        return W_new, H, d, cor_distance(W_new, W)

    W, H, d, _ = logged_fit_loop("nmf_batch", step, W, H, tol, maxit, settings,
                                 verbose=verbose, genes=genes, cells=cells)
    return _finalize(W.cpu().numpy(), d.cpu().numpy(), H.cpu().numpy().T,
                     gene_names, cell_names)
