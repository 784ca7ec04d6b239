"""The alternating-least-squares NMF engine: plain and masked updates.

Port of ``singlet_tpu/solvers/als.py`` (reference:src/singlet.cpp:639-666).
Each plain half-update is a Gram, one ``P^T X`` product, the batched
CD-NNLS over all columns (kernel B1 on CUDA), and a column rescale; the
convergence metric is 1 - Pearson of W against the previous iterate on the
true (unpadded) rows.

Masked (cross-validation) half-updates loop over column blocks
(``P.block``: 2048 cells, 4096 genes from ``make_dense_providers``), so
memory stays bounded at large n. Per block: the test-mask tile, the
training product of the masked operand, the per-column Gram corrections
``a_c = X^T X - sum_{masked j} X_j X_j^T`` (reference:src/singlet.cpp:
447-464) from one packed-outer-product matmul, and one CD-NNLS over the
block's columns with a Gram per column (kernel B2 on CUDA).

Semantics kept from the JAX package:
  * warm-started NNLS + column rescale => damped (EMA-like) ALS updates;
  * empty columns are skipped, retaining their previous values;
  * the masked test-set MSE counts all masked entries, zeros included,
    averaged per column, then over the true columns
    (reference:src/singlet.cpp:536-568);
  * tol starts at 1.0, so a ``tol_target >= 1`` runs no iteration; the
    adaptive sweep latch is fed the previous iteration's tol; the tol trace
    is kept.

The JAX fit loop is one ``lax.while_loop`` so that a fit costs one sync
with a remote TPU. Here it is a host loop that syncs once per iteration,
for the tol test; the checkpointed fit (``checkpoint=``, the JAX package's
per-step path) runs the same loop with a save after each iteration, and
every fit logs ``fit_start``, ``iteration`` and ``fit_end`` events
(``tracing.py``), and, while the tracing is on, its spans (``singlet.
setup``, ``.iter``, ``.step``, ``.sync``, ``.output``) and the CD-NNLS
counters of each iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from singlet_tpu_torch.checkpoint import CheckpointManager, resolve_manager
from singlet_tpu_torch.device import is_scipy_sparse, resolve_device
from singlet_tpu_torch.ops.linalg import (cor_distance, gram, mask_dot_t,
                                          packed_outer_products,
                                          scale_columns, triu_pairs)
from singlet_tpu_torch.ops.nnls import (CD_MAX_SWEEPS, SweepSettings,
                                        solve_nnls, solve_nnls_packed_t,
                                        sweep_cap_update)
from singlet_tpu_torch.parallel.collectives import (all_gather_cells,
                                                    barrier, rank_of)
from singlet_tpu_torch.sparse.matrix import DenseMatrix, _round_up
from singlet_tpu_torch.tracing import (CdCounts, call_fields,
                                       get_metric_logger, output_span, span)


def pick_block(n_true: int, target: int, quantum: int = 256) -> int:
    """Choose a column-block size: single block for small axes (minimal
    padding), otherwise the configured target."""
    if n_true <= target:
        return _round_up(n_true, quantum)
    return target


def make_dense_providers(A, cell_block: int = 2048, gene_block: int = 4096,
                         dtype=torch.float32,
                         device=None) -> Tuple[DenseMatrix, DenseMatrix]:
    """Build (A, At) dense providers on ``device`` (default ``"cuda"``) from
    a genes x cells array (numpy or scipy sparse), padded as the JAX package
    pads them.

    scipy-sparse inputs ship only their COO triplets to the device and are
    densified there by one scatter-add. At's data is the transposed VIEW
    of A's (no second copy of the operand; the matmuls read it transposed),
    and the two share one test-mask cache.
    """
    device = resolve_device(device)
    genes, cells = A.shape
    cb = pick_block(cells, cell_block)
    gb = pick_block(genes, gene_block)
    cells_pad = _round_up(cells, cb)
    genes_pad = _round_up(genes, gb)

    if is_scipy_sparse(A):
        coo = A.tocoo()
        data = torch.zeros((genes_pad, cells_pad), dtype=dtype, device=device)
        idx = (torch.as_tensor(coo.row.astype(np.int64), device=device),
               torch.as_tensor(coo.col.astype(np.int64), device=device))
        data.index_put_(idx, torch.as_tensor(coo.data, dtype=dtype,
                                             device=device), accumulate=True)
    else:
        buf = np.zeros((genes_pad, cells_pad), dtype=np.float32)
        buf[:genes, :cells] = np.asarray(A)
        data = torch.as_tensor(buf).to(device=device, dtype=dtype)

    nz = data != 0
    Ap = DenseMatrix(data=data, nonempty=nz.any(dim=0), rows_true=genes,
                     cols_true=cells, cols_are_cells=True, block=cb)
    Atp = DenseMatrix(data=data.T, nonempty=nz.any(dim=1), rows_true=cells,
                      cols_true=genes, cols_are_cells=False, block=gb,
                      mask_cache=Ap.mask_cache)
    return Ap, Atp


# --------------------------------------------------------------------------
# Half-updates and one ALS iteration
# --------------------------------------------------------------------------

def _half_update(P: DenseMatrix, X, Y_warm, L1, L2, link=None,
                 sweep_cap=None, max_sweeps: int = CD_MAX_SWEEPS):
    """Unmasked half-update: solve P's columns against factor matrix X
    (``predict`` / ``predict_link``, reference:src/singlet.cpp:333-347,
    416-433)."""
    a = gram(X)
    B = P.t_matmul(X)
    if link is not None:
        B = B * link
    return solve_nnls(a, B, Y_warm, L1=L1, L2=L2, update_mask=P.nonempty,
                      max_sweeps=max_sweeps, sweep_cap=sweep_cap)


def _half_update_masked(P: DenseMatrix, X, Y_warm, seed, L1, L2,
                        inv_density: int, block: int, sweep_cap=None,
                        max_sweeps: int = CD_MAX_SWEEPS):
    """Masked half-update over column blocks (reference:src/singlet.cpp:
    436-466): one kernel-B2 solve per block of ``block`` columns."""
    k = X.shape[1]
    a_full = gram(X)
    iu = triu_pairs(k)
    P_pairs = packed_outer_products(X, iu)          # (rows_pad, npairs)
    if P.cols_pad % block:
        raise ValueError(f"block {block} does not divide {P.cols_pad}")
    Ys = []
    for col_start in range(0, P.cols_pad, block):
        m = P.mask_tile(seed, col_start, block, inv_density)   # (blk, rows)
        tile = P.col_block(col_start, block)                   # (rows, blk)
        B = torch.where(m, 0.0, tile.T) @ X                    # (blk, k)
        packed_t = mask_dot_t(P_pairs, m, 1)                   # (np, blk)
        cols = slice(col_start, col_start + block)
        Ys.append(solve_nnls_packed_t(
            a_full, packed_t, iu, B, Y_warm[cols], L1=L1, L2=L2,
            update_mask=P.nonempty[cols], max_sweeps=max_sweeps,
            sweep_cap=sweep_cap))
    return torch.cat(Ys)


def mse_test(A: DenseMatrix, W, d, H, seed, inv_density: int, block: int):
    """Held-out test-set MSE (reference:src/singlet.cpp:536-568): the mean
    over true cells of (sum over masked genes of (w d h - A)^2 / n_masked).
    A 0-d tensor on the fit's device."""
    Wd = W * d[None, :]
    total = torch.zeros((), dtype=W.dtype, device=W.device)
    for col_start in range(0, A.cols_pad, block):
        m = A.mask_tile(seed, col_start, block, inv_density)    # (blk, genes)
        tile = A.col_block(col_start, block)                    # (genes, blk)
        pred = H[col_start:col_start + block] @ Wd.T            # (blk, genes)
        diff2 = torch.square(pred - tile.T)
        s = torch.where(m, diff2, 0.0).sum(dim=1)
        n = m.sum(dim=1)
        total = total + torch.where(n > 0, s / n.clamp(min=1), 0.0).sum()
    return total / A.cols_true


def als_step(A: DenseMatrix, At: DenseMatrix, W, H, L1_h, L1_w, L2_h, L2_w,
             link_h=None, link_w=None, sweep_cap=None,
             max_sweeps: int = CD_MAX_SWEEPS):
    """One ALS iteration: h-update, rescale, w-update, rescale, tol
    (reference:src/singlet.cpp:647-664, linked :1073-1084). Returns
    (W, H, d, tol) with tol a 0-d tensor on the fit's device."""
    H = _half_update(A, W, H, L1_h, L2_h, link=link_h, sweep_cap=sweep_cap,
                     max_sweeps=max_sweeps)
    H, d = scale_columns(H)
    W_new = _half_update(At, H, W, L1_w, L2_w, link=link_w,
                         sweep_cap=sweep_cap, max_sweeps=max_sweeps)
    W_new, d = scale_columns(W_new)
    tol = cor_distance(W_new[: At.cols_true], W[: At.cols_true])
    return W_new, H, d, tol


def als_step_masked(A: DenseMatrix, At: DenseMatrix, W, H, seed, L1, L2,
                    inv_density: int, cell_block: int, gene_block: int,
                    sweep_cap=None, max_sweeps: int = CD_MAX_SWEEPS):
    """One masked ALS iteration (reference:src/singlet.cpp:1107-1114).
    Returns (W, H, d, tol) with tol a 0-d tensor on the fit's device."""
    H = _half_update_masked(A, W, H, seed, L1, L2, inv_density, cell_block,
                            sweep_cap=sweep_cap, max_sweeps=max_sweeps)
    H, d = scale_columns(H)
    W_new = _half_update_masked(At, H, W, seed, L1, L2, inv_density,
                                gene_block, sweep_cap=sweep_cap,
                                max_sweeps=max_sweeps)
    W_new, d = scale_columns(W_new)
    tol = cor_distance(W_new[: At.cols_true], W[: At.cols_true])
    return W_new, H, d, tol


def _fit_loop(step, W, H, tol_target: float, maxit: int,
              settings: SweepSettings, masked: bool = False,
              verbose: bool = False, d=None, tols=(), on_step=None,
              fit_id: Optional[str] = None):
    """The ALS loop with the JAX ``_fit_loop_device`` semantics, one
    ``.item()`` sync per iteration. ``step(W, H, sweep_cap)`` is one
    iteration, returning (W, H, d, tol); ``masked`` selects the masked
    fast-phase cap. Returns (W, H, d, tol_trace).

    A resumed fit passes its saved ``d`` and ``tols``: the loop goes on
    from ``len(tols)`` iterations, from the last saved tol, with the
    exact-phase latch recovered from the trace (it fired iff a saved tol
    crossed its threshold, as the JAX checkpoint path recovers it).
    ``on_step(it, W, H, d, {"tol_trace": tols})`` runs after each
    iteration (``checkpoint_saver``); with ``fit_id``, each iteration logs
    an ``iteration`` event (tol and ms, and while the tracing is on the
    step's CD-NNLS counts) to the metric logger."""
    k = W.shape[1]
    if d is None:
        d = torch.ones(k, dtype=W.dtype, device=W.device)
    target = np.float32(tol_target)
    tols = list(tols)
    tolv = np.float32(tols[-1]) if tols else np.float32(1.0)
    exact = False
    for t in tols:
        _, exact = sweep_cap_update(exact, t, target, masked=masked,
                                    settings=settings)
    logger = get_metric_logger()
    counts = CdCounts(W.device)
    while len(tols) < maxit and tolv > target:
        with span("singlet.iter"):
            t0 = time.perf_counter()
            cap, exact = sweep_cap_update(exact, tolv, target, masked=masked,
                                          settings=settings)
            with counts.armed(), span("singlet.step"):
                W, H, d, t = step(W, H, cap)
            with span("singlet.sync"):
                (tv,), cd = counts.read(t)
            tolv = np.float32(tv)
            tols.append(float(tolv))
            if fit_id is not None:
                logger.log("iteration", fit=fit_id, iter=len(tols),
                           tol=float(tolv),
                           ms=round((time.perf_counter() - t0) * 1e3, 3),
                           **cd)
            if verbose:
                print(f"{len(tols):4d} | {tolv:8.2e}")
            if on_step is not None:
                on_step(len(tols), W, H, d, {"tol_trace": tols})
    return W, H, d, tols


def logged_fit_loop(algo: str, step, W, H, tol_target: float, maxit: int,
                    settings: SweepSettings, verbose: bool = False,
                    masked: bool = False, **fields):
    """``_fit_loop`` of a fit (plain unless ``masked``) between its
    ``fit_start`` and ``fit_end`` events (``fields``, e.g. genes and cells,
    go to ``fit_start``), each iteration logged. Returns (W, H, d,
    tol_trace)."""
    logger = get_metric_logger()
    fit_id = logger.new_fit_id(algo)
    logger.log("fit_start", fit=fit_id, algo=algo, k=int(W.shape[1]),
               maxit=maxit, **fields, **call_fields())
    W, H, d, tols = _fit_loop(step, W, H, tol_target, maxit, settings,
                              masked=masked, verbose=verbose, fit_id=fit_id)
    logger.log("fit_end", fit=fit_id, n_iter=len(tols),
               tol=tols[-1] if tols else None)
    return W, H, d, tols


def save_once(mgr, it: int, state, mesh=None) -> None:
    """Save ``state()`` as ``mgr``'s checkpoint of iteration ``it`` once
    for the mesh: rank 0 builds and writes it, and every rank waits for the
    write at a barrier, so that a later restore on any rank reads the file.
    Without a mesh this process writes."""
    if rank_of(mesh) == 0:
        mgr.save(it, state())
    barrier(mesh)


def checkpoint_saver(mgr, config: dict, mesh=None):
    """The ``on_step`` hook of a checkpointed fit loop, or None without a
    manager: when ``mgr``'s cadence says so, and only then, W, H and d are
    copied to the host and saved with ``config`` and the loop's traces (a
    dict of lists, saved under their keys). On a mesh H (the rank's rows)
    is first gathered over the ranks and ``save_once`` writes it."""
    if mgr is None:
        return None

    def save(it, W, H, d, traces):
        if not mgr.should_save(it):
            return
        H = all_gather_cells(mesh, H)
        save_once(mgr, it, lambda: dict(
            config, W=W.cpu().numpy(), H=H.cpu().numpy(), d=d.cpu().numpy(),
            **traces), mesh)
    return save


def restore_fit_state(mgr, config: dict, device, verbose=False):
    """The newest checkpoint of ``mgr`` with fingerprint ``config`` (W, H
    and d as tensors on ``device``, the traces and ``it`` as saved), or
    None without a manager or a match."""
    st = mgr.restore(config, verbose=bool(verbose)) if mgr else None
    if st is not None:
        for key in ("W", "H", "d"):
            st[key] = torch.as_tensor(st[key]).to(device)
    return st


# --------------------------------------------------------------------------
# Fit driver
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FitResult:
    w: np.ndarray            # (genes, k) — true rows only
    d: np.ndarray            # (k,)
    h: np.ndarray            # (k, cells) — reference orientation
    tol: float
    n_iter: int
    tol_trace: list


def _as_pair(x) -> Tuple[float, float]:
    if isinstance(x, (tuple, list)):
        return float(x[0]), float(x[1] if len(x) > 1 else x[0])
    return float(x), float(x)


def init_w(k: int, genes_pad: int, genes_true: int, seed: int,
           device=None) -> torch.Tensor:
    """Uniform(0,1) init of W (genes, k), zero on padded rows
    (reference:R/run_nmf.R:56).

    Drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (default ``"cuda"``). The JAX package draws from threefry, which torch
    cannot reproduce, so the same ``seed`` gives a DIFFERENT init than
    ``singlet_tpu``; pass ``w_init`` to start both from the same W.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    w = torch.rand((genes_pad, k), generator=gen, dtype=torch.float32,
                   device=device)
    w[genes_true:] = 0.0
    return w


def _padded(x, rows: int, k: int, device) -> torch.Tensor:
    """(rows, k) float32 zeros on ``device`` with ``x`` (numpy or tensor)
    in its top rows."""
    out = torch.zeros((rows, k), dtype=torch.float32, device=device)
    x = torch.as_tensor(x)
    out[: x.shape[0]] = x.to(device=device, dtype=torch.float32)
    return out


def fit_providers(A, At, device):
    """(A, At, device) of a fit: ``A`` with ``At`` is a prebuilt provider
    pair, whose device is then the fit's; otherwise ``A`` is a genes x cells
    array made into dense providers on ``device`` (default ``"cuda"``)."""
    if At is not None:
        if device is not None and \
                resolve_device(device).type != A.device.type:
            raise ValueError(f"providers are on {A.device}, device={device}")
        return A, At, resolve_device(A.device)
    dev = resolve_device(device)
    return (*make_dense_providers(np.asarray(A), device=dev), dev)


def nmf_fit(
    A: Union[np.ndarray, DenseMatrix],
    k: int,
    At: Optional[DenseMatrix] = None,
    w_init=None,
    tol: float = 1e-4,
    maxit: int = 100,
    L1: Union[float, Tuple[float, float]] = 0.01,
    L2: Union[float, Tuple[float, float]] = 0.0,
    seed: int = 0,
    verbose: bool = False,
    link_h=None,
    link_w=None,
    checkpoint=None,
    device=None,
) -> FitResult:
    """Fit NMF by ALS: the engine under ``run_nmf`` (reference:R/run_nmf.R:
    18-77, solver loop reference:src/singlet.cpp:639-666).

    ``A`` is a genes x cells array, or with ``At`` a prebuilt provider pair
    (whose device is then the fit's). ``device`` defaults to ``"cuda"`` and
    raises without a card. L1/L2 may be scalars or (w, h) pairs;
    ``link_h``/``link_w`` are 0/1 linking masks (cells, k) / (genes, k)
    (reference:src/singlet.cpp:1059-1086).

    ``checkpoint`` (a directory path or ``CheckpointManager``) saves the
    fit state atomically every ``every`` iterations and resumes from the
    newest checkpoint of the same config fingerprint (the JAX package's
    ``algo="als"`` fingerprint and file format: a checkpoint of the JAX
    ``nmf_fit`` of the same geometry resumes here). The checkpointed and
    the plain fit run the same host loop, so a resumed fit equals the
    uninterrupted one bit for bit.
    """
    with span("singlet.setup"):
        Ap, Atp, dev = fit_providers(A, At, device)
        genes_pad = Ap.rows_pad
        cells_pad = Ap.cols_pad
        if w_init is None:
            W = init_w(k, genes_pad, Ap.rows_true, seed, device=dev)
        else:
            W = _padded(w_init, genes_pad, k, dev)
        H = torch.zeros((cells_pad, k), dtype=torch.float32, device=dev)
        d = None

        L1_w, L1_h = _as_pair(L1)
        L2_w, L2_h = _as_pair(L2)
        linked = [link_h is not None, link_w is not None]
        if link_h is not None:
            link_h = _padded(link_h, cells_pad, k, dev)
        if link_w is not None:
            link_w = _padded(link_w, genes_pad, k, dev)

        mgr = resolve_manager(checkpoint)
        ckpt_config = CheckpointManager.config_of(
            algo="als", k=int(k), genes_pad=int(genes_pad),
            cells_pad=int(cells_pad), L1=[L1_w, L1_h], L2=[L2_w, L2_h],
            seed=int(seed), linked=linked)
        tol_trace = []
        if mgr is not None:
            st = restore_fit_state(mgr, ckpt_config, dev, verbose)
            if st is not None:
                W, H, d = st["W"], st["H"], st["d"]
                tol_trace = list(st["tol_trace"])

        logger = get_metric_logger()
        fit_id = logger.new_fit_id("als")
        logger.log("fit_start", fit=fit_id, algo="als", k=int(k),
                   genes=int(Ap.rows_true), cells=int(Ap.cols_true),
                   maxit=maxit, resumed_at=len(tol_trace) or None,
                   **call_fields())
        settings = SweepSettings.from_env()

        def step(W, H, cap):
            return als_step(Ap, Atp, W, H, L1_h, L1_w, L2_h, L2_w, link_h,
                            link_w, sweep_cap=cap,
                            max_sweeps=settings.max_sweeps)

    W, H, d, tol_trace = _fit_loop(
        step, W, H, tol, maxit, settings, verbose=verbose, d=d,
        tols=tol_trace, on_step=checkpoint_saver(mgr, ckpt_config),
        fit_id=fit_id)
    tol_ = tol_trace[-1] if tol_trace else 1.0
    logger.log("fit_end", fit=fit_id, n_iter=len(tol_trace), tol=tol_)
    with output_span():
        w, d, h = (W[: Ap.rows_true].cpu().numpy(), d.cpu().numpy(),
                   H[: Ap.cols_true].T.cpu().numpy())
    return FitResult(w=w, d=d, h=h, tol=tol_, n_iter=len(tol_trace),
                     tol_trace=tol_trace)
