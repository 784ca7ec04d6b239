"""Matrix-in / model-out drivers: ``run_nmf``, ``cross_validate_nmf``,
``GetBestRank`` and the ``ard_nmf`` rank search.

Port of ``singlet_tpu/solvers/drivers.py`` (reference:R/run_nmf.R:18-77,
reference:R/cross_validate_nmf.R:18-105, reference:R/GetBestRank.R:8-46,
reference:R/ard_nmf.R:31-193), with a ``device=`` argument. Dense numpy
input, and scipy input up to ``SPARSE_THRESHOLD`` dense entries, become
dense providers on the device; larger scipy input, a chunk list (scipy
matrices, ``.svc``/``.npz``/``.mtx`` paths or loader callables) and a
directory staged by ``sparse.chunked.stage_chunks`` go to the blocked-ELL
engine (``parallel/sharded_ell.py``) on the device, the lists and
directories streamed in (``shard_ell_from_chunks``,
``shard_ell_from_staged``) with no concatenated matrix on the host.
Either backend is built once and shared by every fit of a rank search,
and a ``ShardedEllEngine`` passes through. With ``mesh=`` (a 1-D
``DeviceMesh`` named ``"cells"``, ``parallel.make_mesh``; one process per
device, every rank calling the driver with the same arguments) every
input but an engine or a provider pair goes to the engine on the mesh,
each rank packing only its own cells, and every rank gets the whole model.
The CV trace frame (columns k, rep, test_error, iter, tol[,
overfit_score]) is the JAX package's.

Ranks: every rank runs, on the card as on the CPU. The CD-NNLS kernels B1
and B2 and the fused test MSE B7 hold a column's k coordinates in
registers up to k = 512 (``ops/nnls_cuda.py`` ``MAX_K``,
``MAX_K_BATCHED``, ``ops/bell_cuda.py`` ``MAX_K_MSE``) and take their
wide-k routes past it, as the JAX package has no limit.

While the port's tracing is on (``tracing.enabled``), each driver call is
a ``singlet.driver`` span, which opens the call id that its fits' spans
and ``fit_start`` events carry, with its routing and inits in
``singlet.setup`` and its sort by d and CV frame in ``singlet.finalize``.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp

from singlet_tpu_torch.checkpoint import CheckpointManager, resolve_manager
from singlet_tpu_torch.device import is_scipy_sparse, resolve_device, vprint
from singlet_tpu_torch.model import NMFModel
from singlet_tpu_torch.parallel.sharded import check_mesh
from singlet_tpu_torch.parallel.sharded_ell import (ShardedEllEngine,
                                                    shard_ell_from_chunks,
                                                    shard_ell_from_staged)
from singlet_tpu_torch.solvers.als import (init_w, make_dense_providers,
                                           nmf_fit, save_once)
from singlet_tpu_torch.solvers.ard import ard_nmf_fit
from singlet_tpu_torch.tracing import span

# scipy-sparse inputs with more dense entries than this go to the blocked-ELL
# engine; smaller ones are densified
SPARSE_THRESHOLD = 64e6


def _coerce_dense(A) -> np.ndarray:
    """A dense float32 numpy array of the (non-scipy) input."""
    return np.asarray(A, dtype=np.float32)


def _engine_or_providers(A, mesh, device):
    """Route the input to a compute backend, as the JAX drivers do
    (``singlet_tpu/solvers/drivers.py`` ``_engine_or_providers``): a
    ``ShardedEllEngine`` or a prebuilt ``(A, At)`` provider pair passes
    through; a staged directory (``str``) and a chunk list become a
    ``ShardedEllEngine`` on ``mesh`` (None: one device), streamed into the
    rank's planes; scipy input above ``SPARSE_THRESHOLD`` dense entries
    becomes the engine too, and with a mesh so does every dense or scipy
    input; everything else dense providers on ``device``. A ``mesh`` that
    is not a 1-D ``"cells"`` DeviceMesh raises TypeError."""
    mesh = check_mesh(mesh)
    if isinstance(A, ShardedEllEngine):
        return A
    if isinstance(A, tuple) and len(A) == 2 and hasattr(A[0], "t_matmul"):
        return A
    if isinstance(A, str):
        return ShardedEllEngine(None, data=shard_ell_from_staged(
            A, device, mesh=mesh))
    if isinstance(A, (list, tuple)):
        return ShardedEllEngine(None, data=shard_ell_from_chunks(
            A, device, mesh=mesh))
    if mesh is not None:
        A = A if is_scipy_sparse(A) else _coerce_dense(A)
        return ShardedEllEngine(sp.csc_matrix(A), mesh=mesh, device=device)
    device = resolve_device(device)
    if is_scipy_sparse(A):
        if A.shape[0] * A.shape[1] > SPARSE_THRESHOLD:
            return ShardedEllEngine(sp.csc_matrix(A), device=device)
        return make_dense_providers(A, device=device)
    return make_dense_providers(_coerce_dense(A), device=device)


def _fit_plain(P, k, *, w_init, tol, maxit, L1, L2, seed, verbose):
    """A plain fit on the engine or on dense providers: (w, d, h)."""
    if isinstance(P, ShardedEllEngine):
        out = P.fit(k, tol=tol, maxit=maxit, L1=L1, L2=L2, seed=seed,
                    verbose=bool(verbose), w_init=w_init)
        return out["w"], out["d"], out["h"]
    Ap, Atp = P
    res = nmf_fit(Ap, int(k), At=Atp, w_init=w_init, tol=tol, maxit=maxit,
                  L1=L1, L2=L2, seed=seed, verbose=bool(verbose))
    return res.w, res.d, res.h


def _fit_masked(P, k, **kw):
    """A masked (trace-producing) fit on the engine or on dense providers:
    ArdFitResult."""
    if isinstance(P, ShardedEllEngine):
        return P.ard_fit(k, **kw)
    Ap, Atp = P
    return ard_nmf_fit(Ap, k, At=Atp, **kw)


def _rows_pad_of(P) -> int:
    return P.rows_pad if isinstance(P, ShardedEllEngine) else P[0].rows_pad


def _rows_true_of(P) -> int:
    return P.rows_true if isinstance(P, ShardedEllEngine) else P[0].rows_true


def _device_of(P):
    return P.device if isinstance(P, ShardedEllEngine) else P[0].device


def _finalize(w, d, h, gene_names=None, cell_names=None, cv_data=None,
              reduction_key: str = "NMF_") -> NMFModel:
    """Sort factors by decreasing d and attach names
    (reference:R/run_nmf.R:65-76)."""
    with span("singlet.finalize"):
        model = NMFModel(w=w, d=d, h=h, gene_names=gene_names,
                         cell_names=cell_names, cv_data=cv_data,
                         reduction_key=reduction_key)
        return model.sorted_by_d()


def _driver(fn):
    """The driver ``fn`` as one ``singlet.driver`` span."""
    @functools.wraps(fn)
    def driver(*args, **kwargs):
        with span("singlet.driver"):
            return fn(*args, **kwargs)
    return driver


def _check_density(test_density: float) -> None:
    if test_density > 0.2 or test_density < 0.01:
        warnings.warn("'test_density' should not be greater than 0.2 or less "
                      "than 0.01, as a general rule of thumb")


@_driver
def run_nmf(
    A,
    rank: int,
    tol: float = 1e-4,
    maxit: int = 100,
    verbose: Union[bool, int] = False,
    L1: Union[float, Tuple[float, float]] = 0.01,
    L2: Union[float, Tuple[float, float]] = 0.0,
    seed: int = 0,
    w_init: Optional[np.ndarray] = None,
    gene_names=None,
    cell_names=None,
    mesh=None,
    config=None,
    device=None,
) -> NMFModel:
    """Fit NMF at a fixed rank (reference:R/run_nmf.R:18-77).

    ``A`` is a genes x cells numpy array or scipy matrix, a chunk list
    (scipy matrices, ``.svc``/``.npz``/``.mtx`` paths or loader
    callables, split along the cells), a directory staged by
    ``sparse.chunked.stage_chunks``, or a prebuilt ``(A, At)`` provider
    pair (whose device is then the fit's). ``device`` defaults to
    ``"cuda"`` and raises without a card. ``config`` (an
    :class:`~singlet_tpu_torch.config.NMFConfig`) supplies the solver
    hyperparameters, taking precedence over the per-argument defaults.
    scipy input above ``SPARSE_THRESHOLD`` dense entries, chunk lists,
    staged directories and a ``ShardedEllEngine`` fit on the blocked-ELL
    engine. ``mesh`` (a 1-D ``"cells"`` DeviceMesh, ``parallel.make_mesh``)
    fits any input but a provider pair on the engine with the cells split
    over the mesh's ranks, each rank on its own device (``device``, or
    ``cuda:{LOCAL_RANK}``); every rank calls ``run_nmf`` with the same
    arguments and gets the whole model. Any ``rank`` runs on the card:
    past 512 kernels B1, B2 and B7 take their wide-k routes.
    """
    if config is not None:
        tol, maxit, L1, L2, seed = (config.tol, config.maxit, config.L1,
                                    config.L2, config.seed)
    if np.isscalar(L1) and L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    with span("singlet.setup"):
        P = _engine_or_providers(A, mesh, device)
    w, d, h = _fit_plain(P, int(rank), w_init=w_init, tol=tol, maxit=maxit,
                         L1=L1, L2=L2, seed=seed, verbose=verbose)
    return _finalize(w, d, h, gene_names, cell_names)


# ---------------------------------------------------------------------------
# GetBestRank — the rank-selection rule (pandas, as in the JAX package)
# ---------------------------------------------------------------------------

def get_best_rank(df: pd.DataFrame, tol_overfit: float = 1e-4) -> int:
    """Select the best rank from CV traces (reference:R/GetBestRank.R:8-46).

    Per replicate: cap max_rank at the smallest rank whose running-min
    normalized error trace rises by more than tol_overfit; below the cap,
    condense each (rep, k) to its last trace point and take the k minimizing
    test error; floor of the mean across replicates.
    """
    if len(df) == 0:
        # e.g. the very first fit of a search already overfit: nothing below
        # the cap — fall back to the minimum rank (mirrors the empty-cap
        # branch below; R would propagate NaN here)
        return 2
    best_ranks = []
    for rep in sorted(df["rep"].unique()):
        df_rep = df[df["rep"] == rep]
        max_rank = int(df_rep["k"].max()) + 1
        for rank in pd.unique(df_rep["k"]):
            if rank < max_rank:
                err = df_rep[df_rep["k"] == rank]["test_error"].to_numpy()
                if err.size > 1:
                    v2 = err[1:]
                    v1 = err[:-1].copy()
                    # running min, exactly as the reference's in-place loop
                    for pos in range(1, v1.size):
                        if v1[pos] > v1[pos - 1]:
                            v1[pos] = v1[pos - 1]
                    rise = np.max(np.concatenate([[0.0], (v2 - v1) / (v2 + v1)]))
                    if rise > tol_overfit:
                        max_rank = int(rank)
        df_cap = df_rep[df_rep["k"] < max_rank]
        if len(df_cap) == 0:
            best_ranks.append(2)
        elif len(df) == 1:  # quirk preserved: tests the FULL frame's length
            best_ranks.append(int(df_cap["k"].iloc[0]))
        else:
            condensed = (
                df_cap.sort_values("iter").groupby("k", as_index=False).last()
            )
            best_ranks.append(
                int(condensed["k"].iloc[condensed["test_error"].to_numpy().argmin()])
            )
    return int(math.floor(float(np.mean(best_ranks))))


# R-style alias (public surface name)
GetBestRank = get_best_rank


# ---------------------------------------------------------------------------
# cross_validate_nmf — fixed-grid CV
# ---------------------------------------------------------------------------

@_driver
def cross_validate_nmf(
    A,
    ranks: Sequence[int],
    n_replicates: int = 3,
    tol: float = 1e-4,
    maxit: int = 100,
    verbose: int = 1,
    L1: float = 0.01,
    L2: float = 0.0,
    test_density: float = 0.05,
    tol_overfit: float = 1e-4,
    trace_test_mse: int = 5,
    seed: int = 0,
    mesh=None,
    config=None,
    device=None,
) -> pd.DataFrame:
    """Masked CV over a (rank, replicate) grid
    (reference:R/cross_validate_nmf.R:18-105).

    Each replicate shares one nested w_init (the rank-k fit uses its first
    k columns) and a deterministic per-replicate mask seed. Returns the tidy
    trace frame of class ``cross_validate_nmf_data``. ``A`` (chunk lists
    and staged directories included), ``mesh`` and ``device`` are taken as
    ``run_nmf`` takes them. ``config`` (an
    NMFConfig) supplies the hyperparameters, taking precedence over the
    per-argument defaults.
    """
    if config is not None:
        n_replicates, maxit, verbose = (config.reps, config.maxit,
                                        config.verbose)
        tol = config.cv_tol_effective
        L1, L2, seed = config.L1, config.L2, config.seed
        test_density = config.test_set_density
        tol_overfit, trace_test_mse = (config.tol_overfit,
                                       config.trace_test_mse)
    if L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    _check_density(test_density)
    with span("singlet.setup"):
        P = _engine_or_providers(A, mesh, device)
        genes_pad, genes_true, dev = (_rows_pad_of(P), _rows_true_of(P),
                                      _device_of(P))
        k_top = int(max(ranks))
        inv_density = round(1.0 / test_density)

        w_inits = [
            init_w(k_top, genes_pad, genes_true, seed=seed * 1000 + rep,
                   device=dev)
            for rep in range(1, n_replicates + 1)
        ]

    rows = []
    # expand.grid(k, rep) varies k fastest: rep-major outer, k inner
    grid = [(int(k), rep) for rep in range(1, n_replicates + 1) for k in ranks]
    for idx, (k, rep) in enumerate(grid):
        vprint(verbose, 2, f"k = {k}, rep = {rep} ({idx + 1}/{len(grid)}):")
        res = _fit_masked(
            P, k, w_init=w_inits[rep - 1][:, :k],
            mask_seed=seed + rep, inv_density=inv_density, tol=tol,
            maxit=maxit, L1=L1, L2=L2, overfit_threshold=tol_overfit,
            trace_test_mse=trace_test_mse, verbose=verbose,
        )
        for e, i, t in zip(res.test_mse, res.iter, res.tol):
            rows.append(dict(k=k, rep=rep, test_error=e, iter=i, tol=t))
        vprint(verbose, 2, f"test set error: {res.test_mse[-1]:.4e}\n")

    with span("singlet.finalize"):
        df = pd.DataFrame(rows)
        df.attrs["class"] = "cross_validate_nmf_data"
    return df


# ---------------------------------------------------------------------------
# ard_nmf — adaptive rank search
# ---------------------------------------------------------------------------

@_driver
def ard_nmf(
    A,
    k_init: Optional[int] = 2,
    k_max: int = 100,
    k_min: int = 2,
    n_replicates: int = 1,
    tol: float = 1e-5,
    cv_tol: float = 1e-4,
    maxit: int = 100,
    verbose: int = 1,
    L1: float = 0.01,
    L2: float = 0.0,
    test_density: float = 0.05,
    learning_rate: float = 1.0,
    tol_overfit: float = 1e-3,
    trace_test_mse: int = 1,
    seed: int = 0,
    gene_names=None,
    cell_names=None,
    max_fits: int = 100,
    mesh=None,
    config=None,
    checkpoint=None,
    device=None,
) -> NMFModel:
    """Automatic rank determination (reference:R/ard_nmf.R:31-193).

    Replicated adaptive search: exponential step growth while the best rank
    is the largest fit so far, bisection between bracketing ranks otherwise;
    k_max shrinks to any rank that overfits; stops when the bracketing
    neighbors are within 1. Then refits unmasked at the chosen rank (kernel
    B1 on CUDA; the masked fits run kernel B2).

    ``max_fits`` is a safety valve (no reference counterpart) against
    pathological search oscillation. ``config`` (an NMFConfig) supplies the
    hyperparameters, taking precedence over per-argument defaults. ``A``
    (chunk lists and staged directories included), ``mesh`` and
    ``device`` are taken as ``run_nmf`` takes them.

    ``checkpoint`` (a ``CheckpointManager`` or directory path) saves the
    SEARCH state after every completed rank fit: the CV rows and the
    adaptive walk's position (replicate, rank, step size, shrunken k_max),
    under the JAX package's ``kind="ard_search"`` fingerprint, which leaves
    ``max_fits`` out. A killed or valve-stopped search re-run with the same
    arguments skips every completed fit and goes on bit for bit: the w
    inits are deterministic in ``seed`` and the test mask is a stateless
    hash of the mask seed, so the state holds no arrays. On a mesh rank
    0 writes the search state and every rank waits for the write.
    """
    if config is not None:
        k_init, k_max, k_min = config.k_init, config.k_max, config.k_min
        n_replicates, tol, maxit = config.reps, config.tol, config.maxit
        cv_tol = config.cv_tol_effective
        L1, L2, seed, verbose = (config.L1, config.L2, config.seed,
                                 config.verbose)
        test_density = config.test_set_density
        learning_rate, tol_overfit = (config.learning_rate,
                                      config.tol_overfit)
        trace_test_mse = config.trace_test_mse
    if L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    _check_density(test_density)
    if k_init is None or k_init < k_min:
        k_init = k_min
    if k_min < 2:
        raise ValueError("k_min cannot be less than 2")

    with span("singlet.setup"):
        P = _engine_or_providers(A, mesh, device)
        # the mesh the search state is saved on: the engine's, also when
        # an engine on a mesh is passed in
        mesh = getattr(P, "mesh", None)
        genes_pad, genes_true, dev = (_rows_pad_of(P), _rows_true_of(P),
                                      _device_of(P))
        inv_density = round(1.0 / test_density)
        test_seed = seed

        w_inits = [
            init_w(k_max, genes_pad, genes_true, seed=seed * 1000 + rep,
                   device=dev)
            for rep in range(1, n_replicates + 1)
        ]

    # the search state, saved after every completed fit
    ckpt = resolve_manager(checkpoint, default_every=1)
    ckpt_cfg = CheckpointManager.config_of(
        kind="ard_search", genes=int(genes_true),
        k_init=int(k_init), k_max=int(k_max), k_min=int(k_min),
        n_replicates=int(n_replicates), tol=float(tol), cv_tol=float(cv_tol),
        maxit=int(maxit), L1=float(L1), L2=float(L2),
        inv_density=int(inv_density), learning_rate=float(learning_rate),
        tol_overfit=float(tol_overfit), trace_test_mse=int(trace_test_mse),
        seed=int(seed)) if ckpt else None
    # (max_fits is not fingerprinted: a valve-stopped search resumes with
    # a larger max_fits)

    rows = []
    n_fits = 0
    start_rep, resume_inner = 1, None
    if ckpt is not None:
        st = ckpt.restore(ckpt_cfg, verbose=verbose >= 1)
        if st is not None:
            rows = list(st["rows"])
            n_fits = int(st["n_fits"])
            start_rep = int(st["curr_rep"])
            if st.get("in_rep"):
                resume_inner = (float(st["step_size"]),
                                int(st["curr_rank"]), int(st["this_k_max"]))

    def _save_search(curr_rep, in_rep, step_size=1.0, curr_rank=0,
                     this_k_max=0):
        if ckpt is None:
            return
        save_once(ckpt, n_fits, lambda: dict(
            ckpt_cfg, rows=rows, n_fits=int(n_fits), curr_rep=int(curr_rep),
            in_rep=bool(in_rep), step_size=float(step_size),
            curr_rank=int(curr_rank), this_k_max=int(this_k_max)), mesh)

    for curr_rep in range(start_rep, n_replicates + 1):
        if verbose >= 1 and n_replicates > 1:
            print(f"\nREPLICATE {curr_rep}/{n_replicates}")
        if resume_inner is not None:
            step_size, curr_rank, this_k_max = resume_inner
            resume_inner = None
        else:
            step_size = 1.0
            curr_rank = int(k_init)
            this_k_max = k_max
        while (step_size >= 1 and curr_rank <= this_k_max
               and curr_rank >= k_min and n_fits < max_fits):
            vprint(verbose, 1, f"k = {curr_rank} , rep = {curr_rep}")
            res = _fit_masked(
                P, curr_rank,
                w_init=w_inits[curr_rep - 1][:, :curr_rank],
                mask_seed=test_seed + curr_rep, inv_density=inv_density,
                tol=cv_tol, maxit=maxit, L1=L1, L2=L2,
                overfit_threshold=tol_overfit,
                trace_test_mse=trace_test_mse, verbose=verbose,
            )
            n_fits += 1
            overfit_score = res.score_overfit[-1]
            for e, i, t in zip(res.test_mse, res.iter, res.tol):
                rows.append(dict(k=int(curr_rank), rep=int(curr_rep),
                                 test_error=float(e), iter=int(i),
                                 tol=float(t),
                                 overfit_score=float(overfit_score)))
            vprint(verbose, 2, f"   test_error = {res.test_mse[-1]:.4e}")
            if overfit_score >= tol_overfit:
                this_k_max = curr_rank

            df_rep = pd.DataFrame([r for r in rows if r["rep"] == curr_rep])
            df_rep = df_rep.sort_values("k", kind="stable")
            # NOTE: the reference calls GetBestRank with its *default*
            # tol.overfit here (reference:R/ard_nmf.R:129), not tol_overfit.
            best_rank = get_best_rank(df_rep[df_rep["k"] < this_k_max])
            condensed = (
                df_rep.sort_values("iter").groupby("k", as_index=False).last()
            ).sort_values("k").reset_index(drop=True)
            vprint(verbose, 2, f"   best rank in replicate = {best_rank}\n")
            kvals = condensed["k"].tolist()
            if best_rank not in kvals:
                # can occur only via the empty-frame fallback of
                # get_best_rank; step outward from it
                curr_rank = best_rank + int(step_size)
                step_size *= (1 + learning_rate)
                _save_search(curr_rep, True, step_size, curr_rank,
                             this_k_max)
                continue
            rank_ind = kvals.index(best_rank)
            if rank_ind == len(kvals) - 1:
                step_size *= (1 + learning_rate)
                curr_rank = best_rank + int(step_size)
            elif rank_ind == 0:
                if int(step_size) < best_rank:
                    curr_rank = best_rank - int(step_size)
                    step_size *= (learning_rate + 1)
                else:
                    curr_rank = best_rank // 2
            else:
                next_lower = kvals[rank_ind - 1]
                next_higher = kvals[rank_ind + 1]
                diff_lower = best_rank - next_lower
                diff_higher = next_higher - best_rank
                if diff_lower <= 1 and diff_higher <= 1:
                    break
                elif diff_lower >= diff_higher:
                    curr_rank = best_rank - diff_lower // 2
                else:
                    curr_rank = best_rank + diff_higher // 2
            _save_search(curr_rep, True, step_size, curr_rank, this_k_max)
        # the replicate is finished, unless the max_fits valve stopped it
        # mid-search: then the in-replicate state saved above survives, so
        # that a resume with a larger max_fits goes on with the walk
        if not (step_size >= 1 and curr_rank <= this_k_max
                and curr_rank >= k_min and n_fits >= max_fits):
            _save_search(curr_rep + 1, False)

    df = pd.DataFrame(rows)
    df.attrs["class"] = "cross_validate_nmf_data"
    best_rank = get_best_rank(df, tol_overfit)

    vprint(verbose, 1, f"\nFitting final model at k = {best_rank}")
    w, d, h = _fit_plain(P, best_rank, w_init=w_inits[0][:, :best_rank],
                         tol=tol, maxit=maxit, L1=L1, L2=L2, seed=seed,
                         verbose=verbose > 2)
    return _finalize(w, d, h, gene_names, cell_names, cv_data=df)
