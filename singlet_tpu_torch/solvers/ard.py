"""Masked (cross-validation) ALS fit with overfit early stopping.

Port of ``singlet_tpu/solvers/ard.py`` (``c_ard_nmf_base``,
reference:src/singlet.cpp:1091-1152): the ALS loop runs with the speckled
test set masked out of both half-updates; every ``trace_test_mse``
iterations the held-out MSE is evaluated and an overfit score
``(err - min_err) / (err + min_err)`` is tracked; the fit stops early when
the score exceeds ``overfit_threshold``.

The JAX fit loop (``_ard_loop_device``) is one ``lax.while_loop`` so that a
fit costs one sync with a remote TPU. Here it is a host loop that syncs
once per iteration (the tol, and the test MSE at a trace iteration, in one
read), with the same schedule: the trace is taken at ``it % trace == 0``
with ``it`` counted from 0 before its increment, scores are compared in
float32, and on a stop ``it`` is not incremented (the reference breaks
before ``it++``). The checkpointed fit (``checkpoint=``, the JAX
package's per-step path) runs the same loop with a save after each step
that did not stop the fit; every fit logs ``fit_start``, ``iteration``
(with ``test_mse`` and ``overfit_score`` on traced iterations) and
``fit_end`` events, and, while the tracing is on, the spans and the
CD-NNLS counters of ``solvers/als.py``'s loop, with ``singlet.test_mse``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from singlet_tpu_torch.checkpoint import CheckpointManager, resolve_manager
from singlet_tpu_torch.device import vprint
from singlet_tpu_torch.ops.nnls import SweepSettings, sweep_cap_update
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.solvers.als import (_padded, als_step_masked,
                                           checkpoint_saver, fit_providers,
                                           init_w, mse_test,
                                           restore_fit_state)
from singlet_tpu_torch.sparse.matrix import DenseMatrix
from singlet_tpu_torch.tracing import (CdCounts, call_fields,
                                       get_metric_logger, output_span, span)


@dataclasses.dataclass
class ArdFitResult:
    w: np.ndarray           # (genes, k)
    d: np.ndarray           # (k,)
    h: np.ndarray           # (k, cells)
    test_mse: List[float]
    iter: List[int]
    tol: List[float]
    score_overfit: List[float]


def _score(err, min_err):
    """The overfit score in float32, as the JAX loop computes it on device
    (0/0 gives NaN there too)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return (err - min_err) / (err + min_err)


def _ard_loop(step, mse, W, H, tol_target, overfit_threshold, maxit: int,
              trace_every: int, settings: SweepSettings, verbose: int = 0,
              start: Optional[dict] = None, on_step=None,
              fit_id: Optional[str] = None):
    """The masked fit loop with the trace and early-stop policy of
    ``_ard_loop_device``. ``step(W, H, sweep_cap)`` is one masked iteration,
    returning (W, H, d, tol); ``mse(W, d, H)`` the test MSE, a 0-d tensor.

    ``start`` is a saved state to go on from (``d``, ``it`` and the four
    traces ``test_mse``, ``iter``, ``tol``, ``score_overfit``, as the
    checkpoint holds them): the loop resumes at iteration ``it`` from the
    last traced tol, with the exact-phase latch recovered from the traced
    tols, as the JAX checkpoint path does (with ``trace_every`` = 1 that is
    the state of the uninterrupted loop). ``on_step(it, W, H, d, traces)``
    runs after each step that did not stop the fit; with ``fit_id`` each
    step logs an ``iteration`` event. Returns (W, H, d, it, stopped,
    traces, tol) with ``tol`` the last step's."""
    target = np.float32(tol_target)
    threshold = np.float32(overfit_threshold)
    st = start or {}
    d = st.get("d")
    if d is None:
        d = torch.ones(W.shape[1], dtype=W.dtype, device=W.device)
    traces = {key: list(st.get(key, ())) for key in
              ("test_mse", "iter", "tol", "score_overfit")}
    traces["iter"] = [int(i) for i in traces["iter"]]
    it = int(st.get("it", 0))
    tolv = np.float32(traces["tol"][-1]) if traces["tol"] else np.float32(1.0)
    min_err = np.float32(min(traces["test_mse"], default=np.inf))
    exact = stopped = False
    for t in traces["tol"]:
        _, exact = sweep_cap_update(exact, t, target, masked=True,
                                    settings=settings)
    logger = get_metric_logger()
    counts = CdCounts(W.device)
    while not stopped and it < maxit and tolv > target:
        with span("singlet.iter"):
            t0 = time.perf_counter()
            cap, exact = sweep_cap_update(exact, tolv, target, masked=True,
                                          settings=settings)
            with counts.armed(), span("singlet.step"):
                W, H, d, t = step(W, H, cap)
            traced = it % trace_every == 0
            if traced:
                with span("singlet.test_mse"):
                    err_t = mse(W, d, H)
                with span("singlet.sync"):
                    (tv, ev), cd = counts.read(t, err_t)    # the one sync
            else:
                with span("singlet.sync"):
                    (tv,), cd = counts.read(t)
            tolv = np.float32(tv)
            event = dict(iter=it + 1, tol=float(tolv), **cd)
            if traced:
                err = np.float32(ev)
                min_err = min(min_err, err)
                score = _score(err, min_err)
                for key, v in (("test_mse", float(err)), ("iter", it),
                               ("tol", float(tolv)),
                               ("score_overfit", float(score))):
                    traces[key].append(v)
                event.update(test_mse=float(err), overfit_score=float(score))
                stopped = bool(score > threshold)
                vprint(verbose, 3,
                       f"{it + 1:4d} | {tolv:8.2e} | {score:8.2e}")
            else:
                vprint(verbose, 3, f"{it + 1:4d} | {tolv:8.2e} |        -")
            if fit_id is not None:
                logger.log("iteration", fit=fit_id,
                           ms=round((time.perf_counter() - t0) * 1e3, 3),
                           **event)
            if not stopped:
                it += 1
                if on_step is not None:
                    on_step(it, W, H, d, traces)
    return W, H, d, it, stopped, traces, float(tolv)


def run_ard(step, mse, W, H, k: int, rows_true: int, cols_true: int,
            tol, overfit_threshold, maxit: int, trace_test_mse: int,
            settings: SweepSettings, verbose: int = 0,
            start: Optional[dict] = None, on_step=None,
            fit_id: Optional[str] = None, gather=None) -> ArdFitResult:
    """:func:`_ard_loop` (``start``, ``on_step`` and ``fit_id`` passed on),
    then the tail trace (a test MSE after the last step when the schedule
    did not trace it), as an ``ArdFitResult`` of the true rows, columns
    and factors; with ``fit_id``, a ``fit_end`` event. Shared by the dense
    masked fit and the blocked-ELL engine; ``gather(H)`` gives the whole H
    from a rank's rows on a mesh."""
    W, H, d, it, stopped, tr, tol_ = _ard_loop(
        step, mse, W, H, tol, overfit_threshold, int(maxit),
        int(trace_test_mse), settings, verbose=verbose, start=start,
        on_step=on_step, fit_id=fit_id)
    test_mse_t, iter_t, tol_t, score_t = (
        tr["test_mse"], tr["iter"], tr["tol"], tr["score_overfit"])

    if (it % trace_test_mse != 0 and not stopped
            and (not iter_t or iter_t[-1] != it)):
        with span("singlet.test_mse"):
            err_t = mse(W, d, H)
        with span("singlet.sync"):
            err = float(err_t)
        test_mse_t.append(err)
        iter_t.append(it)
        tol_t.append(tol_)
        min_err = min(test_mse_t)
        score_t.append((err - min_err) / (err + min_err))

    if gather is not None:
        H = gather(H)
    if fit_id is not None:
        get_metric_logger().log(
            "fit_end", fit=fit_id, n_iter=it,
            test_mse=test_mse_t[-1] if test_mse_t else None,
            stopped_early=stopped)
    with output_span():
        w, d, h = (W[:rows_true, :k].cpu().numpy(), d[:k].cpu().numpy(),
                   H[:cols_true, :k].T.cpu().numpy())
    return ArdFitResult(
        w=w,
        d=d,
        h=h,
        test_mse=test_mse_t,
        iter=iter_t,
        tol=tol_t,
        score_overfit=score_t,
    )


def ard_nmf_fit(
    A: Union[np.ndarray, DenseMatrix],
    k: int,
    At: Optional[DenseMatrix] = None,
    w_init=None,
    mask_seed: int = 0,
    inv_density: int = 20,
    tol: float = 1e-4,
    maxit: int = 100,
    L1: float = 0.01,
    L2: float = 0.0,
    overfit_threshold: float = 1e-3,
    trace_test_mse: int = 1,
    verbose: int = 0,
    init_seed: int = 0,
    checkpoint=None,
    k_bucket: int = 8,
    device=None,
) -> ArdFitResult:
    """One masked fit at fixed rank k, returning factor matrices + traces.

    The trace schedule, overfit score, early stop and tail trace follow
    reference:src/singlet.cpp:1106-1141; the trace vectors feed the
    ``cross_validate_nmf_data`` frame (reference:R/ard_nmf.R:118). ``A``
    and ``device`` are taken as ``nmf_fit`` takes them.

    ``k_bucket`` is accepted for the JAX signature and does nothing: it
    pads the factor count so that the rank searches share compiled XLA
    programs, and the padded fit equals the unpadded one up to
    reassociation (tests/test_drivers.py::test_rank_bucketing_is_exact).
    Eager PyTorch compiles nothing per rank.

    ``checkpoint`` (a directory path or ``CheckpointManager``) saves W, H,
    d, ``it`` and the four traces every ``every`` iterations under the JAX
    package's ``algo="ard"`` fingerprint, with ``k_pad`` written as ``k``
    because ``k_bucket`` is inert here; a re-run resumes from the newest
    checkpoint of that fingerprint, with the latch and the loop's tol
    recovered from the traced tols as JAX recovers them (bit for bit the
    uninterrupted fit when every iteration is traced).
    """
    with span("singlet.setup"):
        Ap, Atp, dev = fit_providers(A, At, device)
        genes_pad, cells_pad = Ap.rows_pad, Ap.cols_pad
        sp = seed_pair(mask_seed)
        if w_init is None:
            W = init_w(k, genes_pad, Ap.rows_true, init_seed, device=dev)
        else:
            W = _padded(w_init, genes_pad, k, dev)
        H = torch.zeros((cells_pad, k), dtype=torch.float32, device=dev)

        mgr = resolve_manager(checkpoint)
        ckpt_config = CheckpointManager.config_of(
            algo="ard", k=int(k), k_pad=int(k), genes_pad=int(genes_pad),
            cells_pad=int(cells_pad), L1=L1, L2=L2, mask_seed=int(mask_seed),
            inv_density=int(inv_density), trace=int(trace_test_mse))
        start = restore_fit_state(mgr, ckpt_config, dev, verbose)
        if start is not None:
            W, H = start["W"], start["H"]

        logger = get_metric_logger()
        fit_id = logger.new_fit_id("ard")
        logger.log("fit_start", fit=fit_id, algo="ard_masked", k=int(k),
                   genes=int(Ap.rows_true), cells=int(Ap.cols_true),
                   inv_density=int(inv_density), maxit=maxit,
                   resumed_at=(start or {}).get("it") or None,
                   **call_fields())
        settings = SweepSettings.from_env()
        cell_block, gene_block = Ap.block, Atp.block

        def step(W, H, cap):
            return als_step_masked(Ap, Atp, W, H, sp, float(L1), float(L2),
                                   int(inv_density), cell_block, gene_block,
                                   sweep_cap=cap,
                                   max_sweeps=settings.max_sweeps)

        def mse(W, d, H):
            return mse_test(Ap, W, d, H, sp, int(inv_density), cell_block)

    return run_ard(step, mse, W, H, k, Ap.rows_true, Ap.cols_true, tol,
                   overfit_threshold, maxit, trace_test_mse, settings,
                   verbose=verbose, start=start,
                   on_step=checkpoint_saver(mgr, ckpt_config), fit_id=fit_id)
