"""The comparison that decides ``correct``.

The window's fits are judged through one of them, drawn from the seed:
the reference (``reference.py``) follows that fit's first step from the
start it re-derives itself, and its last step from the program's state
before it, and each half-update of the program is held to the
reference's on a sample of columns drawn from the seed. The numbers:

* ``init_gap``: the largest difference between the W the fit started from
  and the W that the init rule gives for the fit's seed (exact: 0);
* ``fit_gap``: the largest of these relative gaps (Frobenius norms over
  the sampled columns, as a share of the reference's): the program's H of
  the sampled cells against the reference's h-side solve from the same W
  and warm start, each factor normalised over the sampled cells (the
  program normalises over all cells), and the program's W diag(d) of the
  sampled genes against the reference's w-side solve from the program's
  H, each at the first and the last step; for a masked fit also the test
  errors the driver returned at the last traced iteration, the least
  error and the tail trace against the reference's test MSEs of the
  states they were taken from. The parts are kept in ``parts``; one number,
  because a TF32 control moves the h-side by 20-80 times the program's
  gap while the w-side and the test MSE, sums over hundreds of thousands
  of cells or held-out entries, average TF32's rounding away;
* ``stop_gap``: whether the fit stopped where it should. Its parts: the
  step count that the stop rule (a frozen copy of the fit loops' own)
  gives on the fit's trace of tols and test errors, with the reference's
  test MSEs in place of the program's at the states that decide a masked
  stop (the last traced iteration's and the least error's, which the tap
  keeps), less the steps the fit ran (``replay``); and the relative gap
  between the tol that the first step returned and the reference's 1 -
  Pearson of its W against its input W (``tol1``). A step that reports
  too small a tol, a loop that stops before its rule does, or a test
  error that moves the overfit decision, reads high. The same gap at the
  last step, and the gap of the last trace's overfit score in units of
  the threshold, are kept beside them (``info.``) but not compared: the
  program's float32 tol near 1e-5 and its float32 score read as far from
  the reference as the control does (see PERF.md);
* ``model_gap`` (plain fits): the largest difference between the model
  the driver returned and the fit's last state sorted by decreasing d
  (exact: 0).

With ``control``, the same numbers of the reference put in the program's
place at a lower precision, from the same states.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench import reference as ref


@dataclasses.dataclass(frozen=True)
class FitRules:
    """What one fit of a call starts from, solves, and stops by: the init
    draws ``k_top`` columns from ``init_seed`` and keeps the first ``k``;
    a masked fit holds out the test set of ``mask_seed`` at 1 in
    ``inv_density``, traces its test error every ``trace_every``
    iterations and stops when the overfit score passes ``overfit``."""

    masked: bool
    k: int
    k_top: int
    init_seed: int
    tol: float
    L1: float
    maxit: int
    mask_seed: int = 0
    inv_density: int = 0
    trace_every: int = 0
    overfit: float = 0.0


def col_gap(P: torch.Tensor, R: torch.Tensor) -> float:
    """||P - R|| over ||R|| (Frobenius, float64) of the sampled columns."""
    P, R = P.to(torch.float64), R.to(torch.float64)
    return float(torch.linalg.vector_norm(P - R)
                 / torch.linalg.vector_norm(R))


def _normalised(X: torch.Tensor) -> torch.Tensor:
    X = X.to(torch.float64)
    return X / (X.sum(dim=0, keepdim=True) + 1e-300)


def sample(n: int, size: int, seed: int, device) -> torch.Tensor:
    """``size`` distinct indices of ``range(n)`` (all when size >= n),
    sorted, drawn from ``seed``."""
    if size >= n:
        return torch.arange(n, device=device)
    gen = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(n, generator=gen)[:size].sort().values.to(device)


def step_spec(rules, cfg, tols, j: int) -> ref.StepSpec:
    """The reference's spec of step j (1-based) of a fit."""
    quantized = rules.masked and cfg.get("mask_products") == "int8"
    return ref.StepSpec(
        L1_h=rules.L1, L1_w=rules.L1,
        cap=ref.sweep_cap(tols[:j - 1], rules.tol, rules.masked),
        masked=rules.masked, mask_seed=rules.mask_seed,
        inv_density=rules.inv_density, quantized=quantized,
        h_quant_block=int(cfg.get("cell_block", 0)))


def _steps(fit):
    out = [(1, fit.first)]
    if fit.steps > 1:
        out.append((fit.steps, fit.last))
    return out


def replay_steps(rules: FitRules, its, errs=None) -> int:
    """The steps that the fit loops' stop rule runs on the fit's trace
    ``its`` (its ``iteration`` events: the tol of each step, the test
    error of each traced one), with ``errs`` (trace index: error) in place
    of the trace's errors where given: the first step after which the
    rule stops, or one past the trace when it would go on."""
    errs = errs or {}
    target = np.float32(rules.tol)
    it, n, min_err = 0, 0, np.float32(np.inf)
    for i, e in enumerate(its):
        stopped = False
        traced = rules.masked and it % rules.trace_every == 0
        if traced != ("test_mse" in e):
            return 0            # a trace where the schedule has none, or none
        if traced:
            err = np.float32(errs.get(n, e["test_mse"]))
            n += 1
            min_err = min(min_err, err)
            with np.errstate(invalid="ignore", divide="ignore"):
                score = (err - min_err) / (err + min_err)
            stopped = bool(score > np.float32(rules.overfit))
        if not stopped:
            it += 1
        if stopped or it >= rules.maxit or \
                not np.float32(e["tol"]) > target:
            return i + 1
    return len(its) + 1


def _score(errs):
    """The overfit score of the last of ``errs``."""
    lo = min(errs)
    return (errs[-1] - lo) / (errs[-1] + lo)


def test_errors(fit, its, op, rules: FitRules, prec: ref.Precision):
    """{test-MSE call index: error in ``prec``} of the states the tap kept
    that decide the stop: the last traced iteration's, the least error's
    and the tail trace's (the last call)."""
    errs = [float(e["test_mse"]) for e in its if "test_mse" in e]
    keep = {len(errs) - 1, min(range(len(errs)), key=errs.__getitem__),
            fit.n_mse - 1}
    out = {}
    for i in sorted(keep):
        W, d, H = fit.mse_states[i]
        out[i] = ref.test_mse(op, W, d, H, rules.mask_seed,
                              rules.inv_density, prec)
    return out


def stop_parts(fit, rules: FitRules, its, op, prec: ref.Precision,
               errs_ref=None, errs_got=None,
               control: Optional[ref.Precision] = None):
    """(the parts of ``stop_gap``, the readings kept beside them), see the
    module's docstring; ``errs_ref`` and ``errs_got`` are ``test_errors``
    of the reference and, with ``control``, of the control."""
    held, info = {}, {}
    if control is None:
        held["replay"] = float(abs(replay_steps(rules, its, errs_ref)
                                   - fit.steps))
    g = op.genes_true
    for j, st in _steps(fit):
        want = ref.cor_distance(st.W[:g], st.W_in[:g], prec)
        got = float(st.tol) if control is None else \
            ref.cor_distance(st.W[:g], st.W_in[:g], control)
        (held if j == 1 else info)[f"tol{j}"] = \
            abs(got - want) / max(abs(want), 1e-30)
    if rules.masked:
        errs = [float(e["test_mse"]) for e in its if "test_mse" in e]
        last = len(errs) - 1
        want, got = list(errs), list(errs)
        for i in range(last + 1):
            if i in errs_ref:
                want[i] = errs_ref[i]
                if control is not None:
                    got[i] = errs_got[i]
        # the program scores its own errors in float32, as the loop does
        prog = float(_score(np.float32(got) if control is None else got))
        info["score"] = abs(prog - _score(want)) / rules.overfit
    return held, info


def judge(fit, rules: FitRules, its, answers, op, cfg, check, seed: int,
          control: Optional[ref.Precision] = None):
    """(the numbers compared, their parts) for one fit
    (``tap.FitRecord``), with its ``FitRules``, its ``iteration`` events,
    the answers the driver returned and the reference's operand. With
    ``control``, the numbers of the reference computed at that precision
    in the program's place."""
    prec = ref.Precision()
    dev = fit.first.W_in.device
    k = rules.k
    tols = [e["tol"] for e in its]
    cells = sample(op.cells_pad, int(check["cells"]), seed, dev)
    genes = sample(op.genes_pad, int(check["genes"]), seed + 1, dev)
    W0 = ref.init_w(rules.k_top, op.genes_pad, op.genes_true,
                    rules.init_seed, dev)[:, :k]
    out = {"init_gap": float((fit.first.W_in - W0).abs().max())}
    parts = {}
    for j, st in _steps(fit):
        spec = step_spec(rules, cfg, tols, j)
        h_ref = ref.h_half(op, st.W_in, st.H_in, cells, spec, prec)
        w_ref = ref.w_half(op, st.H, st.W_in, genes, spec, prec)
        if control is None:
            h_prog = st.H[cells]
            w_prog = st.W[genes].to(torch.float64) * \
                st.d.to(torch.float64)[None, :]
        else:
            h_prog = ref.h_half(op, st.W_in, st.H_in, cells, spec, control)
            w_prog = ref.w_half(op, st.H, st.W_in, genes, spec, control)
        parts[f"h{j}"] = col_gap(_normalised(h_prog), _normalised(h_ref))
        parts[f"w{j}"] = col_gap(w_prog, w_ref)
    last = fit.last
    errs_ref = errs_got = None
    if rules.masked:
        errs_ref = test_errors(fit, its, op, rules, prec)
        errs_got = answers["test_error"] if control is None else \
            test_errors(fit, its, op, rules, control)
        parts["mse"] = max(abs(errs_got[i] - e) / e
                           for i, e in errs_ref.items())
    out["fit_gap"] = max(parts.values())
    held, info = stop_parts(fit, rules, its, op, prec, errs_ref, errs_got,
                            control)
    out["stop_gap"] = max(held.values())
    parts.update({f"stop.{n}": v for n, v in held.items()})
    parts.update({f"info.{n}": v for n, v in info.items()})
    if not rules.masked:
        d = last.d.cpu().numpy()
        order = np.argsort(-d, kind="stable")
        w = last.W[:op.genes_true].cpu().numpy()[:, order]
        h = last.H[:op.cells_true].T.cpu().numpy()[order]
        if control is None:
            gaps = [np.abs(answers["w"] - w).max(),
                    np.abs(answers["d"] - d[order]).max(),
                    np.abs(answers["h"] - h).max()]
        else:
            gaps = [0.0]
        out["model_gap"] = float(max(gaps))
    return out, parts
