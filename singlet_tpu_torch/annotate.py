"""Factor annotation: one-vs-all means models with moderated t statistics.

Equivalent of the reference's ``AnnotateNMF`` stack
(reference:R/AnnotateNMF.R:29-113, getModelMatrix.R:46-84, getModelFit.R:23-62,
getModelResults.R:27-56): for each categorical metadata column, build a
one-vs-all means-model design (``~ 0 + group``), fit row-wise least squares of
the (centered) factor embedding matrix h on it, shrink residual variances by
empirical Bayes (Smyth 2004 closed forms: fitFDist moment estimator +
squeezeVar), and report per-(factor, group) log-odds (lods/B statistic),
one-tailed moderated-t p-values and BH-FDR.

The reference calls limma with ``robust=TRUE`` (reference:R/getModelFit.R:23-62);
``annotate_nmf(..., robust=True)`` (the default, matching the reference)
uses the outlier-robust hyperparameter fit: winsorized moment matching of
the log-F prior (the estimator structure of limma::fitFDistRobustly,
Phipson et al. 2016) plus per-row prior-df down-weighting for outlier
variances, so hypervariable factors keep their own variance instead of
being squeezed toward an inflated prior. ``robust=False`` gives the
standard Smyth 2004 closed forms.

A copy of ``singlet_tpu/annotate.py`` (numpy, scipy and pandas; host code,
no kernel): the port imports nothing of the JAX package, whose ``__init__``
imports jax.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd
from scipy import special, stats


# ---------------------------------------------------------------------------
# design construction
# ---------------------------------------------------------------------------

def is_factor_like(col: np.ndarray, max_levels: int = 200) -> bool:
    """A column usable for annotation: categorical with 2..max_levels levels
    (reference:R/checkColumns.R)."""
    vals = [v for v in col if v is not None and v == v]
    if len(vals) == 0:
        return False
    if isinstance(vals[0], (int, np.integer, float, np.floating)) and not isinstance(
            vals[0], (bool, np.bool_)):
        return False  # numeric columns are not factors
    levels = set(vals)
    return 1 < len(levels) <= max_levels


def check_columns(meta: Dict[str, np.ndarray], columns: Optional[Sequence[str]],
                  max_levels: int = 200) -> List[str]:
    cols = list(columns) if columns is not None else list(meta.keys())
    return [c for c in cols if c in meta and
            is_factor_like(np.asarray(meta[c], dtype=object), max_levels)]


def model_matrix(groups: np.ndarray):
    """One-vs-all means model: indicator column per level, no intercept
    (reference:R/getModelMatrix.R:46-84 with ova=TRUE). Rows with missing
    values are dropped (limma drops NA design rows).

    Returns (design (n_kept, n_levels), level names, kept row indices)."""
    groups = np.asarray(groups, dtype=object)
    keep = np.array([g is not None and g == g for g in groups])
    kept = np.where(keep)[0]
    vals = groups[kept]
    levels = sorted(set(vals.tolist()), key=str)
    X = np.zeros((len(kept), len(levels)))
    for j, lv in enumerate(levels):
        X[np.asarray([v == lv for v in vals]), j] = 1.0
    return X, [str(lv) for lv in levels], kept


# ---------------------------------------------------------------------------
# row-wise least squares + empirical Bayes (limma semantics)
# ---------------------------------------------------------------------------

def lm_fit(data: np.ndarray, design: np.ndarray):
    """Row-wise OLS of data (rows x samples) on design (samples x coefs).

    Returns dict with coefficients, stdev_unscaled, sigma2, df_residual.
    """
    X = np.asarray(design, np.float64)
    Y = np.asarray(data, np.float64)
    n, p = X.shape
    XtX = X.T @ X
    XtX_inv = np.linalg.pinv(XtX)
    coef = Y @ X @ XtX_inv.T                      # (rows, p)
    resid = Y - coef @ X.T
    df_resid = n - np.linalg.matrix_rank(X)
    sigma2 = np.sum(resid ** 2, axis=1) / max(df_resid, 1)
    stdev_unscaled = np.sqrt(np.maximum(np.diag(XtX_inv), 0.0))[None, :]
    return dict(coefficients=coef,
                stdev_unscaled=np.broadcast_to(stdev_unscaled, coef.shape),
                sigma2=sigma2, df_residual=df_resid)


def trigamma_inverse(y: float) -> float:
    """Solve trigamma(x) = y (limma::trigammaInverse, Newton iteration)."""
    if y <= 0:
        return math.inf
    if y > 1e7:
        return 1.0 / math.sqrt(y)
    if y < 1e-6:
        return 1.0 / y
    x = 0.5 + 1.0 / y
    for _ in range(50):
        tri = float(special.polygamma(1, x))
        dif = tri * (1.0 - tri / y) / float(special.polygamma(2, x))
        x = x + dif
        if abs(dif) / x < 1e-8:
            break
    return x


def fit_f_dist(s2: np.ndarray, df1: float):
    """Moment estimator of the scaled-F prior (limma::fitFDist):
    s2 ~ s0^2 * F(df1, df0). Returns (s0^2, df0)."""
    s2 = np.asarray(s2, np.float64)
    ok = s2 > 0
    if ok.sum() == 0:
        return np.nan, np.nan
    z = np.log(s2[ok])
    e = z - special.digamma(df1 / 2) + math.log(df1 / 2)
    emean = e.mean()
    n = e.size
    if n > 1:
        evar = e.var(ddof=1) - float(special.polygamma(1, df1 / 2))
    else:
        evar = 0.0
    if evar > 0:
        df0 = 2 * trigamma_inverse(evar)
        s20 = math.exp(emean + special.digamma(df0 / 2) - math.log(df0 / 2))
    else:
        df0 = math.inf
        s20 = math.exp(emean)
    return s20, df0


def fit_f_dist_robust(s2: np.ndarray, df1: float,
                      winsor_tail_p=(0.05, 0.1), grid: int = 4097):
    """Outlier-robust scaled-F prior fit (the estimator structure of
    limma::fitFDistRobustly, Phipson et al. 2016, consumed by the
    reference's eBayes(robust=TRUE) call at reference:R/getModelFit.R:44):

      1. winsorize z = log(s2) at the (lower, upper) tail quantiles;
      2. choose df0 so the *theoretical* winsorized variance of
         log F(df1, df0) (computed by quantile-grid integration) matches
         the observed winsorized variance — outlier variances cannot
         inflate the prior spread;
      3. s0^2 from the winsorized-mean match;
      4. per-observation prior df: each row's F tail probability under the
         fitted prior is compared with its empirical tail probability;
         rows more extreme than their rank warrants get prior df shrunk
         toward 0 (ProbOutlier-weighted), so their own variance is kept
         unsqueezed.

    Returns (s20, df0, df0_per_row).
    """
    s2 = np.asarray(s2, np.float64)
    z = np.log(np.maximum(s2, 1e-300))
    n = z.size
    if n < 2:
        s20, df0 = fit_f_dist(s2, df1)
        return s20, df0, np.full(n, df0)
    lo_p, hi_p = winsor_tail_p
    zq = np.quantile(z, [lo_p, 1.0 - hi_p])
    zw = np.clip(z, zq[0], zq[1])
    zwmean = float(zw.mean())
    zwvar = float(zw.var(ddof=1))

    pgrid = (np.arange(grid) + 0.5) / grid
    lo_i = int(np.floor(lo_p * grid))
    hi_i = int(np.ceil((1.0 - hi_p) * grid))

    def win_moments(df0):
        x = np.log(stats.f.ppf(pgrid, df1, df0))
        x = np.clip(x, x[lo_i], x[min(hi_i, grid - 1)])
        return float(x.mean()), float(x.var(ddof=0))

    # solve the winsorized-variance match on log10(df0); the theoretical
    # winsorized var decreases monotonically in df0
    from scipy.optimize import brentq

    def gap(log10_df0):
        return win_moments(10.0 ** log10_df0)[1] - zwvar

    try:
        if gap(-1.0) < 0:         # observed spread wider than any prior: df0->0
            df0 = 0.1
        elif gap(7.0) > 0:        # observed spread narrower than df0=1e7
            df0 = math.inf
        else:
            df0 = 10.0 ** brentq(gap, -1.0, 7.0, xtol=1e-4)
    except ValueError:
        df0 = math.inf

    # an infinitely informative prior still needs per-row outlier handling;
    # use a large finite surrogate for the row computations (F(df1, 1e6) is
    # numerically the scaled chi-squared limit)
    df0_eff = min(df0, 1e6)
    th_mean, _ = win_moments(df0_eff)
    s20 = math.exp(zwmean - th_mean)

    # per-row outlier probability and df0 shrinkage
    Fstat = s2 / s20
    tail_p = stats.f.sf(Fstat, df1, df0_eff)
    r = stats.rankdata(Fstat)
    empirical_tail = (n - r + 0.5) / n
    prob_not_outlier = np.minimum(tail_p / empirical_tail, 1.0)
    df0_row = np.where(prob_not_outlier >= 1.0, df0,
                       prob_not_outlier * df0_eff)
    return s20, df0, df0_row


def squeeze_var(sigma2: np.ndarray, df: float, robust: bool = False):
    """Shrink row variances toward the fitted prior (limma::squeezeVar).

    With ``robust=True`` the prior is fitted by the winsorized robust
    estimator and outlier rows get per-row prior df near 0 (their own
    variance survives). Returns (s2_post, s20, df0) — ``df0`` is a scalar
    for the classic path, a per-row array for the robust path."""
    if robust:
        s20, _, df0 = fit_f_dist_robust(sigma2, df)
        fin = np.isfinite(df0)
        df0_f = np.where(fin, df0, 1.0)
        s2_post = np.where(fin, (df0_f * s20 + df * sigma2) / (df0_f + df),
                           s20)
        return s2_post, s20, df0
    s20, df0 = fit_f_dist(sigma2, df)
    if math.isinf(df0):
        s2_post = np.full_like(sigma2, s20)
    else:
        s2_post = (df0 * s20 + df * sigma2) / (df0 + df)
    return s2_post, s20, df0


def _tmixture_vector(tstat, stdev_unscaled, df, proportion, v0_lim):
    """limma::tmixture.vector — estimate the prior coefficient variance from
    the top `proportion` of t statistics."""
    tstat = np.abs(np.asarray(tstat, np.float64))
    n = tstat.size
    ntarget = math.ceil(proportion / 2 * n)
    if ntarget < 1:
        return np.nan
    p = max(ntarget / n, proportion)
    order = np.argsort(-tstat)[:ntarget]
    tt = tstat[order]
    v1 = np.asarray(stdev_unscaled, np.float64)[order] ** 2
    r = np.arange(1, ntarget + 1)
    p0 = 2 * stats.t.sf(tt, df)
    ptarget = ((r - 0.5) / n - (1.0 - p) * p0) / p
    v0 = np.zeros(ntarget)
    pos = ptarget > p0
    if pos.any():
        qtarget = stats.t.isf(ptarget[pos] / 2, df)
        v0[pos] = v1[pos] * ((tt[pos] / qtarget) ** 2 - 1.0)
    v0 = np.clip(v0, v0_lim[0], v0_lim[1])
    return float(np.mean(v0))


def ebayes(fit: dict, proportion: float = 0.01,
           stdev_coef_lim=(0.1, 4.0), robust: bool = False) -> dict:
    """Empirical-Bayes moderation (limma::eBayes essentials): squeezed
    variances, moderated t, and the lods/B statistic. ``robust=True`` uses
    the outlier-robust prior fit (limma eBayes(robust=TRUE), the
    reference's call, reference:R/getModelFit.R:44) — ``df_total`` is then
    a per-row array (outlier rows get smaller prior df)."""
    coef = fit["coefficients"]
    su = fit["stdev_unscaled"]
    df = fit["df_residual"]
    s2_post, s20, df0 = squeeze_var(fit["sigma2"], df, robust=robust)
    df_pooled = df * coef.shape[0]
    df_total = np.minimum(np.nan_to_num(df + df0, posinf=df_pooled),
                          df_pooled)
    t = coef / (su * np.sqrt(s2_post)[:, None])

    # lods per coefficient column
    v0_lim = (stdev_coef_lim[0] ** 2 / float(np.median(s2_post)),
              stdev_coef_lim[1] ** 2 / float(np.median(s2_post)))
    df_mix = float(np.median(df_total))   # tmixture uses one representative df
    lods = np.empty_like(t)
    for j in range(t.shape[1]):
        v0 = _tmixture_vector(t[:, j], su[:, j], df_mix, proportion, v0_lim)
        if not np.isfinite(v0) or v0 < 0:
            v0 = 0.0
        v1 = su[:, j] ** 2
        r = (v1 + v0) / v1
        t2 = t[:, j] ** 2
        kernel = np.where(
            df_total > 1e6,
            t2 * (1 - 1 / r) / 2,
            (1 + df_total) / 2 * np.log(
                (t2 + df_total) / (t2 / r + np.maximum(df_total, 1e-300))))
        lods[:, j] = math.log(proportion / (1 - proportion)) - np.log(r) / 2 + kernel

    return dict(t=t, lods=lods, s2_post=s2_post, df_total=df_total,
                coefficients=coef, s2_prior=s20, df_prior=df0)


def bh_fdr(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg step-up adjustment (R p.adjust method='fdr')."""
    p = np.asarray(p, np.float64)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / np.arange(1, n + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.minimum(ranked, 1.0)
    return out


# ---------------------------------------------------------------------------
# public driver
# ---------------------------------------------------------------------------

def model_results(eb: dict, factor_names: Sequence[str],
                  group_names: Sequence[str], tail: str = "pos",
                  noneg: bool = True) -> pd.DataFrame:
    """Tidy per-(factor, group) results (reference:R/getModelResults.R:27-56):
    one-tailed moderated-t p-values, BH FDR, positive-lods filter."""
    t = eb["t"]
    lods = eb["lods"]
    df_total = np.broadcast_to(np.asarray(eb["df_total"], np.float64),
                               (t.shape[0],))
    rows = []
    for fi, fname in enumerate(factor_names):
        for gi, gname in enumerate(group_names):
            rows.append((gname, fname, lods[fi, gi], t[fi, gi],
                         df_total[fi]))
    df = pd.DataFrame(rows, columns=["group", "factor", "fc", "t", "df"])
    if tail == "pos":
        df["p_raw"] = stats.t.sf(df["t"], df["df"])
    elif tail == "neg":
        df["p_raw"] = stats.t.cdf(df["t"], df["df"])
    elif tail == "std":
        df["p_raw"] = 2 * stats.t.sf(np.abs(df["t"]), df["df"])
    else:
        raise ValueError("Invalid tail selection. Choose 'pos','neg', or 'std'")
    df["p"] = bh_fdr(df["p_raw"].to_numpy())
    if noneg:
        df = df[df["fc"] > 0]
    return df[["group", "factor", "fc", "p"]].reset_index(drop=True)


def annotate_nmf(model, meta: Dict[str, np.ndarray],
                 columns: Optional[Sequence[str]] = None,
                 center: bool = True, scale: bool = False,
                 max_levels: int = 200, tail: str = "pos",
                 annotation_name: str = "annotations",
                 robust: bool = True):
    """Annotate an NMFModel's factors against categorical metadata.

    ``robust=True`` (default — the reference runs limma with robust=TRUE,
    reference:R/getModelFit.R:44) protects the variance prior from
    hypervariable factors. Stores {column: DataFrame(group, factor, fc, p)}
    in ``model.misc[annotation_name]`` and returns it.
    """
    cols = check_columns(meta, columns, max_levels)
    h = np.asarray(model.h, np.float64)          # (k, cells)
    results = {}
    for col in cols:
        X, levels, kept = model_matrix(np.asarray(meta[col], dtype=object))
        dat = h[:, kept]
        if center:
            mu = dat.mean(axis=1, keepdims=True)
            dat = dat - mu
            if scale:
                sd = dat.std(axis=1, ddof=1, keepdims=True)
                sd[sd == 0] = 1.0
                dat = dat / sd
        fit = lm_fit(dat, X)
        eb = ebayes(fit, robust=robust)
        results[col] = model_results(eb, model.factor_names, levels, tail=tail)
    model.misc[annotation_name] = results
    return results
