"""Preprocessing: log-normalization, group reweighting, rasterization, normit.

Equivalents of ``PreprocessData`` (reference:R/PreprocessData.R:12-65, i.e.
Seurat::LogNormalize with scale.factor 1e4), ``weight_by_split``
(reference:src/singlet.cpp:119-144), ``rowwise_compress``
(reference:src/singlet.cpp:147-180) and ``normit`` (reference:R/normit.R:22-28).
All operate on scipy sparse or numpy arrays on host — ingest-time transforms,
not hot-path kernels.

A copy of ``singlet_tpu/preprocess.py`` (numpy and scipy; host code, no
kernel): the port imports nothing of the JAX package, whose ``__init__``
imports jax.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def log_normalize(counts, scale_factor: float = 1e4):
    """Seurat LogNormalize: per-cell unit normalization * scale_factor, then
    log1p. counts: genes x cells (sparse or dense). Returns same format."""
    if sp.issparse(counts):
        m = counts.tocsc().astype(np.float32, copy=True)
        colsums = np.asarray(m.sum(axis=0)).ravel()
        colsums[colsums == 0] = 1.0
        scale = (scale_factor / colsums).astype(np.float32)
        m = m.multiply(sp.csr_matrix(scale[None, :])).tocsc()
        m.data = np.log1p(m.data)
        return m
    m = np.asarray(counts, np.float32)
    colsums = m.sum(axis=0)
    colsums[colsums == 0] = 1.0
    return np.log1p(m * (scale_factor / colsums)[None, :])


def looks_like_counts(A) -> bool:
    """The reference's raw-counts heuristic: all values integral
    (reference:R/RunNMF.R:66-69)."""
    v = A.data if sp.issparse(A) else np.asarray(A).ravel()
    return bool(np.sum(v.astype(np.int64)) == np.sum(v))


def weight_by_split(A, split_by, n_groups: int | None = None):
    """Scale each group's columns so every group sums to the first group's
    total (equal contribution to the objective)
    (reference:src/singlet.cpp:119-144).

    split_by: integer group codes (0-based) per column.
    """
    split_by = np.asarray(split_by)
    if split_by.dtype.kind not in "iu":
        _, split_by = np.unique(split_by, return_inverse=True)
    n_groups = n_groups or int(split_by.max()) + 1
    dense = not sp.issparse(A)
    m = np.asarray(A, np.float32) if dense else A.tocsc().astype(np.float32)
    colsum = m.sum(axis=0) if dense else np.asarray(m.sum(axis=0)).ravel()
    sums = np.zeros(n_groups)
    for g in range(n_groups):
        sums[g] = colsum[split_by == g].sum()
    # factor relative to group 0; group 0 unchanged
    factor = np.ones(n_groups)
    factor[1:] = sums[1:] / sums[0]
    colscale = np.ones(m.shape[1], np.float32)
    for g in range(1, n_groups):
        colscale[split_by == g] = 1.0 / factor[g]
    if dense:
        return m * colscale[None, :]
    return m.multiply(sp.csr_matrix(colscale[None, :])).tocsc()


def rasterize_rowwise(A, n: int = 10):
    """Mean-pool every n rows (genomics binning),
    (reference:src/singlet.cpp:147-180). Returns dense (floor(rows/n) x cols);
    trailing rows beyond the last full bin are folded into binning by floor
    division exactly like the reference (row // n, rows with row//n >= n_out
    dropped)."""
    dense = not sp.issparse(A)
    rows = A.shape[0]
    n_out = rows // n
    if dense:
        m = np.asarray(A, np.float64)
        out = np.zeros((n_out, m.shape[1]))
        for r in range(rows):
            b = r // n
            if b < n_out:
                out[b] += m[r]
        return out / n
    m = A.tocoo()
    out = np.zeros((n_out, A.shape[1]))
    b = m.row // n
    keep = b < n_out
    np.add.at(out, (b[keep], m.col[keep]), m.data[keep])
    return out / n


def normit(x):
    """Rank -> Gaussian-quantile transform (reference:R/normit.R:22-28):
    ``qnorm((rank(x) - 0.5) / n_unique)`` with average ties, NaNs passed
    through."""
    from scipy.stats import norm, rankdata

    x = np.asarray(x, np.float64).copy()
    flat = x.ravel()
    ok = ~np.isnan(flat)
    vals = flat[ok]
    n_unique = np.unique(vals).size
    ranks = rankdata(vals, method="average")
    flat[ok] = norm.ppf((ranks - 0.5) / n_unique)
    return flat.reshape(x.shape)


def variable_features_vst(counts, n_features: int = 2000,
                          loess_span: float = 0.3,
                          clip_max: float = None) -> np.ndarray:
    """Rank genes by vst standardized variance (Seurat FindVariableFeatures
    selection.method="vst" — the producer of the ``@var.features`` slot the
    reference indexes at reference:R/RunNMF.R:73-74).

    Per gene: fit expected log10(variance) as a local quadratic (loess-style,
    tricube weights, span fraction of genes) of log10(mean); standardize
    counts by the expected sd, clip at sqrt(n_cells), and rank genes by the
    variance of the clipped standardized values. Returns the indices of the
    top ``n_features`` genes (descending standardized variance).
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(counts).astype(np.float64)   # genes x cells
    genes, n = A.shape
    if clip_max is None:
        clip_max = float(np.sqrt(n))
    mu = np.asarray(A.mean(axis=1)).ravel()
    ex2 = np.asarray(A.multiply(A).mean(axis=1)).ravel()
    var = (ex2 - mu ** 2) * n / max(n - 1, 1)
    ok = var > 0
    if ok.sum() < 3:
        return np.argsort(-var, kind="stable")[:n_features]

    x = np.log10(mu[ok])
    y = np.log10(var[ok])

    # loess-style local quadratic on an evaluation grid, interpolated back
    order = np.argsort(x)
    xs, ys = x[order], y[order]
    m = xs.size
    win = max(int(np.ceil(loess_span * m)), 5)
    grid = np.linspace(xs[0], xs[-1], min(200, m))
    fitted_grid = np.empty_like(grid)
    for gi, gx in enumerate(grid):
        # nearest `win` points around gx
        pos = np.searchsorted(xs, gx)
        lo = max(0, min(pos - win // 2, m - win))
        sl = slice(lo, lo + win)
        xi, yi = xs[sl], ys[sl]
        dmax = max(np.max(np.abs(xi - gx)), 1e-12)
        wts = (1 - np.minimum(np.abs(xi - gx) / dmax, 1.0) ** 3) ** 3
        X = np.stack([np.ones_like(xi), xi - gx, (xi - gx) ** 2], axis=1)
        Xw = X * wts[:, None]
        beta, *_ = np.linalg.lstsq(Xw.T @ X, Xw.T @ yi, rcond=None)
        fitted_grid[gi] = beta[0]
    fitted = np.interp(x, grid, fitted_grid)

    exp_sd = np.zeros(genes)
    exp_sd[ok] = np.sqrt(10.0 ** fitted)

    # standardized variance with upper clipping, computed sparsely:
    # sum over nonzeros of min(clip_max, (x - mu)/sd)^2 plus the zeros'
    # contribution (n - nnz) * (mu/sd)^2, divided by (n - 1)
    std_var = np.zeros(genes)
    indptr, vals = A.indptr, A.data
    for g in np.where(ok)[0]:
        sdg = exp_sd[g]
        z = (vals[indptr[g]:indptr[g + 1]] - mu[g]) / sdg
        z = np.minimum(z, clip_max)
        nnz = z.size
        z0 = min(clip_max, -mu[g] / sdg)
        std_var[g] = (np.sum(z ** 2) + (n - nnz) * z0 ** 2) / max(n - 1, 1)

    return np.argsort(-std_var, kind="stable")[:n_features]
