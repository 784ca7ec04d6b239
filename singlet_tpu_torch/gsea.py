"""Preranked gene-set enrichment analysis on factor loadings.

Equivalent of ``RunGSEA`` (reference:R/RunGSEA.R:27-166): ranks = factor
loading weights of w's columns, gene sets filtered to the reduction's genes
and by size, per-factor enrichment, results padded to the union of pathways,
-log10 p / padj matrices ordered by Ward hierarchical clustering, stored in
``model.misc['gsea']``.

Two enrichment engines, both from-scratch implementations of the preranked
GSEA statistic (weighted KS running-sum):

  * ``fgsea_simple`` — size-stratified permutation null distributions, the
    sampling scheme of fgsea's original "simple" method; p resolution is
    bounded by ``nperm``.
  * ``fgsea_multilevel`` — the adaptive multilevel split Monte Carlo
    estimator of fgsea's default method (Korotkevich et al. 2019): levels
    of conditional sampling, each conditioning on exceeding the previous
    level's median ES via Metropolis swap moves, halve the estimated tail
    probability per level, so p-values far below 1/sampleSize are resolved
    (down to ``eps``). This is what ``run_gsea`` uses by default,
    matching the reference's ``fgseaMultilevel`` call
    (reference:R/RunGSEA.R:89-91).

Deviation from the reference: msigdbr gene-set catalogs are not bundled (no
network); pass ``gene_sets`` explicitly or load a .gmt file with
:func:`read_gmt`.

A copy of ``singlet_tpu/gsea.py`` (numpy, scipy and pandas; host code, no
kernel), with ``bh_fdr`` from the port's ``annotate``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd


def msigdb_gene_sets(category: Optional[str] = None,
                     subcategory: Optional[str] = None,
                     species: Optional[str] = None,
                     path: Optional[str] = None,
                     id_col: str = "gene_symbol") -> Dict[str, List[str]]:
    """Load an msigdbr-style gene-set catalog from a LOCAL staging file.

    The reference fetches MSigDB collections over the network at call time
    via the msigdbr package and filters them by species/category
    (reference:R/RunGSEA.R:46-57). This build runs with zero egress, so the
    catalog must be staged locally ONCE — e.g. in R,
    ``write.csv(msigdbr::msigdbr("Homo sapiens"), "msigdb.csv")`` — and
    pointed at via ``path`` or the ``SINGLET_TPU_MSIGDB`` environment
    variable. Accepted formats:

      * CSV/TSV with msigdbr's columns: ``gs_name`` + the ``id_col``
        (default ``gene_symbol``, matching the reference's ``ID`` argument),
        optionally ``gs_cat``/``gs_collection``, ``gs_subcat``/
        ``gs_subcollection`` for filtering;
      * a ``.gmt`` file, or a directory of ``.gmt`` files (category/
        subcategory filters then match against file stems).

    Returns {gs_name: [genes...]}, the shape ``run_gsea`` consumes.
    """
    import os

    path = path or os.environ.get("SINGLET_TPU_MSIGDB")
    if not path:
        raise ValueError(
            "no local MSigDB catalog configured: the reference pulls gene "
            "sets from the network via msigdbr (reference:R/RunGSEA.R:46), "
            "which a zero-egress build cannot; stage a catalog file and "
            "pass path= or set SINGLET_TPU_MSIGDB (see msigdb_gene_sets "
            "docstring for accepted formats)")
    if os.path.isdir(path):
        def _norm(v):
            # MSigDB filenames spell subcategories with dots (c5.go.bp.*);
            # msigdbr-style filters use colons ('GO:BP') — compare on the
            # alphanumeric skeleton so both spellings match
            return "".join(ch for ch in v.lower() if ch.isalnum())

        out: Dict[str, List[str]] = {}
        pats = [p for p in sorted(os.listdir(path)) if p.endswith(".gmt")]
        for p in pats:
            stem = _norm(p[:-4])
            if category and _norm(category) not in stem:
                continue
            if subcategory and _norm(subcategory) not in stem:
                continue
            out.update(read_gmt(os.path.join(path, p)))
        if not out:
            raise ValueError(
                f"MSigDB directory {path!r} has no .gmt file matching "
                f"category={category!r} subcategory={subcategory!r}")
        return out
    if path.endswith(".gmt"):
        return read_gmt(path)

    sep = "\t" if path.endswith((".tsv", ".txt")) else ","
    df = pd.read_csv(path, sep=sep)
    if "gs_name" not in df.columns or id_col not in df.columns:
        raise ValueError(
            f"{path} lacks msigdbr columns 'gs_name' and '{id_col}' "
            f"(has: {list(df.columns)[:8]}...)")

    def _filter(col_names, value):
        nonlocal df
        if value is None:
            return
        for c in col_names:
            if c in df.columns:
                # case-insensitive EQUALITY, not regex — msigdbr values
                # contain metacharacters ('(', '+') that str.fullmatch
                # would treat as patterns (or raise re.error on)
                vals = df[c].astype(str).str.casefold()
                df = df[vals == str(value).casefold()]
                return
        import warnings

        warnings.warn(
            f"msigdb_gene_sets: none of the filter columns {col_names} "
            f"exist in the staged catalog; the {value!r} filter was NOT "
            "applied", stacklevel=3)

    _filter(("gs_cat", "gs_collection"), category)
    _filter(("gs_subcat", "gs_subcollection"), subcategory)
    _filter(("species_name", "gs_species"), species)
    out = {}
    for name, grp in df.groupby("gs_name"):
        out[str(name)] = sorted(set(grp[id_col].astype(str)))
    return out


def read_gmt(path: str) -> Dict[str, List[str]]:
    """Load gene sets from a GMT file (name <tab> desc <tab> genes...)."""
    out: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                out[parts[0]] = [g for g in parts[2:] if g]
    return out


def _es_from_hits(positions: np.ndarray, weights_cum: np.ndarray,
                  NR: float, n: int, s: int):
    """Enrichment score extremes given sorted hit positions (ascending).

    positions: (batch, s) 0-based positions of hits in the descending-sorted
    stats array; weights_cum: (batch, s) cumulative |stat| weights at hits.
    Returns (pos_extreme, neg_extreme) per batch row.
    """
    j = np.arange(1, s + 1)[None, :]
    miss_step = 1.0 / (n - s)
    # running value AT hit j (inclusive): cumw_j/NR - (p_j + 1 - j) * miss_step
    at_hit = weights_cum / NR - (positions + 1 - j) * miss_step
    # running value just BEFORE hit j: cumw_{j-1}/NR - (p_j - (j-1)) * miss_step
    before = (weights_cum - np.diff(np.concatenate(
        [np.zeros((weights_cum.shape[0], 1)), weights_cum], axis=1), axis=1)) \
        / NR - (positions - (j - 1)) * miss_step
    pos_ext = at_hit.max(axis=1)
    neg_ext = before.min(axis=1)
    return pos_ext, neg_ext


def _es_single(hit_mask: np.ndarray, absstats: np.ndarray, score_type: str):
    """ES for one gene set over descending-sorted stats."""
    n = absstats.size
    s = int(hit_mask.sum())
    if s == 0 or s == n:
        return 0.0
    pos = np.where(hit_mask)[0][None, :]
    w = absstats[pos[0]]
    NR = float(w.sum())
    if NR == 0:
        return 0.0
    cumw = np.cumsum(w)[None, :]
    pe, ne = _es_from_hits(pos.astype(np.float64), cumw, NR, n, s)
    if score_type == "pos":
        return float(pe[0])
    if score_type == "neg":
        return float(ne[0])
    return float(pe[0]) if pe[0] > -ne[0] else float(ne[0])


def fgsea_simple(ranks: pd.Series, pathways: Dict[str, Sequence[str]],
                 min_size: int = 10, max_size: int = 500, nperm: int = 1000,
                 score_type: str = "pos", seed: int = 0) -> pd.DataFrame:
    """Preranked GSEA with size-stratified permutation p-values.

    ranks: Series indexed by gene name (loading weights of one factor).
    Returns DataFrame(pathway, pval, padj, ES, NES, size).
    """
    rng = np.random.default_rng(seed)
    genes = np.asarray(ranks.index)
    stats = np.asarray(ranks.to_numpy(), np.float64)
    order = np.argsort(-stats, kind="stable")
    genes_sorted = genes[order]
    stats_sorted = stats[order]
    absstats = np.abs(stats_sorted)
    n = genes_sorted.size
    gene_pos = {g: i for i, g in enumerate(genes_sorted)}

    sets = {}
    for name, members in pathways.items():
        idx = np.array(sorted(gene_pos[g] for g in set(members) if g in gene_pos),
                       dtype=np.int64)
        if min_size < idx.size < max_size:
            sets[name] = idx
    if not sets:
        return pd.DataFrame(columns=["pathway", "pval", "padj", "ES", "NES",
                                     "size"])

    # null distributions shared per set size
    sizes = sorted({v.size for v in sets.values()})
    nulls = {}
    for s in sizes:
        samples = np.sort(
            rng.permuted(np.broadcast_to(np.arange(n), (nperm, n)), axis=1)
            [:, :s], axis=1).astype(np.float64)
        w = absstats[samples.astype(np.int64)]
        cumw = np.cumsum(w, axis=1)
        NRs = cumw[:, -1]
        NRs[NRs == 0] = 1.0
        j = np.arange(1, s + 1)[None, :]
        miss_step = 1.0 / (n - s)
        at_hit = cumw / NRs[:, None] - (samples + 1 - j) * miss_step
        before = (cumw - w) / NRs[:, None] - (samples - (j - 1)) * miss_step
        nulls[s] = (at_hit.max(axis=1), before.min(axis=1))

    rows = []
    for name, idx in sets.items():
        s = idx.size
        es = _es_single(np.isin(np.arange(n), idx), absstats, score_type)
        pos_null, neg_null = nulls[s]
        if score_type == "pos" or (score_type == "std" and es >= 0):
            null = pos_null
            exceed = int(np.sum(null >= es))
            denom = max(float(np.mean(np.abs(null[null >= 0]))), 1e-12) \
                if np.any(null >= 0) else 1e-12
        else:
            null = neg_null
            exceed = int(np.sum(null <= es))
            denom = max(float(np.mean(np.abs(null[null <= 0]))), 1e-12) \
                if np.any(null <= 0) else 1e-12
        pval = (exceed + 1) / (null.size + 1)
        rows.append((name, pval, es, es / denom, s))

    df = pd.DataFrame(rows, columns=["pathway", "pval", "ES", "NES", "size"])
    from singlet_tpu_torch.annotate import bh_fdr
    df["padj"] = bh_fdr(df["pval"].to_numpy())
    return df[["pathway", "pval", "padj", "ES", "NES", "size"]]


def _es_positions(pos: np.ndarray, absstats: np.ndarray, n: int):
    """Vectorized positive/negative ES extremes for a batch of gene sets.

    pos: (batch, s) SORTED 0-based hit positions. Returns (pos_ext, neg_ext).
    """
    s = pos.shape[1]
    w = absstats[pos]                       # (batch, s)
    cumw = np.cumsum(w, axis=1)
    NR = cumw[:, -1].copy()
    NR[NR == 0] = 1.0
    j = np.arange(1, s + 1)[None, :]
    miss_step = 1.0 / (n - s)
    at_hit = cumw / NR[:, None] - (pos + 1 - j) * miss_step
    before = (cumw - w) / NR[:, None] - (pos - (j - 1)) * miss_step
    return at_hit.max(axis=1), before.min(axis=1)


def _multilevel_pval(es_obs: float, s: int, absstats: np.ndarray, n: int,
                     sample_size: int, eps: float, rng,
                     negative: bool = False, max_levels: int = 120):
    """Adaptive multilevel split Monte Carlo estimate of the GSEA tail
    probability P(ES_random >= es_obs) (or <= for ``negative``).

    The estimator of fgsea's default ``fgseaMultilevel`` (Korotkevich,
    Sukhov, Sergushichev 2019, Algorithm; reference consumes it at
    R/RunGSEA.R:89): maintain an odd-sized population of random gene sets;
    while the population median ES is below the observed ES, condition the
    population on exceeding the median (discard the lower half, duplicate
    the upper half, diversify with Metropolis gene-swap moves that reject
    proposals falling below the threshold) and multiply the probability
    estimate by 1/2. Each level doubles the resolvable tail depth, so p ~
    2^-levels values far beyond 1/sample_size are estimated. Returns
    (pval, nes_denominator, log2err_levels).
    """
    Z = sample_size if sample_size % 2 == 1 else sample_size + 1
    half = (Z - 1) // 2

    def es_of(pos):
        pe, ne = _es_positions(pos, absstats, n)
        return -ne if negative else pe

    # level 0: unconditional sample
    pos = np.sort(
        rng.permuted(np.broadcast_to(np.arange(n), (Z, n)), axis=1)[:, :s],
        axis=1).astype(np.int64)
    es = es_of(pos)
    gamma = -es_obs if negative else es_obs
    # NES denominator from the unconditional sample (same-sign mean)
    denom = float(np.mean(np.abs(es[es >= 0]))) if np.any(es >= 0) else 1e-12
    denom = max(denom, 1e-12)

    logp = 0.0          # log2 of the probability accumulated over levels
    levels = 0
    while levels < max_levels:
        med = float(np.median(es))
        if med >= gamma or 2.0 ** logp <= eps:
            break
        # condition on ES >= med: keep the strict upper half, duplicate
        order = np.argsort(es, kind="stable")
        keep = order[half:]                  # Z - half = half + 1 survivors
        pos = np.concatenate([pos[keep], pos[keep[: Z - keep.size]]], axis=0)
        es = np.concatenate([es[keep], es[keep[: Z - keep.size]]])
        # Metropolis diversification: s rounds of one proposed swap per
        # particle, accepted iff the new ES stays above the threshold
        for _ in range(max(1, s)):
            drop = rng.integers(0, s, size=Z)
            cand = rng.integers(0, n, size=Z)
            # skip proposals already in the set
            in_set = (pos == cand[:, None]).any(axis=1)
            prop = pos.copy()
            prop[np.arange(Z), drop] = np.where(in_set, pos[np.arange(Z),
                                                            drop], cand)
            prop = np.sort(prop, axis=1)
            es_prop = es_of(prop)
            acc = (es_prop >= med) & ~in_set
            pos = np.where(acc[:, None], prop, pos)
            es = np.where(acc, es_prop, es)
        logp -= 1.0                          # P(ES >= med) ~ 1/2 per level
        levels += 1

    exceed = int(np.sum(es >= gamma))
    pval = (2.0 ** logp) * (exceed + 1) / (Z + 1)
    return max(pval, eps if pval > 0 else eps), denom, levels


def fgsea_multilevel(ranks: pd.Series, pathways: Dict[str, Sequence[str]],
                     min_size: int = 10, max_size: int = 500,
                     sample_size: int = 101, eps: float = 1e-10,
                     score_type: str = "pos",
                     seed: int = 0) -> pd.DataFrame:
    """Preranked GSEA with the multilevel split p-value estimator — the
    counterpart of the reference's ``fgseaMultilevel`` call
    (reference:R/RunGSEA.R:89-91). Same frame schema as
    :func:`fgsea_simple`; p-values are floored at ``eps`` (fgsea's
    convention: values below are reported as the bound)."""
    rng = np.random.default_rng(seed)
    genes = np.asarray(ranks.index)
    stats = np.asarray(ranks.to_numpy(), np.float64)
    order = np.argsort(-stats, kind="stable")
    genes_sorted = genes[order]
    absstats = np.abs(stats[order])
    n = genes_sorted.size
    gene_pos = {g: i for i, g in enumerate(genes_sorted)}

    rows = []
    for name, members in pathways.items():
        idx = np.array(sorted(gene_pos[g] for g in set(members)
                              if g in gene_pos), dtype=np.int64)
        s = idx.size
        if not (min_size < s < max_size):
            continue
        es = _es_single(np.isin(np.arange(n), idx), absstats, score_type)
        if score_type == "pos" or (score_type == "std" and es >= 0):
            pval, denom, _ = _multilevel_pval(es, s, absstats, n,
                                              sample_size, eps, rng)
        else:
            pval, denom, _ = _multilevel_pval(es, s, absstats, n,
                                              sample_size, eps, rng,
                                              negative=True)
        if score_type == "std":
            pval = min(1.0, 2.0 * pval)     # two-sided doubling
        rows.append((name, pval, es, es / denom, s))

    df = pd.DataFrame(rows, columns=["pathway", "pval", "ES", "NES", "size"])
    if len(df):
        from singlet_tpu_torch.annotate import bh_fdr
        df["padj"] = bh_fdr(df["pval"].to_numpy())
    else:
        df["padj"] = []
    return df[["pathway", "pval", "padj", "ES", "NES", "size"]]


def _ward_order(X: np.ndarray):
    from scipy.cluster.hierarchy import leaves_list, linkage

    if X.shape[0] < 3:
        return np.arange(X.shape[0])
    ok = ~np.isnan(X).any(axis=1)
    order = leaves_list(linkage(X[ok], method="ward"))
    full = np.where(ok)[0][order]
    rest = np.where(~ok)[0]
    return np.concatenate([full, rest])


def run_gsea(model, gene_sets,
             min_size: int = 10, max_size: int = 500, nperm: int = 1000,
             dims: Optional[Sequence[int]] = None, padj_sig: float = 0.01,
             score_type: str = "pos", verbose: bool = False, seed: int = 0,
             gsea_name: str = "gsea", method: str = "multilevel",
             sample_size: int = 101, eps: float = 1e-10,
             species: Optional[str] = None):
    """GSEA over every factor's loadings; store -log10 matrices in misc.

    ``gene_sets`` may be a {name: [genes]} dict, a ``.gmt``/catalog file
    path, or an MSigDB category name like the reference's ``category="C5"``
    (resolved against the locally staged catalog — see
    :func:`msigdb_gene_sets`; the reference fetches it from the network,
    reference:R/RunGSEA.R:46-57).

    ``method="multilevel"`` (default) uses the adaptive multilevel split
    p-value estimator, matching the reference's ``fgseaMultilevel``
    (reference:R/RunGSEA.R:89-91); ``method="simple"`` uses the
    ``nperm``-permutation estimator. Returns dict(pval, padj, es, nes) of
    DataFrames (pathways x factors), rows/cols ordered by Ward clustering
    of -log10(padj) (reference:R/RunGSEA.R:118-130).
    """
    if isinstance(gene_sets, str):
        import os

        if os.path.exists(gene_sets):
            gene_sets = (read_gmt(gene_sets) if gene_sets.endswith(".gmt")
                         else msigdb_gene_sets(path=gene_sets,
                                               species=species))
        elif (os.sep in gene_sets
              or gene_sets.endswith((".gmt", ".csv", ".tsv", ".txt"))):
            # looks like a file path, not an MSigDB category name — a typo
            # here must not fall through to category resolution (it would
            # either raise the unrelated no-catalog error or silently
            # filter the staged catalog down to an empty dict)
            raise FileNotFoundError(
                f"gene_sets file not found: {gene_sets!r}")
        else:
            gene_sets = msigdb_gene_sets(category=gene_sets, species=species)
    w = np.asarray(model.w)
    names = model.factor_names
    if model.gene_names is None:
        raise ValueError("model has no gene_names; GSEA needs named genes")
    genes = list(model.gene_names)
    cols = list(range(w.shape[1])) if dims is None else list(dims)

    # filter genes to those covered by any pathway (reference:R/RunGSEA.R:55-57)
    covered = set()
    for members in gene_sets.values():
        covered.update(members)
    keep = [i for i, g in enumerate(genes) if g in covered]
    w = w[keep]
    genes = [genes[i] for i in keep]
    rs = w.sum(axis=1)
    nz = rs != 0
    w = w[nz]
    genes = [g for g, ok in zip(genes, nz) if ok]

    per_factor = {}
    for ci in cols:
        ranks = pd.Series(w[:, ci], index=genes)
        if method == "multilevel":
            res = fgsea_multilevel(ranks, gene_sets, min_size=min_size,
                                   max_size=max_size,
                                   sample_size=sample_size, eps=eps,
                                   score_type=score_type, seed=seed)
        else:
            res = fgsea_simple(ranks, gene_sets, min_size=min_size,
                               max_size=max_size, nperm=nperm,
                               score_type=score_type, seed=seed)
        per_factor[names[ci]] = res.set_index("pathway")
        if verbose:
            print(f"{names[ci]}: {len(res)} pathways", flush=True)

    all_paths = sorted(set().union(*[set(df.index) for df in per_factor.values()]))
    def mat(field):
        M = pd.DataFrame(index=all_paths,
                         columns=[names[c] for c in cols], dtype=float)
        for fname, df in per_factor.items():
            M.loc[df.index, fname] = df[field]
        return M

    pval, padj = mat("pval"), mat("padj")
    es, nes = mat("ES"), mat("NES")
    lpadj = -np.log10(padj.astype(float))
    lpval = -np.log10(pval.astype(float))

    ro = _ward_order(np.nan_to_num(lpadj.to_numpy(), nan=0.0))
    co = _ward_order(np.nan_to_num(lpadj.to_numpy(), nan=0.0).T)
    out = {
        "pval": lpval.iloc[ro, co],
        "padj": lpadj.iloc[ro, co],
        "es": es.iloc[ro, co],
        "nes": nes.iloc[ro, co],
    }
    model.misc[gsea_name] = out
    return out
