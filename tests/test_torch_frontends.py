"""The port's copies of the JAX package's host-side front ends against the
originals, on the CPU: preprocessing, the R serialization reader and the
dataset readers and writers, annotation, GSEA, the summaries and the
plots. Each module of ``singlet_tpu_torch`` here is a copy of its twin
with the imports pointed at the port, so the same inputs give equal
results (``np.testing.assert_array_equal``,
``pandas.testing.assert_frame_equal``), not merely close ones.

The geometries are those of tests/test_annotate.py, test_gsea.py,
test_rds_seurat.py and the synthetic cases of test_data_preprocess.py;
the ``.rds`` writers of test_rds_seurat.py are loaded from that file.
"""

import importlib.util
import os
import warnings

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from pandas.testing import assert_frame_equal

import singlet_tpu.annotate as ja
import singlet_tpu.data as jd
import singlet_tpu.gsea as jg
import singlet_tpu.model as jm
import singlet_tpu.preprocess as jp
import singlet_tpu.sparse.rdata as jr
import singlet_tpu.summary as js
import singlet_tpu_torch.annotate as ta
import singlet_tpu_torch.data as td
import singlet_tpu_torch.gsea as tg
import singlet_tpu_torch.model as tm
import singlet_tpu_torch.preprocess as tp
import singlet_tpu_torch.sparse.rdata as tr
import singlet_tpu_torch.summary as ts

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rds_writers():
    """tests/test_rds_seurat.py as a module, for its .rds writers."""
    spec = importlib.util.spec_from_file_location(
        "_rds_writers", os.path.join(HERE, "test_rds_seurat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b):
    """Equal values: arrays and sparse matrices element for element, frames
    and series by pandas, containers item by item."""
    if isinstance(a, pd.DataFrame):
        assert_frame_equal(a, b)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b)
    elif sp.issparse(a):
        assert sp.issparse(b) and a.shape == b.shape and a.format == b.format
        np.testing.assert_array_equal(a.toarray(), b.toarray())
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _datasets_equal(a, b):
    _same(a.counts, b.counts)
    assert a.gene_names == b.gene_names and a.cell_names == b.cell_names
    assert a.normalized == b.normalized
    _same(a.meta, b.meta)


# ------------------------------------------------------------ preprocessing

def _counts(rng, genes=40, cells=30, density=0.3):
    A = sp.random(genes, cells, density=density, random_state=3,
                  dtype=np.float32, format="csc")
    A.data = np.round(A.data * 9 + 1).astype(np.float32)
    return A


@pytest.mark.parametrize("fmt", ["csc", "dense"])
def test_log_normalize_and_counts_test(rng, fmt):
    A = _counts(rng)
    A = A if fmt == "csc" else A.toarray()
    _same(jp.log_normalize(A), tp.log_normalize(A))
    _same(jp.log_normalize(A, 1e3), tp.log_normalize(A, 1e3))
    assert jp.looks_like_counts(A) == tp.looks_like_counts(A)
    N = tp.log_normalize(A)
    assert jp.looks_like_counts(N) == tp.looks_like_counts(N)


@pytest.mark.parametrize("labels", [np.array([0, 0, 1, 1]),
                                    np.array(["x", "x", "y", "y"])])
def test_weight_by_split(labels):
    A = sp.csc_matrix(np.array([[1.0, 2.0, 4.0, 8.0],
                                [1.0, 2.0, 4.0, 8.0]], np.float32))
    _same(jp.weight_by_split(A, labels), tp.weight_by_split(A, labels))
    _same(jp.weight_by_split(A.toarray(), labels),
          tp.weight_by_split(A.toarray(), labels))


def test_rasterize_rowwise_and_normit(rng):
    A = rng.random((23, 7))
    A[A < 0.5] = 0
    for n in (1, 5, 10):
        _same(jp.rasterize_rowwise(A, n=n), tp.rasterize_rowwise(A, n=n))
        _same(jp.rasterize_rowwise(sp.csc_matrix(A), n=n),
              tp.rasterize_rowwise(sp.csc_matrix(A), n=n))
    x = np.array([3.0, 1.0, 2.0, 2.0, np.nan])
    _same(jp.normit(x), tp.normit(x))
    y = rng.normal(size=50)
    _same(jp.normit(y), tp.normit(y))


def test_variable_features_vst(rng):
    genes, cells = 120, 400
    base = 10 ** rng.uniform(-1.0, 0.8, genes)
    lam = np.tile(base[:, None], (1, cells))
    for g in (3, 17, 58, 99):
        lam[g, : cells // 2] = 0.05
        lam[g, cells // 2:] = 4.0
    counts = sp.csc_matrix(rng.poisson(lam).astype(np.float32))
    for n in (10, 50):
        _same(jp.variable_features_vst(counts, n_features=n),
              tp.variable_features_vst(counts, n_features=n))


# ------------------------------------------------- R serialization, readers

@pytest.mark.parametrize("kind", ["seurat", "sce_sparse", "sce_dense",
                                  "sce_logcounts"])
def test_rds_readers(tmp_path, rng, kind):
    """A Seurat or SingleCellExperiment .rds written by the JAX tests'
    writer: the same parsed object parts and the same CellDataset."""
    w = _rds_writers()
    M, genes, cells, meta = w._toy(rng)
    path = str(tmp_path / "obj.rds")
    if kind == "seurat":
        w._write_seurat_rds(path, M, genes, cells, meta)
        _same(jr.seurat_to_parts(jr.read_rds(path)),
              tr.seurat_to_parts(tr.read_rds(path)))
        _datasets_equal(jd.read_seurat_rds(path), td.read_seurat_rds(path))
    else:
        w._write_sce_rds(path, M, genes, cells, meta,
                         dense=kind == "sce_dense",
                         assay_name=("logcounts" if kind == "sce_logcounts"
                                     else "counts"))
        _same(jr.sce_to_parts(jr.read_rds(path)),
              tr.sce_to_parts(tr.read_rds(path)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _datasets_equal(jd.read_seurat_rds(path),
                            td.read_seurat_rds(path))
    assert jr.r_class(jr.read_rds(path)) == tr.r_class(tr.read_rds(path))


def test_rds_rejects_alike(tmp_path):
    w = _rds_writers()._W()
    path = tmp_path / "vec.rds"
    path.write_bytes(w.rds_bytes(lambda: w.intvec([1, 2, 3])))
    _same(jr.r_to_python(jr.read_rds(str(path))),
          tr.r_to_python(tr.read_rds(str(path))))
    for mod in (jd, td):
        with pytest.raises(ValueError):
            mod.read_seurat_rds(str(path))


def _write_10x(directory, M, genes, cells, gz):
    """A 10x directory: matrix.mtx, features.tsv and barcodes.tsv, gzipped
    or not."""
    import gzip

    import scipy.io

    os.makedirs(directory, exist_ok=True)
    suffix = ".gz" if gz else ""
    opener = gzip.open if gz else open
    scipy.io.mmwrite(os.path.join(directory, "matrix.mtx"), sp.coo_matrix(M))
    if gz:
        with open(os.path.join(directory, "matrix.mtx"), "rb") as f:
            data = f.read()
        with gzip.open(os.path.join(directory, "matrix.mtx.gz"), "wb") as f:
            f.write(data)
        os.remove(os.path.join(directory, "matrix.mtx"))
    with opener(os.path.join(directory, "features.tsv" + suffix), "wt") as f:
        f.writelines(f"ENSG{i}\t{g}\tGene Expression\n"
                     for i, g in enumerate(genes))
    with opener(os.path.join(directory, "barcodes.tsv" + suffix), "wt") as f:
        f.writelines(f"{c}\n" for c in cells)


@pytest.mark.parametrize("gz", [False, True])
def test_read_10x_mtx(tmp_path, rng, gz):
    M = _counts(rng, 25, 18)
    genes = [f"G{i}" for i in range(25)]
    cells = [f"C{i}" for i in range(18)]
    _write_10x(str(tmp_path / "tenx"), M, genes, cells, gz)
    _datasets_equal(jd.read_10x_mtx(str(tmp_path / "tenx")),
                    td.read_10x_mtx(str(tmp_path / "tenx")))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_h5ad_round_trip_across_packages(tmp_path, writer):
    """An .h5ad written by either package (matrix, metadata, a reduction)
    reads back alike in both, byte for byte the same file."""
    pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    A = sp.random(30, 40, density=0.3, random_state=3, dtype=np.float32,
                  format="csc")
    meta = {"cell_type": np.array(["a", "b"] * 20)}
    w = rng.random((30, 3)).astype(np.float32)
    d = np.array([3.0, 2.0, 1.0], np.float32)
    h = rng.random((3, 40)).astype(np.float32)
    paths = {}
    for name, D, M in (("jax", jd, jm), ("torch", td, tm)):
        ds = D.CellDataset(counts=A, gene_names=[f"g{i}" for i in range(30)],
                           cell_names=[f"c{i}" for i in range(40)],
                           meta=dict(meta))
        paths[name] = str(tmp_path / f"{name}.h5ad")
        D.write_h5ad(paths[name], ds,
                     reductions={"nmf": M.NMFModel(w=w, d=d, h=h)})
    with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
        assert f.read() == g.read()
    _datasets_equal(jd.read_h5ad(paths[writer]), td.read_h5ad(paths[writer]))


# ------------------------------------------------------------- annotation

def _planted_model(M, rng, k=3, cells=60):
    types = np.array(["T"] * (cells // 3) + ["B"] * (cells // 3)
                     + ["NK"] * (cells - 2 * (cells // 3)), dtype=object)
    h = rng.random((k, cells)) * 0.1
    h[0, types == "T"] += 1.0
    h[1, types == "B"] += 1.0
    return M.NMFModel(w=rng.random((10, k)), d=np.ones(k), h=h), types


@pytest.mark.parametrize("robust", [True, False])
def test_annotate_nmf(robust):
    models = {}
    for name, M, A in (("jax", jm, ja), ("torch", tm, ta)):
        model, types = _planted_model(M, np.random.default_rng(5))
        res = A.annotate_nmf(model, {"cell_type": types,
                                     "lane": np.array(["x", "y"] * 30)},
                             robust=robust)
        models[name] = (model, res)
    _same(models["jax"][1], models["torch"][1])
    _same(models["jax"][0].misc["annotations"],
          models["torch"][0].misc["annotations"])


def test_annotate_parts(rng):
    groups = np.array(["b", "a", "b", None, "c"], dtype=object)
    _same(ja.model_matrix(groups), ta.model_matrix(groups))
    meta = {"ok": np.array(["a", "b", "a"], dtype=object),
            "numeric": np.array([1.0, 2.0, 3.0]),
            "single": np.array(["x", "x", "x"], dtype=object)}
    assert ja.check_columns(meta, None) == ta.check_columns(meta, None)
    X, _, _ = ja.model_matrix(np.repeat(["a", "b", "c"], 10))
    data = rng.normal(size=(30, 30))
    fit_j, fit_t = ja.lm_fit(data, X), ta.lm_fit(data, X)
    _same(fit_j, fit_t)
    _same(ja.ebayes(fit_j), ta.ebayes(fit_t))
    _same(ja.ebayes(fit_j, robust=True), ta.ebayes(fit_t, robust=True))
    s2 = rng.chisquare(20, 60) / 20 * 2.0
    s2 = np.concatenate([s2, [400.0, 900.0]])
    _same(ja.fit_f_dist(s2, 20.0), ta.fit_f_dist(s2, 20.0))
    _same(ja.fit_f_dist_robust(s2, 20.0), ta.fit_f_dist_robust(s2, 20.0))
    _same(ja.squeeze_var(np.full(10, 2.0), 5), ta.squeeze_var(np.full(10, 2.0),
                                                             5))
    p = rng.random(40)
    _same(ja.bh_fdr(p), ta.bh_fdr(p))


# ------------------------------------------------------------------ GSEA

def _ranked(rng, n=300, block=20, lift=2.0):
    genes = [f"g{i}" for i in range(n)]
    vals = rng.random(n) * 0.1
    vals[:block] += lift
    return genes, pd.Series(vals, index=genes)


@pytest.mark.parametrize("engine", ["simple", "multilevel"])
@pytest.mark.parametrize("score_type", ["std", "pos"])
def test_fgsea_engines(engine, score_type):
    genes, ranks = _ranked(np.random.default_rng(11))
    sets = {"ENRICHED": genes[:20], "RANDOM": genes[100:125],
            "MIXED": genes[10:30] + genes[200:210]}
    out = []
    for mod in (jg, tg):
        fn = mod.fgsea_simple if engine == "simple" else mod.fgsea_multilevel
        kw = (dict(nperm=300) if engine == "simple"
              else dict(sample_size=51))
        out.append(fn(ranks, sets, min_size=10, max_size=100,
                      score_type=score_type, seed=1, **kw))
    _same(out[0], out[1])


@pytest.mark.parametrize("multilevel", [False, True])
def test_run_gsea(multilevel):
    models = []
    for mod, M in ((jg, jm), (tg, tm)):
        rng = np.random.default_rng(2)
        genes = [f"g{i}" for i in range(200)]
        w = rng.random((200, 3)) * 0.1
        w[:15, 0] += 1.5
        sets = {"SET_A": genes[:15], "SET_B": genes[50:80],
                "SET_C": genes[120:140]}
        model = M.NMFModel(w=w, d=np.ones(3), h=rng.random((3, 30)),
                           gene_names=genes)
        kw = dict(min_size=10, max_size=100, seed=2)
        if not multilevel:
            kw["nperm"] = 300
        models.append((mod.run_gsea(model, sets, **kw), model.misc["gsea"]))
    _same(models[0], models[1])


def test_gene_set_catalogs(tmp_path, monkeypatch):
    """read_gmt and the local msigdbr catalog (a CSV and a directory of
    .gmt files), with and without filters, and the unstaged catalog's
    error."""
    rows = [dict(gs_name=gs, gene_symbol=g, gs_cat=cat, gs_subcat=sub,
                 species_name="Homo sapiens")
            for gs, cat, sub, genes in [
                ("GOBP_ALPHA", "C5", "GO:BP", ["G1", "G2", "G3"]),
                ("GOMF_BETA", "C5", "GO:MF", ["G2", "G4"]),
                ("HALLMARK_X", "H", "", ["G5", "G1"])]
            for g in genes]
    csv = tmp_path / "msigdb.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    gmt_dir = tmp_path / "gmt"
    gmt_dir.mkdir()
    (gmt_dir / "c5.go.bp.gmt").write_text(
        "SET_A\tdesc\tG1\tG2\nSET_B\tdesc\tG3\n")
    (gmt_dir / "h.all.gmt").write_text("HALL\tdesc\tG4\n")
    _same(jg.read_gmt(str(gmt_dir / "c5.go.bp.gmt")),
          tg.read_gmt(str(gmt_dir / "c5.go.bp.gmt")))
    for kw in (dict(path=str(csv)), dict(category="C5", path=str(csv)),
               dict(category="C5", subcategory="GO:BP", path=str(csv)),
               dict(category="c5", path=str(gmt_dir)),
               dict(path=str(gmt_dir))):
        _same(jg.msigdb_gene_sets(**kw), tg.msigdb_gene_sets(**kw))
    monkeypatch.setenv("SINGLET_TPU_MSIGDB", str(csv))
    _same(jg.msigdb_gene_sets(category="H"), tg.msigdb_gene_sets(category="H"))
    monkeypatch.delenv("SINGLET_TPU_MSIGDB")
    for mod in (jg, tg):
        with pytest.raises(ValueError, match="msigdbr"):
            mod.msigdb_gene_sets(category="C5")


# -------------------------------------------------------------- summaries

def _lnmf_like(M, rng):
    """A model whose factor 2 is zero on group 'b' (a unique factor)."""
    h = rng.random((4, 40))
    groups = np.array(["a", "b"] * 20)
    h[2, groups == "b"] = 0.0
    return M.NMFModel(w=rng.random((10, 4)), d=np.ones(4), h=h), groups


@pytest.mark.parametrize("n_groups", [2, 3, 5])
@pytest.mark.parametrize("reorder", [True, False])
def test_metadata_summary(n_groups, reorder):
    rng = np.random.default_rng(n_groups)
    h = rng.random((6, 60))
    labels = np.array([f"grp{i % n_groups}" for i in range(60)])
    _same(js.metadata_summary(h, labels, reorder=reorder),
          ts.metadata_summary(h, labels, reorder=reorder))


def test_shared_and_unique_factors():
    (mj, groups), (mt, _) = (_lnmf_like(jm, np.random.default_rng(4)),
                             _lnmf_like(tm, np.random.default_rng(4)))
    assert js.get_unique_factors(mj, groups) == \
        ts.get_unique_factors(mt, groups) == [2]
    assert js.get_shared_factors(mj, groups) == \
        ts.get_shared_factors(mt, groups)


# ------------------------------------------------------------------ plots

def _fig_arrays(fig):
    """What a figure plots, axes by axes: lines' data, images' arrays,
    scatter offsets, sizes and colour values, bars' rectangles, line
    collections' segments, and the tick labels and titles."""
    out = []
    for ax in fig.axes:
        out.append([ln.get_xydata() for ln in ax.get_lines()])
        out.append([im.get_array() for im in ax.get_images()])
        for c in ax.collections:
            arrays = [c.get_offsets(), c.get_array()]
            if hasattr(c, "get_sizes"):
                arrays.append(c.get_sizes())
            if hasattr(c, "get_segments"):
                arrays.extend(c.get_segments())
            out.append([np.ma.filled(np.asarray(a, dtype=float), np.nan)
                        if a is not None else None for a in arrays])
        out.append([(p.get_x(), p.get_y(), p.get_width(), p.get_height())
                    for p in ax.patches])
        out.append([t.get_text() for t in ax.get_xticklabels()
                    + ax.get_yticklabels()] + [ax.get_title(),
                                               ax.get_xlabel(),
                                               ax.get_ylabel()])
    return out


def _same_figs(fj, ft):
    import matplotlib.pyplot as plt

    a, b = _fig_arrays(fj), _fig_arrays(ft)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if u is None or v is None:
                assert u is None and v is None
            elif isinstance(u, str):
                assert u == v
            else:
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    plt.close(fj)
    plt.close(ft)


def _cv_frame():
    rows = []
    rng = np.random.default_rng(7)
    for rep in (1, 2):
        for k in (2, 3, 4, 5, 6):
            for it in range(1, 8):
                err = (1.0 + abs(k - 4) * 0.1) * (1 + 1.0 / it) \
                    + rng.random() * 1e-3
                rows.append(dict(k=k, rep=rep, test_error=err, iter=it,
                                 tol=1e-3 / it))
    return pd.DataFrame(rows)


@pytest.mark.parametrize("which", ["rank_1", "rank_2", "metadata_stacked",
                                   "metadata_side", "metadata_heatmap",
                                   "annotation", "gsea", "weights",
                                   "weights_ranges"])
def test_plots_render_alike(which):
    """Each plot rendered to Agg by both packages plots the same arrays."""
    pytest.importorskip("matplotlib")
    import singlet_tpu.plots as jpl
    import singlet_tpu_torch.plots as tpl

    rng = np.random.default_rng(9)
    genes = [f"g{i}" for i in range(40)]
    w = rng.random((40, 4))
    h = rng.random((4, 60))
    padj = rng.random((12, 4))
    ranges = pd.DataFrame({"chrom": [f"chr{i % 3}" for i in range(40)],
                           "start": np.arange(40) * 1000 + 5}, index=genes)
    figs = []
    for pl, M, A, S in ((jpl, jm, ja, js), (tpl, tm, ta, ts)):
        model = M.NMFModel(w=w.copy(), d=np.ones(4), h=h.copy(),
                           gene_names=genes)
        if which.startswith("rank"):
            fig = pl.rank_plot(_cv_frame(), detail=int(which[-1]))
        elif which.startswith("metadata"):
            summ = S.metadata_summary(h, np.array(["a", "b", "c"] * 20),
                                      factor_names=model.factor_names)
            fig = (pl.metadata_heatmap(summ) if which == "metadata_heatmap"
                   else pl.metadata_plot(summ,
                                         stacked=which.endswith("stacked")))
        elif which == "annotation":
            model, types = _planted_model(M, np.random.default_rng(5), k=4)
            res = A.annotate_nmf(model, {"ct": types})
            fig = pl.annotation_plot(res["ct"], max_p=1.0)
        elif which == "gsea":
            gsea = {"padj": pd.DataFrame(padj,
                                         index=[f"S{i}" for i in range(12)],
                                         columns=model.factor_names)}
            fig = pl.gsea_heatmap(gsea, top_n=8)
        elif which == "weights":
            fig = pl.plot_factor_weights(model, 1, top_n=10)
        else:
            fig = pl.plot_factor_weights(model, 2, ranges=ranges)
        figs.append(fig)
    _same_figs(*figs)


def test_factor_weights_ranges_alike():
    pytest.importorskip("matplotlib")
    import singlet_tpu.plots as jpl
    import singlet_tpu_torch.plots as tpl

    rng = np.random.default_rng(1)
    genes = [f"g{i}" for i in range(30)]
    ranges = pd.DataFrame({"chrom": ["chr1"] * 30,
                           "start": np.arange(30) * 10}, index=genes[::-1])
    w = rng.random((30, 5))
    out = [pl.factor_weights_ranges(
        M.NMFModel(w=w, d=np.ones(5), h=np.ones((5, 3)), gene_names=genes),
        ranges, factors=[0, "NMF_3"]) for pl, M in ((jpl, jm), (tpl, tm))]
    _same(out[0], out[1])
