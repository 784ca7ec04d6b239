"""The port's ``Experiment`` (``singlet_tpu_torch/experiment.py``) against
the JAX package's on the CPU: one synthetic counts matrix with categorical
metadata and x/y coordinates, both packages' drivers given one numpy
``init_w`` (as tests/test_torch_masked.py does; ``init_w`` draws from
threefry in JAX and from a torch.Generator in the port).

Covered: a fixed rank, a ``k`` list (cross-validation, then the chosen
rank), ``k=None`` (the ``ard_nmf`` search, whose ``k_max=10000`` does not
matter at this size), ``run_lnmf`` with shared and unique factors,
``project_data``, ``find_local_neighbors`` + ``run_gcnmf``,
``annotate_nmf``, ``run_gsea`` and the summaries. Fits are held at the
JAX package's fit tolerance (tests/test_als.py), rtol 5e-3 and atol 5e-4,
and so are the analyses run on each package's own fits.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import singlet_tpu.experiment as jexp
import singlet_tpu_torch.experiment as texp
from singlet_tpu.solvers import als as jals
from singlet_tpu.solvers import ard as jard
from singlet_tpu.solvers import drivers as jdrivers
from singlet_tpu_torch.solvers import als as tals
from singlet_tpu_torch.solvers import ard as tard
from singlet_tpu_torch.solvers import drivers as tdrivers

FIT = dict(rtol=5e-3, atol=5e-4)
GENES, CELLS, RANK = 60, 48, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_init_w(monkeypatch):
    """One numpy init for both packages' fits: W (genes_pad, k) from the
    seed, zero on padded rows."""
    def draw(k, genes_pad, genes_true, seed):
        w = np.random.default_rng(seed).random((genes_pad, k))
        w[genes_true:] = 0.0
        return w.astype(np.float32)

    for mod in (jdrivers, jals, jard):
        monkeypatch.setattr(mod, "init_w", lambda k, gp, gt, seed:
                            jnp.asarray(draw(k, gp, gt, seed)))
    for mod in (tdrivers, tals, tard):
        monkeypatch.setattr(mod, "init_w",
                            lambda k, gp, gt, seed, device=None:
                            torch.as_tensor(draw(k, gp, gt, seed),
                                            device=device))


@pytest.fixture(autouse=True)
def _shared_init_w(monkeypatch):
    _patch_init_w(monkeypatch)


def _data():
    """Counts of a planted rank-3 model, 60 genes x 48 cells, with a
    cell type tied to the factors, a batch, and x/y coordinates."""
    rng = np.random.default_rng(21)
    types = np.repeat(["T", "B", "NK"], CELLS // 3)
    H = rng.random((RANK, CELLS)) * 0.3
    for f, t in enumerate(("T", "B", "NK")):
        H[f, types == t] += 2.0
    W = rng.random((GENES, RANK)) ** 2
    counts = rng.poisson(W @ H * 3.0).astype(np.float32)
    meta = {"cell_type": types.astype(object),
            "batch": np.array(["b1", "b2"] * (CELLS // 2), dtype=object),
            "x": (rng.random(CELLS) * 10).astype(np.float32),
            "y": (rng.random(CELLS) * 10).astype(np.float32)}
    return sp.csc_matrix(counts), meta


def _experiments():
    counts, meta = _data()
    genes = [f"g{i}" for i in range(GENES)]
    cells = [f"c{i}" for i in range(CELLS)]
    return (jexp.Experiment(counts=counts.copy(), gene_names=list(genes),
                            cell_names=list(cells), meta=dict(meta)),
            texp.Experiment(counts=counts.copy(), gene_names=list(genes),
                            cell_names=list(cells), meta=dict(meta)))


def _close_models(got, want):
    assert got.k == want.k
    assert got.gene_names == want.gene_names
    assert got.cell_names == want.cell_names
    assert got.reduction_key == want.reduction_key
    for f in ("w", "d", "h"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


def _close_frames(got: pd.DataFrame, want: pd.DataFrame, exact=()):
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index)
    for col in got.columns:
        a, b = got[col].to_numpy(), want[col].to_numpy()
        if col in exact or a.dtype == object:
            np.testing.assert_array_equal(a, b, err_msg=col)
        else:
            np.testing.assert_allclose(a.astype(float), b.astype(float),
                                       **FIT, err_msg=col)


FIT_KW = dict(tol=1e-4, maxit=60, verbose=0, seed=5)


def test_fixed_rank_and_preprocessing():
    ej, et = _experiments()
    ej.run_nmf(k=RANK, **FIT_KW)
    et.run_nmf(k=RANK, device="cpu", **FIT_KW)
    np.testing.assert_array_equal(et.data.toarray(), ej.data.toarray())
    _close_models(et.reductions["nmf"], ej.reductions["nmf"])


def test_rank_list_cross_validates_then_fits():
    ej, et = _experiments()
    kw = dict(FIT_KW, reps=2, maxit=30, reduction_name="cv")
    ej.run_nmf(k=[2, 3, 4], **kw)
    et.run_nmf(k=[2, 3, 4], device="cpu", **kw)
    got, want = et.reductions["cv"], ej.reductions["cv"]
    _close_frames(got.cv_data, want.cv_data, exact=("k", "rep", "iter"))
    _close_models(got, want)


def test_auto_rank_search():
    """k=None: the ard_nmf search with k_max=10000, which this operand's
    search never reaches."""
    ej, et = _experiments()
    kw = dict(FIT_KW, maxit=30)
    ej.run_nmf(k=None, **kw)
    et.run_nmf(k=None, device="cpu", **kw)
    got, want = et.reductions["nmf"], ej.reductions["nmf"]
    assert got.k < 20
    _close_frames(got.cv_data[["k", "rep", "test_error", "iter"]],
                  want.cv_data[["k", "rep", "test_error", "iter"]],
                  exact=("k", "rep", "iter"))
    _close_models(got, want)


@pytest.fixture(scope="module")
def fitted():
    """Both experiments after a fixed-rank fit (their own) and a shared
    copy of the JAX fit as the reduction 'base', for the analyses that
    read one model."""
    import singlet_tpu_torch.model as tm

    mp = pytest.MonkeyPatch()
    _patch_init_w(mp)
    try:
        ej, et = _experiments()
        ej.run_nmf(k=RANK, **FIT_KW)
        et.run_nmf(k=RANK, device="cpu", **FIT_KW)
    finally:
        mp.undo()
    base = ej.reductions["nmf"]
    ej.reductions["base"] = base
    et.reductions["base"] = tm.NMFModel(
        w=base.w.copy(), d=base.d.copy(), h=base.h.copy(),
        gene_names=list(base.gene_names), cell_names=list(base.cell_names))
    return ej, et


def test_linked_nmf_and_factor_split(fitted):
    ej, et = fitted
    kw = dict(split_by="batch", reduction_use="base", tol=1e-4, maxit=40,
              verbose=False, link_cutoff=0.5)
    ej.run_lnmf(**kw)
    et.run_lnmf(device="cpu", **kw)
    _close_models(et.reductions["lnmf"], ej.reductions["lnmf"])
    assert et.shared_factors("batch") == ej.shared_factors("batch")
    assert et.unique_factors("batch") == ej.unique_factors("batch")


@pytest.mark.parametrize("split_by", [None, "batch"])
def test_project_data(fitted, split_by):
    """Projection onto the shared fit's loadings, a gene subset in another
    order, matched by name."""
    ej, et = fitted
    base = ej.reductions["base"]
    order = np.arange(GENES)[::-1][: GENES - 10]
    w = base.w[order]
    names = [base.gene_names[i] for i in order]
    for exp, kw in ((ej, {}), (et, dict(device="cpu"))):
        exp.project_data(w, gene_names_w=names, split_by=split_by,
                         reduction_name="proj", **kw)
    _close_models(et.reductions["proj"], ej.reductions["proj"])


def test_local_neighbors_and_gcnmf(fitted):
    ej, et = fitted
    kw = dict(reduction="base", k=5, radius=3.0, snn=0.1)
    ej.find_local_neighbors(**kw)
    et.find_local_neighbors(device="cpu", **kw)
    for name in ("lknn", "lknn_snn"):
        got, want = et.graphs[name], ej.graphs[name]
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=1e-4,
                                   atol=1e-7)
    w0 = np.random.default_rng(8).random((GENES, RANK)).astype(np.float32)
    gkw = dict(graph="lknn", k=RANK, tol=1e-4, maxit=30, w_init=w0)
    ej.run_gcnmf(**gkw)
    et.run_gcnmf(device="cpu", **gkw)
    _close_models(et.reductions["gcnmf"], ej.reductions["gcnmf"])


def test_annotate_gsea_and_summaries(fitted):
    """The analyses on each package's own fit: annotation frames, GSEA
    matrices and metadata summaries within the fit tolerance."""
    ej, et = fitted
    ej.annotate_nmf(columns=["cell_type", "batch"])
    et.annotate_nmf(columns=["cell_type", "batch"])
    ann_j = ej.reductions["nmf"].misc["annotations"]
    ann_t = et.reductions["nmf"].misc["annotations"]
    assert list(ann_t) == list(ann_j) == ["cell_type", "batch"]
    for col in ann_j:
        _close_frames(ann_t[col], ann_j[col])
    genes = ej.gene_names
    sets = {"TOP_1": [genes[i] for i in
                      np.argsort(-ej.reductions["nmf"].w[:, 0])[:12]],
            "MID": genes[20:35], "TAIL": genes[40:55]}
    kw = dict(min_size=5, max_size=50, seed=3)
    ej.run_gsea(sets, **kw)
    et.run_gsea(sets, **kw)
    gj, gt = ej.reductions["nmf"].misc["gsea"], et.reductions["nmf"].misc[
        "gsea"]
    assert list(gt) == list(gj)
    for key in ("pval", "padj", "es", "nes"):
        _close_frames(gt[key], gj[key])
    for split_by in ("cell_type", "batch"):
        _close_frames(et.metadata_summary(split_by),
                      ej.metadata_summary(split_by))
