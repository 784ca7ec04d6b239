"""The port's remaining solvers against the JAX package's on the CPU, from
one shared numpy W (``w_init``): linked NMF and projection on dense
providers and on the blocked-ELL engine (rtol 3e-4, atol 3e-5, as
tests/test_sharded_ell.py's linked and project tests); ``nmf_batch`` and
the engine's ``batch_fit``, dense ``gcnmf`` and the engine's
``gcnmf_fit``, each against the JAX dense solver (rtol 2e-4, atol 2e-5,
as tests/test_sharded_ell.py's batch and GCNMF tests); ``mu_nmf`` (both
steps) with both packages' random inits replaced by one numpy draw; and
the numpy edge-cluster utilities and ``build_link_matrix`` exactly."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import singlet_tpu_torch as stt
from singlet_tpu.solvers import batch as jbatch
from singlet_tpu.solvers import gcnmf as jgcnmf
from singlet_tpu.solvers import linked as jlinked
from singlet_tpu.solvers import mu as jmu
from singlet_tpu.solvers import project as jproject
from singlet_tpu_torch.parallel import sharded_ell as tell
from singlet_tpu_torch.solvers import mu as tmu
from test_torch_sharded_ell import _sparse

LINKED = dict(rtol=3e-4, atol=3e-5)
SOLVER = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain versions here are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operand():
    """48 genes x 300 cells, 20% dense; on the engine in blocks of 256
    cells and 32 genes (two cell blocks, two gene blocks)."""
    return _sparse(48, 300, density=0.2, seed=11)


def _engine(A):
    return tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                                 gene_block=32)


def _close(got, want, tol, fields=("w", "d", "h")):
    for f in fields:
        g = got[f] if isinstance(got, dict) else getattr(got, f)
        w = want[f] if isinstance(want, dict) else getattr(want, f)
        np.testing.assert_allclose(g, w, **tol, err_msg=f)


def _links(genes, cells, k):
    link_h = np.ones((k, cells), np.float32)
    link_h[0, : cells // 2] = 0.0          # factor 0 unlinked from 1st half
    link_w = np.ones((genes, k), np.float32)
    link_w[: genes // 4, 1] = 0.0          # factor 1 unlinked from 1st genes
    return link_h, link_w


@pytest.mark.parametrize("route", ["dense", "engine"])
def test_linked_matches_jax(rng, route):
    A = _operand()
    genes, cells = A.shape
    k = 4
    w0 = rng.random((genes, k)).astype(np.float32)
    link_h, link_w = _links(genes, cells, k)
    kw = dict(link_h=link_h, link_w=link_w, tol=0.0, maxit=5, verbose=False)
    want = jlinked.run_linked_nmf(A.toarray(), w0, **kw)
    src = A.toarray() if route == "dense" else _engine(A)
    got = stt.run_linked_nmf(src, w0, device="cpu", **kw)
    _close(got, want, LINKED)
    np.testing.assert_array_equal(got.misc["link_matrix"], link_h)
    assert np.abs(got.h[:, : cells // 2]).min() == pytest.approx(0.0)


def test_linked_refusals(rng):
    A = _operand().toarray()
    w0 = rng.random((48, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="cannot be None"):
        stt.run_linked_nmf(A, w0, device="cpu")
    with pytest.raises(ValueError, match="link_h"):
        stt.run_linked_nmf(A, w0, link_h=np.ones((3, 7)), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh.*'cells'"):
        stt.run_linked_nmf(A, w0, link_h=np.ones((3, 300)), mesh=object(),
                           device="cpu")


def test_build_link_matrix_matches_jax(rng):
    emb = rng.random((90, 5))
    emb[:30, 2] *= 0.01                  # factor 2 absent from group "a"
    groups = np.array(["a"] * 30 + ["b"] * 40 + ["c"] * 20)
    got = stt.build_link_matrix(emb, groups, link_cutoff=0.5)
    want = jlinked.build_link_matrix(emb, groups, link_cutoff=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[0][2, :30].max() == 0.0


@pytest.mark.parametrize("route", ["dense", "engine", "chunks"])
@pytest.mark.parametrize("transposed", [False, True])
def test_project_matches_jax(rng, route, transposed):
    A = _operand()
    W = rng.random((A.shape[0], 5)).astype(np.float32)
    h_d, d_d = jproject.project_model(A.toarray(), W, L1=0.01)
    src = {"dense": A.toarray(), "engine": _engine(A),
           "chunks": [A[:, :130], A[:, 130:]]}[route]
    h, d = stt.project_model(src, W.T if transposed else W, L1=0.01,
                             device="cpu")
    np.testing.assert_allclose(h, h_d, **LINKED)
    np.testing.assert_allclose(d, d_d, rtol=LINKED["rtol"])
    with pytest.raises(ValueError, match="common edge"):
        stt.project_model(A.toarray(), rng.random((7, 9)), device="cpu")


def _batch_ids(n):
    return (np.arange(n) % 3).astype(np.int64)


@pytest.mark.parametrize("route", ["dense", "batch_fit"])
def test_nmf_batch_matches_jax_dense(rng, route):
    A = _operand()
    w0 = rng.random((A.shape[0], 3)).astype(np.float32)
    bid = _batch_ids(A.shape[1])
    kw = dict(tol=0.0, maxit=5, w_init=w0)
    want = jbatch.nmf_batch(A.toarray(), 3, bid, **kw)
    if route == "dense":
        got = stt.nmf_batch(A.toarray(), 3, bid, device="cpu", **kw)
    else:
        out = _engine(A).batch_fit(bid, 3, **kw)
        got = stt.NMFModel(out["w"], out["d"], out["h"]).sorted_by_d()
        assert len(out["tol_trace"]) == 5
    _close(got, want, SOLVER)


def test_nmf_batch_penalty_bites_and_labels(rng):
    A = _operand().toarray()
    w0 = rng.random((48, 3)).astype(np.float32)
    bid = _batch_ids(300)
    kw = dict(tol=0.0, maxit=5, w_init=w0, device="cpu")
    batched = stt.nmf_batch(A, 3, bid, **kw)
    labels = stt.nmf_batch(A, 3, np.array(["x", "y", "z"])[bid], **kw)
    np.testing.assert_array_equal(labels.w, batched.w)
    plain = stt.nmf_batch(A, 3, np.zeros(300, np.int64), **kw)
    assert np.isfinite(plain.w).all()
    assert not np.allclose(batched.w, plain.w)
    assert np.allclose(stt.nmf_batch(A, 3, bid, L1=0.0, **kw).w,
                       stt.nmf_batch(A, 3, bid, L1=0.0, **kw).w)
    with pytest.raises(ValueError, match="same length"):
        stt.nmf_batch(A, 3, bid[:10], **kw)
    with pytest.raises(TypeError, match="DeviceMesh.*'cells'"):
        stt.nmf_batch(A, 3, bid, mesh=object(), **kw)


def _ring(n):
    """A sparse row-normalized ring graph over cells."""
    return sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1], format="csc").astype(np.float32) / 3.0


@pytest.mark.parametrize("route", ["dense", "gcnmf_fit"])
def test_gcnmf_matches_jax_dense(rng, route):
    A = _operand()
    n = A.shape[1]
    w0 = rng.random((A.shape[0], 3)).astype(np.float32)
    G = _ring(n)
    # a cell with an empty column but graph neighbours is solved too
    A = A.tolil()
    A[:, 5] = 0
    A = sp.csc_matrix(A)
    kw = dict(tol=0.0, maxit=5, w_init=w0, seed=0)
    want = jgcnmf.gcnmf(A.toarray(), G, 3, **kw)
    if route == "dense":
        got = stt.gcnmf(A.toarray(), G, 3, device="cpu", **kw)
    else:
        out = _engine(A).gcnmf_fit(G, 3, tol=0.0, maxit=5, w_init=w0)
        got = stt.NMFModel(out["w"], out["d"], out["h"]).sorted_by_d()
        assert len(out["tol_trace"]) == 5
    _close(got, want, SOLVER)
    assert got.h[:, 5].max() > 0


def test_gcnmf_refusals(rng):
    A = _operand()
    eng = _engine(A)
    with pytest.raises(ValueError, match="cells x cells"):
        eng.gcnmf_fit(_ring(10), 3, maxit=1)
    with pytest.raises(ValueError, match="cells x cells"):
        stt.gcnmf(A.toarray(), _ring(10), 3, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh.*'cells'"):
        stt.gcnmf(A.toarray(), _ring(300), 3, mesh=object(), device="cpu")
    # G's planes pad its rows to a multiple of the gene block, which must
    # be cells_pad (the JAX engine asserts it)
    B = _sparse(512, 600, density=0.02, seed=2)
    odd = tell.ShardedEllEngine(B, device="cpu", cell_block=768,
                                gene_block=512)
    with pytest.raises(ValueError, match="cells_pad"):
        odd.gcnmf_fit(_ring(600), 3, maxit=1)
    g = eng.graph_data(_ring(300))
    assert (g.genes_pad, g.cells_pad) == (eng.data.cells_pad,) * 2


def test_edge_cluster_utilities_match_jax(rng):
    n, k = 40, 4
    G = sp.csc_matrix((rng.random((n, n)) < 0.1).astype(np.float32))
    h = rng.random((k, n))
    for hh in (h, h.T):
        np.testing.assert_array_equal(stt.differentiate_model(hh, G),
                                      jgcnmf.differentiate_model(hh, G))
    labels = rng.integers(0, 5, G.nnz)
    np.testing.assert_array_equal(
        stt.assign_cells_to_edge_clusters(G, labels),
        jgcnmf.assign_cells_to_edge_clusters(G, labels))
    with pytest.raises(ValueError, match="compatible"):
        stt.differentiate_model(rng.random((3, 7)), G)


@pytest.mark.parametrize("faithful", [False, True])
def test_mu_nmf_matches_jax(rng, monkeypatch, faithful):
    """Both packages start from one numpy draw: the JAX package's uniform
    and normal draws and the port's ``_mu_init`` are replaced."""
    A = _operand().toarray()
    genes, cells = A.shape
    k = 3
    u = rng.random((genes, k)).astype(np.float32)
    z = rng.standard_normal((k, cells)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None: jax.numpy.asarray(u))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jax.numpy.asarray(z))
    monkeypatch.setattr(tmu, "_mu_init", lambda g, c, kk, seed, device: (
        torch.as_tensor(u) + 1e-3, torch.as_tensor(z).abs() + 1e-3))
    maxit = 3 if faithful else 10
    want = jmu.mu_nmf(A, k, tol=0.0, maxit=maxit, faithful=faithful)
    got = stt.mu_nmf(A, k, tol=0.0, maxit=maxit, faithful=faithful,
                     device="cpu")
    _close(got, want, SOLVER)
    np.testing.assert_allclose(got["tol_trace"], want["tol_trace"],
                               **SOLVER)
    assert len(got["tol_trace"]) == maxit


def test_mu_nmf_draws_its_own_init():
    A = _operand().toarray()
    out = stt.mu_nmf(A, 3, tol=1e-3, maxit=20, device="cpu")
    assert out["w"].shape == (48, 3) and out["h"].shape == (3, 300)
    assert np.isfinite(out["w"]).all() and (out["w"] >= 0).all()
    assert out["tol_trace"] == stt.mu_nmf(A, 3, tol=1e-3, maxit=20,
                                          device="cpu")["tol_trace"]
