"""The port's spatial graphs (``singlet_tpu_torch/graphs/spatial.py``)
against the JAX package's on the CPU, at tests/test_graphs.py's
tolerances: ``spatial_graph`` and ``rescale_spatial`` (numpy copies)
exactly; ``local_knn`` for each metric, with the ``similarity`` rule and
``max_dist``, the same edges (indices and column pointers) and values
within rtol 1e-4; ``snn_graph`` the same edges and values within rtol
1e-6, empty columns and a similarity floor included."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import singlet_tpu_torch as stt
from singlet_tpu.graphs import spatial as jspatial


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_edges(got: sp.csc_matrix, want: sp.csc_matrix, rtol: float):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=1e-7)


def test_spatial_graph_and_rescale_match_jax(rng):
    c1, c2 = rng.random(70) * 10, rng.random(70) * 10
    for max_k in (100, 3):
        got = stt.spatial_graph(c1, c2, max_dist=3.0, max_k=max_k, block=16)
        want = jspatial.spatial_graph(c1, c2, max_dist=3.0, max_k=max_k,
                                      block=16)
        _same_edges(got, want, rtol=0)
        np.testing.assert_array_equal(got.data, want.data)
    coords = np.array([[0.0, 0.0], [0.1, 0.2], [0.2, 0.4], [0.3, 0.8]])
    np.testing.assert_array_equal(stt.rescale_spatial(coords, units=2.0),
                                  jspatial.rescale_spatial(coords, units=2.0))


def _profiles(rng, metric, f, n):
    if metric == "hamming":                  # discrete, so distances differ
        return rng.integers(0, 3, (f, n)).astype(np.float32)
    return (rng.random((f, n)) + 0.05).astype(np.float32)


@pytest.mark.parametrize("metric,similarity,max_dist", [
    ("euclidean", True, 0.0), ("euclidean", True, 0.9),
    ("cosine", True, 0.0), ("cosine", False, 0.0),
    ("jaccard", True, 0.0), ("jaccard", False, 0.0),
    ("manhattan", True, 0.0), ("hamming", True, 0.0), ("kl", True, 0.0)])
def test_local_knn_matches_jax(rng, metric, similarity, max_dist):
    n, f, k, radius = 90, 6, 5, 3.0
    M = _profiles(rng, metric, f, n)
    cx = (rng.random(n) * 10).astype(np.float32)
    cy = (rng.random(n) * 10).astype(np.float32)
    kw = dict(k=k, radius=radius, metric=metric, similarity=similarity,
              max_dist=max_dist, block=32)
    got = stt.local_knn(M, cx, cy, device="cpu", **kw)
    want = jspatial.local_knn(M, cx, cy, **kw)
    _same_edges(got, want, rtol=1e-4)
    assert got.nnz > n and np.diff(got.indptr).max() <= k
    # profiles given as (n, features)
    _same_edges(stt.local_knn(M.T, cx, cy, device="cpu", **kw), got, 0)


def test_local_knn_refusals(rng):
    M = rng.random((4, 10)).astype(np.float32)
    c = rng.random(12).astype(np.float32)
    with pytest.raises(ValueError, match="coordinates"):
        stt.local_knn(M, c, c, k=3, radius=1.0, device="cpu")
    with pytest.raises(ValueError, match="unknown metric"):
        stt.local_knn(M, c[:10], c[:10], k=3, radius=1.0, metric="nope",
                      device="cpu")


@pytest.mark.parametrize("min_similarity", [0.0, 0.2])
def test_snn_graph_matches_jax(rng, min_similarity):
    n = 70
    A = (rng.random((n, n)) < 0.12).astype(np.float32)
    np.fill_diagonal(A, 0)
    A[:, 4] = 0                              # an empty column
    G = sp.csc_matrix(A * rng.random((n, n)).astype(np.float32))
    got = stt.snn_graph(G, min_similarity, block=16, device="cpu")
    want = jspatial.snn_graph(G, min_similarity, block=16)
    _same_edges(got, want, rtol=1e-6)
    assert got[:, 4].nnz == 0 and got[4, 3] == want[4, 3]
    assert (got.diagonal()[np.diff(G.indptr) > 0] == 1.0).all()


def test_snn_of_local_knn_matches_jax(rng):
    """The workflow of ``find_local_neighbors``: LKNN, then SNN."""
    n = 80
    M = rng.random((5, n)).astype(np.float32)
    cx, cy = (rng.random((2, n)) * 8).astype(np.float32)
    kw = dict(k=6, radius=3.0, metric="jaccard")
    G = stt.local_knn(M, cx, cy, device="cpu", **kw)
    _same_edges(stt.snn_graph(G, 0.1, device="cpu"),
                jspatial.snn_graph(jspatial.local_knn(M, cx, cy, **kw), 0.1),
                rtol=1e-6)
