"""Streaming ingest in the port (``singlet_tpu_torch/sparse/chunked.py``,
``parallel/sharded_ell.py`` ``shard_ell_from_chunks`` /
``shard_ell_from_staged``, the drivers' list and directory routes) against
the JAX package's on a one-device mesh, on the CPU: planes bit for bit
(chunks as scipy matrices, SVC and .mtx paths and callables, uneven
widths, a chunk boundary inside a cell block, empty columns), directories
staged by either package read by the other, ``run_nmf`` on a list against
the matrix (rtol 2e-4, atol 2e-5, as tests/test_chunked.py) and
``cross_validate_nmf`` on a staged directory against JAX's (the frame
tolerances of tests/test_torch_masked.py)."""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import singlet_tpu_torch as stt
from singlet_tpu import cross_validate_nmf as jax_cross_validate_nmf
from singlet_tpu import run_nmf as jax_run_nmf
from singlet_tpu.parallel import sharded_ell as jell
from singlet_tpu.parallel.sharded import make_mesh
from singlet_tpu.sparse import chunked as jchunked
from singlet_tpu_torch import native as tnative
from singlet_tpu_torch.parallel import sharded_ell as tell
from singlet_tpu_torch.solvers import drivers as tdrivers
from singlet_tpu_torch.sparse import chunked as tchunked
from test_torch_masked import _assert_frames_close, _shared_init_w

CHUNKED = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain versions here are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mat(genes=120, cells=700, density=0.05, seed=7):
    A = sp.random(genes, cells, density=density, random_state=seed,
                  dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    A = A.tolil()
    A[:, [0, 3, cells // 2 + 1, cells - 1]] = 0   # empty columns
    A[:, cells // 2 - 1] = 2.5               # a dense cell sets the width
    return sp.csc_matrix(A)


# uneven chunk widths; with cell_block 256 the bounds 250, 300 and 530 fall
# inside cell blocks
BOUNDS = [0, 250, 300, 530, 700]


def _split(A, bounds=BOUNDS):
    return [A[:, lo:hi].tocsc() for lo, hi in zip(bounds[:-1], bounds[1:])]


def _sources(kind, chunks, tmp_path):
    """The chunks as the chunk list a user would pass."""
    if kind == "scipy":
        return chunks
    if kind == "callable":
        return [lambda M=M: M for M in chunks]
    paths = []
    for i, M in enumerate(chunks):
        p = str(tmp_path / f"c{i}.{kind}")
        if kind == "svc":
            tnative.svc_write(p, M)
        elif kind == "mtx":
            scipy.io.mmwrite(p, M)
        paths.append(p)
    return paths


def _assert_same_data(td, jd):
    """The port's ShardedEllData equals the JAX one's, planes bit for bit."""
    for f in ("b_li", "b_val", "nonempty", "gene_nonempty"):
        got, want = getattr(td, f).numpy(), np.asarray(getattr(jd, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("b_width", "genes_true", "cells_true", "genes_pad",
              "cells_pad", "cell_block", "gene_block"):
        assert getattr(td, f) == getattr(jd, f), f


@pytest.mark.parametrize("kind", ["scipy", "callable", "svc", "mtx"])
def test_chunk_planes_match_jax(kind, tmp_path):
    A = _mat()
    chunks = _sources(kind, _split(A), tmp_path)
    td = tell.shard_ell_from_chunks(chunks, "cpu", cell_block=256,
                                    gene_block=32)
    jd = jell.shard_ell_from_chunks(chunks, make_mesh(1), cell_block=256,
                                    gene_block=32)
    _assert_same_data(td, jd)
    # the planes of the concatenated matrix
    mono = tell.shard_ell_data(A, "cpu", cell_block=256, gene_block=32)
    np.testing.assert_array_equal(td.b_li.numpy(), mono.b_li.numpy())
    np.testing.assert_array_equal(td.b_val.numpy(), mono.b_val.numpy())
    np.testing.assert_array_equal(td.nonempty.numpy(),
                                  mono.nonempty.numpy())


def test_chunks_disagreeing_on_genes_raise():
    A = _mat()
    with pytest.raises(ValueError, match="gene axis"):
        tell.shard_ell_from_chunks([A[:, :10], A[:60, 10:20]], "cpu")


@pytest.mark.parametrize("value_compress", [False, True])
@pytest.mark.parametrize("stager", ["jax", "port"])
def test_staged_directories_cross_packages(stager, value_compress, tmp_path):
    """A directory staged by either package is ingested by both into the
    same planes, and its loaders give back the matrix."""
    A = _mat(seed=3)
    stage = (jchunked if stager == "jax" else tchunked).stage_chunks
    d = stage(str(tmp_path / "staged"), _split(A),
              value_compress=value_compress)
    td = tell.shard_ell_from_staged(d, "cpu", cell_block=256, gene_block=32)
    jd = jell.shard_ell_from_staged(d, make_mesh(1), cell_block=256,
                                    gene_block=32)
    _assert_same_data(td, jd)
    loaders = tchunked.staged_chunk_loaders(d)
    assert len(loaders) == len(BOUNDS) - 1
    R = sp.hstack([ld() for ld in loaders]).tocsc()
    assert (R != A).nnz == 0
    # the staged planes are the chunk list's
    tc = tell.shard_ell_from_chunks(
        [os.path.join(d, f) for f in sorted(os.listdir(d))
         if f.endswith(".svc")], "cpu", cell_block=256, gene_block=32)
    np.testing.assert_array_equal(td.b_li.numpy(), tc.b_li.numpy())
    np.testing.assert_array_equal(td.b_val.numpy(), tc.b_val.numpy())


def test_not_a_staged_directory(tmp_path):
    with open(tmp_path / "manifest.json", "w") as f:
        f.write('{"format": "other"}')
    with pytest.raises(ValueError, match="not a staged chunk directory"):
        tchunked.staged_chunk_loaders(str(tmp_path))
    with pytest.raises(ValueError, match="not a staged chunk directory"):
        tell.shard_ell_from_staged(str(tmp_path), "cpu")


def test_run_nmf_list_matches_matrix_and_jax(rng):
    A = _mat(genes=80, cells=400, density=0.1)
    w0 = rng.random((80, 4)).astype(np.float32)
    kw = dict(rank=4, tol=0.0, maxit=5, w_init=w0)
    m_list = stt.run_nmf(_split(A, [0, 150, 260, 400]), device="cpu", **kw)
    m_mono = stt.run_nmf(A.toarray(), device="cpu", **kw)
    for f in ("w", "d", "h"):
        np.testing.assert_allclose(getattr(m_list, f), getattr(m_mono, f),
                                   **CHUNKED, err_msg=f)
    m_jax = jax_run_nmf(_split(A, [0, 150, 260, 400]), **kw)
    for f in ("w", "d", "h"):
        np.testing.assert_allclose(getattr(m_list, f), getattr(m_jax, f),
                                   **CHUNKED, err_msg=f)


def test_list_and_directory_route_to_the_engine(tmp_path):
    A = _mat(genes=60, cells=300, density=0.1)
    P = tdrivers._engine_or_providers(_split(A, [0, 100, 300]), None, "cpu")
    assert isinstance(P, tell.ShardedEllEngine)
    assert (P.rows_true, P.cols_true) == (60, 300)
    d = tchunked.stage_chunks(str(tmp_path / "s"), _split(A, [0, 120, 300]))
    P = tdrivers._engine_or_providers(d, None, "cpu")
    assert isinstance(P, tell.ShardedEllEngine) and P.cols_true == 300
    with pytest.raises(TypeError, match="DeviceMesh.*'cells'"):
        tdrivers._engine_or_providers(d, object(), "cpu")


def test_cross_validate_on_staged_dir_matches_jax(tmp_path, monkeypatch):
    _shared_init_w(monkeypatch)
    A = _mat(genes=60, cells=300, density=0.1)
    d = tchunked.stage_chunks(str(tmp_path / "s"), _split(A, [0, 140, 300]))
    kw = dict(ranks=[2, 3], n_replicates=1, maxit=3, verbose=0,
              trace_test_mse=1)
    got = stt.cross_validate_nmf(d, device="cpu", **kw)
    want = jax_cross_validate_nmf(d, **kw)
    assert set(got["k"]) == {2, 3}
    assert np.isfinite(got["test_error"]).all()
    _assert_frames_close(got, want)
