"""The drivers on the blocked-ELL route: ``run_nmf``, ``cross_validate_nmf``
and ``ard_nmf`` of the port against the JAX package's on scipy input that
both send to their ELL engine (``SPARSE_THRESHOLD`` monkeypatched low in
both packages' drivers), from one numpy ``init_w``
(tests/test_torch_masked.py), on the CPU. Tolerances are those of
tests/test_drivers.py: rtol=5e-3 on test errors, rtol=5e-3, atol=5e-4 on
factors, equal ``k``, ``rep`` and ``iter`` columns and the same chosen rank.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import singlet_tpu_torch as stt
from singlet_tpu import ard_nmf as jax_ard_nmf
from singlet_tpu import cross_validate_nmf as jax_cross_validate_nmf
from singlet_tpu import run_nmf as jax_run_nmf
from singlet_tpu.solvers import drivers as jdrivers
from singlet_tpu_torch.parallel import sharded_ell as tell
from singlet_tpu_torch.solvers import drivers as tdrivers
from test_drivers import _lowrank
from test_torch_masked import _assert_frames_close, _shared_init_w
from test_torch_sharded_ell import FIT, _sparse


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain versions here are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _route_low(monkeypatch, threshold=1000):
    """Send small scipy input to the ELL engine in both packages."""
    monkeypatch.setattr(jdrivers, "SPARSE_THRESHOLD", threshold)
    monkeypatch.setattr(tdrivers, "SPARSE_THRESHOLD", threshold)
    made = []
    real = tdrivers.ShardedEllEngine

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tdrivers, "ShardedEllEngine", Spy)
    return made


def test_run_nmf_on_ell_route_matches_jax(rng, monkeypatch):
    made = _route_low(monkeypatch)
    A = _sparse(40, 300)
    w0 = rng.random((40, 4)).astype(np.float32)
    kw = dict(rank=4, tol=1e-4, maxit=15, w_init=w0)
    got = stt.run_nmf(A, device="cpu", **kw)
    want = jax_run_nmf(A, **kw)
    assert len(made) == 1
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


def test_cross_validate_on_ell_route_matches_jax(rng, monkeypatch):
    _shared_init_w(monkeypatch)
    made = _route_low(monkeypatch)
    A = sp.csc_matrix(_lowrank(rng, genes=50, cells=260, k=3, noise=0.05))
    kw = dict(ranks=[2, 3, 5], n_replicates=1, tol=1e-3, maxit=20,
              verbose=0, seed=11)
    got = stt.cross_validate_nmf(A, device="cpu", **kw)
    want = jax_cross_validate_nmf(A, **kw)
    assert len(made) == 1
    _assert_frames_close(got, want)
    assert stt.GetBestRank(got) == jdrivers.GetBestRank(want)


def test_ard_nmf_on_ell_route_matches_jax(rng, monkeypatch):
    _shared_init_w(monkeypatch)
    made = _route_low(monkeypatch)
    A = sp.csc_matrix(_lowrank(rng, genes=60, cells=300, k=2, noise=0.01,
                               sparsity=0.0))
    kw = dict(k_max=6, maxit=20, cv_tol=1e-3, tol=1e-4, learning_rate=0.5,
              verbose=0, seed=3)
    got = stt.ard_nmf(A, device="cpu", **kw)
    want = jax_ard_nmf(A, **kw)
    assert len(made) == 1
    _assert_frames_close(got.cv_data, want.cv_data)
    assert got.k == want.k
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


def test_engine_passes_through_the_drivers(rng):
    A = _sparse(40, 300)
    te = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                               gene_block=32)
    w0 = rng.random((40, 3)).astype(np.float32)
    model = stt.run_nmf(te, 3, tol=0.0, maxit=3, w_init=w0)
    out = te.fit(3, tol=0.0, maxit=3, w_init=w0)
    np.testing.assert_array_equal(np.sort(model.d)[::-1], model.d)
    np.testing.assert_allclose(np.sort(model.d), np.sort(out["d"]))
    df = stt.cross_validate_nmf(te, ranks=[2, 3], n_replicates=1, maxit=4,
                                verbose=0)
    assert sorted(df["k"].unique()) == [2, 3]
