"""Checkpoint / resume and metric logging of the port
(``singlet_tpu_torch/checkpoint.py``, ``tracing.py`` and the ``checkpoint=``
of every fit), on the CPU.

Twins of the five tests of tests/test_checkpoint.py, on the same inputs;
then the ELL engine's ``fit`` and ``ard_fit`` interrupted and resumed, on
its f32 route (the CPU's) and on its hash route (forced by patching
``sharded_ell._kernel_device``, so that the plain versions of B10/B11
run): each resumed fit equals the uninterrupted one bit for bit; and a
checkpoint that the JAX ``nmf_fit`` writes, resumed by the port's, against
JAX's uninterrupted fit from the same numpy W0 within the fit tolerance
(rtol 5e-3, atol 5e-4: two frameworks' float32 sums).
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu_torch.checkpoint import (CheckpointManager, load_fit_state,
                                          save_fit_state)
from singlet_tpu_torch.parallel import sharded_ell as tell
from singlet_tpu_torch.solvers.als import nmf_fit
from singlet_tpu_torch.solvers.ard import ard_nmf_fit
from singlet_tpu_torch.tracing import metric_logging

FIT = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, genes=40, cells=56):
    W = rng.gamma(0.5, 1.0, (genes, 4)).astype(np.float32)
    H = rng.gamma(0.5, 1.0, (4, cells)).astype(np.float32)
    return np.log1p(rng.poisson(W @ H).astype(np.float32))


def test_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "s.npz")
    state = dict(W=np.arange(6.0).reshape(2, 3), d=np.ones(3),
                 it=7, tol_trace=[0.5, 0.25], config="abc")
    save_fit_state(path, state)
    out = load_fit_state(path)
    np.testing.assert_array_equal(out["W"], state["W"])
    assert out["it"] == 7 and out["tol_trace"] == [0.5, 0.25]
    assert out["config"] == "abc"
    assert os.listdir(tmp_path) == ["s.npz"]     # no temporary file left


def test_manager_rolls_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    cfg = CheckpointManager.config_of(k=3)
    for it in (1, 2, 3):
        mgr.save(it, dict(cfg, W=np.full((2, 2), float(it)), tol_trace=[]))
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2  # keep=2
    st = mgr.restore(cfg)
    assert st["it"] == 3
    assert mgr.restore(CheckpointManager.config_of(k=4)) is None  # mismatch


def test_nmf_fit_resume_identical(rng, tmp_path):
    A = _data(rng)
    w0 = rng.random((A.shape[0], 3)).astype(np.float32)
    full = nmf_fit(A, 3, w_init=w0, tol=0.0, maxit=6, device="cpu")

    # interrupted run: stops at iter 3, checkpointing every iteration
    mgr = CheckpointManager(str(tmp_path), every=1)
    nmf_fit(A, 3, w_init=w0, tol=0.0, maxit=3, checkpoint=mgr, device="cpu")
    # resumed run continues from iter 3 to 6
    res = nmf_fit(A, 3, w_init=w0, tol=0.0, maxit=6, checkpoint=mgr,
                  device="cpu")
    np.testing.assert_array_equal(res.w, full.w)
    np.testing.assert_array_equal(res.h, full.h)
    np.testing.assert_array_equal(res.d, full.d)
    assert res.tol_trace == full.tol_trace


def test_ard_fit_resume_identical(rng, tmp_path):
    A = _data(rng)
    w0 = rng.random((A.shape[0], 3)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=5, inv_density=8, tol=0.0,
              trace_test_mse=1, device="cpu")
    full = ard_nmf_fit(A, 3, maxit=6, **kw)
    mgr = CheckpointManager(str(tmp_path), every=2)
    ard_nmf_fit(A, 3, maxit=4, checkpoint=mgr, **kw)
    res = ard_nmf_fit(A, 3, maxit=6, checkpoint=mgr, **kw)
    np.testing.assert_array_equal(res.w, full.w)
    assert res.test_mse == full.test_mse
    assert res.iter == full.iter
    assert res.tol == full.tol and res.score_overfit == full.score_overfit


def test_ard_search_resume_identical(rng, tmp_path):
    """The ard_nmf search checkpoints its adaptive-walk state per completed
    rank fit; a valve-stopped search resumed with the same arguments
    reproduces the uninterrupted search's CV trace and final model."""
    from singlet_tpu_torch.solvers.drivers import ard_nmf

    A = _data(rng, genes=48, cells=64)
    kw = dict(k_init=2, k_max=8, n_replicates=2, tol=0.0, cv_tol=0.0,
              maxit=4, trace_test_mse=2, seed=11, verbose=0, device="cpu")
    full = ard_nmf(A, **kw)

    ckdir = str(tmp_path / "ard_search")
    # interrupted: the max_fits valve stops the search after 3 fits with
    # the walk state checkpointed mid-replicate
    ard_nmf(A, max_fits=3, checkpoint=ckdir, **kw)
    assert os.path.exists(ckdir) and os.listdir(ckdir)
    # resumed with the full budget: skips the 3 completed fits and goes on
    # to the identical end state
    res = ard_nmf(A, checkpoint=ckdir, **kw)

    assert res.k == full.k
    np.testing.assert_array_equal(res.w, full.w)
    np.testing.assert_array_equal(res.d, full.d)
    np.testing.assert_array_equal(res.h, full.h)
    for col in ("k", "rep", "test_error", "iter", "tol"):
        np.testing.assert_array_equal(res.cv_data[col].to_numpy(),
                                      full.cv_data[col].to_numpy())
    assert res.cv_data.dtypes.equals(full.cv_data.dtypes)


def test_metric_logging_jsonl(rng, tmp_path):
    A = _data(rng, genes=24, cells=32)
    path = str(tmp_path / "metrics.jsonl")
    with metric_logging(path) as logger:
        nmf_fit(A, 2, tol=0.0, maxit=3, device="cpu")
        events = list(logger.events)
    names = [e["event"] for e in events]
    assert names[0] == "fit_start" and names[-1] == "fit_end"
    assert names.count("iteration") == 3
    iters = [e for e in events if e["event"] == "iteration"]
    assert all("tol" in e and "ms" in e and e["fit"] for e in iters)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == len(events)


def test_metric_logging_masked_and_engine(rng):
    """The masked fit logs test_mse and overfit_score on traced iterations;
    the ELL engine logs bell_ingest and its fits' events."""
    A = _data(rng, genes=24, cells=32)
    with metric_logging() as logger:
        ard_nmf_fit(A, 2, tol=0.0, maxit=4, trace_test_mse=2,
                    overfit_threshold=1.0, device="cpu")
        eng = tell.ShardedEllEngine(sp.csc_matrix(A), device="cpu")
        eng.fit(2, tol=0.0, maxit=2)
        eng.ard_fit(2, tol=0.0, maxit=2, overfit_threshold=1.0)
    ev = logger.events
    start = [e for e in ev if e["event"] == "fit_start"]
    assert [e["algo"] for e in start] == ["ard_masked", "sharded_ell_fit",
                                          "sharded_ell_ard"]
    ard = [e for e in ev if e["event"] == "iteration"
           and e["fit"] == start[0]["fit"]]
    assert [e["iter"] for e in ard] == [1, 2, 3, 4]
    assert ["test_mse" in e and "overfit_score" in e for e in ard] == [
        True, False, True, False]
    assert [e["event"] for e in ev].count("fit_end") == 3
    ingest = [e for e in ev if e["event"] == "bell_ingest"]
    assert len(ingest) == 1 and ingest[0]["width"] == eng.data.b_width


def _ell_operand():
    A = sp.random(200, 600, density=0.1, random_state=2, format="csc",
                  dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    return A


@pytest.mark.parametrize("route", ["f32", "hash"])
@pytest.mark.parametrize("method", ["fit", "ard_fit"])
def test_ell_resume_identical(rng, tmp_path, monkeypatch, route, method):
    """The ELL engine's checkpointed fits, stopped and resumed, equal the
    uninterrupted checkpointed fit bit for bit, on the f32 route and on
    the hash route (B10/B11's plain versions)."""
    from singlet_tpu_torch.ops import maskgram

    if route == "hash":
        monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    eng = tell.ShardedEllEngine(_ell_operand(), device="cpu",
                                cell_block=256, gene_block=64)
    w0 = rng.random((200, 3)).astype(np.float32)
    if method == "fit":
        kw = dict(w_init=w0, tol=0.0, masked=True, mask_seed=4)
    else:
        kw = dict(w_init=w0, tol=0.0, mask_seed=4, trace_test_mse=1,
                  overfit_threshold=1.0)
    fit = getattr(eng, method)
    calls = maskgram.PLAIN_CALLS
    full = fit(3, maxit=4, checkpoint=CheckpointManager(
        str(tmp_path / "full"), every=2), **kw)
    # 3 cell blocks of 256: a B10 and a B11 per block and step
    assert maskgram.PLAIN_CALLS - calls == (24 if route == "hash" else 0)
    mgr = CheckpointManager(str(tmp_path / "cut"), every=2)
    fit(3, maxit=2, checkpoint=mgr, **kw)
    res = fit(3, maxit=4, checkpoint=mgr, **kw)
    if method == "fit":
        for key in ("w", "h", "d"):
            np.testing.assert_array_equal(res[key], full[key])
        assert res["tol_trace"] == full["tol_trace"]
        assert res["test_mse"] == full["test_mse"]
    else:
        for key in ("w", "h", "d"):
            np.testing.assert_array_equal(getattr(res, key),
                                          getattr(full, key))
        assert res.iter == full.iter == [0, 1, 2, 3]
        assert res.test_mse == full.test_mse and res.tol == full.tol


def test_sharded_ell_nmf_fit_passes_checkpoint(rng, tmp_path):
    A = _ell_operand()
    kw = dict(w_init=rng.random((200, 3)).astype(np.float32), tol=0.0,
              device="cpu")
    full = tell.sharded_ell_nmf_fit(A, 3, maxit=4, **kw)
    ck = str(tmp_path / "ck")
    tell.sharded_ell_nmf_fit(A, 3, maxit=2, checkpoint=CheckpointManager(
        ck, every=1), **kw)
    res = tell.sharded_ell_nmf_fit(A, 3, maxit=4, checkpoint=ck, **kw)
    assert res["tol_trace"] == full["tol_trace"]
    np.testing.assert_array_equal(res["w"], full["w"])
    with pytest.raises(NotImplementedError, match="chunk_iters"):
        tell.sharded_ell_nmf_fit(A, 3, chunk_iters=2, device="cpu")


def test_jax_checkpoint_resumes_in_the_port(rng, tmp_path):
    """JAX's nmf_fit writes 3 iterations with checkpoint=; the port's
    resumes them to 6 (the same file format and fingerprint), and agrees
    with JAX's uninterrupted 6-iteration fit from the same numpy W0."""
    from singlet_tpu.checkpoint import CheckpointManager as JaxManager
    from singlet_tpu.solvers.als import nmf_fit as jax_nmf_fit

    A = _data(rng)
    w0 = rng.random((A.shape[0], 3)).astype(np.float32)
    ck = str(tmp_path / "ck")
    jax_nmf_fit(A, 3, w_init=w0, tol=0.0, maxit=3,
                checkpoint=JaxManager(ck, every=1))
    want = jax_nmf_fit(A, 3, w_init=w0, tol=0.0, maxit=6)
    with metric_logging() as logger:
        got = nmf_fit(A, 3, w_init=w0, tol=0.0, maxit=6,
                      checkpoint=CheckpointManager(ck, every=1),
                      device="cpu")
    start = logger.events[0]
    assert start["event"] == "fit_start" and start["resumed_at"] == 3
    assert [e["iter"] for e in logger.events
            if e["event"] == "iteration"] == [4, 5, 6]
    assert got.n_iter == 6
    np.testing.assert_allclose(got.tol_trace, want.tol_trace, **FIT)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)
