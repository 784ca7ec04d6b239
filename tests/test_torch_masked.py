"""Parity of the port's masked rank search (packed Grams, masked ALS step,
test MSE, ``ard_nmf_fit``, ``cross_validate_nmf``, ``GetBestRank`` and
``ard_nmf``) with the JAX package's XLA path and the float64 oracle, on the
CPU, on the same numpy inputs.

Both packages start from the same numpy W0: ``init_w`` draws from threefry
in the JAX package and from a torch.Generator in the port, so the driver
tests replace ``init_w`` in both packages' drivers with one numpy draw.
Tolerances are those of the JAX package's own tests: rtol=5e-3, atol=5e-4
on factors (tests/test_als.py), rtol=5e-3 on test MSE
(tests/test_drivers.py). The packed-Gram helpers are compared exactly, on
integer-valued inputs whose f32 products and sums are exact in any order.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import reference_impl as ref
import singlet_tpu_torch as stt
from singlet_tpu import ard_nmf as jax_ard_nmf
from singlet_tpu import cross_validate_nmf as jax_cross_validate_nmf
from singlet_tpu.ops import linalg as jlinalg
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu.solvers import als as jals
from singlet_tpu.solvers import ard as jard
from singlet_tpu.solvers import drivers as jdrivers
from singlet_tpu_torch.ops import linalg as tlinalg
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.solvers import als as tals
from singlet_tpu_torch.solvers import ard as tard
from singlet_tpu_torch.solvers import drivers as tdrivers
from test_als import _synthetic
from test_drivers import _lowrank

FIT = dict(rtol=5e-3, atol=5e-4)


# ---------------------------------------------------------------- packed Grams

@pytest.mark.parametrize("k", [1, 4, 6])
def test_packed_grams_match_jax_exactly(rng, k):
    rows, n = 40, 24
    X = rng.integers(0, 4, (rows, k)).astype(np.float32)
    m = rng.random((n, rows)) < 0.2
    a_full = (X.T @ X).astype(np.float32)
    iu = tlinalg.triu_pairs(k)
    np.testing.assert_array_equal(np.stack(iu), np.stack(jlinalg.triu_pairs(k)))
    np.testing.assert_array_equal(tlinalg._sym_pos(k, iu),
                                  jlinalg._sym_pos(k, iu))

    P = tlinalg.packed_outer_products(torch.as_tensor(X), iu)
    jP = jlinalg.packed_outer_products(jnp.asarray(X), iu)
    np.testing.assert_array_equal(P.numpy(), np.asarray(jP))
    pt = tlinalg.mask_dot_t(P, torch.as_tensor(m), 1)             # (np, n)
    jpt = jlinalg.mask_dot_t(jP, jnp.asarray(m), 1)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(
        tlinalg.mask_dot_t(P, torch.as_tensor(m.T), 0).numpy(), pt.numpy())

    packed = pt.T.contiguous()                                    # (n, np)
    a = torch.as_tensor(a_full)
    np.testing.assert_array_equal(
        tlinalg.unpack_sym(packed, k, iu).numpy(),
        np.asarray(jlinalg.unpack_sym(jnp.asarray(packed.numpy()), k, iu)))
    at = tlinalg.unpack_sym_from_t(pt, k, iu, a)
    np.testing.assert_array_equal(at.numpy(), np.asarray(
        jlinalg.unpack_sym_from_t(jpt, k, iu, jnp.asarray(a_full))))
    np.testing.assert_array_equal(
        tlinalg.unpack_sym_t(packed, k, iu, a).numpy(), at.numpy())
    # the per-column Gram of column c is a_full minus its masked rows' Gram
    c = 5
    Xm = X[m[c]]
    np.testing.assert_array_equal(at[:, :, c].numpy(), a_full - Xm.T @ Xm)


# ------------------------------------------------------------ masked ALS step

def test_masked_step_matches_jax_and_oracle(rng):
    """tests/test_als.py::test_masked_step_matches_oracle's geometry: two
    masked iterations and the test MSE."""
    A = _synthetic(rng, genes=24, cells=18)
    k, seed, inv_density = 3, 909, 5
    w_init = rng.random((A.shape[0], k)).astype(np.float32)

    Ap, Atp = tals.make_dense_providers(A, device="cpu")
    genes_pad, cells_pad = Ap.data.shape
    W = torch.zeros((genes_pad, k))
    W[: A.shape[0]] = torch.as_tensor(w_init)
    H = torch.zeros((cells_pad, k))
    jAp, jAtp = jals.make_dense_providers(A)
    jW = jnp.zeros((genes_pad, k), jnp.float32).at[: A.shape[0]].set(w_init)
    jH = jnp.zeros((cells_pad, k), jnp.float32)
    sp, jsp = seed_pair(seed), jax_seed_pair(seed)
    for _ in range(2):
        W, H, d, tol = tals.als_step_masked(Ap, Atp, W, H, sp, 0.01, 0.0,
                                            inv_density, cells_pad, genes_pad)
        jW, jH, jd, jtol = jals.als_step_masked(
            jAp, jAtp, jW, jH, jsp, 0.01, 0.0, inv_density, cells_pad,
            genes_pad)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), **FIT)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), **FIT)
    np.testing.assert_allclose(float(tol), float(jtol), rtol=5e-3, atol=1e-5)

    w = w_init.T.astype(np.float64).copy()
    h = np.zeros((k, A.shape[1]))
    for _ in range(2):
        w_it = w.copy()
        h = ref.predict_mask(A.astype(np.float64), seed, inv_density, w, h,
                             0.01, 0.0, mask_t=False)
        h, dd = ref.scale(h)
        w = ref.predict_mask(A.T.astype(np.float64), seed, inv_density, h, w,
                             0.01, 0.0, mask_t=True)
        w, dd = ref.scale(w)
        tol_ref = ref.cor_distance(w, w_it)
    np.testing.assert_allclose(W[: A.shape[0]].numpy(), w.T, **FIT)
    np.testing.assert_allclose(H[: A.shape[1]].numpy().T, h, **FIT)
    np.testing.assert_allclose(float(tol), tol_ref, rtol=5e-3, atol=1e-5)

    got = float(tals.mse_test(Ap, W, torch.as_tensor(dd, dtype=torch.float32),
                              H, sp, inv_density, cells_pad))
    want_jax = float(jals.mse_test(jAp, jW, jnp.asarray(dd, jnp.float32), jH,
                                   jsp, inv_density, cells_pad))
    want = ref.mse_test(A.astype(np.float64), w, dd, h, seed, inv_density)
    np.testing.assert_allclose(got, want_jax, rtol=5e-3)
    np.testing.assert_allclose(got, want, rtol=5e-3)


# ---------------------------------------------------------------- ARD fit

# (maxit, trace_test_mse, tol, overfit_threshold): the oracle test's
# schedule; an early stop; a tail trace after the last traced iteration
ARD_CASES = {
    "oracle": (6, 2, 1e-3, 1e-3),
    "early_stop": (30, 1, 1e-6, 1e-6),
    "tail_trace": (5, 3, 1e-6, 1.0),
}


@pytest.mark.parametrize("case", sorted(ARD_CASES))
def test_ard_fit_matches_jax(rng, case):
    maxit, trace, tol, threshold = ARD_CASES[case]
    A = _lowrank(rng, genes=24, cells=18)
    k, seed, inv_density = 3, 55, 5
    w0 = rng.random((24, k)).astype(np.float32)
    kw = dict(w_init=w0, mask_seed=seed, inv_density=inv_density, tol=tol,
              maxit=maxit, L1=0.01, overfit_threshold=threshold,
              trace_test_mse=trace)
    got = tard.ard_nmf_fit(A, k, device="cpu", **kw)
    want = jard.ard_nmf_fit(A, k, k_bucket=1, **kw)
    assert got.iter == want.iter
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=5e-3)
    np.testing.assert_allclose(got.tol, want.tol, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(got.score_overfit, want.score_overfit,
                               rtol=5e-2, atol=1e-4)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)
    if case == "early_stop":
        assert got.score_overfit[-1] > threshold and got.iter[-1] < maxit - 1
    if case == "tail_trace":
        assert got.iter == [0, 3, 5]
    if case == "oracle":
        out = ref.ard_nmf(A.astype(np.float64), w0.T.copy(), seed,
                          inv_density, tol=tol, maxit=maxit, L1=0.01,
                          overfit_threshold=threshold, trace_test_mse=trace)
        assert got.iter == out["iter"]
        np.testing.assert_allclose(got.test_mse, out["test_mse"], rtol=5e-3)


def test_ard_fit_k_bucket_is_accepted_and_inert(rng):
    A = _lowrank(rng, genes=24, cells=18)
    w0 = rng.random((24, 3)).astype(np.float32)
    kw = dict(w_init=w0, maxit=4, device="cpu")
    a = tard.ard_nmf_fit(A, 3, k_bucket=8, **kw)
    b = tard.ard_nmf_fit(A, 3, k_bucket=1, **kw)
    assert a.w.shape == (24, 3) and a.test_mse == b.test_mse
    np.testing.assert_array_equal(a.w, b.w)


# ---------------------------------------------------------------- drivers

def _shared_init_w(monkeypatch):
    """Give both packages' drivers one numpy init: W (genes_pad, k) from
    the seed, zero on padded rows."""
    def draw(k, genes_pad, genes_true, seed):
        w = np.random.default_rng(seed).random((genes_pad, k))
        w[genes_true:] = 0.0
        return w.astype(np.float32)

    monkeypatch.setattr(jdrivers, "init_w",
                        lambda k, gp, gt, seed: jnp.asarray(draw(k, gp, gt,
                                                                 seed)))
    monkeypatch.setattr(tdrivers, "init_w",
                        lambda k, gp, gt, seed, device=None:
                        torch.as_tensor(draw(k, gp, gt, seed), device=device))


def _assert_frames_close(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert got.attrs["class"] == "cross_validate_nmf_data"
    for col in ("k", "rep", "iter"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      want[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(got["test_error"], want["test_error"],
                               rtol=5e-3)
    np.testing.assert_allclose(got["tol"], want["tol"], rtol=5e-3, atol=1e-5)


def test_cross_validate_and_best_rank_match_jax(rng, monkeypatch):
    _shared_init_w(monkeypatch)
    A = _lowrank(rng, genes=50, cells=40, k=3, noise=0.05)
    kw = dict(ranks=[2, 3, 4, 6], n_replicates=2, tol=1e-3, maxit=20,
              verbose=0, seed=11)
    got = stt.cross_validate_nmf(A, device="cpu", **kw)
    want = jax_cross_validate_nmf(A, **kw)
    assert set(got.columns) == {"k", "rep", "test_error", "iter", "tol"}
    _assert_frames_close(got, want)
    assert stt.GetBestRank(got) == jdrivers.GetBestRank(want)
    assert stt.get_best_rank is stt.GetBestRank


def test_get_best_rank_rule_matches_jax():
    """tests/test_drivers.py's two hand-made frames, and an empty one."""
    rows = [dict(k=k, rep=1, test_error=e, iter=10, tol=1e-4)
            for k, e in [(2, 1.0), (3, 0.5), (4, 0.8), (5, 0.9)]]
    capped = [
        dict(k=2, rep=1, test_error=1.0, iter=5, tol=1e-3),
        dict(k=2, rep=1, test_error=0.9, iter=10, tol=1e-4),
        dict(k=3, rep=1, test_error=0.6, iter=5, tol=1e-3),
        dict(k=3, rep=1, test_error=0.55, iter=10, tol=1e-4),
        dict(k=4, rep=1, test_error=0.50, iter=5, tol=1e-3),
        dict(k=4, rep=1, test_error=0.40, iter=10, tol=1e-3),
        dict(k=4, rep=1, test_error=0.53, iter=15, tol=1e-4),
    ]
    assert stt.GetBestRank(pd.DataFrame(rows)) == 3
    assert stt.GetBestRank(pd.DataFrame(capped), tol_overfit=1e-4) == 3
    assert stt.GetBestRank(pd.DataFrame()) == 2
    for frame in (rows, capped):
        df = pd.DataFrame(frame)
        assert stt.GetBestRank(df) == jdrivers.GetBestRank(df)


def test_ard_nmf_matches_jax(rng, monkeypatch):
    """A search that grows the rank (2, 3, 5) and then bisects (4)."""
    _shared_init_w(monkeypatch)
    A = _lowrank(rng, genes=60, cells=60, k=2, noise=0.01, sparsity=0.0)
    kw = dict(k_max=6, maxit=20, cv_tol=1e-3, tol=1e-4, learning_rate=0.5,
              verbose=0, seed=3)
    got = stt.ard_nmf(A, device="cpu", **kw)
    want = jax_ard_nmf(A, **kw)
    assert sorted(got.cv_data["k"].unique()) == [2, 3, 4, 5]
    _assert_frames_close(got.cv_data, want.cv_data)
    np.testing.assert_allclose(got.cv_data["overfit_score"],
                               want.cv_data["overfit_score"], rtol=5e-2,
                               atol=1e-4)
    assert got.k == want.k
    assert got.factor_names == [f"NMF_{i + 1}" for i in range(got.k)]
    assert (np.diff(got.d) <= 0).all()
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **FIT,
                                   err_msg=f)


def test_drivers_take_config(rng, monkeypatch):
    _shared_init_w(monkeypatch)
    A = _lowrank(rng, genes=30, cells=24, k=2)
    cfg = stt.NMFConfig(reps=1, maxit=6, tol=1e-3, verbose=0, seed=2,
                        trace_test_mse=2)
    by_cfg = stt.cross_validate_nmf(A, ranks=[2, 3], device="cpu",
                                    config=cfg)
    by_args = stt.cross_validate_nmf(A, ranks=[2, 3], n_replicates=1,
                                     maxit=6, tol=1e-2, verbose=0, seed=2,
                                     trace_test_mse=2, device="cpu")
    pd.testing.assert_frame_equal(by_cfg, by_args)
    with pytest.raises(ValueError, match="L1"):
        stt.cross_validate_nmf(A, ranks=[2], L1=1.0, device="cpu")
    with pytest.raises(ValueError, match="k_min"):
        stt.ard_nmf(A, k_min=1, device="cpu")
