"""CD-NNLS problems the kernels used to answer differently from the
reference, on the CPU: the port's plain versions against the JAX package's
on the same numpy inputs.

- A zero Gram diagonal: a factor that is zero on every kept row gives a
  Gram whose row, column and diagonal entry are exactly 0 and a right-hand
  side whose entry is exactly 0, so 1/diag is inf, the step's diff
  0 * inf = NaN and ``max(diff, -x_i)`` keeps it; the column turns NaN. A
  negative right-hand side there clamps the coordinate to 0 instead. The
  port's ``nnls_batch``, ``solve_nnls``, ``solve_nnls_packed`` and
  ``solve_nnls_packed_t`` give JAX's NaN positions and, elsewhere, its
  values within the NNLS tolerance (rtol 5e-3, atol 1e-6, that of
  tests/test_pallas_nnls.py), with a shared Gram and with per-column
  Grams (the masked fit's), held columns (``update_mask``) included.
- Per-column Grams with a per-coordinate (n, k) L1 (batch mode), which
  the card's kernel B2 now takes: ``solve_nnls`` and ``solve_nnls_packed``
  against JAX's.

The card's kernels are held to these plain versions in
tests/test_torch_nnls_cuda.py and tests/test_torch_wide_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import linalg as jlinalg
from singlet_tpu.ops import nnls as jnnls
from singlet_tpu_torch.ops import linalg, nnls

RTOL, ATOL = 5e-3, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shared_problem(n, k, z, seed, mixed):
    """A shared Gram F^T F whose factor z is zero on every row (its row,
    column and diagonal exactly 0), B = G F (column z exactly 0); with
    ``mixed`` a third of the columns get b_z < 0 (clamped to 0, finite)."""
    rng = np.random.default_rng(seed)
    m = 2 * k + 8
    F = rng.random((m, k)).astype(np.float32)
    F[:, z] = 0.0
    eye = np.eye(k, dtype=np.float32)
    eye[z, z] = 0.0
    a = (F.T @ F + 1e-15 * eye).astype(np.float32)
    B = (rng.random((n, m)).astype(np.float32) @ F).astype(np.float32)
    if mixed:
        B[::3, z] = -0.5
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.8
    return a, B, X0, mask


def _masked_problem(n, k, z, seed):
    """A masked half-update's per-column Grams: factor z nonzero on one
    row r0 alone, held out (masked) for every other column, so those
    columns' Grams a_full - corr_c have row, column and diagonal z exactly
    0 and their B (from the kept rows) column z exactly 0; the rest keep
    r0 and stay finite. Returns a_full, packed (n, npairs), iu, the (n, k,
    k) Grams, B, X0, update_mask."""
    rng = np.random.default_rng(seed)
    m = 2 * k + 8
    F = rng.random((m, k)).astype(np.float32)
    F[:, z] = 0.0
    F[3, z] = 0.75
    held = rng.random((n, m)) < 0.05
    held[:, 3] = np.arange(n) % 2 == 0
    iu = linalg.triu_pairs(k)
    a_full = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    a_full[z, z] = np.float32(0.75) * np.float32(0.75)
    # the held rows' outer products, each column's sum of them in row order
    outer = (F[:, iu[0]] * F[:, iu[1]]).astype(np.float32)     # (m, npairs)
    packed = (held.astype(np.float32) @ outer).astype(np.float32)
    grams = (a_full[None] - _unpack(packed, k, iu)).astype(np.float32)
    kept = np.where(held, 0.0, rng.random((n, m))).astype(np.float32)
    B = (kept @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.85
    return a_full, packed, iu, grams, B, X0, mask


def _unpack(packed, k, iu):
    out = np.zeros((packed.shape[0], k, k), np.float32)
    out[:, iu[0], iu[1]] = packed
    out[:, iu[1], iu[0]] = packed
    return out


def _close(got, want, label):
    """The same NaN positions (assert_allclose's equal_nan) and values
    within the NNLS tolerance elsewhere."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=label)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("k,z", [(8, 3), (24, 0), (24, 23)])
@pytest.mark.parametrize("mixed", [False, True])
def test_shared_gram_zero_diagonal_matches_jax(k, z, mixed):
    """B1's problem: every column's coordinate z has a zero diagonal. With
    b_z = 0 the columns turn NaN (from coordinate z on in the sweep that
    meets it); with b_z < 0 (``mixed``) those columns clamp x_z to 0 and
    stay finite."""
    a, B, X0, mask = _shared_problem(40, k, z, k + z, mixed)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=16.0)
    want = jnnls.solve_nnls(*_j(a, B, X0), update_mask=jnp.asarray(mask),
                            **kw)
    assert np.isnan(np.asarray(want)).any()
    if mixed:
        assert np.isfinite(np.asarray(want)[::3][mask[::3]]).all()
    ta, tB, tX0, tm = _t(a, B, X0, mask)
    _close(nnls.nnls_batch(ta, tB, tX0, update_mask=tm, **kw), want,
           "nnls_batch")
    _close(nnls.solve_nnls(ta, tB, tX0, update_mask=tm, **kw), want,
           "solve_nnls")


@pytest.mark.parametrize("k,z", [(8, 5), (24, 11)])
def test_per_column_grams_zero_diagonal_matches_jax(k, z):
    """B2's problem: the columns that hold factor z's one nonzero row out
    have a zero diagonal there and turn NaN, the others stay finite; the
    dense (n, k, k) Grams, the packed corrections and their transpose all
    give JAX's result."""
    a_full, packed, iu, grams, B, X0, mask = _masked_problem(36, k, z, k)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=32.0)
    want = jnnls.solve_nnls(*_j(grams, B, X0),
                            update_mask=jnp.asarray(mask), **kw)
    w = np.asarray(want)
    assert np.isnan(w[0::2][mask[0::2]]).any(axis=1).all()
    assert np.isfinite(w[1::2]).all()
    want_p = jnnls.solve_nnls_packed(*_j(a_full, packed), iu,
                                     *_j(B, X0),
                                     update_mask=jnp.asarray(mask), **kw)
    _close(want_p, want, "JAX solve_nnls_packed")
    tg, ta, tp, tB, tX0, tm = _t(grams, a_full, packed, B, X0, mask)
    _close(nnls.nnls_batch(tg, tB, tX0, update_mask=tm, **kw), want,
           "nnls_batch")
    _close(nnls.solve_nnls(tg, tB, tX0, update_mask=tm, **kw), want,
           "solve_nnls")
    _close(nnls.solve_nnls_packed(ta, tp, iu, tB, tX0, update_mask=tm,
                                  **kw), want, "solve_nnls_packed")
    _close(nnls.solve_nnls_packed_t(ta, tp.T.contiguous(), iu, tB, tX0,
                                    update_mask=tm, **kw), want,
           "solve_nnls_packed_t")


@pytest.mark.parametrize("k", [6, 24])
@pytest.mark.parametrize("sweep_cap", [None, 8.0])
def test_per_column_grams_l1_array_matches_jax(k, sweep_cap):
    """Per-column Grams with an (n, k) L1: the JAX dispatchers run it on
    their XLA path, and the port's solve_nnls and solve_nnls_packed give
    its result."""
    a_full, packed, iu, grams, B, X0, mask = _masked_problem(30, k, 1, 7 + k)
    # a problem without the zero diagonal: factor 1's row 3 kept for all
    grams = grams[1::2]
    packed, B, X0, mask = packed[1::2], B[1::2], X0[1::2], mask[1::2]
    L1 = (np.random.default_rng(k).random(B.shape) * 0.05).astype(
        np.float32)
    kw = dict(L2=0.001, sweep_cap=sweep_cap)
    want = jnnls.solve_nnls(*_j(grams, B, X0), L1=jnp.asarray(L1),
                            update_mask=jnp.asarray(mask), **kw)
    assert np.isfinite(np.asarray(want)).all()
    tg, ta, tp, tB, tX0, tm, tL1 = _t(grams, a_full, packed, B, X0, mask, L1)
    _close(nnls.solve_nnls(tg, tB, tX0, L1=tL1, update_mask=tm, **kw), want,
           "solve_nnls")
    _close(nnls.solve_nnls_packed(ta, tp, iu, tB, tX0, L1=tL1,
                                  update_mask=tm, **kw), want,
           "solve_nnls_packed")
    want_p = jnnls.solve_nnls_packed(*_j(a_full, packed), iu, *_j(B, X0),
                                     L1=jnp.asarray(L1),
                                     update_mask=jnp.asarray(mask), **kw)
    _close(want_p, want, "JAX solve_nnls_packed")


def test_unpack_matches_both_packages():
    """The test's own unpack of the corrections is linalg.unpack_sym of
    both packages."""
    _, packed, iu, _, _, _, _ = _masked_problem(5, 7, 2, 1)
    want = _unpack(packed, 7, iu)
    np.testing.assert_array_equal(
        linalg.unpack_sym(torch.as_tensor(packed), 7, iu).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jlinalg.unpack_sym(jnp.asarray(packed), 7, iu)), want)
