"""Parity of the port's CD-NNLS (``singlet_tpu_torch/ops/nnls.py``) with the
JAX package's on the same numpy inputs, on the CPU.

The port's ``nnls_batch`` is the plain version of kernel B1; the JAX side is
its XLA ``nnls_batch`` and the Pallas kernel ``nnls_batch_pallas`` in
interpret mode, as tests/test_pallas_nnls.py runs it. Tolerance rtol=5e-3,
atol=1e-6 (that file's): the sweep-end tol is a reduction summed in another
order, so a borderline column may run one sweep more or fewer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import nnls as jnnls
from singlet_tpu.ops.pallas_nnls import nnls_batch_pallas
from singlet_tpu_torch.ops import nnls as tnnls
from test_nnls import _random_problem, nnls_cd_numpy


def _problem(rng, n, k):
    """tests/test_pallas_nnls.py's geometry: warm X0 with zeros, 10% of
    the columns masked out."""
    F = rng.random((64, k)).astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (rng.random((n, 64)) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return a, B, X0, mask


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_shared_gram_matches_jax_and_pallas(rng):
    a, B, X0, mask = _problem(rng, 256, 9)
    kw = dict(L1=0.01, L2=0.001)
    got = tnnls.nnls_batch(*_t(a, B, X0), update_mask=torch.as_tensor(mask),
                           **kw).numpy()
    xla = np.asarray(jnnls.nnls_batch(*_j(a, B, X0),
                                      update_mask=jnp.asarray(mask), **kw))
    pallas = np.asarray(nnls_batch_pallas(*_j(a, B, X0),
                                          update_mask=jnp.asarray(mask),
                                          block=128, interpret=True, **kw))
    np.testing.assert_allclose(got, xla, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=5e-3, atol=1e-6)
    np.testing.assert_array_equal(got[~mask], X0[~mask])


def test_traced_cap_n_coord_and_sweep_counts(rng):
    a, B, X0, mask = _problem(rng, 128, 7)
    X, sweeps = tnnls.nnls_batch(*_t(a, B, X0),
                                 update_mask=torch.as_tensor(mask), L1=0.01,
                                 n_coord=5.0, sweep_cap=8.0,
                                 return_sweeps=True)
    Xj, sweeps_j = jnnls.nnls_batch(*_j(a, B, X0),
                                    update_mask=jnp.asarray(mask), L1=0.01,
                                    n_coord=jnp.float32(5.0),
                                    sweep_cap=jnp.float32(8.0),
                                    return_sweeps=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=5e-3,
                               atol=1e-6)
    sweeps, sweeps_j = sweeps.numpy(), np.asarray(sweeps_j)
    assert sweeps.dtype == np.int32 and sweeps.shape == (128,)
    assert np.abs(sweeps - sweeps_j).max() <= 1
    assert (sweeps[~mask] == 0).all() and sweeps.max() <= 8


@pytest.mark.parametrize("l1_matrix", [False, True])
def test_batched_gram_matches_jax(rng, l1_matrix):
    n, k = 24, 7
    a = np.zeros((n, k, k), np.float32)
    B = np.zeros((n, k), np.float32)
    for c in range(n):
        F = rng.random((32, k)).astype(np.float32)
        a[c] = F.T @ F + 1e-15 * np.eye(k)
        B[c] = F.T @ rng.random(32).astype(np.float32)
    X0 = rng.random((n, k)).astype(np.float32)
    L1 = (rng.random((n, k)) * 0.1).astype(np.float32) if l1_matrix else 0.01
    got = tnnls.nnls_batch(*_t(a, B, X0), L1=_t(L1)[0] if l1_matrix else L1,
                           L2=0.001)
    want = jnnls.nnls_batch(*_j(a, B, X0), L1=_j(L1)[0] if l1_matrix else L1,
                            L2=0.001)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)


@pytest.mark.parametrize("warm", [False, True])
def test_matches_float64_cd_oracle(rng, warm):
    _, a, _, B = _random_problem(rng, n=16, k=10)
    X0 = (rng.random((16, 10)) if warm else np.zeros((16, 10))
          ).astype(np.float32)
    X = tnnls.nnls_batch(*_t(a, B, X0)).numpy()
    for c in range(16):
        np.testing.assert_allclose(X[c], nnls_cd_numpy(a, B[c], X0[c]),
                                   rtol=2e-4, atol=2e-5)


def test_sweep_cap_update_matches_jax():
    tols = [1.0, 0.3, 2e-3, 5e-4, 1.5e-4, 9e-5, 2e-4, 3e-5, 1e-6]
    for target, masked in ((0.0, False), (1e-5, False), (1e-4, True)):
        exact, exact_j = False, jnp.bool_(False)
        for t in tols:
            cap, exact = tnnls.sweep_cap_update(exact, t, target,
                                                masked=masked)
            cap_j, exact_j = jnnls.sweep_cap_update(
                exact_j, jnp.float32(t), jnp.float32(target), masked=masked)
            assert cap == float(cap_j)
            assert exact == bool(exact_j)
        assert exact    # the sequence crosses the latch


def test_sweep_settings_read_when_asked(monkeypatch):
    monkeypatch.setenv("SINGLET_TPU_SWEEPS", "reference")
    assert tnnls.sweep_cap_update(False, 1.0, 0.0) == (None, False)
    monkeypatch.setenv("SINGLET_TPU_SWEEPS", "12")
    assert tnnls.sweep_cap_update(False, 1.0, 0.0) == (12.0, False)
    monkeypatch.setenv("SINGLET_TPU_SWEEPS", "adaptive")
    monkeypatch.setenv("SINGLET_TPU_FAST_SWEEPS", "4")
    monkeypatch.setenv("SINGLET_TPU_MAX_SWEEPS", "60")
    assert tnnls.sweep_cap_update(False, 1.0, 0.0) == (4.0, False)
    assert tnnls.sweep_cap_update(False, 1e-5, 0.0) == (60.0, True)


def _masked_problem(rng, n, k, rows=48):
    """Per-column Grams as a masked half-update makes them: a_full minus
    the packed Gram of each column's masked rows; B from the kept rows."""
    from singlet_tpu_torch.ops import linalg as tlinalg

    X = rng.random((rows, k)).astype(np.float32)
    m = rng.random((n, rows)) < 0.2
    iu = tlinalg.triu_pairs(k)
    P = tlinalg.packed_outer_products(torch.as_tensor(X), iu)
    packed_t = tlinalg.mask_dot_t(P, torch.as_tensor(m), 1).numpy()
    a_full = (X.T @ X + 1e-15 * np.eye(k)).astype(np.float32)
    G = rng.random((n, rows)).astype(np.float32)
    B = (np.where(m, 0.0, G) @ X).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return a_full, packed_t, iu, B, X0, mask


@pytest.mark.parametrize("transposed", [False, True])
def test_masked_solve_matches_jax(rng, transposed):
    """solve_nnls_packed(_t) against the JAX package's XLA path, with the
    adaptive cap and update mask of a masked half-update."""
    a_full, packed_t, iu, B, X0, mask = _masked_problem(rng, 96, 6)
    packed = packed_t if transposed else np.ascontiguousarray(packed_t.T)
    t_fn = tnnls.solve_nnls_packed_t if transposed else tnnls.solve_nnls_packed
    j_fn = jnnls.solve_nnls_packed_t if transposed else jnnls.solve_nnls_packed
    for cap in (32.0, 100.0):
        kw = dict(L1=0.01, L2=0.001, sweep_cap=cap)
        got = t_fn(*_t(a_full, packed), iu, *_t(B, X0),
                   update_mask=torch.as_tensor(mask), **kw).numpy()
        want = np.asarray(j_fn(*_j(a_full, packed), iu, *_j(B, X0),
                               update_mask=jnp.asarray(mask),
                               sweep_cap=jnp.float32(cap), L1=0.01,
                               L2=0.001))
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)
        np.testing.assert_array_equal(got[~mask], X0[~mask])
