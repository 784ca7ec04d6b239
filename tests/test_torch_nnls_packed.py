"""Kernel B2's packed entry (``singlet_tpu_torch/ops/nnls_cuda.py``
``nnls_batch_cuda_batched_packed_t``) and the masked solve that reaches it,
``ops.nnls.solve_nnls_packed_t``, on the CPU.

On the card B2 reads ``a_full`` (k, k) and the packed corrections
``packed_t`` (npairs, n) in place of the (k, k, n) tile that
``linalg.unpack_sym_from_t`` writes, through a table of row starts that the
wrapper hands over, and gets 1/diag from the wrapper. Here: that table
entry for entry against ``linalg._sym_pos``, that 1/diag bit for bit
against the unpacked tile's, and the CPU route of ``solve_nnls_packed_t``
against the JAX package's ``unpack_sym_from_t`` + ``nnls_batch_pallas_
batched_at`` in interpret mode and its XLA twin ``solve_nnls_packed_t``,
with tests/test_pallas_nnls.py's tolerance (rtol=5e-3, atol=1e-6: the
sweep-end tol is summed in another order, so a borderline column may run
one sweep more or fewer). The kernel itself needs a card
(tests/test_torch_nnls_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import linalg as jlinalg
from singlet_tpu.ops import nnls as jnnls
from singlet_tpu.ops.pallas_nnls import nnls_batch_pallas_batched_at
from singlet_tpu_torch.ops import linalg as tlinalg
from singlet_tpu_torch.ops import nnls as tnnls
from singlet_tpu_torch.ops import nnls_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them
    (the plain version is many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masked_problem(seed, n, k):
    """A masked half-update's solve: a_full = X^T X + 1e-15 I, the packed
    Gram corrections of each column's 5% masked rows (npairs, n), B from
    the kept rows, a warm X0 with zeros and 10% of the columns masked
    out: tests/test_pallas_nnls.py's geometry with per-column Grams."""
    rng = np.random.default_rng(seed)
    rows = max(64, 2 * k)
    X = rng.random((rows, k)).astype(np.float32)
    iu = tlinalg.triu_pairs(k)
    m = rng.random((n, rows)) < 0.05
    P = tlinalg.packed_outer_products(torch.as_tensor(X), iu)
    packed_t = tlinalg.mask_dot_t(P, torch.as_tensor(m), 1).numpy()
    a_full = (X.T @ X + 1e-15 * np.eye(k)).astype(np.float32)
    B = (np.where(m, 0.0, rng.random((n, rows))) @ X).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return a_full, packed_t, iu, B, X0, mask


@pytest.mark.parametrize("k", [1, 9, 50, 100, 300])
def test_row_starts_give_sym_pos(k):
    """The table the wrapper hands to the kernel: pos(i, j) =
    starts[min(i, j)] + |i - j| equals linalg._sym_pos entry for entry."""
    iu = tlinalg.triu_pairs(k)
    starts = nnls_cuda.packed_row_starts(k, iu)
    assert starts.dtype == np.int32 and starts.shape == (k,)
    i, j = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    pos = starts[np.minimum(i, j)] + np.abs(i - j)
    np.testing.assert_array_equal(pos, tlinalg._sym_pos(k, iu))
    np.testing.assert_array_equal(pos, jlinalg._sym_pos(k, iu))


def test_row_starts_refuse_another_pair_order():
    k = 6
    iu = tlinalg.triu_pairs(k)
    order = np.lexsort((iu[0], iu[1]))     # column-major triangle
    with pytest.raises(ValueError, match="triu_pairs"):
        nnls_cuda.packed_row_starts(k, (iu[0][order], iu[1][order]))


@pytest.mark.parametrize("n,k", [(40, 9), (40, 50), (24, 100), (8, 300)])
def test_packed_inv_diag_is_the_tiles(n, k):
    """1/diag built from a_full and packed_t equals, bit for bit,
    1 / unpack_sym_from_t(...)[i, i, :], what the tile entry computes."""
    a_full, packed_t, iu, *_ = _masked_problem(n + k, n, k)
    a_full, packed_t = torch.as_tensor(a_full), torch.as_tensor(packed_t)
    got = nnls_cuda.packed_inv_diag(
        a_full, packed_t, nnls_cuda.packed_row_starts(k, iu))
    at = tlinalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    want = 1.0 / at.reshape(k * k, n)[:: k + 1]
    assert got.dtype == torch.float32 and got.shape == (k, n)
    assert torch.equal(got, want)
    assert torch.equal(got, 1 / torch.diagonal(at, dim1=0, dim2=1).T)


@pytest.mark.parametrize("n,k", [(40, 50), (40, 100), (20, 300)])
def test_solve_packed_t_matches_jax(n, k):
    """solve_nnls_packed_t on the CPU (and the packed entry's CPU route)
    against JAX's unpack_sym_from_t + nnls_batch_pallas_batched_at in
    interpret mode and its XLA solve_nnls_packed_t, at the masked fast
    cap; widths that are no multiple of 32."""
    a_full, packed_t, iu, B, X0, mask = _masked_problem(n * k, n, k)
    kw = dict(L1=0.01, L2=0.001)
    tt = [torch.as_tensor(x) for x in (a_full, packed_t)]
    tb = [torch.as_tensor(x) for x in (B, X0)]
    plain = tnnls.PLAIN_CALLS
    got = tnnls.solve_nnls_packed_t(*tt, iu, *tb, sweep_cap=32.0,
                                    update_mask=torch.as_tensor(mask),
                                    **kw).numpy()
    entry = nnls_cuda.nnls_batch_cuda_batched_packed_t(
        *tt, iu, *tb, sweep_cap=32.0, update_mask=torch.as_tensor(mask),
        **kw).numpy()
    assert tnnls.PLAIN_CALLS == plain + 2
    np.testing.assert_array_equal(entry, got)

    ja, jp, jB, jX0 = (jnp.asarray(x) for x in (a_full, packed_t, B, X0))
    at = jlinalg.unpack_sym_from_t(jp, k, iu, ja)
    pallas = np.asarray(nnls_batch_pallas_batched_at(
        at, jB, jX0, update_mask=jnp.asarray(mask), block=n,
        interpret=True, sweep_cap=jnp.float32(32.0), **kw))
    xla = np.asarray(jnnls.solve_nnls_packed_t(
        ja, jp, iu, jB, jX0, update_mask=jnp.asarray(mask),
        sweep_cap=jnp.float32(32.0), **kw))
    np.testing.assert_allclose(got, pallas, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=5e-3, atol=1e-6)
    np.testing.assert_array_equal(got[~mask], X0[~mask])
