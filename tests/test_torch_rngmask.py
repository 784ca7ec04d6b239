"""Bit-exactness of the port's counter-RNG test mask
(``singlet_tpu_torch/ops/rngmask.py``) against the JAX package's
``mask_block`` and the Python-integer oracle ``reference_impl.hash_ij``, and
of the port's cached ``DenseMatrix.mask_tile`` against the JAX one, on the
CPU. No tolerance: the mask must agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as ref
from singlet_tpu.ops import rngmask as jmask
from singlet_tpu.solvers.als import make_dense_providers as jax_providers
from singlet_tpu_torch.ops import rngmask as tmask
from singlet_tpu_torch.solvers.als import make_dense_providers
from test_als import _synthetic

# tests/test_rngmask.py's seeds
SEEDS = [0, 1, 999, 123456789, 2**31 - 1, 2**63 + 12345]
M64 = (1 << 64) - 1


def _ids(rng, size):
    """Random ids below 2**31 plus the ids just below 2**31 - 1."""
    return np.concatenate([rng.integers(0, 1 << 31, size=size),
                           np.arange(2**31 - 4, 2**31)]).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_mask_block_matches_jax_and_oracle(rng, seed):
    cells, genes = _ids(rng, 13), _ids(rng, 17)
    for inv_density in (20, 3):
        got = tmask.mask_block(tmask.seed_pair(seed), torch.as_tensor(cells),
                               torch.as_tensor(genes), inv_density).numpy()
        want = np.asarray(jmask.mask_block(
            jmask.seed_pair(seed), jnp.asarray(cells), jnp.asarray(genes),
            inv_density))
        np.testing.assert_array_equal(got, want)
        oracle = np.array([[ref.hash_ij(seed & M64, int(c), int(g))
                            % inv_density == 0 for g in genes]
                           for c in cells])
        np.testing.assert_array_equal(got, oracle)


def test_hash_halves_match_python_integers(rng):
    """The (hi, lo) int64 emulation of hash_ij against Python's unbounded
    integers, half by half."""
    seed = 2**63 + 12345
    i, j = _ids(rng, 20), _ids(rng, 20)
    i_t, j_t = torch.as_tensor(i), torch.as_tensor(j)
    hi, lo = tmask.hash_ij(seed >> 32, seed & 0xFFFFFFFF,
                           (torch.zeros_like(i_t), i_t),
                           (torch.zeros_like(j_t), j_t))
    got = [(int(h) << 32) | int(l) for h, l in zip(hi, lo)]
    assert got == [ref.hash_ij(seed, int(a), int(b)) for a, b in zip(i, j)]


def test_u64_mod_small_exact(rng):
    for d in (2, 3, 17, 20, 33, 100, 1000):
        vals = rng.integers(0, M64, size=64, dtype=np.uint64)
        hi = torch.as_tensor((vals >> np.uint64(32)).astype(np.int64))
        lo = torch.as_tensor((vals & np.uint64(0xFFFFFFFF)).astype(np.int64))
        got = tmask.u64_mod_small((hi, lo), d).numpy()
        np.testing.assert_array_equal(got, (vals % np.uint64(d)).astype(
            np.int64))


def test_mask_fraction_matches_jax():
    got = tmask.mask_fraction(seed=42, n_cells=500, n_genes=400,
                              inv_density=20)
    want = jmask.mask_fraction(seed=42, n_cells=500, n_genes=400,
                               inv_density=20)
    assert abs(got - 0.05) < 0.005
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mask_tile_matches_jax_and_excludes_padding(rng):
    """tests/test_als.py::test_mask_excludes_padding's geometry; every
    tile of both orientations equals the JAX tile, and padding is never
    masked."""
    A = _synthetic(rng, genes=24, cells=18)
    Ap, Atp = make_dense_providers(A, device="cpu")
    jAp, jAtp = jax_providers(A)
    for seed, inv in ((3, 4), (909, 5)):
        sp, jsp = tmask.seed_pair(seed), jmask.seed_pair(seed)
        for P, jP in ((Ap, jAp), (Atp, jAtp)):
            m = P.mask_tile(sp, 0, P.cols_pad, inv).numpy()
            np.testing.assert_array_equal(
                m, np.asarray(jP.mask_tile(jsp, 0, P.cols_pad, inv)))
            assert not m[P.cols_true:, :].any()
            assert not m[:, P.rows_true:].any()
            assert m[: P.cols_true, : P.rows_true].any()
    # A and At share one cached mask
    assert len(Ap.mask_cache) == 1 and Ap.mask_cache is Atp.mask_cache


def test_mask_tiles_are_views_of_one_grid(rng):
    """Blocked tiles of a multi-block provider equal the full grid's
    (the shard-invariance property of tests/test_rngmask.py)."""
    A = rng.random((40, 600)).astype(np.float32)
    Ap, Atp = make_dense_providers(A, cell_block=256, gene_block=256,
                                   device="cpu")
    sp = tmask.seed_pair(999)
    full = tmask.mask_block(sp, torch.arange(600), torch.arange(40), 20)
    for c0 in range(0, Ap.cols_pad, Ap.block):
        tile = Ap.mask_tile(sp, c0, Ap.block, 20)
        n = min(600 - c0, Ap.block)
        assert torch.equal(tile[:n, :40], full[c0:c0 + n])
    tile_t = Atp.mask_tile(sp, 0, Atp.block, 20)
    assert torch.equal(tile_t[:40, :600], full.T)
