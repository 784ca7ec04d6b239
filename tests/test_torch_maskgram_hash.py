"""Kernels B10 and B11 of the hash route (``singlet_tpu_torch/ops/maskgram.py``
``mask_packed_w_t`` / ``mask_packed_h_t``): their plain PyTorch versions,
which the CPU runs, against the JAX package's Pallas kernels in interpret
mode on the same numpy inputs; and against the bits route's B8/B9 (bf16)
fed the packed words of the same seed.

The geometries are those of tests/test_pallas_maskgram.py (96 genes in
gene blocks of 32, 48 cells, k = 5, inv_density 5, with and without the
validity clamps), a global cell offset, and 2048 cells, so that B11 adds
two cell sub-blocks of 1024. The JAX kernels take the pair axis padded to
128 (``pad_pairs``); the port's keeps its true length, so the first
``npairs`` rows are compared. Tolerance rtol = atol = 1e-5: both round the
operand to bf16, whose products with the 0/1 mask are exact in float32,
and sum in float32 in another order. Against B8/B9 the words hold the same
mask, and the sums differ only in order: 1e-5 x max |output|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import linalg as jlinalg
from singlet_tpu.ops import pallas_maskgram as jmg
from singlet_tpu.ops.rngmask import seed_pair as jseed_pair
from singlet_tpu_torch.ops import linalg, maskgram
from singlet_tpu_torch.ops.maskbits import pack_mask_words, unpack_all
from singlet_tpu_torch.ops.rngmask import seed_pair

GENES, GENE_BLOCK, CELLS, K = 96, 32, 48, 5
INV_DENSITY = 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(cells_true, genes_true, gene_block=GENE_BLOCK):
    return dict(gene_block=gene_block, inv_density=INV_DENSITY,
                cells_true=cells_true, genes_true=genes_true)


def _packed(X, k):
    """Packed outer products of numpy X: the port's (rows, npairs) and the
    JAX package's padded to 128 pairs."""
    iu = jlinalg.triu_pairs(k)
    P_jax = jlinalg.packed_outer_products(jnp.asarray(X),
                                          jlinalg.pad_pairs(iu, 128))
    P = linalg.packed_outer_products(torch.as_tensor(X), linalg.triu_pairs(k))
    return P, P_jax, iu[0].shape[0]


# (cells, genes, offset, cells_true, genes_true): the JAX test's unclamped
# and clamped geometries, a global cell offset past cells_true for some
# cells, and 2048 cells (B11: two sub-blocks of 1024)
GEOMS = {
    "plain": (CELLS, GENES, 0, CELLS, GENES),
    "clamped": (CELLS, GENES, 0, CELLS - 10, GENES - 7),
    "offset": (CELLS, GENES, 4096, 4096 + 40, GENES - 3),
    "two_sub_blocks": (2048, GENES, 12345, 12345 + 2000, GENES),
}


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_mask_packed_w_t_matches_jax(rng, geom):
    cells, genes, offset, cells_true, genes_true = GEOMS[geom]
    W = rng.random((genes, K)).astype(np.float32)
    P, P_jax, npairs = _packed(W, K)
    ids = np.arange(offset, offset + cells, dtype=np.int32)
    calls = maskgram.PLAIN_CALLS
    got = maskgram.mask_packed_w_t(P, seed_pair(13), torch.as_tensor(ids),
                                   **_kw(cells_true, genes_true))
    assert maskgram.PLAIN_CALLS == calls + 1
    want = jmg.mask_packed_w_t(P_jax, jseed_pair(13), jnp.asarray(ids),
                               **_kw(cells_true, genes_true), interpret=True)
    assert got.shape == (npairs, cells) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:npairs], **TOL)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_mask_packed_h_t_matches_jax(rng, geom):
    cells, genes, offset, cells_true, genes_true = GEOMS[geom]
    H = rng.random((cells, K)).astype(np.float32)
    P, P_jax, npairs = _packed(H, K)
    ids = np.arange(offset, offset + cells, dtype=np.int32)
    acc0 = rng.random((128, genes)).astype(np.float32)
    acc = torch.as_tensor(acc0[:npairs].copy())
    out = maskgram.mask_packed_h_t(P, seed_pair(29), torch.as_tensor(ids),
                                   acc, **_kw(cells_true, genes_true))
    assert out is acc           # updated in place
    want = jmg.mask_packed_h_t(P_jax, jseed_pair(29), jnp.asarray(ids),
                               jnp.asarray(acc0),
                               **_kw(cells_true, genes_true), interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want)[:npairs], **TOL)


def test_hash_mask_is_the_packed_mask():
    """The mask B10/B11 hash is the one ``pack_mask_words`` packs for the
    same cells, validity clamps included."""
    ids = torch.arange(4096, 4096 + CELLS)
    kw = _kw(4096 + 40, GENES - 3)
    m = maskgram.hash_mask(seed_pair(7), ids, GENES, **{
        key: kw[key] for key in ("inv_density", "cells_true",
                                 "genes_true")})
    words = pack_mask_words(seed_pair(7), ids, genes_pad=GENES,
                            gene_block=GENE_BLOCK, inv_density=INV_DENSITY,
                            cells_true=kw["cells_true"],
                            genes_true=kw["genes_true"])
    assert torch.equal(m, unpack_all(words, GENES, GENE_BLOCK))
    assert not m[40:].any() and not m[:, GENES - 3:].any() and m.any()


@pytest.mark.parametrize("geom", ["clamped", "two_sub_blocks"])
def test_hash_products_match_bits_products(rng, geom):
    """Plain B10 against plain bf16 B8, and plain B11 against plain bf16
    B9 with one quantization group, on the packed words of the same seed:
    the same function from another mask source."""
    cells, genes, offset, cells_true, genes_true = GEOMS[geom]
    kw = _kw(cells_true, genes_true)
    ids = torch.arange(offset, offset + cells)
    words = pack_mask_words(seed_pair(3), ids, genes_pad=genes,
                            gene_block=GENE_BLOCK, inv_density=INV_DENSITY,
                            cells_true=cells_true, genes_true=genes_true)
    W = torch.as_tensor(rng.random((genes, K)).astype(np.float32))
    H = torch.as_tensor(rng.random((cells, K)).astype(np.float32))
    iu = linalg.triu_pairs(K)
    Pw = linalg.packed_outer_products(W, iu)
    Ph = linalg.packed_outer_products(H, iu)
    ones = torch.ones(Pw.shape[1])

    got = maskgram.mask_packed_w_t(Pw, seed_pair(3), ids, **kw)
    want = maskgram.mask_packed_w_t_bits(Pw.to(torch.bfloat16), ones, words,
                                         gene_block=GENE_BLOCK)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    acc = torch.as_tensor(rng.random((Pw.shape[1], genes)).astype(np.float32))
    got = maskgram.mask_packed_h_t(Ph, seed_pair(3), ids, acc.clone(), **kw)
    want = maskgram.mask_packed_h_t_bits(Ph.to(torch.bfloat16), ones[:, None],
                                         words, acc.clone(),
                                         gene_block=GENE_BLOCK)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_sub_block_refusal():
    """A block that splits only into sub-blocks under 8 cells raises where
    the JAX kernel would leave cells out."""
    P = torch.zeros((1026, 15))
    with pytest.raises(ValueError, match="8 cells"):
        maskgram.mask_packed_h_t(P, seed_pair(1), torch.arange(1026),
                                 torch.zeros((15, GENES)), **_kw(2000, GENES))
