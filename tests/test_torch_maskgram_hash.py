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

The CUDA B10/B11 hash the mask into words packed along the product's K
axis and sum all of K in one float32 accumulator: ``pack_mask_k`` (their
hash pass's plain version) unpacks to ``hash_mask`` with zero tails, and
products formed from its words match the plain versions within 1e-5 x max
|output|. The engine hands them its bf16 operands as views of pair-padded
buffers; on the CPU that gives the unpadded fit bit for bit.
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


def _unpack_mask_k(words, K):
    """The bool (rows, K) mask of K-packed words (``pack_mask_k``)."""
    shift = torch.arange(32, dtype=torch.int64)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> shift) & 1
    return bits.reshape(words.shape[0], -1)[:, :K].bool()


@pytest.mark.parametrize("gene_rows", [False, True])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_pack_mask_k_unpacks_to_the_hash_mask(geom, gene_rows):
    """The K-packed words of B10 (a row per cell) and B11 (a row per gene)
    unpack to ``hash_mask`` or its transpose, validity clamps included, and
    every bit past K (the ragged word and the rows' padding to 4 words) is
    0."""
    cells, genes, offset, cells_true, genes_true = GEOMS[geom]
    ids = torch.arange(offset, offset + cells)
    kw = {key: val for key, val in _kw(cells_true, genes_true).items()
          if key != "gene_block"}
    m = maskgram.hash_mask(seed_pair(11), ids, genes, **kw)
    words = maskgram.pack_mask_k(seed_pair(11), ids, genes,
                                 gene_rows=gene_rows, **kw)
    want = m.T if gene_rows else m
    rows, K = want.shape
    assert words.dtype == torch.int32
    assert words.shape == (rows, maskgram.k_words(K))
    assert words.shape[1] % 4 == 0 and words.shape[1] * 32 >= K
    full = _unpack_mask_k(words, words.shape[1] * 32)
    assert torch.equal(full[:, :K], want)
    assert not full[:, K:].any() and want.any()


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_products_from_k_packed_words_match_plain(rng, geom):
    """B10's and B11's GEMM on the K-packed words (one float32 sum over all
    of K, as the kernels take it) against the plain versions (partials per
    gene block or cell sub-block): within 1e-5 x max |output|."""
    cells, genes, offset, cells_true, genes_true = GEOMS[geom]
    kw = _kw(cells_true, genes_true)
    hkw = {key: val for key, val in kw.items() if key != "gene_block"}
    ids = torch.arange(offset, offset + cells)
    iu = linalg.triu_pairs(K)
    Pw = linalg.packed_outer_products(
        torch.as_tensor(rng.random((genes, K)).astype(np.float32)), iu)
    Ph = linalg.packed_outer_products(
        torch.as_tensor(rng.random((cells, K)).astype(np.float32)), iu)
    acc0 = torch.as_tensor(rng.random((Pw.shape[1], genes)).astype(np.float32))

    def bf16(P):
        return P.to(torch.bfloat16).to(torch.float64)

    m_w = _unpack_mask_k(maskgram.pack_mask_k(
        seed_pair(17), ids, genes, gene_rows=False, **hkw), genes)
    m_h = _unpack_mask_k(maskgram.pack_mask_k(
        seed_pair(17), ids, genes, gene_rows=True, **hkw), cells)
    got_w = (m_w.to(torch.float64) @ bf16(Pw)).T.to(torch.float32)
    want_w = maskgram.mask_packed_w_t_plain(Pw, seed_pair(17), ids, **kw)
    assert float((got_w - want_w).abs().max()) \
        <= 1e-5 * float(want_w.abs().max())
    got_h = (acc0.to(torch.float64)
             + (m_h.to(torch.float64) @ bf16(Ph)).T).to(torch.float32)
    want_h = maskgram.mask_packed_h_t_plain(Ph, seed_pair(17), ids,
                                            acc0.clone(), **kw)
    assert float((got_h - want_h).abs().max()) \
        <= 1e-5 * float(want_h.abs().max())


def test_pair_buffer_layout():
    """The bf16 operands of B10/B11 as the engine lays them out: the
    [:, :npairs] view of a buffer whose rows are PAIR_PAD-padded."""
    for npairs in (15, 64, 5050):
        v = maskgram.pair_buffer(3, npairs, "cpu")
        assert v.shape == (3, npairs) and v.dtype == torch.bfloat16
        assert v.stride() == (-(-npairs // 64) * 64, 1)


@pytest.mark.parametrize("fit", ["fit", "ard_fit"])
def test_engine_padded_operands_give_the_same_fit(rng, monkeypatch, fit):
    """The engine's hash route hands B10/B11 views of pair-padded bf16
    buffers: on the CPU (the plain versions, the kernel route forced) the
    fit equals bit for bit the one with unpadded (contiguous) operands."""
    import scipy.sparse as sp

    from singlet_tpu_torch.parallel import sharded_ell as tell

    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", "hash")
    A = sp.random(300, 1024, density=0.1, random_state=8, format="csc",
                  dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    w0 = rng.random((300, 4)).astype(np.float32)
    if fit == "fit":
        kw = dict(w_init=w0, tol=0.0, maxit=2, masked=True, mask_seed=3)
        fields = ("w", "h", "d", "tol_trace", "test_mse")
    else:
        kw = dict(w_init=w0, mask_seed=3, maxit=2, tol=0.0,
                  trace_test_mse=1, overfit_threshold=1.0)
        fields = ("w", "h", "d", "test_mse", "iter", "tol")

    def run():
        eng = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                                    gene_block=128)
        return getattr(eng, fit)(4, **kw)

    calls = maskgram.PLAIN_CALLS
    padded = run()
    # 4 blocks of 256 cells: a B10 and a B11 per block and step
    assert maskgram.PLAIN_CALLS == calls + 2 * 4 * 2
    monkeypatch.setattr(maskgram, "PAIR_PAD", 1)
    unpadded = run()
    for f in fields:
        x, y = ((padded[f], unpadded[f]) if isinstance(padded, dict)
                else (getattr(padded, f), getattr(unpadded, f)))
        np.testing.assert_array_equal(x, y, err_msg=f)
