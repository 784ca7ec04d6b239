"""The bits route's w-side mask products B8 and B13 as one GEMM over the
block's mask packed along the genes (``singlet_tpu_torch/ops/maskgram.py``):
the plain versions of their passes, ``pack_words_g`` (bitplane words) and
``pack_mask8_g`` (the prebuilt int8 mask), against ``pack_mask_k`` with
``gene_rows=False``, the plain version of the hash pass that B10's GEMM
reads; the operand layouts in which the engine builds Pw once per step
(int8 K-major in a ``kmajor_buffer``, bf16 in a ``pair_buffer``) fed to the
plain B8 and B13 against contiguous P and against the JAX kernels in
interpret mode; and the engine's ``_w_operand``.

Tolerances: the passes give the words of ``pack_mask_k`` for the same seed
and cells bit for bit. On int8 the plain B8/B13 sum exact integers and
dequantize with one rounding, so any layout of P gives the same bits, and
the JAX kernels' within rtol = atol = 1e-6 (tests/test_torch_maskbits.py's
EXACT8); on bf16 they sum float32 in another order than the JAX kernels
(rtol = atol = 1e-5, its BF16), and any layout of P gives the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import maskbits as jmb
from singlet_tpu.ops import pallas_maskgram as jmg
from singlet_tpu.ops.linalg import packed_outer_products as j_packed
from singlet_tpu.ops.linalg import pad_pairs
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu_torch.ops import maskbits, maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.parallel import sharded_ell as tell

EXACT8 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (cells, offset, gene_block, n_gb, cells_true, genes_true): gene blocks of
# 8 (a load per bit on the card), 32 in 40 blocks (a second, partial word
# group) and 256; 300 and 33 cells (no multiple of 32) at offsets, both
# clamps; 1720 genes in one block (no multiple of 32 words)
PACK_GEOMS = {"gene_block_8": (33, 7, 8, 5, 7 + 33, 37),
              "forty_gene_blocks": (300, 12345, 32, 40, 12345 + 250, 1263),
              "gene_block_256": (100, 0, 256, 3, 100, 768),
              "two_word_groups": (40, 64, 8, 64, 64 + 40, 500),
              "gene_block_1720": (33, 4096, 1720, 1, 4096 + 30, 1700)}


def _pack_inputs(geom, seed=41, inv=5):
    cells, offset, gb, n_gb, cells_true, genes_true = PACK_GEOMS[geom]
    genes = gb * n_gb
    ids = torch.arange(offset, offset + cells)
    kw = dict(inv_density=inv, cells_true=cells_true, genes_true=genes_true)
    words = maskbits.pack_mask_words(seed_pair(seed), ids, genes_pad=genes,
                                     gene_block=gb, **kw)
    want = maskgram.pack_mask_k(seed_pair(seed), ids, genes, gene_rows=False,
                                **kw)
    return words, want, gb, genes


@pytest.mark.parametrize("geom", sorted(PACK_GEOMS))
def test_pack_words_g_equals_pack_mask_k(geom):
    words, want, gb, genes = _pack_inputs(geom)
    got = maskgram.pack_words_g(words, gene_block=gb, genes_pad=genes)
    assert got.dtype == torch.int32
    assert got.shape == (words.shape[0], maskgram.k_words(genes))
    assert torch.equal(got, want)
    # at least one held-out entry, so the comparison is not of zeros
    assert bool((want != 0).any())


@pytest.mark.parametrize("geom", sorted(PACK_GEOMS))
def test_pack_mask8_g_equals_pack_mask_k(geom):
    words, want, gb, genes = _pack_inputs(geom)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    assert torch.equal(maskgram.pack_mask8_g(m8), want)


@pytest.mark.parametrize("geom", sorted(PACK_GEOMS))
def test_g_and_k_passes_are_transposes(geom):
    """The block's words packed along the genes (B8/B13) and along the
    cells (B9/B14) hold the same mask."""
    words, _, gb, genes = _pack_inputs(geom)
    cells = words.shape[0]
    g = maskgram.pack_words_g(words, gene_block=gb, genes_pad=genes)
    k = maskgram.pack_words_k(words, gene_block=gb, genes_pad=genes)
    bits = lambda w, n: ((w.long()[:, :, None] >> torch.arange(32))  # noqa
                         & 1).reshape(w.shape[0], -1)[:, :n]
    assert torch.equal(bits(g, genes), bits(k, cells).T)


def test_pass_wrappers_take_plain_versions_on_cpu():
    words, want, gb, genes = _pack_inputs("forty_gene_blocks")
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    before = maskgram_cuda.LAUNCHES_KPACK
    assert torch.equal(maskgram_cuda.pack_words_g_cuda(
        words, gene_block=gb, genes_pad=genes), want)
    assert torch.equal(maskgram_cuda.pack_mask8_g_cuda(m8), want)
    assert maskgram_cuda.LAUNCHES_KPACK == before


# (genes, gene_block, cells, k, inv_density): tests/test_torch_maskbits.py's
# MPW_GEOMETRIES (one word group; 64 gene blocks, a second word group)
MPW_GEOMETRIES = {"small": (96, 32, 48, 5, 5),
                  "two_word_groups": (512, 8, 16, 3, 3)}


def _jax_words(seed, cells, genes, gene_block, inv, cells_true, genes_true):
    kw = dict(genes_pad=genes, gene_block=gene_block, inv_density=inv,
              cells_true=cells_true, genes_true=genes_true)
    got = maskbits.pack_mask_words(seed_pair(seed), torch.arange(cells), **kw)
    want = jmb.pack_mask_words(jax_seed_pair(seed),
                               jnp.arange(cells, dtype=jnp.int32), **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    return got, want


def _w_operands(W, k, dtype):
    """Pw of W quantized (int8) or rounded (bf16), contiguous, and the same
    for JAX (pairs padded to 128), with the scales."""
    iu = triu_pairs(k)
    P = packed_outer_products(torch.as_tensor(W), iu)
    Pj = j_packed(jnp.asarray(W), pad_pairs(iu, 128))
    if dtype == "int8":
        q, s = maskgram.quantize_pairs(P, axis=0)
        qj, sj = jmg.quantize_pairs(Pj, axis=0)
    else:
        q, s = P.to(torch.bfloat16), torch.ones(P.shape[1])
        qj, sj = Pj.astype(jnp.bfloat16), jnp.ones((Pj.shape[1],),
                                                   jnp.float32)
    return q, s, qj, sj, iu[0].shape[0]


def _engine_layout(op):
    """``op`` as the engine builds Pw once per step: int8 in a K-major
    ``kmajor_buffer``, bf16 in a pair-padded ``pair_buffer``."""
    make = maskgram.kmajor_buffer if op.dtype == torch.int8 \
        else maskgram.pair_buffer
    buf = make(op.shape[0], op.shape[1], "cpu")
    buf.copy_(op)
    assert not buf.is_contiguous()
    return buf


@pytest.mark.parametrize("kernel", ["B8", "B13"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("geom", sorted(MPW_GEOMETRIES))
def test_w_products_on_engine_layout_match_jax(rng, geom, dtype, kernel):
    genes, gb, cells, k, inv = MPW_GEOMETRIES[geom]
    W = rng.random((genes, k)).astype(np.float32)
    words, jwords = _jax_words(13, cells, genes, gb, inv, cells - 3,
                               genes - 5)
    op, s, opj, sj, npairs = _w_operands(W, k, dtype)
    if kernel == "B8":
        plain = maskgram.mask_packed_w_t_bits_plain
        mask = words
        want = jmg.mask_packed_w_t_bits(opj, sj, jwords.T, gene_block=gb,
                                        interpret=True)
    else:
        plain = maskgram.mask_packed_w_t_m8_plain
        mask = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                               genes_pad=genes)
        want = jmg.mask_packed_w_t_m8(opj, sj, jnp.asarray(mask.numpy().T),
                                      gene_block=gb, interpret=True)
    got = plain(_engine_layout(op), s, mask, gene_block=gb)
    assert got.shape == (npairs, cells)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:npairs],
                               **(EXACT8 if dtype == "int8" else BF16))
    assert torch.equal(got, plain(op, s, mask, gene_block=gb))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_engine_w_operand_layout(rng, mode):
    """The engine's Pw operand, built from W: the values and scales of
    ``quantize_pairs`` (int8) or bf16 with unit scales, in the layout
    B8/B13 read in place (int8 K-major, bf16 pair-padded)."""
    W = torch.as_tensor(rng.random((96, 5)).astype(np.float32))
    Pw = packed_outer_products(W, triu_pairs(5))
    op, s = tell._w_operand(W, mode)
    q, qs = (maskgram.quantize_pairs(Pw, axis=0) if mode == "int8"
             else (Pw.to(torch.bfloat16), torch.ones(Pw.shape[1])))
    assert op.shape == Pw.shape and op.dtype == q.dtype
    assert torch.equal(op, q) and torch.equal(s, qs)
    if mode == "int8":
        assert maskgram.kmajor_pitch(op) == 96
    else:
        assert op.stride() == (maskgram.PAIR_PAD, 1)
