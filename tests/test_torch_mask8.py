"""The plain versions of kernels B12-B14 (``singlet_tpu_torch/ops/maskbits.py``
``unpack_mask_bits_plain``, ``ops/maskgram.py`` ``mask_packed_w_t_m8_plain``
and ``mask_packed_h_t_m8_plain``), the ELL engine's prebuilt int8 mask of
``SINGLET_TPU_MASK8=1``, against the JAX kernels in interpret mode on the
same numpy inputs, and against the port's bits-route B8/B9.

Geometries are those of tests/test_torch_maskbits.py, with one more whose
40 gene blocks are no multiple of 32 (a second, partial word group).
Tolerances: B12 gives the JAX bytes exactly; B13 and B14 on int8 sum exact
integers and dequantize with one rounding, so they give the JAX kernels'
bits and those of plain B8/B9 on the same words; on bf16 they sum float32
in another order than the JAX kernels (max abs error within 1e-5 x max
|output|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import maskbits as jmb
from singlet_tpu.ops import pallas_maskgram as jmg
from singlet_tpu.ops.linalg import packed_outer_products as j_packed
from singlet_tpu.ops.linalg import pad_pairs, triu_pairs
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu_torch.ops import maskbits, maskgram
from singlet_tpu_torch.ops.linalg import packed_outer_products
from singlet_tpu_torch.ops.rngmask import seed_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(seed, cells, genes, gene_block, inv, cells_true=None,
           genes_true=None):
    """The same packed words from both packages: (torch int32, jax uint32)."""
    kw = dict(genes_pad=genes, gene_block=gene_block, inv_density=inv,
              cells_true=cells if cells_true is None else cells_true,
              genes_true=genes if genes_true is None else genes_true)
    got = maskbits.pack_mask_words(seed_pair(seed), torch.arange(cells), **kw)
    want = jmb.pack_mask_words(jax_seed_pair(seed),
                               jnp.arange(cells, dtype=jnp.int32), **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    return got, want


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + 1e-30, err


def _check(got, want, dtype):
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


# (genes, gene_block, cells, k, inv_density): test_torch_maskbits.py's, and
# 40 gene blocks (word groups of 32 and 8 planes)
MPW_GEOMETRIES = {"small": (96, 32, 48, 5, 5),
                  "two_word_groups": (512, 8, 16, 3, 3),
                  "forty_gene_blocks": (320, 8, 24, 3, 3)}
# (genes, gene_block, cells, scale_block, k): test_torch_maskbits.py's (one
# group; three groups with gene slabs; two groups of two sub-blocks; 64 gene
# blocks) and 40 gene blocks in two groups
MPH_GEOMETRIES = {"one_group": (96, 32, 48, 48, 5),
                  "three_groups_slabs": (128, 32, 48, 16, 4),
                  "subblocks": (64, 32, 4096, 2048, 3),
                  "two_word_groups": (512, 8, 32, 16, 3),
                  "forty_gene_blocks": (320, 8, 48, 24, 3)}


@pytest.mark.parametrize("geom", sorted(MPW_GEOMETRIES))
def test_unpack_mask_bits_plain_matches_jax(geom):
    genes, gb, cells, _, inv = MPW_GEOMETRIES[geom]
    words, jwords = _words(11, cells, genes, gb, inv, cells - 3, genes - 5)
    got = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                          genes_pad=genes)
    want = jmb.unpack_mask_bits(jwords, gene_block=gb, genes_pad=genes,
                                interpret=True)
    assert got.dtype == torch.int8 and got.shape == (cells, genes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got.bool(), maskbits.unpack_all(words, genes, gb))
    # into a reused buffer, overwriting what it held
    buf = torch.full((cells, genes), 7, dtype=torch.int8)
    assert maskbits.unpack_mask_bits(words, gene_block=gb, genes_pad=genes,
                                     out=buf) is buf
    assert torch.equal(buf, got)


def _pairs(X, k):
    """Packed outer products of X, unpadded (port) and padded to 128 pairs
    (the JAX kernels' lane multiple)."""
    iu = triu_pairs(k)
    return (packed_outer_products(torch.as_tensor(X), iu),
            j_packed(jnp.asarray(X), pad_pairs(iu, 128)), iu[0].shape[0])


def _operands(P, Pj, dtype):
    """(port operand, port scales, JAX operand, JAX scales)."""
    if dtype == "int8":
        q, s = maskgram.quantize_pairs(P, axis=0)
        qj, sj = jmg.quantize_pairs(Pj, axis=0)
        return q, s, qj, sj
    return (P.to(torch.bfloat16), torch.ones(P.shape[1]),
            Pj.astype(jnp.bfloat16), jnp.ones((Pj.shape[1],), jnp.float32))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("geom", sorted(MPW_GEOMETRIES))
def test_mask_packed_w_t_m8_plain_matches_jax(rng, geom, dtype):
    genes, gb, cells, k, inv = MPW_GEOMETRIES[geom]
    W = rng.random((genes, k)).astype(np.float32)
    words, jwords = _words(13, cells, genes, gb, inv, cells - 3, genes - 5)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    P, Pj, npairs = _pairs(W, k)
    op, s, opj, sj = _operands(P, Pj, dtype)
    got = maskgram.mask_packed_w_t_m8_plain(op, s, m8, gene_block=gb)
    want = jmg.mask_packed_w_t_m8(opj, sj, jnp.asarray(m8.numpy().T),
                                  gene_block=gb, interpret=True)
    assert got.shape == (npairs, cells)
    _check(got.numpy(), np.asarray(want)[:npairs], dtype)


def _group_operands(rng, cells, scale_block, k, dtype):
    """Per quantization group (scale_block cells) its own quantized packed
    products, stacked: the engine's batched B14 operand."""
    H = rng.random((cells, k)).astype(np.float32)
    parts = [_operands(*_pairs(H[c0:c0 + scale_block], k)[:2], dtype)
             for c0 in range(0, cells, scale_block)]
    npairs = k * (k + 1) // 2
    return (torch.cat([p[0] for p in parts]),
            torch.stack([p[1] for p in parts], dim=1),
            jnp.concatenate([p[2] for p in parts]),
            jnp.stack([p[3] for p in parts], axis=1), npairs)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("geom", sorted(MPH_GEOMETRIES))
def test_mask_packed_h_t_m8_plain_matches_jax(rng, geom, dtype):
    genes, gb, cells, scale_block, k = MPH_GEOMETRIES[geom]
    words, jwords = _words(29, cells, genes, gb, 5, cells - 5, genes - 3)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    op, s, opj, sj, npairs = _group_operands(rng, cells, scale_block, k,
                                             dtype)
    acc0 = rng.random((128, genes)).astype(np.float32)
    acc = torch.as_tensor(acc0[:npairs].copy())
    got = maskgram.mask_packed_h_t_m8_plain(op, s, m8, acc, gene_block=gb,
                                            scale_block=scale_block)
    assert got is acc
    want = jmg.mask_packed_h_t_m8(opj, sj, jnp.asarray(m8.numpy()),
                                  jnp.asarray(acc0), gene_block=gb,
                                  scale_block=scale_block, interpret=True)
    _check(got.numpy(), np.asarray(want)[:npairs], dtype)


@pytest.mark.parametrize("geom", sorted(MPH_GEOMETRIES))
def test_m8_plain_equal_bits_plain(rng, geom):
    """On int8, plain B13 and B14 on the unpacked mask give the bits of
    plain B8 and B9 on its words."""
    genes, gb, cells, scale_block, k = MPH_GEOMETRIES[geom]
    words, _ = _words(31, cells, genes, gb, 4)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    W = torch.as_tensor(rng.random((genes, k)).astype(np.float32))
    qw, sw = maskgram.quantize_pairs(packed_outer_products(W, triu_pairs(k)))
    blk = slice(0, scale_block)
    assert torch.equal(
        maskgram.mask_packed_w_t_m8_plain(qw, sw, m8[blk], gene_block=gb),
        maskgram.mask_packed_w_t_bits_plain(qw, sw, words[blk],
                                            gene_block=gb))
    op, s, _, _, npairs = _group_operands(rng, cells, scale_block, k, "int8")
    acc0 = torch.as_tensor(rng.random((npairs, genes)).astype(np.float32))
    assert torch.equal(
        maskgram.mask_packed_h_t_m8_plain(op, s, m8, acc0.clone(),
                                          gene_block=gb,
                                          scale_block=scale_block),
        maskgram.mask_packed_h_t_bits_plain(op, s, words, acc0.clone(),
                                            gene_block=gb,
                                            scale_block=scale_block))


@pytest.mark.parametrize("cells", [2050, 5])
def test_m8_refusals(cells):
    """A cell count whose JAX sub-block search ends below 8 cells, where the
    JAX kernels leave cells unwritten, raises in all three."""
    genes, gb, k = 64, 32, 3
    words = torch.zeros((cells, gb), dtype=torch.int32)
    with pytest.raises(ValueError, match="B12"):
        maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                        genes_pad=genes)
    m8 = torch.zeros((cells, genes), dtype=torch.int8)
    npairs = k * (k + 1) // 2
    with pytest.raises(ValueError, match="B13"):
        maskgram.mask_packed_w_t_m8_plain(
            torch.zeros((genes, npairs), dtype=torch.int8),
            torch.ones(npairs), m8, gene_block=gb)
    with pytest.raises(ValueError, match="8 cells"):
        maskgram.mask_packed_h_t_m8_plain(
            torch.zeros((cells, npairs), dtype=torch.int8),
            torch.ones((npairs, 1)), m8, torch.zeros((npairs, genes)),
            gene_block=gb)
    assert maskbits.unpack_sub_block(2048) == 1024
    assert maskgram.m8_sub_block(1536) == 768


def test_m8_dispatchers_take_plain_versions_on_cpu(rng):
    from singlet_tpu_torch.ops import maskgram_cuda

    genes, gb, cells, k, inv = MPW_GEOMETRIES["small"]
    words, _ = _words(5, cells, genes, gb, inv)
    W = torch.as_tensor(rng.random((genes, k)).astype(np.float32))
    H = torch.as_tensor(rng.random((cells, k)).astype(np.float32))
    launches = (maskgram_cuda.LAUNCHES_UNPACK8, maskgram_cuda.LAUNCHES_MPW_M8,
                maskgram_cuda.LAUNCHES_MPH_M8)
    plain = (maskbits.PLAIN_CALLS, maskgram.PLAIN_CALLS)
    m8 = maskbits.unpack_mask_bits(words, gene_block=gb, genes_pad=genes)
    q, s = maskgram.quantize_pairs(packed_outer_products(W, triu_pairs(k)))
    maskgram.mask_packed_w_t_m8(q, s, m8, gene_block=gb)
    qh, sh = maskgram.quantize_pairs(packed_outer_products(H, triu_pairs(k)))
    maskgram.mask_packed_h_t_m8(qh, sh[:, None], m8,
                                torch.zeros((qh.shape[1], genes)),
                                gene_block=gb)
    assert (maskgram_cuda.LAUNCHES_UNPACK8, maskgram_cuda.LAUNCHES_MPW_M8,
            maskgram_cuda.LAUNCHES_MPH_M8) == launches
    assert (maskbits.PLAIN_CALLS, maskgram.PLAIN_CALLS) == (plain[0] + 1,
                                                            plain[1] + 2)
