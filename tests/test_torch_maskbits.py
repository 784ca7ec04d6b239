"""The port's packed test mask (``singlet_tpu_torch/ops/maskbits.py``),
``quantize_pairs`` and the plain versions of kernels B5-B9
(``ops/bell.py``, ``ops/maskgram.py``) against the JAX package on the CPU,
on the same numpy inputs: the JAX kernels run in interpret mode.

Geometries are those of tests/test_maskbits.py, and so are the
tolerances: the packed words and the int8 quantization bit for bit; B5 and
B6 at 1e-6 (the same float32 products as the JAX kernels, summed in
another order); B8 and B9 on int8 at 1e-6 (exact int32 sums, one
dequantizing multiply) and on bf16 at 1e-5 (float32 sums of exact
products in another order); B7's sums at rtol 2e-4, atol 1e-5, its counts
exact. B9 is also run with several quantization groups (n_scales > 1),
with several sub-blocks per group, at the geometries where the JAX kernel
takes gene slabs (ng > 1), and batched against block-by-block calls, which
must give the same bits. The JAX words are uint32; the port holds their
int32 bit patterns, compared through a numpy view.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu.ops import maskbits as jmb
from singlet_tpu.ops import pallas_bell as jpb
from singlet_tpu.ops import pallas_maskgram as jmg
from singlet_tpu.ops.linalg import packed_outer_products as j_packed
from singlet_tpu.ops.linalg import pad_pairs, triu_pairs
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu_torch.ops import bell, maskbits, maskgram
from singlet_tpu_torch.ops.linalg import packed_outer_products
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.parallel import sharded_ell as tell

GENES, GENE_BLOCK, CELLS, K = 96, 32, 48, 5
INV_DENSITY = 5
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


def _words(seed, cells, genes, gene_block, inv, cells_true=None,
           genes_true=None, cell_block=2048):
    """The same packed words from both packages: (torch int32, jax uint32)."""
    kw = dict(genes_pad=genes, gene_block=gene_block, inv_density=inv,
              cells_true=cells if cells_true is None else cells_true,
              genes_true=genes if genes_true is None else genes_true,
              cell_block=cell_block)
    got = maskbits.pack_mask_words(seed_pair(seed), torch.arange(cells), **kw)
    want = jmb.pack_mask_words(jax_seed_pair(seed),
                               jnp.arange(cells, dtype=jnp.int32), **kw)
    return got, want


def _same_words(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("clamped", [False, True])
def test_pack_mask_words_matches_jax(clamped):
    cells_true = CELLS - 10 if clamped else CELLS
    genes_true = GENES - 7 if clamped else GENES
    got, want = _words(13, CELLS, GENES, GENE_BLOCK, INV_DENSITY,
                       cells_true, genes_true, cell_block=16)
    assert got.shape == (CELLS, maskbits.n_word_groups(3) * GENE_BLOCK)
    _same_words(got, want)
    np.testing.assert_array_equal(
        maskbits.unpack_all(got, GENES, GENE_BLOCK).numpy(),
        np.asarray(jmb.unpack_all(want, GENES, GENE_BLOCK)))
    for gb in range(GENES // GENE_BLOCK):
        np.testing.assert_array_equal(
            maskbits.unpack_gene_block(got, gb, GENE_BLOCK).numpy(),
            np.asarray(jmb.unpack_gene_block(want, gb, GENE_BLOCK)))


def test_pack_many_gene_blocks_matches_jax():
    """n_gb = 64: a second word group, and bit 31 set in some words (the
    int32 pattern is negative there)."""
    got, want = _words(7, 16, 8 * 64, 8, 3, cell_block=16)
    assert got.shape == (16, 2 * 8)
    assert (got < 0).any()
    _same_words(got, want)


def test_pack_mask_words_slab_rules():
    """A cell count that is no multiple of the slab halves it (one slab
    layout or another gives the same words); one that only divides into
    slabs under 64 cells past 4096 cells raises, as in JAX."""
    got, want = _words(3, 1000, 64, 32, 4, cell_block=256)
    _same_words(got, want)
    one, _ = _words(3, 1000, 64, 32, 4, cell_block=8)
    assert torch.equal(got, one)
    with pytest.raises(ValueError, match="64-cell slabs"):
        maskbits.pack_mask_words(seed_pair(1), torch.arange(4099),
                                 genes_pad=32, gene_block=32, inv_density=4,
                                 cells_true=4099, genes_true=32)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_pairs_matches_jax(rng, axis):
    P = rng.random((256, 128)).astype(np.float32)
    P[:, 5] = 0.0                          # the scale floor
    # exact halves (half to even) and the clip at 127
    P[:4, 7] = [254.0, 1.0, 3.0, 5.0]
    P[4:, 7] = 0.5
    P = P if axis == 0 else P.T.copy()
    q, s = maskgram.quantize_pairs(torch.as_tensor(P), axis=axis)
    qj, sj = jmg.quantize_pairs(jnp.asarray(P), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_maskgram_mode(monkeypatch):
    for raw, want in (("INT8", "int8"), ("bf16", "bf16"), ("hash", "hash"),
                      ("xla", "xla"), ("nonsense", "int8")):
        monkeypatch.setenv("SINGLET_TPU_MASKGRAM", raw)
        assert maskgram.maskgram_mode() == want == jmg.maskgram_mode()
    monkeypatch.delenv("SINGLET_TPU_MASKGRAM")
    assert maskgram.maskgram_mode() == "int8"


# ---------------------------------------------------------------- B5-B7

def _planes(genes, cells, gene_block, density, seed):
    A = sp.random(genes, cells, density=density, random_state=seed,
                  format="csc", dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    n_gb = genes // gene_block
    width = tell.bell_width(tell.bell_widths(A, n_gb, gene_block))
    li, lv = tell.csc_to_bell(A, cells, gene_block, n_gb, width)
    return (A, tell.planes_to_device_layout(li),
            tell.planes_to_device_layout(lv), n_gb)


# (genes, gene_block, cells, k, inv_density, density, seed): those of
# tests/test_maskbits.py, the second with 64 gene blocks (two word groups)
BELL_GEOMETRIES = {"small": (96, 32, 48, 5, 5, 0.2, 2),
                   "two_word_groups": (512, 8, 16, 3, 3, 0.15, 3)}


@pytest.mark.parametrize("geom", sorted(BELL_GEOMETRIES))
def test_bell_bits_plain_match_jax(rng, geom):
    genes, gb, cells, k, inv, density, seed = BELL_GEOMETRIES[geom]
    A, li, lv, n_gb = _planes(genes, cells, gb, density, seed)
    W = rng.random((genes, k)).astype(np.float32)
    H = rng.random((cells, k)).astype(np.float32)
    d = rng.random(k).astype(np.float32) + 0.5
    words, jwords = _words(17, cells, genes, gb, inv)
    tli, tlv = torch.as_tensor(li), torch.as_tensor(lv)
    jli, jlv = jnp.asarray(li), jnp.asarray(lv)

    got_b = bell.bell_spmm_bits_plain(tli, tlv, torch.as_tensor(W), words,
                                      gene_block=gb)
    want_b = jpb.bell_spmm_bits(jli, jlv, jnp.asarray(W), jwords.T,
                                gene_block=gb, interpret=True)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **EXACT8)

    got_bw = bell.bell_spmm_t_bits_plain(tli, tlv, torch.as_tensor(H), words,
                                         gene_block=gb, n_gb=n_gb)
    want_bw = jpb.bell_spmm_t_bits(jli, jlv, jnp.asarray(H), jwords.T,
                                   gene_block=gb, n_gb=n_gb, interpret=True)
    np.testing.assert_allclose(got_bw.numpy(), np.asarray(want_bw), **EXACT8)

    Wd = W * d[None, :]
    got = bell.bell_mse_bits_plain(tli, tlv, words, torch.as_tensor(Wd),
                                   torch.as_tensor(H), gene_block=gb)
    want = np.asarray(jpb.bell_mse_bits(jli, jlv, jwords.T, jnp.asarray(Wd),
                                        jnp.asarray(H), gene_block=gb,
                                        interpret=True))
    assert got.shape == (2, cells)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    # and the definition: held-out squared errors of the dense operand
    m = maskbits.unpack_all(words, genes, gb).numpy()
    diff2 = (H @ Wd.T - A.toarray().T) ** 2
    np.testing.assert_allclose(got[0].numpy(), (diff2 * m).sum(axis=1),
                               rtol=2e-4, atol=1e-5)


def test_bell_bits_plain_equal_hashed_plain(rng):
    """B5/B6's plain versions with the packed mask equal B3/B4's with the
    hashed one, bit for bit: the same keep factors, the same products."""
    genes, gb, cells, k, inv, density, seed = BELL_GEOMETRIES["small"]
    _, li, lv, n_gb = _planes(genes, cells, gb, density, seed)
    tli, tlv = torch.as_tensor(li), torch.as_tensor(lv)
    W = torch.as_tensor(rng.random((genes, k)).astype(np.float32))
    H = torch.as_tensor(rng.random((cells, k)).astype(np.float32))
    words, _ = _words(17, cells, genes, gb, inv)
    assert torch.equal(
        bell.bell_spmm_bits_plain(tli, tlv, W, words, gene_block=gb),
        bell.bell_spmm_plain(tli, tlv, W, seed_pair(17), gene_block=gb,
                             inv_density=inv))
    assert torch.equal(
        bell.bell_spmm_t_bits_plain(tli, tlv, H, words, gene_block=gb,
                                    n_gb=n_gb),
        bell.bell_spmm_t_plain(tli, tlv, H, seed_pair(17), gene_block=gb,
                               n_gb=n_gb, inv_density=inv))


# ---------------------------------------------------------------- B8, B9

def _pairs(X, k):
    """Packed outer products of X, unpadded (port) and padded to 128 pairs
    (the JAX kernels' lane multiple)."""
    iu = triu_pairs(k)
    return (packed_outer_products(torch.as_tensor(X), iu),
            j_packed(jnp.asarray(X), pad_pairs(iu, 128)), iu[0].shape[0])


def _operands(P, Pj, dtype, axis=0):
    """(port operand, port scales, JAX operand, JAX scales)."""
    if dtype == "int8":
        q, s = maskgram.quantize_pairs(P, axis=axis)
        qj, sj = jmg.quantize_pairs(Pj, axis=axis)
        npairs = P.shape[1]
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj)[:, :npairs])
        return q, s, qj, sj
    ones = jnp.ones((Pj.shape[1],), jnp.float32)
    return (P.to(torch.bfloat16), torch.ones(P.shape[1]),
            Pj.astype(jnp.bfloat16), ones)


# (genes, gene_block, cells, k, inv_density): that of test_maskbits.py and
# 64 gene blocks (a second word group)
MPW_GEOMETRIES = {"small": (GENES, GENE_BLOCK, CELLS, K, INV_DENSITY),
                  "two_word_groups": (512, 8, 16, 3, 3)}


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("geom", sorted(MPW_GEOMETRIES))
def test_mask_packed_w_t_bits_plain_matches_jax(rng, geom, dtype):
    genes, gb, cells, k, inv = MPW_GEOMETRIES[geom]
    W = rng.random((genes, k)).astype(np.float32)
    words, jwords = _words(13, cells, genes, gb, inv, cells - 3, genes - 5)
    P, Pj, npairs = _pairs(W, k)
    op, s, opj, sj = _operands(P, Pj, dtype)
    got = maskgram.mask_packed_w_t_bits_plain(op, s, words, gene_block=gb)
    want = jmg.mask_packed_w_t_bits(opj, sj, jwords.T, gene_block=gb,
                                    interpret=True)
    assert got.shape == (npairs, cells)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:npairs],
                               **(EXACT8 if dtype == "int8" else BF16))


# (genes, gene_block, cells, scale_block, k): one group (test_maskbits.py);
# three groups with 4 gene blocks (the JAX kernel takes gene slabs of 4);
# two groups of 2048 cells (two 1024-cell sub-blocks per group); 64 gene
# blocks (slabs of 8, a second word group)
MPH_GEOMETRIES = {"one_group": (GENES, GENE_BLOCK, CELLS, CELLS, K),
                  "three_groups_slabs": (128, 32, 48, 16, 4),
                  "subblocks": (64, 32, 4096, 2048, 3),
                  "two_word_groups": (512, 8, 32, 16, 3)}


def _group_operands(rng, cells, scale_block, k, dtype):
    """Per quantization group (scale_block cells) its own quantized packed
    products, stacked: the engine's batched B9 operand."""
    H = rng.random((cells, k)).astype(np.float32)
    ops, scales, opsj, scalesj = [], [], [], []
    for c0 in range(0, cells, scale_block):
        P, Pj, npairs = _pairs(H[c0:c0 + scale_block], k)
        op, s, opj, sj = _operands(P, Pj, dtype)
        ops.append(op)
        scales.append(s)
        opsj.append(opj)
        scalesj.append(sj)
    return (torch.cat(ops), torch.stack(scales, dim=1),
            jnp.concatenate(opsj), jnp.stack(scalesj, axis=1), npairs)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("geom", sorted(MPH_GEOMETRIES))
def test_mask_packed_h_t_bits_plain_matches_jax(rng, geom, dtype):
    genes, gb, cells, scale_block, k = MPH_GEOMETRIES[geom]
    words, jwords = _words(29, cells, genes, gb, 5, cells - 5, genes - 3)
    op, s, opj, sj, npairs = _group_operands(rng, cells, scale_block, k,
                                             dtype)
    acc0 = rng.random((128, genes)).astype(np.float32)
    acc = torch.as_tensor(acc0[:npairs].copy())
    got = maskgram.mask_packed_h_t_bits_plain(op, s, words, acc,
                                              gene_block=gb,
                                              scale_block=scale_block)
    assert got is acc
    want = jmg.mask_packed_h_t_bits(opj, sj, jwords, jnp.asarray(acc0),
                                    gene_block=gb, scale_block=scale_block,
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:npairs],
                               **(EXACT8 if dtype == "int8" else BF16))


@pytest.mark.parametrize("geom", ["three_groups_slabs", "subblocks"])
def test_mask_packed_h_t_bits_batched_equals_sequential(rng, geom):
    """One batched call over F quantization groups gives the bits of F
    calls made group by group (int8)."""
    genes, gb, cells, scale_block, k = MPH_GEOMETRIES[geom]
    words, _ = _words(31, cells, genes, gb, 4)
    op, s, _, _, npairs = _group_operands(rng, cells, scale_block, k, "int8")
    acc0 = torch.as_tensor(rng.random((npairs, genes)).astype(np.float32))
    batched = maskgram.mask_packed_h_t_bits_plain(
        op, s, words, acc0.clone(), gene_block=gb, scale_block=scale_block)
    seq = acc0.clone()
    for f, c0 in enumerate(range(0, cells, scale_block)):
        sl = slice(c0, c0 + scale_block)
        maskgram.mask_packed_h_t_bits_plain(op[sl], s[:, f:f + 1].clone(),
                                            words[sl], seq, gene_block=gb)
    assert torch.equal(batched, seq)


def test_b9_sub_block_refusals():
    assert maskgram.b9_sub_block(32768, 2048) == 1024
    assert maskgram.b9_sub_block(48, 16) == 16
    with pytest.raises(ValueError, match="8 cells"):
        maskgram.b9_sub_block(2050, 2050)
    with pytest.raises(ValueError, match="divide"):
        maskgram.b9_sub_block(100, 30)
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        maskgram.mask_packed_w_t_bits_plain(torch.zeros((32, 3)), None,
                                            torch.zeros((4, 32),
                                                        dtype=torch.int32),
                                            gene_block=32)


def test_dispatchers_take_plain_versions_on_cpu(rng):
    from singlet_tpu_torch.ops import bell_cuda, maskgram_cuda

    genes, gb, cells, k, inv, density, seed = BELL_GEOMETRIES["small"]
    _, li, lv, n_gb = _planes(genes, cells, gb, density, seed)
    tli, tlv = torch.as_tensor(li), torch.as_tensor(lv)
    W = torch.as_tensor(rng.random((genes, k)).astype(np.float32))
    words, _ = _words(5, cells, genes, gb, inv)
    launches = (bell_cuda.LAUNCHES_SPMM_BITS, bell_cuda.LAUNCHES_SPMM_T_BITS,
                bell_cuda.LAUNCHES_MSE_BITS, maskgram_cuda.LAUNCHES_MPW_BITS,
                maskgram_cuda.LAUNCHES_MPH_BITS)
    plain = (bell.PLAIN_CALLS, maskgram.PLAIN_CALLS)
    B = bell.bell_spmm_bits(tli, tlv, W, words, gene_block=gb)
    bell.bell_spmm_t_bits(tli, tlv, B, words, gene_block=gb, n_gb=n_gb)
    bell.bell_mse_bits(tli, tlv, words, W, B, gene_block=gb)
    q, s = maskgram.quantize_pairs(packed_outer_products(W, triu_pairs(k)))
    maskgram.mask_packed_w_t_bits(q, s, words, gene_block=gb)
    qh, sh = maskgram.quantize_pairs(packed_outer_products(B, triu_pairs(k)))
    maskgram.mask_packed_h_t_bits(qh, sh[:, None], words,
                                  torch.zeros((qh.shape[1], genes)),
                                  gene_block=gb)
    assert (bell_cuda.LAUNCHES_SPMM_BITS, bell_cuda.LAUNCHES_SPMM_T_BITS,
            bell_cuda.LAUNCHES_MSE_BITS, maskgram_cuda.LAUNCHES_MPW_BITS,
            maskgram_cuda.LAUNCHES_MPH_BITS) == launches
    assert (bell.PLAIN_CALLS, maskgram.PLAIN_CALLS) == (plain[0] + 3,
                                                        plain[1] + 2)

