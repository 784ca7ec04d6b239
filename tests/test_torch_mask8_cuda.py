"""Kernels B12-B14 (``singlet_tpu_torch/ops/maskgram_cuda.py``, source
``csrc/maskgram_m8.cu``), the ELL engine's prebuilt int8 mask of
``SINGLET_TPU_MASK8=1``, on the card against their plain PyTorch versions
and against B8/B9 on the same words; and the engine's MASK8 route on the
card against the same route on the CPU and against the bits route.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_mask8_cuda.py -q

Tolerances: B12 writes bytes, which must be equal. B13 and B14 on int8 sum
exact int32 partials and dequantize with one rounding, as the plain
versions and B8/B9 do, so they must give the same bits as both, whatever
the layout of P; on bf16 they sum float32 in another order than the plain
versions (max abs error <= 1e-5 * max |output|), and B13 runs B8's GEMM on
the same words, so it gives B8's bits on bf16 too. B13's and B14's passes
give the words of their plain versions and of B8's and B9's passes.
The engine on the card against the CPU: rtol 5e-3, atol 5e-4 with equal
``iter`` lists (the fit tests' tolerance); on int8 against the card's own
bits route, the same bits.
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import maskbits, maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
from singlet_tpu_torch.ops.maskbits import pack_mask_words
from singlet_tpu_torch.ops.rngmask import seed_pair

pytestmark = pytest.mark.cuda

CELLS = 1000          # no multiple of 32 or 128
OFFSET = 4096         # global id of the first cell
# (gene_block, n_gb): one word group; 40 gene blocks (a second group); 40
# genes, no multiple of 16 (the mask rows are not 16-byte aligned)
GEOMS = [(256, 3), (32, 40), (8, 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B12-B14 have no CPU mode")
    return torch.device("cuda")


def _words(cells, gene_block, n_gb, inv, device, seed=77):
    genes = gene_block * n_gb
    return pack_mask_words(
        seed_pair(seed), torch.arange(OFFSET, OFFSET + cells, device=device),
        genes_pad=genes, gene_block=gene_block, inv_density=inv,
        cells_true=OFFSET + cells, genes_true=genes)


def _operand(X, dtype):
    P = packed_outer_products(X, triu_pairs(X.shape[1]))
    if dtype == "int8":
        return maskgram.quantize_pairs(P, axis=0)
    return P.to(torch.bfloat16), torch.ones(P.shape[1], device=X.device)


def _same(got, want, dtype):
    if dtype == "int8":
        assert torch.equal(got, want), float((got - want).abs().max())
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()) + 1e-30, err


@pytest.mark.parametrize("gene_block,n_gb", GEOMS)
@pytest.mark.parametrize("cells", [CELLS, 4096])
def test_b12_matches_plain(cuda, gene_block, n_gb, cells):
    genes = gene_block * n_gb
    words = _words(cells, gene_block, n_gb, 5, cuda)
    before = maskgram_cuda.LAUNCHES_UNPACK8
    got = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=gene_block,
                                              genes_pad=genes)
    assert maskgram_cuda.LAUNCHES_UNPACK8 == before + 1
    assert got.dtype == torch.int8 and got.shape == (cells, genes)
    assert torch.equal(got, maskbits.unpack_mask_bits_plain(
        words, gene_block=gene_block, genes_pad=genes))
    # into a reused buffer, every byte overwritten
    buf = torch.full((cells, genes), 7, dtype=torch.int8, device=cuda)
    assert maskbits.unpack_mask_bits(words, gene_block=gene_block,
                                     genes_pad=genes, out=buf) is buf
    assert torch.equal(buf, got)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("gene_block,n_gb", GEOMS)
@pytest.mark.parametrize("k", [5, 50, 100, 256, 300, 512])
def test_b13_matches_plain_and_b8(cuda, dtype, gene_block, n_gb, k):
    """B13 on a block of 1000 cells with P as the engine hands it over
    (int8 K-major, bf16 pair-padded) and contiguous: the plain version's
    bits on int8 (within the bf16 tolerance on bf16), the same bits twice
    and from either layout, and B8's bits on the words of the mask."""
    genes = gene_block * n_gb
    W = torch.rand((genes, k), device=cuda)
    words = _words(CELLS, gene_block, n_gb, 20, cuda)
    m8 = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=gene_block,
                                             genes_pad=genes)
    op, s = _operand(W, dtype)
    make = maskgram.kmajor_buffer if dtype == "int8" else maskgram.pair_buffer
    P = make(genes, op.shape[1], cuda)
    P.copy_(op)
    run = lambda P: maskgram_cuda.mask_packed_w_t_m8_cuda(  # noqa: E731
        P, s, m8, gene_block=gene_block)
    before = maskgram_cuda.LAUNCHES_MPW_M8
    got = run(P)
    assert maskgram_cuda.LAUNCHES_MPW_M8 == before + 1
    _same(got, maskgram.mask_packed_w_t_m8_plain(op, s, m8,
                                                 gene_block=gene_block),
          dtype)
    assert torch.equal(got, run(P))
    assert torch.equal(got, run(op))
    assert torch.equal(got, maskgram_cuda.mask_packed_w_t_bits_cuda(
        P, s, words, gene_block=gene_block))


@pytest.mark.parametrize("gene_block,n_gb", GEOMS + [(1720, 1)])
@pytest.mark.parametrize("cells", [CELLS, 2048, 33])
def test_b13_pass_matches_plain_and_b8_pass(cuda, gene_block, n_gb, cells):
    """B13's pass alone: the words of its plain version and of B8's pass on
    the words the mask was unpacked from (40 genes: rows that are not
    16-byte aligned, read byte by byte)."""
    genes = gene_block * n_gb
    words = _words(cells, gene_block, n_gb, 20, cuda)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gene_block,
                                         genes_pad=genes)
    before = maskgram_cuda.LAUNCHES_KPACK
    got = maskgram_cuda.pack_mask8_g_cuda(m8)
    assert maskgram_cuda.LAUNCHES_KPACK == before + 1
    assert torch.equal(got, maskgram.pack_mask8_g(m8))
    assert torch.equal(got, maskgram_cuda.pack_words_g_cuda(
        words, gene_block=gene_block, genes_pad=genes))


# (cells, scale_block): one group; four groups of 2048 (two 1024-cell
# sub-blocks each); three groups of 40 cells (sub-blocks of 40, no multiple
# of the 32-cell word); eight groups of 8 cells
B14_CELLS = [(1000, 1000), (8192, 2048), (120, 40), (64, 8)]


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("gene_block,n_gb", GEOMS)
@pytest.mark.parametrize("cells,scale_block", B14_CELLS)
def test_b14_matches_plain_and_b9(cuda, dtype, gene_block, n_gb, cells,
                                  scale_block):
    genes = gene_block * n_gb
    k = 20
    H = torch.rand((cells, k), device=cuda)
    ops, scales = zip(*[_operand(H[c0:c0 + scale_block], dtype)
                        for c0 in range(0, cells, scale_block)])
    op, s = torch.cat(ops), torch.stack(scales, dim=1).contiguous()
    words = _words(cells, gene_block, n_gb, 20, cuda)
    m8 = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=gene_block,
                                             genes_pad=genes)
    acc0 = torch.rand((op.shape[1], genes), device=cuda)
    before = maskgram_cuda.LAUNCHES_MPH_M8
    got = acc0.clone()
    # P in the engine's layout (int8 K-major, bf16 pair-padded)
    make = maskgram.kmajor_buffer if dtype == "int8" else maskgram.pair_buffer
    P = make(op.shape[0], op.shape[1], cuda)
    P.copy_(op)
    out = maskgram_cuda.mask_packed_h_t_m8_cuda(
        P, s, m8, got, gene_block=gene_block, scale_block=scale_block)
    assert out is got and maskgram_cuda.LAUNCHES_MPH_M8 == before + 1
    assert torch.equal(got, maskgram_cuda.mask_packed_h_t_m8_cuda(
        op, s, m8, acc0.clone(), gene_block=gene_block,
        scale_block=scale_block))
    _same(got, maskgram.mask_packed_h_t_m8_plain(
        op, s, m8, acc0.clone(), gene_block=gene_block,
        scale_block=scale_block), dtype)
    _same(got, maskgram_cuda.mask_packed_h_t_bits_cuda(
        op, s, words, acc0.clone(), gene_block=gene_block,
        scale_block=scale_block), dtype)


@pytest.mark.parametrize("k", [3, 100, 256, 300, 512])
def test_b14_ranks_equal_b9(cuda, k):
    """int8 B14 at every rank the wrappers take: the bits of plain B14 and
    of B9 on the words the mask was unpacked from."""
    op, s = _operand(torch.rand((1000, k), device=cuda), "int8")
    words = _words(1000, 256, 3, 20, cuda)
    m8 = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=256,
                                             genes_pad=768)
    acc0 = torch.rand((op.shape[1], 768), device=cuda)
    P = maskgram.kmajor_buffer(1000, op.shape[1], cuda)
    P.copy_(op)
    got = maskgram_cuda.mask_packed_h_t_m8_cuda(
        P, s[:, None], m8, acc0.clone(), gene_block=256)
    _same(got, maskgram.mask_packed_h_t_m8_plain(
        op, s[:, None], m8, acc0.clone(), gene_block=256), "int8")
    _same(got, maskgram_cuda.mask_packed_h_t_bits_cuda(
        P, s[:, None], words, acc0.clone(), gene_block=256), "int8")


@pytest.mark.parametrize("gene_block,n_gb", GEOMS + [(1720, 1)])
@pytest.mark.parametrize("cells", [CELLS, 8192, 33])
def test_b14_pass_matches_plain_and_b9_pass(cuda, gene_block, n_gb, cells):
    """B14's pass alone: the words of its plain version and of B9's pass on
    the words the mask was unpacked from."""
    genes = gene_block * n_gb
    words = _words(cells, gene_block, n_gb, 20, cuda)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gene_block,
                                         genes_pad=genes)
    before = maskgram_cuda.LAUNCHES_KPACK
    got = maskgram_cuda.pack_mask8_k_cuda(m8)
    assert maskgram_cuda.LAUNCHES_KPACK == before + 1
    assert torch.equal(got, maskgram.pack_mask8_k(m8))
    assert torch.equal(got, maskgram_cuda.pack_words_k_cuda(
        words, gene_block=gene_block, genes_pad=genes))


def test_m8_wrappers_refuse(cuda):
    words = _words(300, 256, 3, 20, cuda)
    m8 = maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=256,
                                             genes_pad=768)
    op, s = _operand(torch.rand((768, 5), device=cuda), "int8")
    with pytest.raises(ValueError, match="words"):
        # 33 gene blocks take two word groups: (300, 512) words
        maskgram_cuda.unpack_mask_bits_cuda(words, gene_block=256,
                                            genes_pad=33 * 256)
    with pytest.raises(ValueError, match="out"):
        maskgram_cuda.unpack_mask_bits_cuda(
            words, gene_block=256, genes_pad=768,
            out=torch.empty((300, 768), dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError, match="int8"):
        maskgram_cuda.mask_packed_w_t_m8_cuda(op, s, m8.bool(),
                                              gene_block=256)
    with pytest.raises(ValueError, match="is on"):
        maskgram_cuda.mask_packed_w_t_m8_cuda(op, s, m8.cpu(),
                                              gene_block=256)
    with pytest.raises(ValueError, match="B12"):
        maskgram_cuda.unpack_mask_bits_cuda(_words(2050, 256, 3, 20, cuda),
                                            gene_block=256, genes_pad=768)
    with pytest.raises(ValueError, match="8 cells"):
        maskgram_cuda.mask_packed_h_t_m8_cuda(
            torch.zeros((2050, s.shape[0]), dtype=torch.int8, device=cuda),
            s[:, None], torch.zeros((2050, 768), dtype=torch.int8,
                                    device=cuda),
            torch.zeros((s.shape[0], 768), device=cuda), gene_block=256,
            scale_block=2050)


def test_engine_mask8_route_on_card(cuda, monkeypatch):
    """The ELL engine's MASK8 route on the card (B12-B14, B5-B7, B2): its
    launches, the same bits as the card's bits route on int8, and the same
    route on the CPU (plain versions) from one W0."""
    import scipy.sparse as sp

    from singlet_tpu_torch.ops import bell, bell_cuda, nnls, nnls_cuda
    from singlet_tpu_torch.parallel import sharded_ell as tell

    rng = np.random.default_rng(13)
    A = sp.random(600, 2048, density=0.1, random_state=3, format="csc",
                  dtype=np.float32)
    w0 = rng.random((600, 6)).astype(np.float32)
    kw = dict(w_init=w0, tol=0.0, maxit=3, mask_seed=2, inv_density=10,
              trace_test_mse=1, overfit_threshold=1.0)
    gpu = tell.ShardedEllEngine(A, device="cuda", cell_block=256,
                                gene_block=256)
    bits = gpu.ard_fit(6, **kw)
    monkeypatch.setenv("SINGLET_TPU_MASK8", "1")
    counters = lambda: (  # noqa: E731
        maskgram_cuda.LAUNCHES_UNPACK8, maskgram_cuda.LAUNCHES_MPW_M8,
        maskgram_cuda.LAUNCHES_MPH_M8, bell_cuda.LAUNCHES_SPMM_BITS,
        bell_cuda.LAUNCHES_SPMM_T_BITS, bell_cuda.LAUNCHES_MSE_BITS,
        nnls_cuda.LAUNCHES_BATCHED, maskgram_cuda.LAUNCHES_MPW_BITS,
        maskgram_cuda.LAUNCHES_MPH_BITS, nnls.PLAIN_CALLS, bell.PLAIN_CALLS,
        maskgram.PLAIN_CALLS, maskbits.PLAIN_CALLS)
    c0 = counters()
    g = gpu.ard_fit(6, **kw)
    # 8 blocks of 256 cells, F = 8: per iteration one B12 and one B14 for
    # the one group, 8 B13, B5, B6 and B2, one B2 over all genes, one B7
    assert [b - a for a, b in zip(c0, counters())] == [
        3, 24, 3, 24, 24, 3, 27, 0, 0, 0, 0, 0, 0]
    for f in ("w", "h", "d", "test_mse", "iter", "tol", "score_overfit"):
        np.testing.assert_array_equal(getattr(g, f), getattr(bits, f),
                                      err_msg=f)
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    c = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                              gene_block=256).ard_fit(6, **kw)
    assert g.iter == c.iter
    np.testing.assert_allclose(g.test_mse, c.test_mse, rtol=5e-3)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=5e-3,
                                   atol=5e-4, err_msg=f)
