"""Kernels B5-B9 (``singlet_tpu_torch/ops/bell_cuda.py``,
``ops/maskgram_cuda.py``) on the card against their plain PyTorch versions
and against B3/B4, on the same inputs; and the ELL engine's bits route on
the card against the same route on the CPU.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_maskbits_cuda.py -q

Tolerances: B5 and B6 skip exactly the slots that masked B3 and B4 skip
and are otherwise the same code, so they must give the same bits. B8 and
B9 on int8 sum exact int32 partials and dequantize with the plain
version's single rounding, so they must give the same bits too, whatever
the layout of P and on a second run; on bf16 they sum float32 in another
order (max abs error <= 1e-5 * max |output|). B8's pass gives the words of
its plain version and of B10's hash pass, B9's those of B11's.
B7 sums in another order (rtol 2e-4, atol 1e-5, as tests/test_maskbits.py)
and counts exactly. The engine on the card against the CPU: rtol 5e-3,
atol 5e-4 with equal ``iter`` lists (the fit tests' tolerance).
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import bell, bell_cuda, maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
from singlet_tpu_torch.ops.maskbits import pack_mask_words
from singlet_tpu_torch.ops.rngmask import seed_pair

pytestmark = pytest.mark.cuda

CELLS = 1000          # no multiple of 32 or 128
OFFSET = 4096         # global id of the first cell
# (gene_block, n_gb): one word group, and 40 gene blocks (a second group)
GEOMS = [(256, 3), (32, 40)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B5-B9 have no CPU mode")
    return torch.device("cuda")


def _planes(width, cells, gene_block, n_gb, seed, device):
    """Random blocked-ELL planes (n_gb * width, cells): per (gene block,
    cell) a random count of distinct local ids in random slot order."""
    rng = np.random.default_rng(seed)
    order = np.argsort(rng.random((n_gb, cells, gene_block)), axis=2)
    li = order[:, :, :width].astype(np.int32)
    count = rng.integers(0, width + 1, (n_gb, cells, 1))
    live = np.arange(width)[None, None, :] < count
    li = np.where(live, li, -1)
    lv = np.where(live, rng.random(li.shape) + 0.1, 0.0)
    to2d = lambda x: np.ascontiguousarray(                     # noqa: E731
        x.transpose(0, 2, 1)).reshape(n_gb * width, cells)
    return (torch.as_tensor(to2d(li), device=device),
            torch.as_tensor(to2d(lv).astype(np.float32), device=device))


def _words(cells, gene_block, n_gb, inv, device, seed=77, offset=OFFSET):
    genes = gene_block * n_gb
    return pack_mask_words(
        seed_pair(seed), torch.arange(offset, offset + cells, device=device),
        genes_pad=genes, gene_block=gene_block, inv_density=inv,
        cells_true=offset + cells, genes_true=genes)


def _close(got, want, rel=1e-5):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()) + 1e-30, err


@pytest.mark.parametrize("gene_block,n_gb", GEOMS)
@pytest.mark.parametrize("width,k", [(8, 3), (32, 100), (40, 50), (32, 129),
                                     (32, 256), (8, 300), (16, 512)])
def test_b5_b6_equal_masked_b3_b4(cuda, gene_block, n_gb, width, k):
    width = min(width, gene_block)
    li, lv = _planes(width, CELLS, gene_block, n_gb, width + k, cuda)
    genes = gene_block * n_gb
    W = torch.rand((genes, k), device=cuda)
    H = torch.rand((CELLS, k), device=cuda)
    words = _words(CELLS, gene_block, n_gb, 20, cuda)
    seed = seed_pair(77)
    before = (bell_cuda.LAUNCHES_SPMM_BITS, bell_cuda.LAUNCHES_SPMM_T_BITS)
    b5 = bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                       gene_block=gene_block)
    b6 = bell_cuda.bell_spmm_t_bits_cuda(li, lv, H, words,
                                         gene_block=gene_block, n_gb=n_gb)
    # one launch each, at any k
    assert (bell_cuda.LAUNCHES_SPMM_BITS, bell_cuda.LAUNCHES_SPMM_T_BITS) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(b5, bell_cuda.bell_spmm_cuda(
        li, lv, W, seed, OFFSET, gene_block=gene_block, inv_density=20))
    assert torch.equal(b6, bell_cuda.bell_spmm_t_cuda(
        li, lv, H, seed, OFFSET, gene_block=gene_block, n_gb=n_gb,
        inv_density=20))
    _close(b5, bell.bell_spmm_bits_plain(li, lv, W, words,
                                         gene_block=gene_block))
    _close(b6, bell.bell_spmm_t_bits_plain(li, lv, H, words,
                                           gene_block=gene_block, n_gb=n_gb))


@pytest.mark.parametrize("gene_block,n_gb", GEOMS)
@pytest.mark.parametrize("k", [3, 50, 100, 224, 256, 300])
def test_b7_matches_plain(cuda, gene_block, n_gb, k):
    li, lv = _planes(24, CELLS, gene_block, n_gb, k, cuda)
    genes = gene_block * n_gb
    Wd = torch.rand((genes, k), device=cuda) / k
    H = torch.rand((CELLS, k), device=cuda)
    words = _words(CELLS, gene_block, n_gb, 5, cuda)
    before = bell_cuda.LAUNCHES_MSE_BITS
    got = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H,
                                       gene_block=gene_block)
    assert bell_cuda.LAUNCHES_MSE_BITS == before + 1
    want = bell.bell_mse_bits_plain(li, lv, words, Wd, H,
                                    gene_block=gene_block)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got, bell_cuda.bell_mse_bits_cuda(
        li, lv, words, Wd, H, gene_block=gene_block))


def test_b7_wide_gene_block_and_odd_cells(cuda):
    """B7 at B5's widest gene block (5,632, width 72, k up to 512) and at
    2049 cells (a tile past the cells): one launch, the plain version's
    counts and sums, the same bits twice."""
    G, n_gb, cells = 5632, 2, 2049
    li, lv = _planes(72, cells, G, n_gb, 5, cuda)
    words = _words(cells, G, n_gb, 20, cuda)
    for k in (3, 100, 512):
        Wd = torch.rand((G * n_gb, k), device=cuda) / k
        H = torch.rand((cells, k), device=cuda)
        before = bell_cuda.LAUNCHES_MSE_BITS
        got = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H,
                                           gene_block=G)
        assert bell_cuda.LAUNCHES_MSE_BITS == before + 1
        want = bell.bell_mse_bits_plain(li, lv, words, Wd, H, gene_block=G)
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), rtol=2e-4,
                                   atol=1e-5)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got, bell_cuda.bell_mse_bits_cuda(
            li, lv, words, Wd, H, gene_block=G))


def test_b7_takes_every_k_in_one_launch(cuda):
    """Every k in 1..512 is one launch with the plain version's counts and
    the same bits twice; its sums against the plain version at the plan's
    edges."""
    G, n_gb, cells = 64, 2, 45
    li, lv = _planes(8, cells, G, n_gb, 6, cuda)
    words = _words(cells, G, n_gb, 4, cuda)
    edges = {1, 31, 32, 33, 64, 65, 96, 97, 128, 129, 224, 256, 257, 300,
             384, 385, 511, 512}
    for k in range(1, bell_cuda.MAX_K_MSE + 1):
        Wd = torch.rand((G * n_gb, k), device=cuda) / k
        H = torch.rand((cells, k), device=cuda)
        before = bell_cuda.LAUNCHES_MSE_BITS
        got = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H,
                                           gene_block=G)
        assert bell_cuda.LAUNCHES_MSE_BITS == before + 1, k
        assert torch.equal(got, bell_cuda.bell_mse_bits_cuda(
            li, lv, words, Wd, H, gene_block=G)), k
        if k in edges:
            want = bell.bell_mse_bits_plain(li, lv, words, Wd, H,
                                            gene_block=G)
            assert torch.equal(got[1], want[1]), k
            np.testing.assert_allclose(got[0].cpu().numpy(),
                                       want[0].cpu().numpy(), rtol=2e-4,
                                       atol=1e-5, err_msg=str(k))


def _operand(X, dtype):
    P = packed_outer_products(X, triu_pairs(X.shape[1]))
    if dtype == "int8":
        return maskgram.quantize_pairs(P, axis=0)
    return P.to(torch.bfloat16), torch.ones(P.shape[1], device=X.device)


def _same(got, want, dtype):
    if dtype == "int8":
        assert torch.equal(got, want), float((got - want).abs().max())
    else:
        _close(got, want)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("gene_block,n_gb", GEOMS)
@pytest.mark.parametrize("k", [5, 50, 100, 256, 300, 512])
def test_b8_matches_plain(cuda, dtype, gene_block, n_gb, k):
    """B8 on a block of 1000 cells (an M tail) with P as the engine hands
    it over (int8 K-major, bf16 pair-padded) and contiguous: the plain
    version's bits on int8 (within the bf16 tolerance on bf16), the same
    bits twice and from either layout."""
    genes = gene_block * n_gb
    W = torch.rand((genes, k), device=cuda)
    words = _words(CELLS, gene_block, n_gb, 20, cuda)
    op, s = _operand(W, dtype)
    run = lambda P: maskgram_cuda.mask_packed_w_t_bits_cuda(  # noqa: E731
        P, s, words, gene_block=gene_block)
    before = maskgram_cuda.LAUNCHES_MPW_BITS
    got = run(_layout(op, "engine"))
    assert maskgram_cuda.LAUNCHES_MPW_BITS == before + 1
    want = maskgram.mask_packed_w_t_bits_plain(op, s, words,
                                               gene_block=gene_block)
    assert got.shape == (op.shape[1], CELLS)
    _same(got, want, dtype)
    assert torch.equal(got, run(_layout(op, "engine")))
    assert torch.equal(got, run(op))


@pytest.mark.parametrize("gene_block,n_gb", GEOMS + [(512, 3), (1720, 1),
                                                     (8, 5)])
@pytest.mark.parametrize("cells", [1000, 2048, 33])
def test_b8_pass_matches_plain_and_hash_pass(cuda, gene_block, n_gb, cells):
    """B8's pass alone (the ballot transpose for gene_block % 32 == 0, a
    load per bit otherwise): the words of its plain version, and of B10's
    hash pass for the same seed and cells."""
    genes = gene_block * n_gb
    words = _words(cells, gene_block, n_gb, 20, cuda)
    before = maskgram_cuda.LAUNCHES_KPACK
    got = maskgram_cuda.pack_words_g_cuda(words, gene_block=gene_block,
                                          genes_pad=genes)
    assert maskgram_cuda.LAUNCHES_KPACK == before + 1
    assert torch.equal(got, maskgram.pack_words_g(
        words, gene_block=gene_block, genes_pad=genes))
    ids = torch.arange(OFFSET, OFFSET + cells, device=cuda)
    assert torch.equal(got, maskgram_cuda.pack_mask_k_cuda(
        seed_pair(77), ids, genes, gene_rows=False, inv_density=20,
        cells_true=OFFSET + cells, genes_true=genes))


# (cells, scale_block): one group (one sub-block of 1000 cells, which ends
# inside a 32-cell word); four groups of 2048 (two 1024-cell sub-blocks
# each); three groups of 40 cells (sub-blocks of 40); eight groups of 8
# cells (four sub-blocks per word); three groups of 1000 cells (sub-blocks
# of 8: 3000 halves to 8)
B9_CELLS = [(1000, 1000), (8192, 2048), (120, 40), (64, 8), (3000, 1000)]
# (gene_block, n_gb) of B9: GEOMS, gene_block 512, and 1720 genes (no
# multiple of the GEMM's 128-gene tile)
B9_GEOMS = GEOMS + [(512, 3), (1720, 1)]


def _group_operand(cells, scale_block, k, dtype, device):
    """The engine's batched B9/B14 operand: per quantization group of
    ``scale_block`` cells its own packed products, stacked contiguous,
    and the (np, groups) scales."""
    H = torch.rand((cells, k), device=device)
    ops, scales = zip(*[_operand(H[c0:c0 + scale_block], dtype)
                        for c0 in range(0, cells, scale_block)])
    return torch.cat(ops), torch.stack(scales, dim=1).contiguous()


def _layout(op, how):
    """``op`` contiguous, as the engine hands it over (int8: the transpose
    of rows 16 bytes apart; bf16: pair-padded rows), or (int8) the
    transpose of rows whose pitch is no multiple of 16, which the wrapper
    must copy."""
    if how == "contiguous":
        return op
    if how == "engine":
        make = maskgram.kmajor_buffer if op.dtype == torch.int8 \
            else maskgram.pair_buffer
        buf = make(op.shape[0], op.shape[1], op.device)
    else:
        buf = torch.empty((op.shape[1], op.shape[0] + 1), dtype=op.dtype,
                          device=op.device)[:, :op.shape[0]].T
    buf.copy_(op)
    return buf


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("gene_block,n_gb", B9_GEOMS)
@pytest.mark.parametrize("cells,scale_block", B9_CELLS)
def test_b9_matches_plain(cuda, dtype, gene_block, n_gb, cells,
                          scale_block):
    genes = gene_block * n_gb
    k = 20
    op, s = _group_operand(cells, scale_block, k, dtype, cuda)
    words = _words(cells, gene_block, n_gb, 20, cuda)
    acc0 = torch.rand((op.shape[1], genes), device=cuda)
    before = maskgram_cuda.LAUNCHES_MPH_BITS
    got = acc0.clone()
    out = maskgram_cuda.mask_packed_h_t_bits_cuda(
        _layout(op, "engine"), s, words, got, gene_block=gene_block,
        scale_block=scale_block)
    assert out is got and maskgram_cuda.LAUNCHES_MPH_BITS == before + 1
    want = maskgram.mask_packed_h_t_bits_plain(
        op, s, words, acc0.clone(), gene_block=gene_block,
        scale_block=scale_block)
    _same(got, want, dtype)
    # the same bits twice
    again = maskgram_cuda.mask_packed_h_t_bits_cuda(
        _layout(op, "engine"), s, words, acc0.clone(), gene_block=gene_block,
        scale_block=scale_block)
    assert torch.equal(got, again)
    if dtype == "int8" and maskgram.b9_sub_block(
            cells, scale_block) == maskgram.b9_sub_block(scale_block,
                                                         scale_block):
        # batched = group by group, bit for bit, where both sum the same
        # sub-blocks (3000 cells in groups of 1000 take sub-blocks of 8,
        # one group alone sub-blocks of 1000)
        seq = acc0.clone()
        for f, c0 in enumerate(range(0, cells, scale_block)):
            sl = slice(c0, c0 + scale_block)
            maskgram_cuda.mask_packed_h_t_bits_cuda(
                op[sl], s[:, f:f + 1].contiguous(), words[sl], seq,
                gene_block=gene_block)
        assert torch.equal(got, seq)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("k", [3, 100, 256, 300, 512])
def test_b9_ranks(cuda, dtype, k):
    """Every rank the wrappers take (np up to 131,328 pairs, 1027 pair
    tiles), over two quantization groups of 1024 cells."""
    op, s = _group_operand(2048, 1024, k, dtype, cuda)
    words = _words(2048, 256, 3, 20, cuda)
    acc0 = torch.rand((op.shape[1], 768), device=cuda)
    got = maskgram_cuda.mask_packed_h_t_bits_cuda(
        _layout(op, "engine"), s, words, acc0.clone(), gene_block=256,
        scale_block=1024)
    _same(got, maskgram.mask_packed_h_t_bits_plain(
        op, s, words, acc0.clone(), gene_block=256, scale_block=1024), dtype)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("how", ["contiguous", "engine", "odd_pitch"])
def test_b9_operand_layouts(cuda, dtype, how):
    """P contiguous, as the engine hands it over, or in a layout the
    wrapper must copy: the bits of the engine's layout (int8), or within
    the bf16 tolerance of the plain version."""
    op, s = _group_operand(2048, 1024, 100, dtype, cuda)
    words = _words(2048, 512, 4, 20, cuda)
    acc0 = torch.rand((op.shape[1], 2048), device=cuda)
    run = lambda P: maskgram_cuda.mask_packed_h_t_bits_cuda(  # noqa: E731
        P, s, words, acc0.clone(), gene_block=512, scale_block=1024)
    got = run(_layout(op, how))
    _same(got, maskgram.mask_packed_h_t_bits_plain(
        op, s, words, acc0.clone(), gene_block=512, scale_block=1024), dtype)
    assert torch.equal(got, run(_layout(op, "engine")))


@pytest.mark.parametrize("gene_block,n_gb", B9_GEOMS)
@pytest.mark.parametrize("cells", [1000, 8192, 33])
def test_b9_pass_matches_plain_and_hash_pass(cuda, gene_block, n_gb, cells):
    """B9's pass alone: the words of its plain version, and of B11's hash
    pass for the same seed and cells."""
    genes = gene_block * n_gb
    words = _words(cells, gene_block, n_gb, 20, cuda)
    before = maskgram_cuda.LAUNCHES_KPACK
    got = maskgram_cuda.pack_words_k_cuda(words, gene_block=gene_block,
                                          genes_pad=genes)
    assert maskgram_cuda.LAUNCHES_KPACK == before + 1
    assert torch.equal(got, maskgram.pack_words_k(
        words, gene_block=gene_block, genes_pad=genes))
    ids = torch.arange(OFFSET, OFFSET + cells, device=cuda)
    assert torch.equal(got, maskgram_cuda.pack_mask_k_cuda(
        seed_pair(77), ids, genes, gene_rows=True, inv_density=20,
        cells_true=OFFSET + cells, genes_true=genes))


def test_wrappers_refuse(cuda):
    li, lv = _planes(8, 300, 256, 3, 4, cuda)
    W = torch.rand((768, 5), device=cuda)
    words = _words(300, 256, 3, 20, cuda)
    with pytest.raises(TypeError, match="int32"):
        bell_cuda.bell_spmm_bits_cuda(li, lv, W, words.long(),
                                      gene_block=256)
    with pytest.raises(ValueError, match="contiguous"):
        bell_cuda.bell_spmm_bits_cuda(li, lv, W, words[:200],
                                      gene_block=256)
    with pytest.raises(ValueError, match="is on"):
        bell_cuda.bell_mse_bits_cuda(li, lv, words.cpu(), W,
                                     torch.rand((300, 5), device=cuda),
                                     gene_block=256)
    op, s = _operand(W, "int8")
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        maskgram_cuda.mask_packed_w_t_bits_cuda(op.float(), s, words,
                                                gene_block=256)
    # 2000 cells in groups of 1000 sum sub-blocks of 16 cells, which would
    # straddle the groups
    with pytest.raises(ValueError, match="straddle"):
        maskgram_cuda.mask_packed_h_t_bits_cuda(
            torch.zeros((2000, s.shape[0]), dtype=torch.int8, device=cuda),
            torch.ones((s.shape[0], 2), device=cuda),
            _words(2000, 256, 3, 20, cuda),
            torch.zeros((s.shape[0], 768), device=cuda), gene_block=256,
            scale_block=1000)
    with pytest.raises(ValueError, match="8 cells"):
        maskgram_cuda.mask_packed_h_t_bits_cuda(
            torch.zeros((2050, s.shape[0]), dtype=torch.int8, device=cuda),
            s[:, None], _words(2050, 256, 3, 20, cuda),
            torch.zeros((s.shape[0], 768), device=cuda), gene_block=256,
            scale_block=2050)


def test_engine_bits_route_on_card_matches_cpu(cuda, monkeypatch):
    """The ELL engine's default masked route on the card (B5-B9, B2), and
    the same route on the CPU (plain versions), from one W0."""
    import scipy.sparse as sp

    from singlet_tpu_torch.ops import nnls, nnls_cuda
    from singlet_tpu_torch.parallel import sharded_ell as tell

    rng = np.random.default_rng(13)
    A = sp.random(600, 2048, density=0.1, random_state=3, format="csc",
                  dtype=np.float32)
    w0 = rng.random((600, 6)).astype(np.float32)
    kw = dict(w_init=w0, tol=0.0, maxit=3, mask_seed=2, inv_density=10,
              trace_test_mse=1, overfit_threshold=1.0)
    gpu = tell.ShardedEllEngine(A, device="cuda", cell_block=256,
                                gene_block=256)
    counters = lambda: (  # noqa: E731
        bell_cuda.LAUNCHES_SPMM_BITS, bell_cuda.LAUNCHES_SPMM_T_BITS,
        bell_cuda.LAUNCHES_MSE_BITS, maskgram_cuda.LAUNCHES_MPW_BITS,
        maskgram_cuda.LAUNCHES_MPH_BITS, nnls_cuda.LAUNCHES_BATCHED,
        bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T,
        nnls.PLAIN_CALLS, bell.PLAIN_CALLS, maskgram.PLAIN_CALLS)
    c0 = counters()
    g = gpu.ard_fit(6, **kw)
    # 8 blocks of 256 cells, F = 8: per iteration 8 B5, B6, B8 and B2, one
    # B9 flush, one B2 over all genes, one B7 test MSE
    assert [b - a for a, b in zip(c0, counters())] == [
        24, 24, 3, 24, 3, 27, 0, 0, 0, 0, 0]
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    c = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                              gene_block=256).ard_fit(6, **kw)
    assert g.iter == c.iter
    np.testing.assert_allclose(g.test_mse, c.test_mse, rtol=5e-3)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=5e-3,
                                   atol=5e-4, err_msg=f)
