"""Kernels B10 and B11 (``singlet_tpu_torch/ops/maskgram_cuda.py``
``mask_packed_w_t_cuda`` / ``mask_packed_h_t_cuda``, source
``csrc/maskgram_hash.cu``) on the card against their plain PyTorch versions
and against bf16 B8/B9 fed the packed words of the same seed; their hash
pass alone (``pack_mask_k_cuda``) against its plain version; and the ELL
engine's hash route and checkpointed fit on the card.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_maskgram_hash_cuda.py -q

Tolerances: against the plain versions and against B8/B9 the sums run in
another order (max abs error <= 1e-5 * max |output|): B10/B11 sum all of a
call's genes or cells in one float32 accumulator, B8 and the plain B10 one
partial per gene block, B9 and the plain B11 one per sub-block of 1024
cells. The same inputs give the same bits twice, whether P is contiguous
or a view of a padded buffer. The hash pass gives the plain version's
words bit for bit. The engine on the card against the CPU: rtol 5e-3,
atol 5e-4 with equal ``iter`` lists (the fit tests' tolerance); a
resumed checkpointed fit on the card equals the uninterrupted one bit for
bit.
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
from singlet_tpu_torch.ops.maskbits import pack_mask_words
from singlet_tpu_torch.ops.rngmask import seed_pair

pytestmark = pytest.mark.cuda

# (cells, offset, gene_block, n_gb, cells_true, genes_true): one word group
# unclamped; 40 gene blocks (a second word group) with both clamps; 2048
# cells (B11: two sub-blocks of 1024) at a global offset. 1000 and 300
# cells are no multiple of the kernels' K stage (128) and 300 of a word
# (32); k = 300 (45,150 pairs) spans 353 pair tiles
GEOMS = [(1000, 4096, 256, 3, 5096, 768),
         (300, 12345, 32, 40, 12345 + 250, 1280 - 17),
         (2048, 262144, 512, 4, 300000, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B10/B11 have no CPU mode")
    return torch.device("cuda")


def _close(got, want, rel=1e-5):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()) + 1e-30, err


def _inputs(cuda, cells, offset, gene_block, n_gb, cells_true, genes_true,
            k, seed):
    genes = gene_block * n_gb
    gen = torch.Generator(device=cuda).manual_seed(k + cells)
    iu = triu_pairs(k)
    Pw = packed_outer_products(
        torch.rand((genes, k), generator=gen, device=cuda), iu)
    Ph = packed_outer_products(
        torch.rand((cells, k), generator=gen, device=cuda), iu)
    ids = torch.arange(offset, offset + cells, device=cuda)
    words = pack_mask_words(seed_pair(seed), ids, genes_pad=genes,
                            gene_block=gene_block, inv_density=20,
                            cells_true=cells_true, genes_true=genes_true)
    kw = dict(gene_block=gene_block, inv_density=20, cells_true=cells_true,
              genes_true=genes_true)
    acc0 = torch.rand((Pw.shape[1], genes), generator=gen, device=cuda)
    return Pw, Ph, ids, words, kw, acc0


def _padded(P):
    """P in bf16 as the engine hands it over: the [:, :np] view of a buffer
    whose pair axis is padded to a multiple of 64."""
    view = maskgram.pair_buffer(P.shape[0], P.shape[1], P.device)
    view.copy_(P)
    return view


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("k", [5, 50, 100, 300])
def test_b10_matches_plain_and_b8(cuda, geom, k):
    Pw, _, ids, words, kw, _ = _inputs(cuda, *geom, k=k, seed=77)
    seed = seed_pair(77)
    before = maskgram_cuda.LAUNCHES_MPW_HASH
    got = maskgram_cuda.mask_packed_w_t_cuda(Pw, seed, ids, **kw)
    again = maskgram_cuda.mask_packed_w_t_cuda(Pw.to(torch.bfloat16), seed,
                                               ids.to(torch.int32), **kw)
    view = maskgram_cuda.mask_packed_w_t_cuda(_padded(Pw), seed, ids, **kw)
    assert maskgram_cuda.LAUNCHES_MPW_HASH == before + 3
    assert torch.equal(got, again) and torch.equal(got, view)
    _close(got, maskgram.mask_packed_w_t_plain(Pw, seed, ids, **kw))
    b8 = maskgram_cuda.mask_packed_w_t_bits_cuda(
        Pw.to(torch.bfloat16), None, words, gene_block=kw["gene_block"])
    _close(got, b8)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("k", [5, 50, 100, 300])
def test_b11_matches_plain_and_b9(cuda, geom, k):
    _, Ph, ids, words, kw, acc0 = _inputs(cuda, *geom, k=k, seed=29)
    seed = seed_pair(29)
    before = maskgram_cuda.LAUNCHES_MPH_HASH
    got = acc0.clone()
    out = maskgram_cuda.mask_packed_h_t_cuda(Ph, seed, ids, got, **kw)
    assert out is got and maskgram_cuda.LAUNCHES_MPH_HASH == before + 1
    again = maskgram_cuda.mask_packed_h_t_cuda(_padded(Ph), seed, ids,
                                               acc0.clone(), **kw)
    assert torch.equal(got, again)
    _close(got, maskgram.mask_packed_h_t_plain(Ph, seed, ids, acc0.clone(),
                                               **kw))
    b9 = maskgram_cuda.mask_packed_h_t_bits_cuda(
        Ph.to(torch.bfloat16), None, words, acc0.clone(),
        gene_block=kw["gene_block"])
    _close(got, b9)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("gene_rows", [False, True])
def test_hash_pass_matches_plain(cuda, geom, gene_rows):
    """The hash pass of B10 (words per cell) and B11 (words per gene) gives
    ``pack_mask_k``'s words bit for bit, clamps and zero tails included."""
    cells, offset, gene_block, n_gb, cells_true, genes_true = geom
    ids = torch.arange(offset, offset + cells, device=cuda)
    kw = dict(gene_rows=gene_rows, inv_density=20, cells_true=cells_true,
              genes_true=genes_true)
    before = maskgram_cuda.LAUNCHES_HASH_K
    got = maskgram_cuda.pack_mask_k_cuda(seed_pair(5), ids,
                                         gene_block * n_gb, **kw)
    assert maskgram_cuda.LAUNCHES_HASH_K == before + 1
    assert torch.equal(got, maskgram.pack_mask_k(seed_pair(5), ids,
                                                 gene_block * n_gb, **kw))


def test_hash_wrappers_refuse(cuda):
    Pw, Ph, ids, _, kw, acc0 = _inputs(cuda, *GEOMS[0], k=5, seed=1)
    seed = seed_pair(1)
    with pytest.raises(ValueError, match="is on"):
        maskgram_cuda.mask_packed_w_t_cuda(Pw, seed, ids.cpu(), **kw)
    with pytest.raises(ValueError, match="gene_block"):
        maskgram_cuda.mask_packed_w_t_cuda(Pw, seed, ids,
                                           **dict(kw, gene_block=500))
    with pytest.raises(ValueError, match="inv_density"):
        maskgram_cuda.mask_packed_w_t_cuda(Pw, seed, ids,
                                           **dict(kw, inv_density=0))
    with pytest.raises(ValueError, match="cell ids"):
        maskgram_cuda.mask_packed_h_t_cuda(Ph, seed, ids[:10], acc0, **kw)
    with pytest.raises(ValueError, match="8 cells"):
        maskgram_cuda.mask_packed_h_t_cuda(
            torch.zeros((2050, Ph.shape[1]), device=cuda), seed,
            torch.arange(2050, device=cuda), acc0, **kw)


def _operand():
    import scipy.sparse as sp

    A = sp.random(600, 2048, density=0.1, random_state=3, format="csc",
                  dtype=np.float32)
    A.data = np.abs(A.data) + 0.1
    return A


def test_engine_hash_route_on_card_matches_cpu(cuda, monkeypatch):
    """The ELL engine's hash route on the card (B3, B4, B10, B11, B2) and
    the same route on the CPU (plain versions), from one W0."""
    from singlet_tpu_torch.ops import bell, bell_cuda, nnls, nnls_cuda
    from singlet_tpu_torch.parallel import sharded_ell as tell

    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", "hash")
    A = _operand()
    w0 = np.random.default_rng(13).random((600, 6)).astype(np.float32)
    kw = dict(w_init=w0, tol=0.0, maxit=3, mask_seed=2, inv_density=10,
              trace_test_mse=1, overfit_threshold=1.0)
    gpu = tell.ShardedEllEngine(A, device="cuda", cell_block=256,
                                gene_block=256)
    counters = lambda: (  # noqa: E731
        bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T,
        maskgram_cuda.LAUNCHES_MPW_HASH, maskgram_cuda.LAUNCHES_MPH_HASH,
        nnls_cuda.LAUNCHES_BATCHED, bell_cuda.LAUNCHES_SPMM_BITS,
        maskgram_cuda.LAUNCHES_MPW_BITS, nnls.PLAIN_CALLS, bell.PLAIN_CALLS,
        maskgram.PLAIN_CALLS)
    c0 = counters()
    g = gpu.ard_fit(6, **kw)
    # 8 blocks of 256 cells: per iteration 8 B3, B4, B10, B11 and B2, one
    # B2 over all genes; the test MSE is the hashed f32 one
    assert [b - a for a, b in zip(c0, counters())] == [
        24, 24, 24, 24, 27, 0, 0, 0, 0, 0]
    monkeypatch.setattr(tell, "_kernel_device", lambda device: True)
    c = tell.ShardedEllEngine(A, device="cpu", cell_block=256,
                              gene_block=256).ard_fit(6, **kw)
    assert g.iter == c.iter
    np.testing.assert_allclose(g.test_mse, c.test_mse, rtol=5e-3)
    for f in ("w", "h", "d"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=5e-3,
                                   atol=5e-4, err_msg=f)


def test_engine_checkpoint_resume_on_card(cuda, tmp_path):
    """A checkpointed ``ard_fit`` on the card's default mode (the hash
    route), stopped and resumed, equals the uninterrupted one bit for
    bit."""
    from singlet_tpu_torch.checkpoint import CheckpointManager
    from singlet_tpu_torch.parallel import sharded_ell as tell

    A = _operand()
    w0 = np.random.default_rng(14).random((600, 6)).astype(np.float32)
    eng = tell.ShardedEllEngine(A, device="cuda", cell_block=256,
                                gene_block=256)
    kw = dict(w_init=w0, tol=0.0, mask_seed=2, inv_density=10,
              trace_test_mse=1, overfit_threshold=1.0)
    before = maskgram_cuda.LAUNCHES_MPW_HASH
    full = eng.ard_fit(6, maxit=4, checkpoint=CheckpointManager(
        str(tmp_path / "full"), every=1), **kw)
    assert maskgram_cuda.LAUNCHES_MPW_HASH == before + 4 * 8
    mgr = CheckpointManager(str(tmp_path / "cut"), every=1)
    eng.ard_fit(6, maxit=2, checkpoint=mgr, **kw)
    res = eng.ard_fit(6, maxit=4, checkpoint=mgr, **kw)
    assert res.iter == full.iter and res.test_mse == full.test_mse
    for f in ("w", "h", "d"):
        np.testing.assert_array_equal(getattr(res, f), getattr(full, f))
