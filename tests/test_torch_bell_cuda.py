"""Kernels B3 and B4 (``singlet_tpu_torch/ops/bell_cuda.py``) on the card
against their plain PyTorch versions on the same inputs, and B6 against
hashed B4 at the shapes where B4's plan splits its work.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_bell_cuda.py -q

Tolerance: max abs error <= 1e-5 * max |output|. Kernel and plain version
form the same float32 products and differ only in the order of the sums
(the plain version densifies each gene block and multiplies densely). With
0/1 values and a 0/1 W every sum is a small integer, exact in any order,
so there the two must be equal: one wrong mask bit would show. B6 skips
exactly the slots that hashed B4 skips and is otherwise the same code, so
the two must give the same bits.
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import bell, bell_cuda
from singlet_tpu_torch.ops.maskbits import pack_mask_words
from singlet_tpu_torch.ops.rngmask import seed_pair

pytestmark = pytest.mark.cuda

GENE_BLOCK = 256
N_GB = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B3 and B4 have no CPU "
                    "mode")
    return torch.device("cuda")


def _planes(width, cells, seed, device, ones=False):
    """Random blocked-ELL planes (N_GB * width, cells): per (gene block,
    cell) a random count of distinct local ids in random slot order, the
    rest pad (-1 / 0)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(rng.random((N_GB, cells, GENE_BLOCK)), axis=2)
    li = order[:, :, :width].astype(np.int32)
    count = rng.integers(0, width + 1, (N_GB, cells, 1))
    live = np.arange(width)[None, None, :] < count
    li = np.where(live, li, -1)
    lv = np.where(live, 1.0 if ones else rng.random(li.shape) + 0.1, 0.0)
    to2d = lambda x: np.ascontiguousarray(                     # noqa: E731
        x.transpose(0, 2, 1)).reshape(N_GB * width, cells)
    return (torch.as_tensor(to2d(li), device=device),
            torch.as_tensor(to2d(lv).astype(np.float32), device=device))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()) + 1e-30, err


CASES = [(w, k) for w in (8, 32, 136) for k in (3, 50, 100, 224)] + [
    (32, 256), (8, 300)]
CELLS = 1000      # no multiple of 256


@pytest.mark.parametrize("width,k", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_b3_matches_plain(cuda, width, k, masked):
    li, lv = _planes(width, CELLS, width + k, cuda)
    W = torch.rand((N_GB * GENE_BLOCK, k), device=cuda)
    seed = seed_pair(77) if masked else None
    before = bell_cuda.LAUNCHES_SPMM
    got = bell_cuda.bell_spmm_cuda(li, lv, W, seed, 4096,
                                   gene_block=GENE_BLOCK, inv_density=20)
    # one launch at any k
    assert bell_cuda.LAUNCHES_SPMM == before + 1
    want = bell.bell_spmm_plain(li, lv, W, seed, 4096,
                                gene_block=GENE_BLOCK, inv_density=20)
    _close(got, want)
    again = bell_cuda.bell_spmm_cuda(li, lv, W, seed, 4096,
                                     gene_block=GENE_BLOCK, inv_density=20)
    assert torch.equal(got, again)


@pytest.mark.parametrize("width,k", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_b4_matches_plain(cuda, width, k, masked):
    li, lv = _planes(width, CELLS, 2 * width + k, cuda)
    H = torch.rand((CELLS, k), device=cuda)
    seed = seed_pair(78) if masked else None
    before = bell_cuda.LAUNCHES_SPMM_T
    got = bell_cuda.bell_spmm_t_cuda(li, lv, H, seed, 123,
                                     gene_block=GENE_BLOCK, n_gb=N_GB,
                                     inv_density=20)
    assert bell_cuda.LAUNCHES_SPMM_T == before + 1
    want = bell.bell_spmm_t_plain(li, lv, H, seed, 123,
                                  gene_block=GENE_BLOCK, n_gb=N_GB,
                                  inv_density=20)
    _close(got, want)
    again = bell_cuda.bell_spmm_t_cuda(li, lv, H, seed, 123,
                                       gene_block=GENE_BLOCK, n_gb=N_GB,
                                       inv_density=20)
    assert torch.equal(got, again)


@pytest.mark.parametrize("k,chunk", [(200, 64), (224, 100), (256, 224),
                                     (300, 128)])
def test_b3_chunks_give_the_bits_of_one_launch(cuda, k, chunk):
    """A column slice of W launched alone gives the bits of those columns
    of the full launch, in B3 and in B5: each output column is one thread's
    sum over the cell's live slots in slot order, whatever the other
    columns and however the plan tiles them. Every call is one launch."""
    from singlet_tpu_torch.ops.maskbits import pack_mask_words

    li, lv = _planes(32, CELLS, k, cuda)
    W = torch.rand((N_GB * GENE_BLOCK, k), device=cuda)
    seed = seed_pair(5)
    kw = dict(gene_block=GENE_BLOCK, inv_density=20)
    before = (bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_BITS)
    whole = bell_cuda.bell_spmm_cuda(li, lv, W, seed, 64, **kw)
    assert bell_cuda.LAUNCHES_SPMM == before[0] + 1
    for c0 in range(0, k, chunk):
        assert torch.equal(whole[:, c0:c0 + chunk], bell_cuda.bell_spmm_cuda(
            li, lv, W[:, c0:c0 + chunk].contiguous(), seed, 64, **kw))
    words = pack_mask_words(seed, torch.arange(64, 64 + CELLS, device=cuda),
                            genes_pad=N_GB * GENE_BLOCK,
                            gene_block=GENE_BLOCK, inv_density=20,
                            cells_true=64 + CELLS,
                            genes_true=N_GB * GENE_BLOCK)
    before = bell_cuda.LAUNCHES_SPMM_BITS
    b5 = bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                       gene_block=GENE_BLOCK)
    assert bell_cuda.LAUNCHES_SPMM_BITS == before + 1
    assert torch.equal(b5, whole)
    for c0 in range(0, k, chunk):
        assert torch.equal(b5[:, c0:c0 + chunk], bell_cuda.bell_spmm_bits_cuda(
            li, lv, W[:, c0:c0 + chunk].contiguous(), words,
            gene_block=GENE_BLOCK))
    _close(b5, bell.bell_spmm_bits_plain(li, lv, W, words,
                                         gene_block=GENE_BLOCK))


@pytest.mark.parametrize("inv_density", [1, 3, 20])
def test_mask_bits_exact_on_indicator(cuda, inv_density):
    """Values 1.0 and W / H 0/1 indicators: integer sums, so kernel and
    plain version must be equal, mask bit for mask bit."""
    li, lv = _planes(32, CELLS, 5, cuda, ones=True)
    genes = N_GB * GENE_BLOCK
    k = 7
    W = torch.zeros((genes, k), device=cuda)
    W[torch.arange(genes), torch.arange(genes) % k] = 1.0
    H = torch.zeros((CELLS, k), device=cuda)
    H[torch.arange(CELLS), torch.arange(CELLS) % k] = 1.0
    seed = seed_pair(2 ** 40 + 3)
    kw = dict(gene_block=GENE_BLOCK, inv_density=inv_density)
    assert torch.equal(
        bell_cuda.bell_spmm_cuda(li, lv, W, seed, 99, **kw),
        bell.bell_spmm_plain(li, lv, W, seed, 99, **kw))
    assert torch.equal(
        bell_cuda.bell_spmm_t_cuda(li, lv, H, seed, 99, n_gb=N_GB, **kw),
        bell.bell_spmm_t_plain(li, lv, H, seed, 99, n_gb=N_GB, **kw))


def test_column_slice_of_planes(cuda):
    """The engine passes column slices of its planes (row stride > cells)."""
    li, lv = _planes(16, 2048, 9, cuda)
    W = torch.rand((N_GB * GENE_BLOCK, 20), device=cuda)
    H = torch.rand((512, 20), device=cuda)
    seed = seed_pair(4)
    sl = slice(1024, 1536)
    got = bell_cuda.bell_spmm_cuda(li[:, sl], lv[:, sl], W, seed, 1024,
                                   gene_block=GENE_BLOCK)
    want = bell.bell_spmm_plain(li[:, sl], lv[:, sl], W, seed, 1024,
                                gene_block=GENE_BLOCK)
    _close(got, want)
    got_t = bell_cuda.bell_spmm_t_cuda(li[:, sl], lv[:, sl], H, seed, 1024,
                                       gene_block=GENE_BLOCK, n_gb=N_GB)
    want_t = bell.bell_spmm_t_plain(li[:, sl], lv[:, sl], H, seed, 1024,
                                    gene_block=GENE_BLOCK, n_gb=N_GB)
    _close(got_t, want_t)


def _planes_g(n_gb, gene_block, width, cells, seed, device, dup_cell=None):
    """Random planes (n_gb * width, cells) of any gene block: per (gene
    block, cell) a random count of distinct local ids in random slot order;
    with ``dup_cell``, that cell's slot 1 repeats its slot 0 in every gene
    block (a non-canonical operand)."""
    rng = np.random.default_rng(seed)
    li = np.stack([np.stack([rng.choice(gene_block, width, replace=False)
                             for _ in range(cells)]) for _ in range(n_gb)])
    count = rng.integers(0, width + 1, (n_gb, cells, 1))
    if dup_cell is not None:
        count[:, dup_cell] = width
        li[:, dup_cell, 1] = li[:, dup_cell, 0]
    live = np.arange(width)[None, None, :] < count
    li = np.where(live, li, -1).astype(np.int32)
    lv = np.where(live, rng.random(li.shape) + 0.1, 0.0).astype(np.float32)
    to2d = lambda x: np.ascontiguousarray(                     # noqa: E731
        x.transpose(0, 2, 1)).reshape(n_gb * width, cells)
    return (torch.as_tensor(to2d(li), device=device),
            torch.as_tensor(to2d(lv), device=device))


def _check_b4_b6(li, lv, H, gene_block, n_gb, offset):
    """B4 plain and hashed within 1e-5 x max |output| of the plain version
    and the same bits twice (one launch a call); B6 on the packed words of
    the same cells the bits of hashed B4; values 1.0 with a 0/1 indicator
    H equal to the plain version, plain and hashed."""
    cells, k = H.shape
    genes = n_gb * gene_block
    seed = seed_pair(78)
    kw = dict(gene_block=gene_block, n_gb=n_gb, inv_density=20)
    for s in (None, seed):
        before = bell_cuda.LAUNCHES_SPMM_T
        got = bell_cuda.bell_spmm_t_cuda(li, lv, H, s, offset, **kw)
        assert bell_cuda.LAUNCHES_SPMM_T == before + 1
        _close(got, bell.bell_spmm_t_plain(li, lv, H, s, offset, **kw))
        assert torch.equal(got, bell_cuda.bell_spmm_t_cuda(li, lv, H, s,
                                                           offset, **kw))
    words = pack_mask_words(seed, torch.arange(offset, offset + cells,
                                               device=H.device),
                            genes_pad=genes, gene_block=gene_block,
                            inv_density=20, cells_true=offset + cells,
                            genes_true=genes)
    b6 = bell_cuda.bell_spmm_t_bits_cuda(li, lv, H, words,
                                         gene_block=gene_block, n_gb=n_gb)
    assert torch.equal(b6, got)
    li = li.contiguous()
    ones = torch.where(li >= 0, 1.0, 0.0)
    Hi = torch.zeros_like(H)
    Hi[torch.arange(cells), torch.arange(cells) % k] = 1.0
    for s in (None, seed):
        assert torch.equal(
            bell_cuda.bell_spmm_t_cuda(li, ones, Hi, s, offset, **kw),
            bell.bell_spmm_t_plain(li, ones, Hi, s, offset, **kw))


# (gene_block, k): where B4's plan splits its work: two and seven row
# groups (gene_block 512 and 1720), lanes of 1 and 4 columns (k 3, 100,
# 128), two to four column tiles (k 129, 300, 512); at width 32 on 2049
# cells (a last tile of one cell)
PLAN_SPLITS = [(512, 3), (512, 100), (512, 128), (512, 129), (512, 300),
               (512, 512), (1720, 100), (1720, 512)]


@pytest.mark.parametrize("gene_block,k", PLAN_SPLITS)
@pytest.mark.parametrize("sliced", [False, True])
def test_b4_b6_where_the_plan_splits(cuda, gene_block, k, sliced):
    """Also on a column slice of wider planes (row stride > cells, at an odd
    cell offset)."""
    cells, n_gb = 2049, 2
    total = cells + 1000 if sliced else cells
    li, lv = _planes_g(n_gb, gene_block, 32, total, gene_block + k, cuda)
    if sliced:
        li, lv = li[:, 517:517 + cells], lv[:, 517:517 + cells]
    H = torch.rand((cells, k), device=cuda)
    _check_b4_b6(li, lv, H, gene_block, n_gb, 4096)


@pytest.mark.parametrize("gene_block,k", [(256, 100), (32, 7)])
def test_b4_sums_a_gene_held_twice(cuda, gene_block, k):
    """A cell whose two slots hold one gene (scipy input with duplicate
    entries): its values add, as in the plain version's dense tile."""
    li, lv = _planes_g(N_GB, gene_block, 16, CELLS, 5, cuda, dup_cell=321)
    H = torch.rand((CELLS, k), device=cuda)
    _check_b4_b6(li, lv, H, gene_block, N_GB, 0)


def _check_b3_b5(li, lv, W, gene_block, offset):
    """B3 plain and hashed within 1e-5 x max |output| of the plain version,
    the same bits twice, one launch a call; B5 on the packed words of the
    same cells the bits of hashed B3; values 1.0 with a 0/1 indicator W
    equal to the plain version, plain and hashed."""
    cells, genes, k = li.shape[1], W.shape[0], W.shape[1]
    seed = seed_pair(79)
    kw = dict(gene_block=gene_block, inv_density=20)
    for s in (None, seed):
        before = bell_cuda.LAUNCHES_SPMM
        got = bell_cuda.bell_spmm_cuda(li, lv, W, s, offset, **kw)
        assert bell_cuda.LAUNCHES_SPMM == before + 1
        _close(got, bell.bell_spmm_plain(li, lv, W, s, offset, **kw))
        assert torch.equal(got, bell_cuda.bell_spmm_cuda(li, lv, W, s, offset,
                                                         **kw))
    words = pack_mask_words(seed, torch.arange(offset, offset + cells,
                                               device=W.device),
                            genes_pad=genes, gene_block=gene_block,
                            inv_density=20, cells_true=offset + cells,
                            genes_true=genes)
    before = bell_cuda.LAUNCHES_SPMM_BITS
    b5 = bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                       gene_block=gene_block)
    assert bell_cuda.LAUNCHES_SPMM_BITS == before + 1
    assert torch.equal(b5, got)
    assert torch.equal(b5, bell_cuda.bell_spmm_bits_cuda(
        li, lv, W, words, gene_block=gene_block))
    li = li.contiguous()
    ones = torch.where(li >= 0, 1.0, 0.0)
    Wi = torch.zeros_like(W)
    Wi[torch.arange(genes), torch.arange(genes) % k] = 1.0
    for s in (None, seed):
        assert torch.equal(
            bell_cuda.bell_spmm_cuda(li, ones, Wi, s, offset, **kw),
            bell.bell_spmm_plain(li, ones, Wi, s, offset, **kw))


# (gene_block, width, k): where B3's plan splits its work: one to
# nineteen column tiles (k 3 to 512), tiles of 4 to 32 columns, k odd and
# not a multiple of 4 (copies of W by 1 and 2 floats), gene_block 1720 at
# width 72, and planes of width 1000 at gene_block 2048, walked in windows
# of slot rows; at 2049 cells (a last pass of one cell)
B3_SPLITS = [(512, 32, 3), (512, 32, 50), (512, 32, 100), (512, 8, 129),
             (512, 32, 256), (512, 32, 300), (512, 16, 512), (1720, 72, 100),
             (1720, 72, 512), (1720, 8, 31), (2048, 1000, 5)]


@pytest.mark.parametrize("gene_block,width,k", B3_SPLITS)
@pytest.mark.parametrize("sliced", [False, True])
def test_b3_b5_where_the_plan_splits(cuda, gene_block, width, k, sliced):
    """Also on a column slice of wider planes (row stride > cells, at an odd
    cell offset)."""
    cells, n_gb = 2049, 2
    total = cells + 1000 if sliced else cells
    li, lv = _planes_g(n_gb, gene_block, width, total, gene_block + k, cuda)
    if sliced:
        li, lv = li[:, 517:517 + cells], lv[:, 517:517 + cells]
    W = torch.rand((n_gb * gene_block, k), device=cuda)
    _check_b3_b5(li, lv, W, gene_block, 4096)


@pytest.mark.parametrize("gene_block,k", [(256, 100), (32, 7)])
def test_b3_sums_a_gene_held_twice(cuda, gene_block, k):
    """A cell whose two slots hold one gene (scipy input with duplicate
    entries): both slots add, in slot order, as the plain version's dense
    tile adds them."""
    li, lv = _planes_g(N_GB, gene_block, 16, CELLS, 6, cuda, dup_cell=321)
    W = torch.rand((N_GB * gene_block, k), device=cuda)
    _check_b3_b5(li, lv, W, gene_block, 0)


def test_dispatchers_launch_kernels_only(cuda):
    li, lv = _planes(8, 300, 3, cuda)
    W = torch.rand((N_GB * GENE_BLOCK, 5), device=cuda)
    counts = (bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T,
              bell.PLAIN_CALLS)
    B = bell.bell_spmm(li, lv, W, gene_block=GENE_BLOCK)
    bell.bell_spmm_t(li, lv, B, gene_block=GENE_BLOCK, n_gb=N_GB)
    assert (bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T,
            bell.PLAIN_CALLS) == (counts[0] + 1, counts[1] + 1, counts[2])


def test_wrappers_refuse(cuda):
    li, lv = _planes(8, 300, 4, cuda)
    W = torch.rand((N_GB * GENE_BLOCK, 5), device=cuda)
    H = torch.rand((300, 5), device=cuda)
    kw = dict(gene_block=GENE_BLOCK)
    with pytest.raises(TypeError):
        bell_cuda.bell_spmm_cuda(li.long(), lv, W, **kw)
    with pytest.raises(TypeError):
        bell_cuda.bell_spmm_t_cuda(li, lv, H.double(), n_gb=N_GB, **kw)
    with pytest.raises(ValueError, match="is on"):
        bell_cuda.bell_spmm_cuda(li.cpu(), lv.cpu(), W, **kw)
    with pytest.raises(ValueError, match="is on"):
        bell_cuda.bell_spmm_t_cuda(li, lv.cpu(), H, n_gb=N_GB, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bell_cuda.bell_spmm_cuda(li.T.contiguous().T, lv.T.contiguous().T,
                                 W, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bell_cuda.bell_spmm_cuda(li, lv, W.T.contiguous().T, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bell_cuda.bell_spmm_t_cuda(li, lv, H.T.contiguous().T, n_gb=N_GB,
                                   **kw)
    with pytest.raises(ValueError, match="gene_block"):
        bell_cuda.bell_spmm_cuda(li, lv, W[:700], **kw)


def test_engine_fit_on_card_matches_cpu(cuda, monkeypatch):
    """The ELL engine's plain and masked fit on the card, through B1-B4
    only, against the same fit on the CPU (tolerance of the fit tests). The
    masked fit takes the f32 route (``SINGLET_TPU_MASKGRAM=xla``), the
    route the CPU takes; the card's default bits route is held against the
    CPU in tests/test_torch_maskbits_cuda.py."""
    import scipy.sparse as sp

    monkeypatch.setenv("SINGLET_TPU_MASKGRAM", "xla")

    from singlet_tpu_torch.ops import nnls, nnls_cuda
    from singlet_tpu_torch.parallel.sharded_ell import ShardedEllEngine

    rng = np.random.default_rng(13)
    A = sp.random(600, 700, density=0.1, random_state=3, format="csc",
                  dtype=np.float32)
    w0 = rng.random((600, 6)).astype(np.float32)
    kw = dict(w_init=w0, tol=0.0, maxit=4)
    gpu = ShardedEllEngine(A, device="cuda", cell_block=256, gene_block=256)
    cpu = ShardedEllEngine(A, device="cpu", cell_block=256, gene_block=256)
    for masked in (False, True):
        counts = [nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED,
                  bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T]
        plain = (nnls.PLAIN_CALLS, bell.PLAIN_CALLS)
        g = gpu.fit(6, masked=masked, inv_density=10, mask_seed=2, **kw)
        assert (nnls.PLAIN_CALLS, bell.PLAIN_CALLS) == plain
        new = [nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_BATCHED,
               bell_cuda.LAUNCHES_SPMM, bell_cuda.LAUNCHES_SPMM_T]
        # plain: B1, B3, B4 once per half-update or pass; masked: 3 cell
        # blocks of 256, each a B3, B2 and B4 launch, plus the w-side B2
        want = ([8, 0, 4, 4] if not masked else [0, 16, 12, 12])
        assert [b - a for a, b in zip(counts, new)] == want
        c = cpu.fit(6, masked=masked, inv_density=10, mask_seed=2, **kw)
        for f in ("w", "h", "d"):
            np.testing.assert_allclose(g[f], c[f], rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(g["tol_trace"], c["tol_trace"],
                                   rtol=5e-3, atol=5e-4)
