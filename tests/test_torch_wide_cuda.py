"""The wide routes of kernels B1, B2, B3, B5 and B7 on the card against
their plain PyTorch versions: ranks above 512 (B1, B2 and B7 hold a
column's coordinates in registers up to 512) and gene blocks whose tiles
do not fit in shared memory (B3 past 7,168 genes, B5 past 5,632).

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one. On a machine with a card (and without jax, which
``tests/conftest.py`` imports), run:

    python -m pytest --noconftest tests/test_torch_wide_cuda.py -q

Tolerances are the tuned routes': rtol=5e-3, atol=1e-6 for B1/B2 (the
sweep-end tol is summed in another order than the plain version's, so a
borderline column may run one sweep more or fewer), 1e-5 x max |output|
for B3/B5 (only the order of the sums differs) and rtol 2e-4 for B7's sums
with equal counts. Where a wide route and a tuned one compute the same
sums in the same order they must give the same bits. A zero Gram diagonal
with a zero right-hand side turns a column NaN on the wide routes as in
the plain version (the same NaN positions, ``equal_nan``), and B2's wide
route takes an (n, k) L1 as B1's does. Up to k = 2048 B2 runs the staged
kernel (csrc/nnls_wide.cuh ``staged_kernel``) and B1 its form in quads
(``quad_kernel``), whose outputs must be the bits of the warp-a-column
kernel they replaced (``wide_kernel``, kept for k > 2048 and the scratch
route, forced here by the plan), NaN for NaN:
at k = 513, 600, 1024 and 2048, column counts that are no multiple of a
block's 4 or 8 columns, masked columns, columns that stop at different
sweeps in one block, an (n, k) L1, a zero diagonal, both entries of B2.
Past k = 2048 the staged kernels take 64, 128 or 256 threads a column and
2 or 1 columns a block where a ring of 4 no longer fits, and B1 runs
``staged_kernel`` on its Gram's rows where its quad ring does not fit (or
past 64 threads a column):
the same bits, at k = 2049, 2560, 4100 and 5000 (no multiple of 32 but
2560). Past the staged kernels' reach (k > 6,452 for B2) the warp kernel
remains, and the scratch route past k = 29,056.
B7's wide route runs tiles of cells (csrc/bell_mse_bits.cu
``b7_wide_kernel``), whose outputs must be the bits of the warp-a-cell
kernel they replaced (csrc/bell_mse_bits_wide_warp.cu, kept as it was):
up to k = 1024 with Wd's rows in registers, past it streamed inside the
dot, and on gene blocks whose slots pass a thread's registers with the
slots walked in passes: at k = 513, 600, 1024, 1025, 1100 and 2560, gene
blocks of 256, 512 and 8,192, 150 and 2,050 cells (no multiple of a
tile), widths 64 and 416, test sets of 1/10 and 1/20, a cell with no
held-out gene and cells holding one held-out gene in two slots: where the
kept kernel's warp stored both in one instruction (a lane a slot, 32 at
a time) the card keeps the upper half-warp's store, and of one half the
lower lane's; else the later store (1,024 pairs of slots of 64 in one
test).
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch import ab_bell_mse
from singlet_tpu_torch.ops import bell, bell_cuda, linalg, nnls, nnls_cuda
from singlet_tpu_torch.ops.maskbits import pack_mask_words
from singlet_tpu_torch.ops.rngmask import seed_pair

pytestmark = pytest.mark.cuda

OFFSET = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wide routes are CUDA kernels "
                    "with no CPU mode")
    return torch.device("cuda")


def _problem(n, k, seed, device):
    rng = np.random.default_rng(seed)
    F = rng.random((2 * k, k)).astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (rng.random((n, 2 * k)) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.9
    return [torch.as_tensor(x, device=device) for x in (a, B, X0, mask)]


def _scratch_plan(n, k, gram="packed"):
    """The wide-k route with its state in device scratch: two blocks of 8
    warps that take the columns in turn."""
    return nnls_cuda.WidePlan(8, 2, False, 0, 2 * 8 * 8 * k)


@pytest.mark.parametrize("n,k,cap", [(300, 513, None), (257, 600, 8.0),
                                     (64, 1024, 8.0), (70, 2560, 8.0)])
@pytest.mark.parametrize("l1", ["scalar", "per_coordinate"])
def test_b1_wide_matches_plain(cuda, n, k, cap, l1):
    a, B, X0, mask = _problem(n, k, n + k, cuda)
    L1 = (0.01 if l1 == "scalar" else
          torch.rand((n, k), generator=torch.Generator(device=cuda)
                     .manual_seed(k), device=cuda) * 0.02)
    kw = dict(L1=L1, L2=0.001, update_mask=mask, sweep_cap=cap)
    before = (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_WIDE, nnls.PLAIN_CALLS)
    Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
    torch.cuda.synchronize()
    assert (nnls_cuda.LAUNCHES, nnls_cuda.LAUNCHES_WIDE,
            nnls.PLAIN_CALLS) == (before[0] + 1, before[1] + 1, before[2])
    Xp = nnls.nnls_batch(a, B, X0, **kw)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])
    assert torch.equal(Xk, nnls_cuda.nnls_batch_cuda(a, B, X0, **kw))


def test_b1_wide_scratch_route_same_bits(cuda, monkeypatch):
    """The state in device scratch, two blocks taking 100 columns in turn:
    the bits of the shared-memory route."""
    a, B, X0, mask = _problem(100, 600, 5, cuda)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=8.0)
    want = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _scratch_plan)
    assert torch.equal(nnls_cuda.nnls_batch_cuda(a, B, X0, **kw), want)


def _corrections(F, m, iu):
    """(npairs, n) packed corrections of each column's held-out rows m[c],
    a column at a time: what ``linalg.mask_dot_t`` of
    ``linalg.packed_outer_products(F, iu)`` holds, summed in another order
    (past k = 2048 the outer products of 2 k rows would take tens of
    GB)."""
    i, j = (torch.as_tensor(x, device=F.device) for x in iu)
    out = torch.empty((i.numel(), m.shape[0]), device=F.device)
    for c in range(m.shape[0]):
        Fh = F[m[c]]
        out[:, c] = (Fh.T @ Fh)[i, j]
    return out


def _packed(F, m, iu, k):
    if k > 2048:
        return _corrections(F, m, iu)
    return linalg.mask_dot_t(linalg.packed_outer_products(F, iu), m,
                             1).contiguous()


def _masked_problem_packed(n, k, seed, device):
    """a_full, the packed corrections of each column's 5% masked rows,
    iu, B, a warm X0 with zeros and a 90% update mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = 2 * k
    F = torch.rand((rows, k), generator=g, device=device)
    iu = linalg.triu_pairs(k)
    m = torch.rand((n, rows), generator=g, device=device) < 0.05
    packed_t = _packed(F, m, iu, k)
    a_full = F.T @ F + 1e-15 * torch.eye(k, device=device)
    B = torch.where(m, 0.0, torch.rand((n, rows), generator=g,
                                       device=device)) @ F
    X0 = (torch.rand((n, k), generator=g, device=device)
          * (torch.rand((n, k), generator=g, device=device) < 0.5))
    mask = torch.rand(n, generator=g, device=device) < 0.9
    return a_full, packed_t, iu, B, X0, mask


@pytest.mark.parametrize("n,k", [(200, 513), (130, 600), (66, 2600)])
def test_b2_wide_entries_match_plain(cuda, monkeypatch, n, k):
    """Both entries on the wide-k route: the same bits (the packed entry
    forms the tile's entries and 1/diag with the same roundings), within
    the gate of the plain version, the masked columns X0; the scratch
    route the same bits."""
    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(n, k, k,
                                                               cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=32.0)
    before = (nnls_cuda.LAUNCHES_BATCHED, nnls_cuda.LAUNCHES_BATCHED_WIDE)
    Xp_ = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu,
                                                     B, X0, **kw)
    Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    torch.cuda.synchronize()
    assert (nnls_cuda.LAUNCHES_BATCHED,
            nnls_cuda.LAUNCHES_BATCHED_WIDE) == (before[0] + 2,
                                                 before[1] + 2)
    assert torch.equal(Xp_, Xt)
    want = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    np.testing.assert_allclose(Xp_.cpu().numpy(), want.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xp_[~mask], X0[~mask])
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _scratch_plan)
    assert torch.equal(nnls_cuda.nnls_batch_cuda_batched_packed_t(
        a_full, packed_t, iu, B, X0, **kw), Xp_)


def _planes(width, cells, gene_block, n_gb, seed, device):
    """Random blocked-ELL planes (n_gb * width, cells): per (gene block,
    cell) a random count of distinct local ids in random slot order."""
    rng = np.random.default_rng(seed)
    li = np.stack([np.stack([rng.choice(gene_block, width, replace=False)
                             for _ in range(cells)]) for _ in range(n_gb)])
    count = rng.integers(0, width + 1, (n_gb, cells, 1))
    live = np.arange(width)[None, None, :] < count
    li = np.where(live, li, -1).astype(np.int32)
    lv = np.where(live, rng.random(li.shape) + 0.1, 0.0)
    to2d = lambda x: np.ascontiguousarray(                     # noqa: E731
        x.transpose(0, 2, 1)).reshape(n_gb * width, cells)
    return (torch.as_tensor(to2d(li), device=device),
            torch.as_tensor(to2d(lv).astype(np.float32), device=device))


def _words(cells, gene_block, n_gb, device, inv_density=20):
    genes = gene_block * n_gb
    return pack_mask_words(
        seed_pair(77), torch.arange(OFFSET, OFFSET + cells, device=device),
        genes_pad=genes, gene_block=gene_block, inv_density=inv_density,
        cells_true=OFFSET + cells, genes_true=genes)


def _close(got, want, rel=1e-5):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()) + 1e-30, err


@pytest.mark.parametrize("gene_block", [7200, 8192])
@pytest.mark.parametrize("k", [5, 50, 100, 300])
def test_b3_b5_wide_block_match_plain(cuda, gene_block, k):
    """B3 (plain and hashed keep) and B5 on gene blocks past their tiles'
    reach: the wide-block route, within 1e-5 x max |output| of the plain
    versions, B5 the bits of masked B3 on the same mask."""
    n_gb, cells, width = 2, 150, 40
    assert isinstance(bell_cuda.b3_plan(cells, n_gb, gene_block, width, k,
                                        True), bell_cuda.B3WidePlan)
    li, lv = _planes(width, cells, gene_block, n_gb, k, cuda)
    W = torch.rand((gene_block * n_gb, k), device=cuda)
    words = _words(cells, gene_block, n_gb, cuda)
    kw = dict(gene_block=gene_block, inv_density=20)
    seed = seed_pair(77)
    before = (bell_cuda.LAUNCHES_SPMM_WIDE, bell_cuda.LAUNCHES_SPMM_BITS_WIDE)
    got = bell_cuda.bell_spmm_cuda(li, lv, W, **kw)
    _close(got, bell.bell_spmm_plain(li, lv, W, **kw))
    masked = bell_cuda.bell_spmm_cuda(li, lv, W, seed, OFFSET, **kw)
    _close(masked, bell.bell_spmm_plain(li, lv, W, seed, OFFSET, **kw))
    bits = bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                         gene_block=gene_block)
    assert torch.equal(bits, masked)
    assert (bell_cuda.LAUNCHES_SPMM_WIDE,
            bell_cuda.LAUNCHES_SPMM_BITS_WIDE) == (before[0] + 2,
                                                   before[1] + 1)


def test_b3_wide_block_takes_the_tiled_bits(cuda, monkeypatch):
    """At a gene block the tiles take, the wide-block route forced by the
    plan gives the tiled kernel's bits: one fmaf chain per output over the
    gene blocks in order and each one's kept slots in slot order."""
    li, lv = _planes(24, 300, 512, 3, 1, cuda)
    W = torch.rand((1536, 100), device=cuda)
    words = _words(300, 512, 3, cuda)
    want = (bell_cuda.bell_spmm_cuda(li, lv, W, gene_block=512),
            bell_cuda.bell_spmm_bits_cuda(li, lv, W, words, gene_block=512))
    monkeypatch.setattr(bell_cuda, "b3_plan", lambda cells, n_gb, gb, w, k,
                        bits: bell_cuda.B3WidePlan(256, -(-k // 256), 8,
                                                   -(-cells // 8)))
    assert torch.equal(bell_cuda.bell_spmm_cuda(li, lv, W, gene_block=512),
                       want[0])
    assert torch.equal(bell_cuda.bell_spmm_bits_cuda(li, lv, W, words,
                                                     gene_block=512),
                       want[1])


@pytest.mark.parametrize("gene_block,n_gb,k,width", [
    (256, 3, 513, 40), (512, 2, 600, 40), (8192, 2, 100, 40),
    (8192, 2, 600, 40), (512, 2, 1100, 40), (8192, 2, 2048, 40),
    (512, 2, 2560, 40), (8192, 2, 100, 416), (8192, 2, 1100, 416)])
def test_b7_wide_matches_plain(cuda, monkeypatch, gene_block, n_gb, k,
                               width):
    """B7 past k = 512 takes the wide route (past k = 1024 Wd's rows
    streamed); at a gene block of 8192 and k = 100 the wide route forced by
    the plan; at width 416 a cell's slots of a gene block walked in
    passes. Sums within rtol 2e-4 of the plain version, counts equal, the
    same bits twice."""
    cells = 150
    li, lv = _planes(width, cells, gene_block, n_gb, k, cuda)
    words = _words(cells, gene_block, n_gb, cuda)
    Wd = torch.rand((gene_block * n_gb, k), device=cuda) / k
    H = torch.rand((cells, k), device=cuda)
    if k <= bell_cuda.MAX_K_MSE:
        monkeypatch.setattr(
            bell_cuda, "b7_plan",
            lambda cells, n_gb, gene_block, width, k:
            bell_cuda.b7_wide_plan(cells, n_gb, gene_block, width, k))
    before = bell_cuda.LAUNCHES_MSE_BITS_WIDE
    got = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H,
                                       gene_block=gene_block)
    assert bell_cuda.LAUNCHES_MSE_BITS_WIDE == before + 1
    want = bell.bell_mse_bits_plain(li, lv, words, Wd, H,
                                    gene_block=gene_block)
    assert torch.equal(got[1], want[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-4, atol=1e-5)
    assert torch.equal(got, bell_cuda.bell_mse_bits_cuda(
        li, lv, words, Wd, H, gene_block=gene_block))


@pytest.mark.parametrize("k", [3, 100, 512])
def test_b7_wide_takes_the_tiled_bits(cuda, monkeypatch, k):
    """At k <= 512 the wide route (its tiles of cells) gives the tiled
    kernel's bits: the same dot (each lane's fmaf chain, the xor butterfly)
    and the same order of the squared errors."""
    li, lv = _planes(24, 300, 256, 3, k, cuda)
    words = _words(300, 256, 3, cuda)
    Wd = torch.rand((768, k), device=cuda) / k
    H = torch.rand((300, k), device=cuda)
    want = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H, gene_block=256)
    monkeypatch.setattr(
        bell_cuda, "b7_plan",
        lambda cells, n_gb, gene_block, width, k:
        bell_cuda.b7_wide_plan(cells, n_gb, gene_block, width, k))
    assert isinstance(bell_cuda.b7_plan(300, 3, 256, 24, k),
                      bell_cuda.B7WidePlan)
    assert torch.equal(bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H,
                                                    gene_block=256), want)


def _held_out(words, gene_block, n_gb):
    """(cells, n_gb * gene_block) bool, the test mask of ``words``: bit (gb
    & 31) of words[c, (gb >> 5) gene_block + l] (ops/maskbits.py)."""
    w = words.cpu().numpy().view(np.uint32)
    held = np.zeros((w.shape[0], n_gb * gene_block), bool)
    for gb in range(n_gb):
        base = (gb >> 5) * gene_block
        held[:, gb * gene_block:(gb + 1) * gene_block] = (
            w[:, base:base + gene_block] >> np.uint32(gb & 31)) & 1
    return held


@pytest.mark.parametrize("inv_density", [10, 20])
@pytest.mark.parametrize("cells", [150, 2050])
@pytest.mark.parametrize("gene_block", [256, 512, 8192])
@pytest.mark.parametrize("k", [513, 600, 1024, 1025, 1100, 2560])
def test_b7_tiles_same_bits_as_warp_kernel(cuda, k, gene_block, cells,
                                           inv_density):
    """B7's wide route, the tiles of cells (Wd's rows in registers up to k
    = 1024, streamed past it): the bits of the warp-a-cell kernel kept in
    csrc/bell_mse_bits_wide_warp.cu, one launch counted; cell 3 holds no
    gene out (sum and count 0); cells hold a held-out gene in two slots
    with different values: of one half-warp of the kept kernel's lanes
    (slots 1 and 3, 17 and 29, 33 and 39, 12 and 15), of its two halves (4
    and 30, 40 and 60), of two groups of 32 (2 and 35); counts those of
    the mask."""
    n_gb, width = 2, 64
    plan = bell_cuda.b7_plan(cells, n_gb, gene_block, width, k)
    assert isinstance(plan, bell_cuda.B7WidePlan)
    assert (plan.npl > 32) == (k > bell_cuda.MAX_K_MSE_WIDE)
    _b7_against_warp_kernel(cuda, k, gene_block, cells, inv_density, width,
                            ((5, (1, 3)), (7, (2, 35)), (9, (4, 30)),
                             (11, (33, 39)), (13, (17, 29)), (15, (40, 60)),
                             (17, (12, 15))))


@pytest.mark.parametrize("cells", [150, 2050])
@pytest.mark.parametrize("k", [100, 600, 1100])
def test_b7_slot_passes_same_bits_as_warp_kernel(cuda, monkeypatch, k,
                                                 cells):
    """Gene blocks of 8,192 at width 416 (the large config's slots a cell
    of a gene block), past a thread's 10 registers of slots (160 at 32
    cells a tile, 80 at 64): the wide route walks each cell's slots in
    passes, forced by the plan at k = 100 (where the tiled kernel fits);
    the kept warp-a-cell kernel's bits, with genes held twice in slots of
    one pass and of two (5 and 300, 170 and 171, 161 and 415)."""
    if k <= bell_cuda.MAX_K_MSE:
        monkeypatch.setattr(
            bell_cuda, "b7_plan",
            lambda cells, n_gb, gene_block, width, k:
            bell_cuda.b7_wide_plan(cells, n_gb, gene_block, width, k))
    plan = bell_cuda.b7_plan(cells, 2, 8192, 416, k)
    assert isinstance(plan, bell_cuda.B7WidePlan)
    assert 416 > 10 * 512 // plan.cells
    _b7_against_warp_kernel(cuda, k, 8192, cells, 20, 416,
                            ((5, (5, 300)), (7, (170, 171)),
                             (9, (161, 415)), (11, (1, 3))))


def _b7_against_warp_kernel(cuda, k, gene_block, cells, inv_density, width,
                            pairs):
    """B7 on random planes of ``width`` against the kept warp-a-cell
    kernel: the same bits, one launch counted (the wide route's too); cell
    3 holds no gene out; each (cell, (s0, s1)) of ``pairs`` holds its first
    held-out gene in slots s0 and s1 with values 0.25 and 4; counts those
    of the mask."""
    n_gb = 2
    li, lv = _planes(width, cells, gene_block, n_gb, k + cells, cuda)
    words = _words(cells, gene_block, n_gb, cuda, inv_density)
    words[3] = 0
    held = _held_out(words, gene_block, n_gb)
    for c, (s0, s1) in pairs:
        g = int(np.flatnonzero(held[c, :gene_block])[0])
        li[s0, c] = li[s1, c] = g
        lv[s0, c], lv[s1, c] = 0.25, 4.0
    gen = torch.Generator(device=cuda).manual_seed(k + gene_block + cells)
    Wd = torch.rand((gene_block * n_gb, k), generator=gen, device=cuda) / k
    H = torch.rand((cells, k), generator=gen, device=cuda)
    before = (bell_cuda.LAUNCHES_MSE_BITS, bell_cuda.LAUNCHES_MSE_BITS_WIDE)
    got = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H,
                                       gene_block=gene_block)
    assert (bell_cuda.LAUNCHES_MSE_BITS,
            bell_cuda.LAUNCHES_MSE_BITS_WIDE) == (before[0] + 1,
                                                  before[1] + 1)
    want = torch.full_like(got, float("nan"))
    err = ab_bell_mse.warp_kernel()(
        li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb, width, cells,
        gene_block, words.data_ptr(), words.stride(0), Wd.data_ptr(),
        H.data_ptr(), k, want.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got[0, 3]) == 0.0 and float(got[1, 3]) == 0.0
    np.testing.assert_array_equal(got[1].cpu().numpy(), held.sum(axis=1))


def _nan_to_zero(x):
    """x with its NaNs (and only those) as 0: with equal NaN masks, two
    results are the same bits where they are numbers."""
    return torch.nan_to_num(x, nan=0.0, posinf=float("inf"),
                            neginf=float("-inf"))


# ---------------------------------------- zero Gram diagonals, (n, k) L1

def _zero_factor(k, z, rows, rng):
    """F (rows, k) whose factor z is nonzero on row 3 alone."""
    F = rng.random((rows, k)).astype(np.float32)
    F[:, z] = 0.0
    F[3, z] = 0.75
    return F


@pytest.mark.parametrize("n,k,z", [(130, 600, 0), (70, 1024, 513)])
def test_b1_wide_zero_diagonal_gives_the_plain_nans(cuda, n, k, z):
    """B1's wide route on a shared Gram whose factor z is zero on every row
    but where b_z < 0 for a third of the columns: the others turn NaN from
    coordinate z on, as the plain version's; with an (n, k) L1 too."""
    rng = np.random.default_rng(k + z)
    F = _zero_factor(k, z, 2 * k, rng)
    F[3, z] = 0.0
    eye = np.eye(k, dtype=np.float32)
    eye[z, z] = 0.0
    a = torch.as_tensor(F.T @ F + 1e-15 * eye, device=cuda)
    B = torch.as_tensor(rng.random((n, 2 * k)).astype(np.float32) @ F,
                        device=cuda)
    B[::3, z] = -0.5
    X0 = torch.as_tensor((rng.random((n, k)) * (rng.random((n, k)) < 0.5))
                         .astype(np.float32), device=cuda)
    mask = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    for L1 in (0.01, torch.full_like(B, 0.02)):
        kw = dict(L1=L1, L2=0.001, update_mask=mask, sweep_cap=8.0)
        wide = nnls_cuda.LAUNCHES_WIDE
        Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
        assert nnls_cuda.LAUNCHES_WIDE == wide + 1
        Xp = nnls.nnls_batch(a, B, X0, **kw)
        torch.cuda.synchronize()
        assert torch.isnan(Xp[mask]).any(dim=1).sum() > 0
        assert torch.isfinite(Xp[::3]).all()
        np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                   rtol=5e-3, atol=1e-6, equal_nan=True)
        assert torch.equal(Xk[~mask], X0[~mask])


@pytest.mark.parametrize("n,k,z", [(66, 600, 599), (40, 700, 31)])
def test_b2_wide_zero_diagonal_gives_the_plain_nans(cuda, monkeypatch, n, k,
                                                    z):
    """B2's wide route, both entries and the scratch route: the columns
    that hold factor z's only row out have a zero diagonal there and turn
    NaN, as the plain version's; the others stay finite."""
    rng = np.random.default_rng(k + z)
    F = torch.as_tensor(_zero_factor(k, z, 2 * k, rng), device=cuda)
    held = rng.random((n, 2 * k)) < 0.05
    held[:, 3] = np.arange(n) % 2 == 0
    m = torch.as_tensor(held, device=cuda)
    iu = linalg.triu_pairs(k)
    packed_t = linalg.mask_dot_t(linalg.packed_outer_products(F, iu), m,
                                 1).contiguous()
    a_full = F.T @ F + 1e-15 * torch.eye(k, device=cuda)
    a_full[z, z] = float(np.float32(0.75) * np.float32(0.75))
    B = (torch.where(m, 0.0, torch.rand((n, 2 * k), device=cuda))
         @ F).contiguous()
    X0 = torch.rand((n, k), device=cuda) * (torch.rand((n, k),
                                                       device=cuda) < 0.5)
    mask = torch.rand(n, device=cuda) < 0.9
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=8.0)
    Xk = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B,
                                                    X0, **kw)
    Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(Xp[0::2][mask[0::2]]).any(dim=1).all()
    assert torch.isfinite(Xp[1::2]).all()
    assert torch.equal(torch.isnan(Xk), torch.isnan(Xt))
    assert torch.equal(_nan_to_zero(Xk), _nan_to_zero(Xt))
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6, equal_nan=True)
    assert torch.equal(Xk[~mask], X0[~mask])
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _scratch_plan)
    Xs = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B,
                                                    X0, **kw)
    assert torch.equal(_nan_to_zero(Xs), _nan_to_zero(Xk))


@pytest.mark.parametrize("n,k", [(200, 513), (130, 600)])
def test_b2_wide_l1_array_matches_plain(cuda, n, k):
    """B2's wide route with a per-coordinate (n, k) L1: both entries the
    same bits, within the gate of the plain version, masked columns X0."""
    a_full, packed_t, iu, B, X0, mask = _masked_problem_packed(n, k, k + 1,
                                                               cuda)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    L1 = torch.rand((n, k), generator=torch.Generator(device=cuda)
                    .manual_seed(k), device=cuda) * 0.02
    kw = dict(L1=L1, L2=0.001, update_mask=mask, sweep_cap=8.0)
    wide = nnls_cuda.LAUNCHES_BATCHED_WIDE
    Xk = nnls.solve_nnls_packed_t(a_full, packed_t, iu, B, X0, **kw)
    Xt = nnls.solve_nnls(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert nnls_cuda.LAUNCHES_BATCHED_WIDE == wide + 2
    assert torch.equal(Xk, Xt)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])


# ------------------------------- the staged kernel against the warp kernel

def _warp_plan(n, k, gram="packed"):
    """The warp-a-column kernel (the route of every k > 512 before the
    staged kernel, and of every k > 2048 before the staged kernels took
    more threads a column) with its state in shared memory, as its plan
    gave it."""
    warps = min(8, 232448 // (8 * k))
    return nnls_cuda.WidePlan(warps, -(-n // warps), True, warps * 8 * k, 0)


def _mixed_stops(B, X0, cols):
    """(B, X0, mask) whose columns stop at different sweeps within each
    block of ``cols`` (or pair of blocks of 2): one with B = X0 = 0 (tol 0 after sweep 1), one with
    B = 0 and X0 = 0.005 at coordinate 5 alone (with an L1 of at least
    0.01 sweep 1 clamps it to 0 and leaves every other coordinate at 0:
    tol 0 after sweep 2), the others as drawn (the sweep cap); columns
    3, 8, 13, ... masked out."""
    B, X0 = B.clone(), X0.clone()
    period = max(cols, 4)
    B[1::period] = 0.0
    X0[1::period] = 0.0
    B[2::period] = 0.0
    X0[2::period] = 0.0
    X0[2::period, 5] = 0.005
    mask = torch.ones(B.shape[0], dtype=torch.bool, device=B.device)
    mask[3::5] = False
    return B, X0, mask


def _same_bits(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(_nan_to_zero(got), _nan_to_zero(want))


def _l1_of(l1, n, k, device):
    """0.01, or an (n, k) L1 drawn from U(0.01, 0.02)."""
    if l1 == "scalar":
        return 0.01
    return 0.01 + torch.rand((n, k), generator=torch.Generator(
        device=device).manual_seed(n + k), device=device) * 0.01


STAGED_SHAPES = ([(n, k) for k in (513, 600, 1024, 2048) for n in (1, 7, 515)]
                 + [(n, k) for k in (2049, 2560, 4100) for n in (1, 7, 133)]
                 + [(7, 5000)])


@pytest.mark.parametrize("n,k", STAGED_SHAPES)
@pytest.mark.parametrize("l1", ["scalar", "per_coordinate"])
def test_b1_staged_same_bits_as_warp_kernel(cuda, monkeypatch, n, k, l1):
    """B1 on the staged kernels (the quad kernel, or past its ring's fit
    the staged kernel on the Gram's rows): the warp kernel's bits, within
    the gate of the plain version, masked columns X0, stops at sweeps 1, 2
    and the cap in the first columns."""
    plan = nnls_cuda.nnls_wide_plan(n, k, "shared")
    assert plan.depth >= 3
    a, B, X0, _ = _problem(n, k, n + k, cuda)
    B, X0, mask = _mixed_stops(B, X0, plan.warps)
    kw = dict(L1=_l1_of(l1, n, k, cuda), L2=0.001, update_mask=mask,
              sweep_cap=8.0)
    wide = nnls_cuda.LAUNCHES_WIDE
    Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
    torch.cuda.synchronize()
    assert nnls_cuda.LAUNCHES_WIDE == wide + 1
    Xp, sweeps = nnls.nnls_batch(a, B, X0, return_sweeps=True, **kw)
    if n > 2:   # columns 0, 1 and 2: the cap, sweep 1, sweep 2
        assert sweeps[:3].tolist() == [8, 1, 2]
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _warp_plan)
    _same_bits(Xk, nnls_cuda.nnls_batch_cuda(a, B, X0, **kw))


@pytest.mark.parametrize("n,k", STAGED_SHAPES)
@pytest.mark.parametrize("l1", ["scalar", "per_coordinate"])
def test_b2_staged_same_bits_as_warp_kernel(cuda, monkeypatch, n, k, l1):
    """Both entries of B2 on the staged kernel: the same bits, the warp
    kernel's, within the gate of the plain version, masked columns X0,
    stops at sweeps 1, 2 and the cap in the first block (its first two at
    k > 1024). The corrections are drawn (0.05 U(0, 1) a pair), a_full
    that of a 2 k-row factor."""
    plan = nnls_cuda.nnls_wide_plan(n, k)
    assert plan.depth >= 3
    g = torch.Generator(device=cuda).manual_seed(n * k)
    F = torch.rand((2 * k, k), generator=g, device=cuda)
    iu = linalg.triu_pairs(k)
    packed_t = 0.05 * torch.rand((k * (k + 1) // 2, n), generator=g,
                                 device=cuda)
    a_full = F.T @ F + 1e-15 * torch.eye(k, device=cuda)
    B = torch.rand((n, 2 * k), generator=g, device=cuda) @ F
    X0 = (torch.rand((n, k), generator=g, device=cuda)
          * (torch.rand((n, k), generator=g, device=cuda) < 0.5))
    B, X0, mask = _mixed_stops(B, X0, plan.warps)
    kw = dict(L1=_l1_of(l1, n, k, cuda), L2=0.001, update_mask=mask,
              sweep_cap=8.0)
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    wide = nnls_cuda.LAUNCHES_BATCHED_WIDE
    Xk = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B,
                                                    X0, **kw)
    Xt = nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw)
    torch.cuda.synchronize()
    assert nnls_cuda.LAUNCHES_BATCHED_WIDE == wide + 2
    _same_bits(Xk, Xt)
    Xp, sweeps = nnls.nnls_batch(at.permute(2, 1, 0), B, X0,
                                 return_sweeps=True, **kw)
    if n > 2:   # columns 0, 1 and 2: the cap, sweep 1, sweep 2
        assert sweeps[:3].tolist() == [8, 1, 2]
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6)
    assert torch.equal(Xk[~mask], X0[~mask])
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _warp_plan)
    _same_bits(Xk, nnls_cuda.nnls_batch_cuda_batched_packed_t(
        a_full, packed_t, iu, B, X0, **kw))
    _same_bits(Xk, nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw))


@pytest.mark.parametrize("n,k,z", [(7, 600, 0), (515, 1024, 513),
                                   (133, 2560, 2049), (7, 4100, 31)])
def test_b1_staged_zero_diagonal_same_bits(cuda, monkeypatch, n, k, z):
    """A shared Gram whose factor z is zero on every row (b_z < 0 for a
    third of the columns): the staged kernel's NaNs and numbers are the
    warp kernel's and the plain version's, with an (n, k) L1 too."""
    rng = np.random.default_rng(k + z)
    F = _zero_factor(k, z, 2 * k, rng)
    F[3, z] = 0.0
    eye = np.eye(k, dtype=np.float32)
    eye[z, z] = 0.0
    a = torch.as_tensor(F.T @ F + 1e-15 * eye, device=cuda)
    B = torch.as_tensor(rng.random((n, 2 * k)).astype(np.float32) @ F,
                        device=cuda)
    B[::3, z] = -0.5
    X0 = torch.as_tensor((rng.random((n, k)) * (rng.random((n, k)) < 0.5))
                         .astype(np.float32), device=cuda)
    mask = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    for L1 in (0.01, torch.full_like(B, 0.02)):
        kw = dict(L1=L1, L2=0.001, update_mask=mask, sweep_cap=8.0)
        Xk = nnls_cuda.nnls_batch_cuda(a, B, X0, **kw)
        Xp = nnls.nnls_batch(a, B, X0, **kw)
        torch.cuda.synchronize()
        assert torch.isnan(Xp[mask]).any(dim=1).sum() > 0
        np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                                   rtol=5e-3, atol=1e-6, equal_nan=True)
        with monkeypatch.context() as m:
            m.setattr(nnls_cuda, "nnls_wide_plan", _warp_plan)
            _same_bits(Xk, nnls_cuda.nnls_batch_cuda(a, B, X0, **kw))


@pytest.mark.parametrize("n,k,z", [(7, 600, 599), (515, 1024, 31),
                                   (70, 2600, 2599)])
def test_b2_staged_zero_diagonal_same_bits(cuda, monkeypatch, n, k, z):
    """B2's entries on the staged kernel where the columns that hold
    factor z's only row out have a zero diagonal: the warp kernel's NaNs
    and numbers, within the plain version's gate."""
    rng = np.random.default_rng(k + z)
    F = torch.as_tensor(_zero_factor(k, z, 2 * k, rng), device=cuda)
    held = rng.random((n, 2 * k)) < 0.05
    held[:, 3] = np.arange(n) % 2 == 0
    m = torch.as_tensor(held, device=cuda)
    iu = linalg.triu_pairs(k)
    packed_t = _packed(F, m, iu, k)
    a_full = F.T @ F + 1e-15 * torch.eye(k, device=cuda)
    a_full[z, z] = float(np.float32(0.75) * np.float32(0.75))
    B = (torch.where(m, 0.0, torch.rand((n, 2 * k), device=cuda))
         @ F).contiguous()
    X0 = torch.rand((n, k), device=cuda) * (torch.rand((n, k),
                                                       device=cuda) < 0.5)
    mask = torch.rand(n, device=cuda) < 0.9
    at = linalg.unpack_sym_from_t(packed_t, k, iu, a_full)
    kw = dict(L1=0.01, L2=0.001, update_mask=mask, sweep_cap=8.0)
    Xk = nnls_cuda.nnls_batch_cuda_batched_packed_t(a_full, packed_t, iu, B,
                                                    X0, **kw)
    Xp = nnls.nnls_batch(at.permute(2, 1, 0), B, X0, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(Xp[mask]).any(dim=1).sum() > 0
    np.testing.assert_allclose(Xk.cpu().numpy(), Xp.cpu().numpy(),
                               rtol=5e-3, atol=1e-6, equal_nan=True)
    _same_bits(Xk, nnls_cuda.nnls_batch_cuda_batched_at(at, B, X0, **kw))
    monkeypatch.setattr(nnls_cuda, "nnls_wide_plan", _warp_plan)
    _same_bits(Xk, nnls_cuda.nnls_batch_cuda_batched_packed_t(
        a_full, packed_t, iu, B, X0, **kw))


def test_b7_tiles_keep_the_warp_kernels_slot_of_a_gene_held_twice(cuda):
    """1,024 cells, each holding its one held-out gene in two slots of 64
    (a pair drawn without repeats from all 2,016) with values 0.25 and 4:
    the tiles give the kept warp-a-cell kernel's bits, so they keep the
    slot its stores kept, for every pair; that slot is the one of the
    later group of 32, of a group the later half-warp, of a half the lower
    lane."""
    rng = np.random.default_rng(5)
    pairs = [(a, b) for a in range(64) for b in range(a + 1, 64)]
    sel = [pairs[i] for i in rng.choice(len(pairs), 1024, replace=False)]
    cells, G, width, k, g = len(sel), 256, 64, 600, 7
    li = np.tile(np.arange(100, 100 + width, dtype=np.int32)[:, None],
                 (1, cells))
    lv = np.ones((width, cells), np.float32)
    for c, (a, b) in enumerate(sel):
        li[a, c] = li[b, c] = g
        lv[a, c], lv[b, c] = 0.25, 4.0
    words = np.zeros((cells, G), np.uint32)
    words[:, g] = 1
    Wd = (rng.random((G, k)) / k).astype(np.float32)
    H = rng.random((cells, k)).astype(np.float32)
    li, lv, words, Wd, H = (torch.as_tensor(x, device=cuda) for x in (
        li, lv, words.view(np.int32), Wd, H))
    assert isinstance(bell_cuda.b7_plan(cells, 1, G, width, k),
                      bell_cuda.B7WidePlan)
    got = bell_cuda.bell_mse_bits_cuda(li, lv, words, Wd, H, gene_block=G)
    want = torch.full_like(got, float("nan"))
    assert ab_bell_mse.warp_kernel()(
        li.data_ptr(), lv.data_ptr(), li.stride(0), 1, width, cells, G,
        words.data_ptr(), words.stride(0), Wd.data_ptr(), H.data_ptr(), k,
        want.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    pred = (H.double() @ Wd[g].double()).cpu().numpy()
    s = got[0].cpu().numpy()
    kept4 = np.abs(s - (pred - 4.0) ** 2) < np.abs(s - (pred - 0.25) ** 2)
    rank = [((a | 15) - (a & 15), (b | 15) - (b & 15)) for a, b in sel]
    np.testing.assert_array_equal(kept4, [rb > ra for ra, rb in rank])
