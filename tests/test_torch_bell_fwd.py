"""Kernels B3 and B5's host plan and schedule (``singlet_tpu_torch/ops/
bell_cuda.py`` ``b3_plan``, ``csrc/bell_spmm.cu`` ``bell_spmm_kernel``),
on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_bell_cuda.py``,
``tests/test_torch_maskbits_cuda.py``). What surrounds it is checked here:
the plan is a function of the shapes alone, covers every cell and output
column exactly once, and fits in a Hopper block's 232,448 bytes of shared
memory for every gene_block <= 1720, plane width <= 72 and k <= 512; a
numpy model of the kernel's schedule on the plan (cell tiles, column
tiles, per gene block in order the window's (offset, value) pairs, then
each cell's kept slots in slot order) visits each output's slots in the
order of the one-warp-per-cell kernel it replaces (gene blocks ascending,
then slots ascending) and agrees with the plain version, pad slots, a gene
held twice by one cell and cells with no live slot included; and the
plain versions of B3 and B5 agree with the JAX kernels in interpret mode
at geometries where the plan splits the columns. Tolerance: max abs error
<= 1e-5 * max |output| for the model against the plain version (the two
differ only in the order of float32 sums; the model rounds each product,
the kernel fuses it), rtol = atol = 1e-5 against JAX, as in
tests/test_torch_bell.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from singlet_tpu.ops import maskbits as jmb
from singlet_tpu.ops import pallas_bell as jpb
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu_torch.ops import bell, maskbits
from singlet_tpu_torch.ops.bell_cuda import (B7WidePlan, b3_bm_words,
                                            b3_plan, b3_smem, b7_cpws,
                                            b7_max_walkers, b7_plan, b7_smem,
                                            b7_wide_plan)
from singlet_tpu_torch.ops.rngmask import seed_pair
from singlet_tpu_torch.parallel import sharded_ell as tell

SMEM = 232448


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (cells, n_gb, gene_block, width, k): the engine's shapes (the 524k
# operand's 8192-cell slice, its 2048-cell blocks and all its cells; the
# bench operand at k = 50, 256 and 300; the edge geometry) and the card
# tests' shapes where the plan splits cells and columns
SHAPES = [(8192, 32, 512, 32, 100), (2048, 32, 512, 32, 100),
          (524288, 32, 512, 32, 100), (8192, 32, 512, 72, 50),
          (8192, 32, 512, 72, 256), (8192, 32, 512, 72, 300),
          (3000, 40, 32, 16, 7), (2049, 2, 512, 32, 3),
          (2049, 2, 512, 8, 129), (2049, 2, 1720, 72, 512),
          (2049, 2, 1720, 8, 31), (1000, 3, 256, 136, 224), (1, 1, 1, 1, 1),
          (31, 1, 5, 3, 3)]


@pytest.mark.parametrize("cells,n_gb,gene_block,width,k", SHAPES)
def test_b3_plan_is_a_function_of_the_shapes(cells, n_gb, gene_block, width,
                                             k):
    for bits in (False, True):
        plan = b3_plan(cells, n_gb, gene_block, width, k, bits)
        assert plan == b3_plan.__wrapped__(cells, n_gb, gene_block, width, k,
                                           bits)
        assert all(isinstance(v, int) and v >= 1 for v in plan)


@pytest.mark.parametrize("cells,n_gb,gene_block,width,k", SHAPES)
def test_b3_plan_covers_everything_once(cells, n_gb, gene_block, width, k):
    """Every cell lies in exactly one cell tile and every output column in
    one column tile, each part non-empty; a tile's columns are a multiple
    of 4 (16-byte rows of W in shared memory) and at most 32 (a
    quarter-warp of 4 columns a lane); a block's cells are 1, 2 or 4
    passes of 64 (a power of two: the stagers split an entry's index into
    slot row and cell by a mask); a cluster is one column tile or two
    neighbouring ones of a cell tile; the shared memory is b3_smem's and
    fits."""
    p = b3_plan(cells, n_gb, gene_block, width, k)
    assert b3_plan(cells, n_gb, gene_block, width, k, True).smem <= SMEM
    assert p.kt % 4 == 0 and 4 <= p.kt <= 32
    assert p.rounds in (1, 2, 4) and p.cells == 64 * p.rounds
    assert p.cs in (1, 2) and p.n_kt % p.cs == 0
    seen = np.zeros(cells, np.int64)
    for t in range(p.n_ct):
        part = seen[t * p.cells:(t + 1) * p.cells]
        assert part.size > 0, t
        part += 1
    assert (seen == 1).all()
    cols = np.zeros(k, np.int64)
    for y in range(p.n_kt):
        j0 = y * p.kt
        assert 0 < min(p.kt, k - j0) <= 32
        cols[j0:j0 + p.kt] += 1
    assert (cols == 1).all()
    # one window a gene block up to 72 slot rows; wider planes may take
    # windows of fewer rows, one after the other
    assert p.win == width or (width > 72 and 1 <= p.win < width)
    assert p.smem == b3_smem(gene_block, p.win, p.kt, p.rounds,
                             p.cs) <= SMEM


@pytest.mark.parametrize("width", [1, 8, 32, 72])
def test_b3_plan_fits_shared_memory(width):
    """For every gene_block <= 1720 and a set of k <= 512 that holds every
    k up to 64 (one and two column tiles, each rounding) and the wide
    ranks; with the engine's 2048-cell blocks and a few cells."""
    ks = list(range(1, 65)) + [99, 100, 127, 128, 129, 200, 224, 225, 255,
                               256, 300, 384, 500, 511, 512]
    plan = b3_plan.__wrapped__
    worst = 0
    for gene_block in range(1, 1721):
        for k in ks:
            for cells, bits in ((2048, True), (31, False)):
                p = plan(cells, 1, gene_block, width, k, bits)
                assert p.smem == b3_smem(gene_block, width, p.kt, p.rounds,
                                         p.cs, bits)
                assert p.n_kt * p.kt >= k > (p.n_kt - 1) * p.kt
                worst = max(worst, p.smem)
    assert worst <= SMEM


def test_b3_plan_fills_the_card_at_the_engine_shapes():
    """At the engine's shapes the grid holds about one block per SM of an
    H100 (132 SMs) or more, one window a gene block: the 8192-cell slice,
    a 2048-cell block and all 524,288 cells at k = 100, the bench planes
    at k = 50."""
    for cells, width, k in ((8192, 32, 100), (2048, 32, 100),
                            (524288, 32, 100), (8192, 72, 50)):
        p = b3_plan(cells, 32, 512, width, k)
        assert p.n_ct * p.n_kt >= 128 and p.win == width, p


def _planes(n_gb, width, cells, gene_block, seed, dup_cell=None,
            empty_cell=None):
    """Random planes (n_gb * width, cells): per (gene block, cell) a random
    count of distinct local ids in random slot order, the rest pad; with
    ``dup_cell``, that cell's slot 1 repeats its slot 0 in every gene
    block (a non-canonical operand); with ``empty_cell``, that cell holds
    no live slot at all."""
    rng = np.random.default_rng(seed)
    order = np.argsort(rng.random((n_gb, cells, gene_block)), axis=2)
    li = order[:, :, :width].astype(np.int32)
    count = rng.integers(0, width + 1, (n_gb, cells, 1))
    if dup_cell is not None:
        count[:, dup_cell] = width
        li[:, dup_cell, 1] = li[:, dup_cell, 0]
    if empty_cell is not None:
        count[:, empty_cell] = 0
    live = np.arange(width)[None, None, :] < count
    li = np.where(live, li, -1)
    lv = np.where(live, rng.random(li.shape) + 0.1, 0.0).astype(np.float32)
    to2d = lambda x: np.ascontiguousarray(                     # noqa: E731
        x.transpose(0, 2, 1)).reshape(n_gb * width, cells)
    return to2d(li), to2d(lv)


def _model_b3(li, lv, W, keep, n_gb, gene_block):
    """numpy model of kernel B3 on ``b3_plan``: per block (cell tile,
    column tile) and per gene block in order, the window staged as (offset,
    value) pairs (offset -1 where the slot is pad, held out or past the
    cells) in windows of the plan's slot rows, each window's pairs of each
    cell walked in slot order, the value times its W row's tile columns
    added into float32 accumulators. Returns B, per (cell, column tile) the
    (gene block, slot) visits in order, and the plan."""
    cells, k = li.shape[1], W.shape[1]
    width = li.shape[0] // n_gb
    p = b3_plan(cells, n_gb, gene_block, width, k)
    B = np.full((cells, k), np.nan, np.float32)
    visits = {}
    for t in range(p.n_ct):
        c0 = t * p.cells
        n = min(p.cells, cells - c0)
        for y in range(p.n_kt):
            j0 = y * p.kt
            kt = min(p.kt, k - j0)
            acc = np.zeros((p.cells, kt), np.float32)
            for c in range(n):
                visits[c0 + c, y] = []
            for gb in range(n_gb):
                s_w = W[gb * gene_block:(gb + 1) * gene_block, j0:j0 + kt]
                win = slice(gb * width, (gb + 1) * width)
                off = np.full((width, p.cells), -1, np.int64)
                val = np.zeros((width, p.cells), np.float32)
                ids = li[win, c0:c0 + n]
                kept = (ids >= 0) & keep[win, c0:c0 + n]
                off[:, :n] = np.where(kept, ids, -1)
                val[:, :n] = np.where(kept, lv[win, c0:c0 + n], 0.0)
                for w0 in range(0, width, p.win):
                    for c in range(p.cells):
                        for w in range(w0, min(width, w0 + p.win)):
                            if off[w, c] >= 0:
                                acc[c] += val[w, c] * s_w[off[w, c]]
                                visits[c0 + c, y].append((gb, w))
            B[c0:c0 + n, j0:j0 + kt] = acc[:n]
    return B, visits, p


def _keep_hashed(li, seed, cell_offset, cells, n_gb, gene_block, inv):
    """The keep factor of each slot of the planes: 1 - the hashed test
    mask at (cell, gene), True at pad slots."""
    width = li.shape[0] // n_gb
    keep = np.ones(li.shape, bool)
    for gb in range(n_gb):
        m = bell._keep(seed, cell_offset, cells, gb * gene_block, gene_block,
                       inv, "cpu").numpy() > 0
        win = li[gb * width:(gb + 1) * width]
        keep[gb * width:(gb + 1) * width] = np.where(
            win >= 0, m[np.arange(cells)[None, :], np.maximum(win, 0)], True)
    return keep


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gene_block,k,cells,dup", [
    (300, 100, 200, None),     # four column tiles of 28, 28, 28, 16
    (40, 130, 150, 17),        # five column tiles; cell 17 repeats a gene
    (32, 7, 300, 299)])        # one column tile of 8; ten cell tiles
def test_b3_schedule_matches_plain(gene_block, k, cells, dup, masked):
    """The model visits each output's live kept slots in the order of the
    kernel it replaces (one thread's fmaf chain: gene blocks ascending,
    then slots ascending, each exactly once), and its sums agree with the
    plain version. Cell 5 holds no live slot: its row is 0."""
    n_gb, width = 2, 12
    li, lv = _planes(n_gb, width, cells, gene_block, seed=gene_block + k,
                     dup_cell=dup, empty_cell=5)
    W = np.random.default_rng(k).random((n_gb * gene_block, k)).astype(
        np.float32)
    seed = seed_pair(3) if masked else None
    keep = (_keep_hashed(li, seed, 50, cells, n_gb, gene_block, 4) if masked
            else np.ones(li.shape, bool))
    got, visits, plan = _model_b3(li, lv, W, keep, n_gb, gene_block)
    assert plan.n_ct > 1 and (plan.n_kt > 1 or k <= plan.kt)
    for c in range(cells):
        want = [(gb, w) for gb in range(n_gb) for w in range(width)
                if li[gb * width + w, c] >= 0 and keep[gb * width + w, c]]
        for y in range(plan.n_kt):
            assert visits[c, y] == want, (c, y)
    assert not visits[5, 0] and (got[5] == 0).all()
    want = bell.bell_spmm_plain(
        torch.as_tensor(li), torch.as_tensor(lv), torch.as_tensor(W), seed,
        50, gene_block=gene_block, inv_density=4).numpy()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def test_b3_schedule_in_windows():
    """Planes wider than shared memory holds beside a gene block's slice of
    W (gene_block 6000, width 500): the plan walks the slot rows in
    windows, one after the other, so each output still visits its slots in
    slot order, and the sums agree with the plain version."""
    n_gb, width, cells, gene_block, k = 1, 500, 40, 6000, 5
    li, lv = _planes(n_gb, width, cells, gene_block, seed=8, dup_cell=3,
                     empty_cell=5)
    W = np.random.default_rng(1).random((gene_block, k)).astype(np.float32)
    keep = np.ones(li.shape, bool)
    got, visits, plan = _model_b3(li, lv, W, keep, n_gb, gene_block)
    assert 1 < plan.win < width and plan.smem <= SMEM
    for c in range(cells):
        assert visits[c, 0] == [(0, w) for w in range(width)
                                if li[w, c] >= 0], c
    want = bell.bell_spmm_plain(torch.as_tensor(li), torch.as_tensor(lv),
                                torch.as_tensor(W),
                                gene_block=gene_block).numpy()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


@pytest.mark.parametrize("gene_block,n_gb", [(512, 32), (32, 40), (100, 3)])
def test_b5_test_bits_by_gene_block(gene_block, n_gb):
    """A numpy model of B5's first pass (bell_spmm.cu
    ``bell_words_t_kernel``): the packed words (cells, n_t * gene_block),
    bit gb & 31 of word (gb >> 5) * gene_block + l, become bit l & 31 of
    bm[gb][l >> 5][cell] with b3_bm_words(gene_block) = ceil(gene_block /
    32) words a gene block, a 32 x 32 bit transpose of each cell's words.
    Looked up as the kernel's stagers look it up, each (gene block, cell,
    gene) gives the word's test bit and no bit lies past the gene block; a
    second word group (40 gene blocks) and a gene block that is no
    multiple of 32 included."""
    cells = 48
    n_t = -(-n_gb // 32)
    rng = np.random.default_rng(gene_block + n_gb)
    words = rng.integers(0, 2 ** 32, (cells, n_t * gene_block),
                         dtype=np.uint64).astype(np.uint32)
    bmw = b3_bm_words(gene_block)
    assert 32 * bmw >= gene_block > 32 * (bmw - 1)
    bm = np.zeros((n_gb, bmw, cells), np.uint32)
    for t in range(n_t):
        for j in range(bmw):
            m = np.zeros((32, cells), np.uint32)    # m[r]: gene 32 j + r
            for r in range(32):
                if 32 * j + r < gene_block:
                    m[r] = words[:, t * gene_block + 32 * j + r]
            for b in range(32):                     # the transpose
                if 32 * t + b < n_gb:
                    bm[32 * t + b, j] = sum(((m[r] >> b) & 1) << r
                                            for r in range(32))
    for gb in range(n_gb):
        for c in range(0, cells, 7):
            for l in range(32 * bmw):
                got = (int(bm[gb, l >> 5, c]) >> (l & 31)) & 1
                want = (int(words[c, (gb >> 5) * gene_block + l]) >> (gb & 31)
                        ) & 1 if l < gene_block else 0
                assert got == want, (gb, c, l)


def _csc_planes(genes, cells, gene_block, density, seed):
    A = sp.random(genes, cells, density=density, random_state=seed,
                  dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    n_gb = genes // gene_block
    width = tell.bell_width(tell.bell_widths(A, n_gb, gene_block))
    li, lv = tell.csc_to_bell(A, cells, gene_block, n_gb, width)
    return (tell.planes_to_device_layout(li),
            tell.planes_to_device_layout(lv), n_gb)


# (genes, gene_block, cells, k, inv_density, cell offset): the plan splits
# k into two (40) and three (70) column tiles
PARITY = {"two_tiles": (96, 32, 48, 40, 5, 0),
          "three_tiles": (64, 32, 40, 70, 6, 1000)}


@pytest.mark.parametrize("geom", sorted(PARITY))
def test_b3_b5_plain_and_model_match_jax(rng, geom):
    """Plain B3 (unmasked and hashed) and plain B5 against the JAX kernels
    in interpret mode, and the schedule model against the same."""
    genes, gb, cells, k, inv, off = PARITY[geom]
    li, lv, n_gb = _csc_planes(genes, cells, gb, 0.2, 7)
    width = li.shape[0] // n_gb
    assert b3_plan(cells, n_gb, gb, width, k).n_kt > 1
    W = rng.random((genes, k)).astype(np.float32)
    tli, tlv, tW = (torch.as_tensor(x) for x in (li, lv, W))
    jli, jlv, jW = (jnp.asarray(x) for x in (li, lv, W))
    ids = jnp.arange(off, off + cells, dtype=jnp.int32)
    for masked in (False, True):
        got = bell.bell_spmm_plain(tli, tlv, tW,
                                   seed_pair(9) if masked else None, off,
                                   gene_block=gb, inv_density=inv).numpy()
        want = np.asarray(jpb.bell_spmm(jli, jlv, jW, jax_seed_pair(9), ids,
                                        gene_block=gb, inv_density=inv,
                                        masked=masked, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        keep = (_keep_hashed(li, seed_pair(9), off, cells, n_gb, gb, inv)
                if masked else np.ones(li.shape, bool))
        model, _, _ = _model_b3(li, lv, W, keep, n_gb, gb)
        np.testing.assert_allclose(model, want, rtol=1e-5, atol=1e-5)
    kw = dict(genes_pad=genes, gene_block=gb, inv_density=inv,
              cells_true=off + cells, genes_true=genes)
    words = maskbits.pack_mask_words(seed_pair(9), torch.arange(off,
                                                                off + cells),
                                     **kw)
    jwords = jmb.pack_mask_words(jax_seed_pair(9), ids, **kw)
    got = bell.bell_spmm_bits_plain(tli, tlv, tW, words,
                                    gene_block=gb).numpy()
    want = np.asarray(jpb.bell_spmm_bits(jli, jlv, jW, jwords.T,
                                         gene_block=gb, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ B7

# (cells, n_gb, gene_block, width, k): the engine's test MSE (all 524,288
# cells and the 8192-cell slice at k = 100, the bench planes at k = 50,
# 256 and 300), the card tests' shapes, gene blocks up to B5's 5,632
B7_SHAPES = [(524288, 32, 512, 32, 100), (8192, 32, 512, 32, 100),
             (8192, 32, 512, 72, 50), (8192, 32, 512, 72, 256),
             (8192, 32, 512, 72, 300), (1000, 3, 256, 24, 224),
             (1000, 40, 32, 24, 3), (2049, 2, 5632, 72, 512),
             (2049, 3, 160, 8, 40), (1, 1, 1, 1, 1), (31, 2, 100, 3, 129)]


@pytest.mark.parametrize("cells,n_gb,gene_block,width,k", B7_SHAPES)
def test_b7_plan_covers_cells_and_sub_blocks_once(cells, n_gb, gene_block,
                                                  width, k):
    """Every cell lies in one tile of walkers * cpw cells; a gene block's
    sub-blocks [sb R, sb R + R) cover its genes once, in ascending order,
    and each one's R / 32 words of test bits lie in the cell's bm_pitch
    words; a walker keeps at most 32 floats of H a lane (or 2 cells); the
    plan is a function of the shapes and does not change the bits."""
    p = b7_plan(cells, n_gb, gene_block, width, k)
    assert p == b7_plan.__wrapped__(cells, n_gb, gene_block, width, k)
    assert 32 * p.npl >= k and p.npl in (1, 2, 4, 8, 12, 16)
    assert p.cpw in b7_cpws(p.npl) and (p.cpw * p.npl <= 32 or p.cpw <= 2)
    assert 1 <= p.walkers <= b7_max_walkers(p.npl, p.cpw) <= 16
    assert p.cells == p.walkers * p.cpw
    assert p.n_ct * p.cells >= cells > (p.n_ct - 1) * p.cells
    assert p.rows in (128, 64, 32)
    genes = [g for sb in range(p.n_sb)
             for g in range(sb * p.rows, min((sb + 1) * p.rows, gene_block))]
    assert genes == list(range(gene_block))
    assert p.n_sb * p.rows // 32 <= p.bm_pitch and p.bm_pitch % 8 == 0
    assert 32 * p.bm_pitch >= gene_block


def test_b7_plan_fits_shared_memory():
    """For gene_block <= 5,632 (B5's reach; the bits' pitch moves every
    256 genes), width <= 72 and k <= 512, at the engine's cell counts and
    a few cells, the plan's block fits in 232,448 bytes."""
    gene_blocks = sorted({1, 31, 32, 33, 100, 255, 256, 257, 512, 1000,
                          1720, 2048, 4096, 5000, 5376, 5377, 5632})
    ks = list(range(1, 65, 3)) + [96, 97, 100, 128, 129, 224, 225, 256,
                                  257, 300, 384, 385, 500, 512]
    worst = 0
    for gene_block in gene_blocks:
        for width in (1, 8, 32, 72):
            for k in ks:
                for cells in (1, 2049, 8192, 524288):
                    p = b7_plan.__wrapped__(cells, 32, gene_block, width, k)
                    assert p.smem == b7_smem(p.rows, p.npl, p.cells,
                                             p.bm_pitch, p.walkers, width)
                    worst = max(worst, p.smem)
    assert worst <= SMEM


def test_b7_plan_fills_the_card_at_the_engine_shapes():
    """All 524,288 cells take tiles of 16 walkers and sub-blocks of 128
    genes; the 8192-cell slice and the bench planes one wave of tiles over
    the 132 SMs."""
    p = b7_plan(524288, 32, 512, 32, 100)
    assert p.walkers == 16 and p.rows == 128
    for width, k in ((32, 100), (72, 50)):
        p = b7_plan(8192, 32, 512, width, k)
        assert p.n_ct <= 132 and p.walkers >= 8


def _f32(x):
    return np.float32(x)


def _fma(a, b, c):
    """fmaf on float32 values (the product is exact in float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _butterfly(parts):
    """The parent's xor butterfly 16, 8, 4, 2, 1 over 32 lane parts: every
    lane's value (all equal)."""
    v = [_f32(x) for x in parts]
    off = 16
    while off:
        v = [_f32(v[l] + v[l ^ off]) for l in range(32)]
        off //= 2
    return v


def _reduce_scatter(parts, m=8):
    """The kernels' batch of m (8, 4 or 2) entries: parts[l][e] the lane
    parts; levels 16, 8, ... (log2 m of them) keep the half of a lane's
    entries whose index bit matches its lane bit and add the partner's
    parts of them, then the rest of the butterfly's offsets. Returns each
    lane's value; lane l's is entry (l >> (5 - log2 m)) & (m - 1)'s."""
    log = m.bit_length() - 1
    p = [[_f32(x) for x in row] for row in parts]
    for lvl in range(log):
        off, half = 16 >> lvl, m >> (lvl + 1)
        new = []
        for l in range(32):
            up = bool(l & off)
            q = list(p[l])
            for i in range(half):
                partner = p[l ^ off]
                # the partner sends what this lane keeps
                recv = partner[i + half] if up else partner[i]
                keep = p[l][i + half] if up else p[l][i]
                q[i] = _f32(keep + recv)
            new.append(q)
        p = new
    v = [row[0] for row in p]
    off = 16 >> log
    while off:
        v = [_f32(v[l] + v[l ^ off]) for l in range(32)]
        off //= 2
    return v


def _parts(rng, shape):
    kind = rng.integers(0, 4, shape)
    x = np.where(kind == 0, 0.0, np.where(
        kind == 1, rng.standard_normal(shape) * 1e-40,
        rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 6, shape)))
    return x.astype(np.float32)


@pytest.mark.parametrize("m", [8, 4, 2])
def test_b7_reduce_scatter_is_the_parents_butterfly(m):
    """Each entry's total after the reduce-scatter of 8 (the tiled kernel),
    4 or 2 entries (the wide route's) has the bits of the parent's
    per-entry butterfly, on parts with zeros, denormals and mixed signs and
    scales."""
    rng = np.random.default_rng(17)
    log = m.bit_length() - 1
    for _ in range(40):
        parts = _parts(rng, (32, m))
        got = _reduce_scatter(parts, m)
        for e in range(m):
            want = _butterfly(parts[:, e])[0]
            for l in range(32):
                if (l >> (5 - log)) & (m - 1) == e:
                    assert got[l].tobytes() == want.tobytes(), (e, l)


def _b7_bits(words, n_gb, gene_block, cells_pad, bm_pitch):
    """numpy model of B7's pass (bell_mse_bits.cu ``b7_bits_kernel``):
    bit (gb & 31) of words[c, (gb >> 5) GB + l] becomes bit (l & 31) of
    bm[gb][c][l >> 5], zero past the gene block and the cells."""
    cells = words.shape[0]
    bm = np.zeros((n_gb, cells_pad, bm_pitch), np.uint32)
    for gb in range(n_gb):
        base = (gb >> 5) * gene_block
        bit = (words[:, base:base + gene_block].astype(np.uint64)
               >> np.uint64(gb & 31)) & np.uint64(1)
        for l in range(gene_block):
            bm[gb, :cells, l >> 5] |= (bit[:, l] << np.uint64(l & 31)
                                       ).astype(np.uint32)
    return bm


def _model_b7(li, lv, words, Wd, H, gene_block, parent_order=False):
    """numpy model of kernel B7 on ``b7_plan`` (the pass's bits, then per
    tile, gene block, sub-block and the tile's cells the held-out genes in
    ascending order, eight at a time, each dot one fmaf chain a lane and
    the reduce-scatter, ``s = fmaf(diff, diff, s)``); with
    ``parent_order``, the parent's (per cell, gene blocks and genes in
    order, the butterfly per entry). Returns (2, cells) and each cell's
    genes in visiting order."""
    cells, k = H.shape
    n_gb = Wd.shape[0] // gene_block
    width = li.shape[0] // n_gb
    p = b7_plan(cells, n_gb, gene_block, width, k)
    kp = 32 * p.npl
    bm = _b7_bits(words, n_gb, gene_block, p.n_ct * p.cells, p.bm_pitch)
    h = np.zeros((cells, kp), np.float32)
    h[:, :k] = H
    w = np.zeros((Wd.shape[0], kp), np.float32)
    w[:, :k] = Wd
    out = np.zeros((2, cells), np.float32)
    order = {c: [] for c in range(cells)}

    def dense_row(c, gb):
        d = np.zeros(gene_block, np.float32)
        for s in range(width):
            l = li[gb * width + s, c]
            if l >= 0:
                d[l] = lv[gb * width + s, c]
        return d

    def lane_parts(c, g):
        parts = []
        for lane in range(32):
            acc = _f32(0)
            for s in range(p.npl):
                acc = _fma(h[c, s * 32 + lane], w[g, s * 32 + lane], acc)
            parts.append(acc)
        return parts

    def add(c, g, tot, d):
        diff = _f32(tot - d)
        out[0, c] = _fma(diff, diff, out[0, c])
        out[1, c] = _f32(out[1, c] + 1)
        order[c].append(g)

    def held(c, gb, lo, hi):
        return [l for l in range(lo, hi)
                if (int(bm[gb, c, l >> 5]) >> (l & 31)) & 1]

    if parent_order:
        for c in range(cells):
            for gb in range(n_gb):
                d = dense_row(c, gb)
                for l in held(c, gb, 0, gene_block):
                    g = gb * gene_block + l
                    add(c, g, _butterfly(lane_parts(c, g))[0], d[l])
        return out, order
    for t in range(p.n_ct):
        for gb in range(n_gb):
            for sb in range(p.n_sb):
                lo, hi = sb * p.rows, min((sb + 1) * p.rows, gene_block)
                for c in range(t * p.cells, min((t + 1) * p.cells, cells)):
                    ls = held(c, gb, lo, hi)
                    d = dense_row(c, gb)
                    for b0 in range(0, len(ls), 8):
                        batch = ls[b0:b0 + 8]
                        parts = np.zeros((32, 8), np.float32)
                        for e, l in enumerate(batch):
                            parts[:, e] = lane_parts(c, gb * gene_block + l)
                        tot = _reduce_scatter(parts)
                        for e, l in enumerate(batch):
                            add(c, gb * gene_block + l, tot[4 * e], d[l])
    return out, order


@pytest.mark.parametrize("cells,n_gb,gene_block,width,k,inv", [
    (37, 3, 160, 8, 40, 5), (20, 2, 96, 6, 3, 3), (16, 33, 8, 4, 9, 2)])
def test_b7_schedule_matches_parent_and_plain(cells, n_gb, gene_block, width,
                                              k, inv):
    """The kernel's schedule (tiles, sub-blocks of the plan, batches of
    eight) visits each cell's held-out genes once in ascending order and
    gives the parent's bits; both are within rtol 2e-4 of the plain
    version, with the same counts. Gene blocks that are no multiple of the
    sub-block, a second word group (33 gene blocks) and tiles past the
    cells included."""
    li, lv = _planes(n_gb, width, cells, gene_block, cells + k)
    genes = n_gb * gene_block
    rng = np.random.default_rng(k)
    Wd = (rng.random((genes, k)) / k).astype(np.float32)
    H = rng.random((cells, k)).astype(np.float32)
    words = maskbits.pack_mask_words(
        seed_pair(3), torch.arange(100, 100 + cells), genes_pad=genes,
        gene_block=gene_block, inv_density=inv, cells_true=100 + cells,
        genes_true=genes).numpy().view(np.uint32)
    got, order = _model_b7(li, lv, words, Wd, H, gene_block)
    want, want_order = _model_b7(li, lv, words, Wd, H, gene_block,
                                 parent_order=True)
    assert order == want_order
    for c in range(cells):
        assert order[c] == sorted(set(order[c]))
    assert got.tobytes() == want.tobytes()
    plain = bell.bell_mse_bits_plain(
        torch.as_tensor(li), torch.as_tensor(lv),
        torch.as_tensor(words.view(np.int32)), torch.as_tensor(Wd),
        torch.as_tensor(H), gene_block=gene_block).numpy()
    np.testing.assert_array_equal(got[1], plain[1])
    assert plain[1].sum() > 0
    np.testing.assert_allclose(got[0], plain[0], rtol=2e-4, atol=1e-5)


# ------------------------------------------------------ B7's wide route

def _lane_parts(h, w, npl):
    """Each lane's fmaf chain over its columns l, l + 32, ... in order (the
    32 lanes at once), from +0."""
    acc = np.zeros(32, np.float32)
    for q in range(npl):
        sl = slice(32 * q, 32 * q + 32)
        acc = (h[sl].astype(np.float64) * w[sl].astype(np.float64)
               + acc.astype(np.float64)).astype(np.float32)
    return acc


def _model_b7_wide(li, lv, words, Wd, H, gene_block, plan, seed=None):
    """numpy model of B7's wide route on ``plan`` (csrc/bell_mse_bits.cu
    ``b7_wide_kernel``): the pass's bits; per tile of ``plan.cells`` cells,
    gene block and sub-block of ``plan.rows`` genes, each cell's live slots
    of the sub-block into keys (of two slots of one gene the one of the
    later group of 32, of a group the later half, of a half the lower
    slot: the parent's stores as the card resolves them);
    then the sub-block's genes in the order of a random permutation (the
    warps take them in any order), for each the tile's cells that hold it
    out in ascending order, four, two or one at a time, each dot one fmaf
    chain a lane and the reduce-scatter, the diff (total - A) in the
    cell's row; then per cell its diffs of the sub-block in ascending gene
    order, ``s = fmaf(diff, diff, s)``, the count by words. With ``seed``
    None, the parent's order instead (per cell, gene blocks and genes in
    order, the butterfly per entry, the same slot's value). Returns (2,
    cells) and each cell's genes in summing order."""
    cells, k = H.shape
    n_gb = Wd.shape[0] // gene_block
    width = li.shape[0] // n_gb
    C, R = plan.cells, plan.rows
    bm = _b7_bits(words, n_gb, gene_block, plan.n_ct * C, plan.bm_pitch)
    kp = 32 * plan.npl
    h = np.zeros((cells, kp), np.float32)
    h[:, :k] = H
    w = np.zeros((Wd.shape[0], kp), np.float32)
    w[:, :k] = Wd
    out = np.zeros((2, cells), np.float32)
    order = {c: [] for c in range(cells)}

    def held(c, gb, l):
        return (int(bm[gb, c, l >> 5]) >> (l & 31)) & 1

    def value(c, gb, l):
        """A(c, g): the value of the slot of highest rank 16 (s / 16) + 15
        - s % 16 that holds gene l, or 0."""
        ranks = [((s | 15) - (s & 15), s) for s in range(width)
                 if li[gb * width + s, c] == l]
        return lv[gb * width + max(ranks)[1], c] if ranks else _f32(0)

    def add(c, g, d):
        out[0, c] = _fma(d, d, out[0, c])
        order[c].append(g)

    if seed is None:
        for c in range(cells):
            for gb in range(n_gb):
                for l in range(gene_block):
                    if held(c, gb, l):
                        g = gb * gene_block + l
                        tot = _butterfly(_lane_parts(h[c], w[g],
                                                     plan.npl))[0]
                        add(c, g, _f32(tot - value(c, gb, l)))
                        out[1, c] = _f32(out[1, c] + 1)
        return out, order
    rng = np.random.default_rng(seed)
    for t in range(plan.n_ct):
        tile = range(t * C, min((t + 1) * C, cells))
        for gb in range(n_gb):
            for sb in range(plan.n_sb):
                lo, hi = sb * R, min((sb + 1) * R, gene_block)
                diff = {}
                for l in rng.permutation(np.arange(lo, hi)):
                    g = gb * gene_block + l
                    cs = [c for c in tile if held(c, gb, l)]
                    b = 0
                    while b < len(cs):
                        m = 4 if len(cs) - b >= 4 else min(2, len(cs) - b)
                        log = m.bit_length() - 1
                        parts = np.stack([_lane_parts(h[c], w[g], plan.npl)
                                          for c in cs[b:b + m]], axis=1)
                        tot = (_reduce_scatter(parts, m) if m > 1
                               else _butterfly(parts[:, 0]))
                        for e, c in enumerate(cs[b:b + m]):
                            diff[c, l] = _f32(tot[e << (5 - log)]
                                              - value(c, gb, l))
                        b += m
                for c in tile:
                    for q in range(lo >> 5, (hi + 31) >> 5):
                        word = int(bm[gb, c, q])
                        out[1, c] = _f32(out[1, c] + bin(word).count("1"))
                        for b in range(32):
                            if word >> b & 1:
                                add(c, gb * gene_block + 32 * q + b,
                                    diff[c, 32 * q + b])
    return out, order


@pytest.mark.parametrize("cells,n_gb,gene_block,width,k,inv,tile,rows", [
    (70, 2, 100, 8, 600, 5, 64, 32), (37, 3, 160, 8, 40, 5, 32, 64),
    (33, 2, 96, 6, 1024, 3, 32, 128), (16, 33, 8, 4, 513, 2, 64, 32),
    (40, 1, 64, 6, 64, 2, 64, 64), (20, 2, 64, 6, 1100, 3, 16, 32),
    (19, 1, 96, 8, 2100, 2, 8, 64)])
def test_b7_wide_schedule_matches_parent_and_plain(cells, n_gb, gene_block,
                                                   width, k, inv, tile,
                                                   rows):
    """B7's wide route's schedule (tiles of 64 or 32 cells, past k = 1024
    of 16 or 8, sub-blocks of 32, 64 or 128 genes, the genes in any
    order, a gene's entries four, two or one at a time) sums each cell's
    held-out genes once in ascending order and gives
    the parent's bits; both within rtol 2e-4 of the plain version with the
    same counts. A cell that holds one gene in slots 0 and 1 (slot 0's
    value), a cell with no live slot, gene blocks that are no multiple of
    the sub-block, a second word group (33 gene blocks) and tiles past the
    cells included."""
    li, lv = _planes(n_gb, width, cells, gene_block, cells + k, dup_cell=1,
                     empty_cell=2)
    genes = n_gb * gene_block
    rng = np.random.default_rng(k)
    Wd = (rng.random((genes, k)) / k).astype(np.float32)
    H = rng.random((cells, k)).astype(np.float32)
    words = maskbits.pack_mask_words(
        seed_pair(3), torch.arange(100, 100 + cells), genes_pad=genes,
        gene_block=gene_block, inv_density=inv, cells_true=100 + cells,
        genes_true=genes).numpy().view(np.uint32)
    plan = b7_wide_plan(cells, n_gb, gene_block, width, k)
    assert isinstance(plan, B7WidePlan)
    plan = plan._replace(cells=tile, n_ct=-(-cells // tile), rows=rows,
                         n_sb=-(-gene_block // rows))
    got, order = _model_b7_wide(li, lv, words, Wd, H, gene_block, plan,
                                seed=k)
    want, want_order = _model_b7_wide(li, lv, words, Wd, H, gene_block,
                                      plan)
    assert order == want_order
    for c in range(cells):
        assert order[c] == sorted(set(order[c]))
    assert got.tobytes() == want.tobytes()
    # the plain version sums a gene's two slots: it is given cell 1's
    # slot 0 alone, the value the kernel keeps
    one_li, one_lv = li.copy(), lv.copy()
    one_li[np.arange(n_gb) * width + 1, 1] = -1
    one_lv[np.arange(n_gb) * width + 1, 1] = 0.0
    plain = bell.bell_mse_bits_plain(
        torch.as_tensor(one_li), torch.as_tensor(one_lv),
        torch.as_tensor(words.view(np.int32)), torch.as_tensor(Wd),
        torch.as_tensor(H), gene_block=gene_block).numpy()
    np.testing.assert_array_equal(got[1], plain[1])
    assert plain[1].sum() > 0
    np.testing.assert_allclose(got[0], plain[0], rtol=2e-4, atol=1e-5)
