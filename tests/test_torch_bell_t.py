"""Kernel B4's host plan and schedule (``singlet_tpu_torch/ops/bell_cuda.py``
``b4_plan``, ``csrc/bell_spmm.cu``), on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_bell_cuda.py``).
What surrounds it is checked here: the plan is a function of the shapes
alone, covers every cell, gene row and output column exactly once, and
fits in a Hopper block's 232,448 bytes of shared memory for every
gene_block <= 1720 and k <= 512; the kernel's bucketing (a (row, cell)
bitmap walked in cell order) gives each gene's run in the order of a numpy
stable sort; and a numpy model of the kernel's schedule on the plan (row
groups, column tiles, cell tiles, chunks summed in chunk order) agrees
with the plain version, duplicate slots included. Tolerance of the model
against the plain version: max abs error <= 1e-5 * max |output|, as on the
card (the two differ only in the order of float32 sums).
"""

import numpy as np
import pytest
import torch

from singlet_tpu_torch.ops import bell, bell_cuda
from singlet_tpu_torch.ops.bell_cuda import b4_plan
from singlet_tpu_torch.ops.rngmask import seed_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (cells, n_gb, gene_block, k): the engine's shapes (the 524k operand's
# 8192-cell slice, its 2048-cell blocks and all its cells; the bench
# operand; the edge geometry) and the card tests' shapes where the plan
# splits rows, columns, tiles and chunks
SHAPES = [(8192, 32, 512, 100), (2048, 32, 512, 100), (524288, 32, 512, 100),
          (8192, 32, 512, 50), (3000, 40, 32, 7), (1000, 3, 256, 300),
          (2049, 2, 512, 129), (2049, 2, 1720, 512), (2049, 2, 1720, 100),
          (1, 1, 1, 1), (31, 1, 5, 3), (1000, 3, 256, 3)]


@pytest.mark.parametrize("cells,n_gb,gene_block,k", SHAPES)
def test_b4_plan_is_a_function_of_the_shapes(cells, n_gb, gene_block, k):
    plan = b4_plan(cells, n_gb, gene_block, k)
    assert plan == b4_plan(cells, n_gb, gene_block, k)
    assert all(isinstance(v, int) and v >= 1 for v in plan)


@pytest.mark.parametrize("cells,n_gb,gene_block,k", SHAPES)
def test_b4_plan_covers_everything_once(cells, n_gb, gene_block, k):
    """Every cell lies in exactly one tile of one chunk, every gene row of
    a gene block in one row group, every column in one column tile; each
    part is non-empty and within what a block holds (20 warps x 26 rows at
    1 or 2 columns a lane, x 13 at 4; 32 lanes x vec columns)."""
    p = b4_plan(cells, n_gb, gene_block, k)
    assert p.rows <= 20 * (13 if p.vec == 4 else 26)
    assert p.tile == 64
    n_tiles = -(-cells // p.tile)
    seen = np.zeros(cells, np.int64)
    for z in range(p.n_chunks):
        tiles = range(z * p.chunk_tiles, min(n_tiles, (z + 1) * p.chunk_tiles))
        assert len(tiles) > 0, z
        for t in tiles:
            seen[t * p.tile:(t + 1) * p.tile] += 1
    assert (seen == 1).all()
    rows = np.zeros(gene_block, np.int64)
    for rg in range(p.n_rg):
        r0 = rg * p.rows
        assert r0 < gene_block
        rows[r0:r0 + p.rows] += 1
    assert (rows == 1).all()
    cols = np.zeros(k, np.int64)
    for y in range(p.n_kt):
        j0 = y * 128
        kt = min(128, k - j0)
        assert 0 < kt <= 32 * p.vec
        cols[j0:j0 + kt] += 1
    assert (cols == 1).all()
    blocks = n_gb * p.n_rg * p.n_kt
    assert p.n_chunks == 1 or blocks * p.n_chunks <= 132


@pytest.mark.parametrize("k0,vec", [(1, 1), (33, 2), (65, 4), (97, 4)])
def test_b4_plan_fits_shared_memory(k0, vec):
    """For every gene_block <= 1720 and every k <= 512 in [k0, k0 + 32)
    (k past 128 is planned as 128 per column tile: a few stand for it)."""
    ks_k = list(range(k0, k0 + 32))
    if k0 == 97:
        ks_k += [129, 256, 300, 384, 511, 512]
    worst = 0
    for gene_block in range(1, 1721):
        for k in ks_k:
            p = b4_plan(2048, 1, gene_block, k)
            assert p.vec == vec
            assert p.smem == bell_cuda.b4_smem(p.rows, k)
            # the epilogue stages the (rows, columns) tile in the same
            # memory, rows rounded up to 16 bytes, before the flags
            assert p.rows * (-(-min(k, 128) // 4) * 4) * 4 <= p.smem - 16
            worst = max(worst, p.smem)
    assert worst <= 232448


def _planes(n_gb, width, cells, gene_block, seed, dup_cell=None):
    """Random planes (n_gb * width, cells): per (gene block, cell) a random
    count of distinct local ids in random slot order; with ``dup_cell``,
    that cell's slot 1 repeats its slot 0 in every gene block (a
    non-canonical operand)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(rng.random((n_gb, cells, gene_block)), axis=2)
    li = order[:, :, :width].astype(np.int32)
    count = rng.integers(0, width + 1, (n_gb, cells, 1))
    if dup_cell is not None:
        count[:, dup_cell] = width
        li[:, dup_cell, 1] = li[:, dup_cell, 0]
    live = np.arange(width)[None, None, :] < count
    li = np.where(live, li, -1)
    lv = np.where(live, rng.random(li.shape) + 0.1, 0.0).astype(np.float32)
    to2d = lambda x: np.ascontiguousarray(                     # noqa: E731
        x.transpose(0, 2, 1)).reshape(n_gb * width, cells)
    return to2d(li), to2d(lv)


def _bucket(li_t, lv_t, keep_t, r0, rows):
    """The kernel's bucketing of one (gene block, row group, tile): the
    (rows, C) bitmap and values of the kept slots whose local gene lies in
    [r0, r0 + rows), a duplicate's values summed in slot order."""
    width, C = li_t.shape
    bits = np.zeros((rows, C), bool)
    val = np.zeros((rows, C), np.float32)
    for c in range(C):
        for w in range(width):
            r = li_t[w, c] - r0
            if 0 <= r < rows and keep_t[w, c]:
                val[r, c] = val[r, c] + lv_t[w, c] if bits[r, c] else lv_t[w, c]
                bits[r, c] = True
    return bits, val


def test_b4_bucketing_runs_equal_a_stable_sort():
    """Walking each row's set bits in cell order visits its live slots in
    the order a stable sort by gene of the slots in cell order gives."""
    li, lv = _planes(1, 24, 64, 300, seed=5)
    keep = np.random.default_rng(6).random(li.shape) > 0.05
    for r0, rows in ((0, 150), (150, 150)):
        bits, val = _bucket(li, lv, keep, r0, rows)
        w_idx, c_idx = np.nonzero(li >= 0)
        order = np.lexsort((w_idx, c_idx))           # cell-major slot order
        w_idx, c_idx = w_idx[order], c_idx[order]
        gene = li[w_idx, c_idx] - r0
        sel = (gene >= 0) & (gene < rows) & keep[w_idx, c_idx]
        w_idx, c_idx, gene = w_idx[sel], c_idx[sel], gene[sel]
        by_gene = np.argsort(gene, kind="stable")
        runs = {}
        for i in by_gene:
            runs.setdefault(int(gene[i]), []).append(
                (int(c_idx[i]), float(lv[w_idx[i], c_idx[i]])))
        for r in range(rows):
            walk = [(int(c), float(val[r, c])) for c in np.nonzero(bits[r])[0]]
            assert walk == runs.get(r, []), r


def _model_b4(li, lv, H, keep, n_gb, gene_block):
    """numpy model of kernel B4 on ``b4_plan``: per (gene block, row group,
    column tile, chunk) the rows' sums over their live cells tile by tile in
    cell order (float32), then the chunks' partials summed in chunk order."""
    cells, k = H.shape
    width = li.shape[0] // n_gb
    p = b4_plan(cells, n_gb, gene_block, k)
    n_tiles = -(-cells // p.tile)
    partials = np.zeros((p.n_chunks, n_gb * gene_block, k), np.float32)
    for gb in range(n_gb):
        win = slice(gb * width, (gb + 1) * width)
        for rg in range(p.n_rg):
            r0 = rg * p.rows
            rows = min(p.rows, gene_block - r0)
            for z in range(p.n_chunks):
                acc = np.zeros((rows, k), np.float32)
                for t in range(z * p.chunk_tiles,
                               min(n_tiles, (z + 1) * p.chunk_tiles)):
                    cs = slice(t * p.tile, min(cells, (t + 1) * p.tile))
                    bits, val = _bucket(li[win, cs], lv[win, cs],
                                        keep[win, cs], r0, rows)
                    for r, c in zip(*np.nonzero(bits)):
                        acc[r] += val[r, c] * H[cs][c]
                g0 = gb * gene_block + r0
                partials[z, g0:g0 + rows] = acc
    out = partials[0].copy()
    for z in range(1, p.n_chunks):
        out += partials[z]
    return out, p


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gene_block,k,cells,dup", [
    (300, 100, 200, None),     # two row groups of 150, chunks of 64-cell tiles
    (40, 130, 150, 17),        # two column tiles; cell 17 repeats a gene
    (32, 7, 300, 299)])        # five chunks of one tile; the last cell
def test_b4_schedule_matches_plain(gene_block, k, cells, dup, masked):
    n_gb, width = 2, 12
    li, lv = _planes(n_gb, width, cells, gene_block, seed=gene_block + k,
                     dup_cell=dup)
    H = np.random.default_rng(k).random((cells, k)).astype(np.float32)
    seed = seed_pair(3) if masked else None
    keep = np.ones(li.shape, bool)
    if masked:
        for gb in range(n_gb):
            m = bell._keep(seed, 50, cells, gb * gene_block, gene_block, 4,
                           "cpu").numpy()
            win = li[gb * width:(gb + 1) * width]
            keep[gb * width:(gb + 1) * width] = np.where(
                win >= 0, m[np.arange(cells)[None, :], np.maximum(win, 0)], 1)
    got, plan = _model_b4(li, lv, H, keep, n_gb, gene_block)
    assert plan.n_chunks > 1 and (plan.n_rg > 1 or plan.n_kt > 1
                                  or plan.chunk_tiles == 1)
    want = bell.bell_spmm_t_plain(
        torch.as_tensor(li), torch.as_tensor(lv), torch.as_tensor(H), seed,
        50, gene_block=gene_block, n_gb=n_gb, inv_density=4).numpy()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
