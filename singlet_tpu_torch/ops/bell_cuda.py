"""Kernels B3-B7: blocked-ELL SpMM and the fused test MSE, hand-written in
CUDA.

B3 (``bell_spmm_cuda``) replaces ``singlet_tpu/ops/pallas_bell.py``
``bell_spmm`` and B4 (``bell_spmm_t_cuda``) replaces ``bell_spmm_t``, both
in their plain and in their masked (in-kernel hashed keep factor) forms; B5
(``bell_spmm_bits_cuda``) and B6 (``bell_spmm_t_bits_cuda``) replace
``bell_spmm_bits`` and ``bell_spmm_t_bits``: the same two kernels with the
keep factor read from the packed test-mask words. Their source is
``csrc/bell_spmm.cu``. B7 (``bell_mse_bits_cuda``) replaces
``bell_mse_bits``; its source is ``csrc/bell_mse_bits.cu`` (a pass into
test bits by gene block, then tiles of cells that read Wd's rows from
shared memory, ``b7_plan``). Wide routes take what those tiles cannot
hold: B3 and B5 on gene blocks whose two slices of W do not fit in shared
memory (``bell_spmm_wide``: 4 to 32 lanes a cell sized to k, a window of
slot rows keep-tested once in shared memory, 16 of a lane's W rows in
flight from L2, ``b3_wide_plan``),
B7 past k = 512 or where no tile fits (``bell_mse_bits_wide``: the H rows
of a tile of cells in shared memory, warps that own genes and hold each of
Wd's rows in registers, up to k = 1024; past it Wd's rows streamed through
L1 inside the dot; a cell's slots of a wide gene block walked in passes;
``b7_wide_plan``); each keeps the order of the sums its plan documents.
Each source's header note gives the design and what bounds it on the
card; ``_build.py`` compiles them with nvcc at first use and this module
binds them with ctypes.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version (``ops/bell.py``), because there is no
card to launch on. Importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from singlet_tpu_torch.ops.bell import (bell_mse_bits_plain,
                                        bell_spmm_bits_plain,
                                        bell_spmm_plain,
                                        bell_spmm_t_bits_plain,
                                        bell_spmm_t_plain)
from singlet_tpu_torch.ops.nnls_cuda import _check

# kernel launches on CUDA tensors of B3 and of B4 (one per wrapper call
# with cells, at any k); read by chip_smoke.py to show that a fit went
# through the kernels
LAUNCHES_SPMM = 0
LAUNCHES_SPMM_T = 0
# likewise B5 (its test bits' pass included), B6 and B7
LAUNCHES_SPMM_BITS = 0
LAUNCHES_SPMM_T_BITS = 0
LAUNCHES_MSE_BITS = 0
# the launches of those counts that took a wide route: B3's and B5's
# wide-block route, and B7's wide route (k > 512 or a gene block whose
# tile does not fit)
LAUNCHES_SPMM_WIDE = 0
LAUNCHES_SPMM_BITS_WIDE = 0
LAUNCHES_MSE_BITS_WIDE = 0

# B3's plan (csrc/bell_spmm.cu): one block an SM of 16 warps that walk, a
# quarter-warp per cell, 64 cells at once, 1, 2 or 4 times (64 to 256
# cells a block), and 4 that stage; output columns in tiles of at most 32,
# a multiple of 4, the blocks of two neighbouring column tiles of a cell
# tile in a cluster that keep-tests each window once; shared memory
# holds two buffers of a gene block's slice of W for the tile with a zero
# row, two of the cells' slot window (all the slot rows of a gene block up
# to 72 of them, the column tile sized for it; wider planes in windows of
# what fits) and this block's share of the window; the plan wants at
# least one block per SM of an H100 (132 SMs) in the grid
_SMS = 132
_SMEM_BLOCK = 232448
_B3_CELLS_PASS = 64
_B3_COLS = 32
_B3_ROUNDS = (4, 2, 1)
_B3_WIN_ROWS = 72
_B3_CLUSTER = 2
# B3's wide-block route (bell_spmm.cu ``bell_spmm_wide``): blocks of 256
# threads, 4, 8, 16 or 32 lanes a cell, each lane one load of VW adjacent
# columns (4; for B5 2 where k is 2 mod 4), or two past 32 VW columns
_B3_WIDE_THREADS = 256
_B3_WIDE_LANES = (4, 8, 16, 32)
# B7 (csrc/bell_mse_bits.cu) keeps its cells' H rows in registers, up to
# 16 columns a lane; a block of up to 15 walker warps (16 where their H
# rows take at most 16 floats a lane) and a producer, Wd's slice of a
# sub-block of 128, 64 or 32 genes in two buffers; past k = 512, or where
# no such tile fits, the wide route: 16 warps a block, the H rows of a
# tile of 64 or 32 cells in shared memory beside a row of keys a cell for
# a sub-block of 128, 64 or 32 genes, a thread's share of its cell's slots
# of a gene block (at most 10 a pass) in registers, Wd's rows in registers
# up to k = 1024 (MAX_K_MSE_WIDE); past it streamed from L1/L2 inside the
# dot, tiles of 32, 16 or 8 cells whose H rows fit (else 32 whose H rows
# are read from device memory)
MAX_K_MSE = 512
MAX_K_MSE_WIDE = 1024
_B7_TILES = (64, 32)
_B7_STREAM_TILES = (32, 16, 8)
_B7_WIDE_ROWS = (128, 64, 32)
_B7_MAX_STEPS = 65536
_B7_WALKERS = 15
_B7_ROWS = (128, 64, 32)
_B7_NPL = (1, 2, 4, 8, 12, 16)
_B7_BATCH = 8
# B7's plan: the weight of a tile's stream of Wd through L2, per float of
# a row, against the walk's cost of an entry on one SM (its shared-memory
# wavefronts, at a 5% test set)
_B7_WD_COST = 0.04

# B4's plan (csrc/bell_spmm.cu): 20 warps a block, each holding the
# outputs of 26 gene rows at 1 or 2 adjacent columns a lane (k <= 64) or of
# 13 at 4; output columns in tiles of 128; cells in tiles of 64, of which
# the first 32 slot rows are staged in shared memory; and in chunks until
# there is about one block per SM of an H100 (at most 16, which bounds the
# chunks' scratch)
_B4_WARPS = 20
_B4_GENES = {1: 26, 2: 26, 4: 13}
_B4_COLS = 128
_B4_TILE = 64
_B4_WIN_ROWS = 32
_B4_MAX_CHUNKS = 16


class B3Plan(NamedTuple):
    """B3's split of one call's work (see ``b3_plan``)."""
    kt: int            # columns a column tile (a multiple of 4, <= 32)
    n_kt: int          # column tiles
    rounds: int        # passes of 64 cells a block: 1, 2 or 4
    cells: int         # cells a block, 64 * rounds
    n_ct: int          # cell tiles
    win: int           # slot rows a window (the width, if it fits)
    cs: int            # blocks of a cluster (neighbouring column tiles)
    smem: int          # dynamic shared memory a block, bytes


class B3WidePlan(NamedTuple):
    """B3's wide-block route (``bell_spmm_wide``, see ``b3_wide_plan``):
    256 / cells lanes a cell, a column chunk of ``cols`` a block, W's rows
    read from device memory ``vw`` floats a load."""
    cols: int          # columns a chunk: vw or 2 vw a lane (8 to 256)
    n_kt: int          # column chunks
    cells: int         # cells a block: 64, 32, 16 or 8 (4 to 32 lanes each)
    n_ct: int          # cell tiles (blocks along the cells)
    vw: int = 4        # adjacent floats of W a load: 4 or 2


def b3_bm_words(gene_block: int) -> int:
    """Words of a cell's test bits of one gene block in B5 (bell_spmm.cu
    ``b3_bm_words``): ceil(gene_block / 32)."""
    return -(-gene_block // 32)


def b3_smem(gene_block: int, win: int, kt: int, rounds: int, cs: int,
            bits: bool = False) -> int:
    """Bytes of B3's dynamic shared memory (bell_spmm.cu
    ``b3_smem_bytes``): two buffers of W's slice (whole TMA boxes of up to
    256 gene rows by kt, a zero row and the last lanes' over-read, in
    128-byte units), two of the (win, 64 * rounds) slot window of 8-byte
    (offset, value) pairs, the ids and the values of the block's share of
    a window (ceil(win / cs) rows, each in 128-byte units), with ``bits``
    (B5) the cells' test bits of a gene block, and five mbarriers."""
    box = min(gene_block, 256)
    w_floats = -(-(-(-gene_block // box) * box * kt + 32) // 32) * 32
    c = _B3_CELLS_PASS * rounds
    raw = -(-(-(-win // cs) * c) // 32) * 32
    bm = c * b3_bm_words(gene_block) if bits else 0
    return 2 * w_floats * 4 + 2 * win * c * 8 + 2 * raw * 4 + bm * 4 + 40


@functools.lru_cache(maxsize=256)
def b3_plan(cells: int, n_gb: int, gene_block: int, width: int, k: int,
            bits: bool = False):
    """B3's plan, from the shapes alone: the fewest column tiles of at
    most 32 columns, split evenly in multiples of 4, in clusters of two
    where the tiles pair up (narrower tiles where two slices of W would not
    fit beside the windows of 64 cells and min(width, 72) slot rows); then
    the most cells a block (1, 2 or 4 passes of 64) whose window holds all
    the slot rows and that gives at least one block per SM, else 64; planes
    too wide for that are walked in windows of what fits; with ``bits``
    (B5) the blocks also hold their cells' test bits of a gene block.
    Where even two slices of W of 4 columns do not fit (gene blocks past
    7,168 genes, or 5,632 with ``bits``), the wide-block route's
    ``b3_wide_plan``. Each
    output is one thread's sum over its cell's gene blocks in order and, in
    each, its kept slots in slot order, whatever the plan: the plan does not
    change the bits. ``n_gb`` does not enter it."""
    rows = max(1, min(width, _B3_WIN_ROWS))

    def smem(win, kt, rounds, cs):
        return b3_smem(gene_block, win, kt, rounds, cs, bits)

    if smem(1, 4, 1, 1) > _SMEM_BLOCK:
        # two slices of W of the gene block do not fit: the wide-block
        # route
        return b3_wide_plan(cells, k, bits)
    for kt_max in range(_B3_COLS, 0, -4):
        n_kt = -(-k // kt_max)
        kt = -(-(-(-k // n_kt)) // 4) * 4
        n_kt = -(-k // kt)
        cs = _B3_CLUSTER if n_kt % _B3_CLUSTER == 0 else 1
        if kt == 4 or smem(rows, kt, 1, cs) <= _SMEM_BLOCK:
            break

    def win(rounds):
        """The most slot rows up to the width (and 256) that fit."""
        w = max(1, min(width, 256))
        while w > 1 and smem(w, kt, rounds, cs) > _SMEM_BLOCK:
            w -= 1
        return w

    def blocks(rounds):
        return -(-cells // (_B3_CELLS_PASS * rounds)) * n_kt

    fits = [r for r in _B3_ROUNDS if smem(1, kt, r, cs) <= _SMEM_BLOCK]
    cands = [r for r in fits if win(r) >= min(width, 256)] or fits
    rounds = next((r for r in cands if blocks(r) >= _SMS), cands[-1])
    return B3Plan(kt, n_kt, rounds, _B3_CELLS_PASS * rounds,
                  -(-cells // (_B3_CELLS_PASS * rounds)), win(rounds), cs,
                  smem(win(rounds), kt, rounds, cs))


def b3_wide_plan(cells: int, k: int, bits: bool = False) -> B3WidePlan:
    """B3's wide-block route: loads of vw = 4 adjacent columns of W, or
    for B5 (``bits``) 2 where k is 2 mod 4 (no padded copy of W, and twice
    the lanes and blocks to hide the test words' latency: 12% faster than
    4 at k = 50 on an H100, where B3 is 3-10% faster with 4); the fewest
    lanes a cell (4, 8, 16 or 32) whose loads cover k, or 32 vw of it;
    past 32 vw columns 32 lanes of two loads (chunks of 64 vw); a block of
    256 threads holds 256 / lanes cells. Every output is one lane's fmaf
    chain over its cell's kept slots in order, whatever the plan: it does
    not change the bits."""
    vw = 2 if bits and k % 4 == 2 else 4
    lanes = next(n for n in _B3_WIDE_LANES if vw * n >= min(k, 32 * vw))
    cols = vw * lanes * (2 if k > 32 * vw else 1)
    tile = _B3_WIDE_THREADS // lanes
    return B3WidePlan(cols, -(-k // cols), tile, -(-cells // tile), vw)


class B4Plan(NamedTuple):
    """B4's split of one call's work (see ``b4_plan``)."""
    vec: int           # adjacent output columns a lane: 1, 2 or 4
    rows: int          # gene rows a block (a row group of a gene block)
    n_rg: int          # row groups a gene block
    n_kt: int          # column tiles of at most 128
    tile: int          # cells a tile
    chunk_tiles: int   # tiles a chunk of cells
    n_chunks: int
    smem: int          # dynamic shared memory a block, bytes


def _b4_vec(k: int) -> int:
    """Adjacent output columns a lane of B4 holds: 1, 2 or 4, for column
    tiles of at most 32, 64 or 128."""
    cols = min(k, _B4_COLS)
    return 1 if cols <= 32 else 2 if cols <= 64 else 4


def b4_smem(rows: int, k: int) -> int:
    """Bytes of B4's dynamic shared memory (bell_spmm.cu
    ``b4_smem_bytes``): a window of 32 slot rows (ids and values), the
    (rows, tile) values, two (rows, tile) bitmaps, two H tiles (rows
    rounded up to 16 bytes, plus the last row's over-read) and four
    flags."""
    cols = min(k, _B4_COLS)
    h_floats = _B4_TILE * (-(-cols // 4) * 4) + 32 * _b4_vec(k)
    return (2 * h_floats * 4 + _B4_WIN_ROWS * _B4_TILE * 8
            + rows * _B4_TILE * 4 + 2 * rows * (_B4_TILE // 32) * 4 + 16)


@functools.lru_cache(maxsize=256)
def b4_plan(cells: int, n_gb: int, gene_block: int, k: int) -> B4Plan:
    """B4's plan, from the shapes alone: each gene block in row groups of
    at most 20 warps x 26 or 13 rows, k in column tiles of 128, the cells in
    tiles of 64 and in chunks of tiles. Every output's sum runs over its
    live cells in cell order within a chunk and over the chunks in order,
    so the plan fixes the bits of the result."""
    vec = _b4_vec(k)
    n_rg = -(-gene_block // (_B4_WARPS * _B4_GENES[vec]))
    rows = -(-gene_block // n_rg)
    n_kt = -(-k // _B4_COLS)
    n_tiles = max(1, -(-cells // _B4_TILE))
    per_chunk = n_gb * n_rg * n_kt
    n_chunks = max(1, min(_B4_MAX_CHUNKS, _SMS // per_chunk, n_tiles))
    chunk_tiles = -(-n_tiles // n_chunks)
    return B4Plan(vec, rows, n_rg, n_kt, _B4_TILE, chunk_tiles,
                  -(-n_tiles // chunk_tiles), b4_smem(rows, k))


class B7Plan(NamedTuple):
    """B7's split of one call's work (see ``b7_plan``)."""
    npl: int           # H columns a lane (k <= 32 npl): 1, 2, 4, 8, 12, 16
    cpw: int           # cells a walker warp
    walkers: int       # walker warps a block
    cells: int         # cells a block, walkers * cpw
    n_ct: int          # cell tiles (blocks)
    rows: int          # genes a sub-block: 128, 64 or 32
    n_sb: int          # sub-blocks a gene block
    bm_pitch: int      # words of a cell's test bits of a gene block
    smem: int          # dynamic shared memory a block, bytes


class B7WidePlan(NamedTuple):
    """B7's wide route (``bell_mse_bits_wide``, see ``b7_wide_plan``): the
    test-bit pass, then tiles of cells whose H rows sit in shared memory,
    warps that own genes."""
    npl: int           # columns of a lane's dot chain (k <= 32 npl); past
                       # 32 Wd's rows streamed inside the dot
    cells: int         # cells a tile (block): 64 or 32; past npl 32, 32,
                       # 16 or 8
    n_ct: int          # cell tiles (blocks)
    rows: int          # genes a sub-block: 128, 64 or 32
    n_sb: int          # sub-blocks a gene block
    bm_pitch: int      # words of a cell's test bits of a gene block
    smem: int          # dynamic shared memory a block, bytes
    h_shared: bool = True   # H's rows in shared memory, else read from
                            # device memory (no tile of 8 fits)


def b7_npl(k: int) -> int:
    """H columns a lane of B7: ceil(k / 32) rounded up to 1, 2, 4, 8, 12
    or 16."""
    return next(n for n in _B7_NPL if 32 * n >= k)


def b7_cpws(npl: int) -> tuple:
    """Cells a walker of B7 may keep in registers (bell_mse_bits.cu
    ``cpw_ok``): 32 floats of H a lane (at least 2 cells, at most 16), 8,
    4 and 1."""
    top = 2 if npl >= 12 else min(16, 32 // npl)
    return tuple(c for c in (32, 16, 8, 4, 2, 1) if c in (top, 8, 4, 1)
                 and c <= top)


def b7_max_walkers(npl: int, cpw: int) -> int:
    """Walker warps a block of B7 may have (bell_mse_bits.cu
    ``max_walkers``): 16 where a walker's H rows take at most 16 floats a
    lane (17 warps at up to 96 registers), else 15."""
    return _B7_WALKERS + 1 if npl * cpw <= 16 else _B7_WALKERS


def b7_bm_pitch(gene_block: int) -> int:
    """Words of a cell's test bits of a gene block in B7's pass output:
    ceil(gene_block / 32) rounded up to 8."""
    return -(-gene_block // 256) * 8


def b7_smem(rows: int, npl: int, cells: int, bm_pitch: int, walkers: int,
            width: int) -> int:
    """Bytes of B7's dynamic shared memory (bell_mse_bits.cu
    ``b7_layout``): two buffers of Wd's (rows, 32 npl) slice, two of the
    tile's test bits of a gene block, a walker's row of ``rows`` (tag,
    value) pairs, 8 floats of scratch and a list of rows + 8 genes, two
    buffers of the tile's slot ids and two of its values (width rows of
    cells + 1), four mbarriers."""
    off = 2 * rows * 32 * npl * 4 + 2 * cells * bm_pitch * 4
    off += walkers * (3 * rows + 2 * _B7_BATCH) * 4
    off += 4 * width * (cells + 1) * 4
    return -(-off // 16) * 16 + 32


@functools.lru_cache(maxsize=256)
def b7_plan(cells: int, n_gb: int, gene_block: int, width: int, k: int):
    """B7's plan, from the shapes alone: H columns a lane from k;
    sub-blocks of 128 genes, or 64 or 32 where Wd's slices would not fit;
    of the (cells a walker in ``b7_cpws``, walkers up to
    ``b7_max_walkers``) whose tile fits in shared memory, the one of
    least cost: the longer of walking the cells (the waves of tiles over
    the card's 132 SMs, a tile with fewer than 16 walkers hiding less of
    the walk's latency) and streaming Wd through L2 once per tile; then
    the most walkers. Every cell's squared errors are summed over its
    held-out genes in ascending order whatever the plan: the plan does not
    change the bits. ``n_gb`` does not enter it. Past k = 512, or where no
    tile fits in shared memory, a wide route (``b7_wide_plan``)."""
    if k < 1:
        raise ValueError(f"kernel B7 takes k >= 1, got {k}")
    if k > MAX_K_MSE:
        return b7_wide_plan(cells, n_gb, gene_block, width, k)
    npl = b7_npl(k)
    bm_pitch = b7_bm_pitch(gene_block)
    for rows in _B7_ROWS:
        fits = [(cpw, w) for cpw in b7_cpws(npl)
                for w in range(b7_max_walkers(npl, cpw), 0, -1)
                if b7_smem(rows, npl, w * cpw, bm_pitch, w, width)
                <= _SMEM_BLOCK]
        if not fits:
            continue

        def cost(cw):
            # in units of an entry's shared-memory wavefronts on one SM:
            # the longer of walking the cells (waves of tiles over the
            # SMs, npl + 6 an entry, fewer than 16 walkers a tile hiding
            # less) and streaming Wd through L2 once per tile, at a 5%
            # test set; then the most walkers
            c = cw[0] * cw[1]
            tiles = -(-max(cells, 1) // c)
            walk = (-(-tiles // _SMS) * c * (npl + 6)
                    * max(1.0, (_B7_WALKERS + 1) / cw[1]))
            return max(walk, tiles * 32 * npl * _B7_WD_COST), -cw[1]

        cpw, walkers = min(fits, key=cost)
        c = walkers * cpw
        return B7Plan(npl, cpw, walkers, c, -(-max(cells, 1) // c), rows,
                      -(-gene_block // rows), bm_pitch,
                      b7_smem(rows, npl, c, bm_pitch, walkers, width))
    return b7_wide_plan(cells, n_gb, gene_block, width, k)


def b7_wide_smem(npl: int, cells: int, rows: int,
                 h_shared: bool = True) -> int:
    """Bytes of the wide route's dynamic shared memory (bell_mse_bits.cu
    ``b7_wide_smem``): the tile's H rows of 32 npl floats (none where they
    are read from device memory), a row of ``rows`` 8-byte keys a cell and
    the tile's bits of a sub-block."""
    return ((cells * 32 * npl * 4 if h_shared else 0) + cells * rows * 8
            + rows // 32 * cells * 4)


@functools.lru_cache(maxsize=256)
def b7_wide_plan(cells: int, n_gb: int, gene_block: int, width: int,
                 k: int) -> B7WidePlan:
    """B7's route where the tiled kernel cannot run, from the shapes alone:
    tiles of cells (``B7WidePlan``) for every k, gene block and width. Up
    to k = 1024 (Wd's rows in registers) 64 cells a tile, or 32 where
    32-cell tiles make one wave over the card's 132 SMs (or where 64 H rows
    do not fit); past it (Wd's rows streamed) the largest of 32, 16 and 8
    cells whose H rows fit; then the first that fits 232,448 bytes with
    sub-blocks of 128, 64 or 32 genes (the largest that fits) and at most
    65,535 sub-blocks a call. Where not even 8 H rows fit (k > 7,168),
    tiles of 32 read H's rows from device memory. A gene block's slots
    past a thread's 10 registers (width > 10 * 512 / cells) are walked in
    passes. Every cell's squared errors are summed over its held-out genes
    in ascending order whatever the plan. Raises where the sub-blocks
    exceed the keys' 16-bit tag (more than about 8.4M genes)."""
    if k < 1:
        raise ValueError(f"kernel B7 takes k >= 1, got {k}")
    n_ct = lambda c: -(-max(cells, 1) // c)                 # noqa: E731
    if k <= MAX_K_MSE_WIDE:
        npl = b7_npl(k) if k <= MAX_K_MSE else -(-k // 32)
        tiles = (32,) if n_ct(32) <= _SMS else _B7_TILES
    else:
        npl = -(-k // 32)
        tiles = _B7_STREAM_TILES
    routes = [(True, tiles)]
    if k > MAX_K_MSE_WIDE:   # no tile's H rows fit: read from device memory
        routes.append((False, (32,)))
    for h_shared, tiles in routes:
        for tile in tiles:
            for rows in _B7_WIDE_ROWS:
                smem = b7_wide_smem(npl, tile, rows, h_shared)
                n_sb = -(-gene_block // rows)
                if smem <= _SMEM_BLOCK and n_gb * n_sb < _B7_MAX_STEPS:
                    return B7WidePlan(npl, tile, n_ct(tile), rows, n_sb,
                                      b7_bm_pitch(gene_block), smem,
                                      h_shared)
    raise ValueError(f"kernel B7 takes fewer than {_B7_MAX_STEPS} "
                     f"sub-blocks of 128 genes a call, got {n_gb} gene "
                     f"blocks of {gene_block}")


def b7_wd_operand(Wd: torch.Tensor, npl: int) -> torch.Tensor:
    """Wd (rows, k) as B7 reads it: rows of 32 npl floats, zeros past k,
    lane l's columns l + 32 s, s = 4 q .. 4 q + 3, at 128 q + 4 l (npl a
    multiple of 4; for npl = 2 lane l's two at 2 l, for npl = 1 in
    place)."""
    rows, k = Wd.shape
    kp = 32 * npl
    pad = torch.zeros((rows, kp), dtype=torch.float32, device=Wd.device)
    pad[:, :k] = Wd
    if npl == 1:
        return pad
    v = min(npl, 4)
    return (pad.view(rows, npl // v, v, 32).transpose(2, 3)
            .reshape(rows, kp).contiguous())


_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# keep mode, seed, cell offset, inv_density, words, words' row stride,
# stream
_KEEP_ARGTYPES = [_CI, ctypes.c_uint64, _CL, _CI, _VP, _CL, _VP]
# bell_spmm: planes, ld, n_gb, width, cells, gene_block, W, its row
# stride, k, B, kt, rounds, win, cs, then the keep arguments with the test
# bits' scratch before the stream
ARGTYPES_B3 = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CL, _CI, _VP, _CI,
               _CI, _CI, _CI] + _KEEP_ARGTYPES[:-1] + [_VP, _VP]
# bell_spmm_wide: planes, ld, n_gb, width, cells, gene_block, W, its row
# stride, k, B, the plan's cols, cells a block and floats a load, then the
# keep arguments
ARGTYPES_B3_WIDE = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CL, _CI,
                    _VP, _CI, _CI, _CI] + _KEEP_ARGTYPES
# bell_spmm_t: planes, ld, n_gb, width, cells, gene_block, H, k, Bw,
# partials, counters, rows, chunk_tiles, n_chunks, h_vec, p_vec, then the
# keep arguments
ARGTYPES_B4 = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CI, _VP, _VP, _VP,
               _CI, _CI, _CI, _CI, _CI] + _KEEP_ARGTYPES

# bell_mse_bits_wide: planes, ld, n_gb, width, cells, gene_block, words,
# their row stride, Wd, H, k, npl, cells a tile, rows a sub-block, H's rows
# in shared memory or not, the bits' scratch, cells_pad, bm_pitch, out,
# stream
ARGTYPES_B7_WIDE = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CL, _VP, _VP,
                    _CI, _CI, _CI, _CI, _CI, _VP, _CI, _CI, _VP, _VP]
# the entry of csrc/bell_mse_bits_wide_warp.cu, the warp-a-cell kernel the
# wide route replaced (timed in turns, the card tests' bits): planes, ld,
# n_gb, width, cells, gene_block, words, their row stride, Wd, H, k, out,
# stream
ARGTYPES_B7_WARP = [_VP, _VP, _CL, _CI, _CI, _CI, _CI, _VP, _CL, _VP, _VP,
                    _CI, _VP, _VP]

_LIB = {}


def _lib():
    if "lib" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("bell_spmm")
        lib.bell_spmm.argtypes = ARGTYPES_B3
        lib.bell_spmm.restype = ctypes.c_int
        lib.bell_spmm_wide.argtypes = ARGTYPES_B3_WIDE
        lib.bell_spmm_wide.restype = ctypes.c_int
        lib.bell_spmm_t.argtypes = ARGTYPES_B4
        lib.bell_spmm_t.restype = ctypes.c_int
        lib.bell_spmm_error_string.argtypes = [ctypes.c_int]
        lib.bell_spmm_error_string.restype = ctypes.c_char_p
        _LIB["lib"] = lib
    return _LIB["lib"]


def _mse_lib():
    if "mse" not in _LIB:
        from singlet_tpu_torch import _build

        lib = _build.load("bell_mse_bits")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bell_mse_bits.argtypes = [vp, vp, cl, ci, ci, ci, ci, vp, cl, vp,
                                      vp, ci, ci, ci, ci, ci, vp, ci, ci, vp,
                                      vp]
        lib.bell_mse_bits.restype = ci
        lib.bell_mse_bits_wide.argtypes = ARGTYPES_B7_WIDE
        lib.bell_mse_bits_wide.restype = ci
        lib.bell_mse_bits_error_string.argtypes = [ci]
        lib.bell_mse_bits_error_string.restype = ctypes.c_char_p
        _LIB["mse"] = lib
    return _LIB["mse"]


def _check_planes(b_li, b_val, n_gb, device):
    """The planes may be a column slice of the engine's planes: cells must
    be contiguous (stride 1), rows any stride, both planes alike."""
    for name, t, dtype in (("b_li", b_li, torch.int32),
                           ("b_val", b_val, torch.float32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be 2-D with contiguous cells "
                             "(stride 1 on its last axis)")
    if b_li.shape != b_val.shape or b_li.stride() != b_val.stride():
        raise ValueError("b_li and b_val must have one shape and strides")
    if b_li.shape[0] % n_gb:
        raise ValueError(f"{b_li.shape[0]} plane rows do not split into "
                         f"{n_gb} gene blocks")


def _seed_args(seed, inv_density):
    if int(inv_density) < 1:
        raise ValueError(f"inv_density must be >= 1, got {inv_density}")
    if seed is None:
        return 0, 0
    hi, lo = int(seed[0]), int(seed[1])
    return 1, ((hi & 0xFFFFFFFF) << 32) | (lo & 0xFFFFFFFF)


def _check_words(words, cells, n_gb, gene_block, device):
    """The packed test-mask words of the planes' cells: (cells, n_t *
    gene_block) int32, rows contiguous (a row slice of the engine's words
    is)."""
    wcols = -(-n_gb // 32) * gene_block
    if words.device != device:
        raise ValueError(f"words is on {words.device}, expected {device}")
    if words.dtype != torch.int32:
        raise TypeError(f"words has dtype {words.dtype}, expected "
                        "torch.int32")
    if tuple(words.shape) != (cells, wcols) or not words.is_contiguous():
        raise ValueError(f"words must be contiguous ({cells}, {wcols}), got "
                         f"{tuple(words.shape)}")


def _raise_on(err, symbol, error_string=None):
    if err != 0:
        error_string = error_string or _lib().bell_spmm_error_string
        msg = error_string(err).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({err})")


def _tma_ready(*xs: torch.Tensor) -> bool:
    """Whether TMA reads these rows as they are: addresses a multiple of
    16 bytes, row strides of 4 elements."""
    return all(x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0 for x in xs)


def _padded(X: torch.Tensor) -> torch.Tensor:
    """A copy of X (rows, cols) in rows padded to a multiple of 4."""
    out = torch.empty((X.shape[0], -(-X.shape[1] // 4) * 4), dtype=X.dtype,
                      device=X.device)
    out[:, :X.shape[1]] = X
    return out[:, :X.shape[1]]


def _launch_b3(b_li, b_val, W, mode, seed64, cell_offset, inv_density,
               words, *,
               gene_block: int) -> tuple[torch.Tensor, int, int]:
    """One launch of bell_spmm.cu's ``bell_spmm`` (B3 with keep mode 0 or
    1, B5 with mode 2) on ``b3_plan``, for any k, or of ``bell_spmm_wide``
    where the plan takes the wide-block route; checks its arguments and
    returns B (cells, k), the number of launches (0 without cells or
    columns) and of them on the wide-block route. The tiled kernel reads W and the planes by TMA: where their
    addresses or row strides do not allow it, it reads padded copies."""
    rows_w, k = W.shape
    if rows_w % gene_block:
        raise ValueError(f"W has {rows_w} rows, not a multiple of "
                         f"gene_block {gene_block}")
    n_gb = rows_w // gene_block
    _check("W", W, (rows_w, k), torch.float32, W.device)
    _check_planes(b_li, b_val, n_gb, W.device)
    cells = b_li.shape[1]
    if words is not None:
        _check_words(words, cells, n_gb, gene_block, W.device)
    B = torch.empty((cells, k), dtype=torch.float32, device=W.device)
    if cells == 0 or k == 0:
        return B, 0, 0
    width = b_li.shape[0] // n_gb
    plan = b3_plan(cells, n_gb, gene_block, width, k, mode == 2)
    if isinstance(plan, B3WidePlan):
        # W's rows vw floats a load: a padded copy where W does not allow it
        aligned = (W.data_ptr() % (4 * plan.vw) == 0
                   and W.stride(0) % plan.vw == 0)
        Wt = W if aligned else _padded(W)
        with torch.cuda.device(W.device):
            stream = torch.cuda.current_stream(W.device).cuda_stream
            err = _lib().bell_spmm_wide(
                b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
                width, cells, gene_block, Wt.data_ptr(), Wt.stride(0), k,
                B.data_ptr(), plan.cols, plan.cells, plan.vw, mode, seed64,
                int(cell_offset),
                int(inv_density), None if words is None else words.data_ptr(),
                0 if words is None else words.stride(0), stream)
        _raise_on(err, "bell_spmm_wide")
        return B, 1, 1
    # mode 2: scratch for the test bits by gene block that the kernel's
    # first pass writes
    bm = (torch.empty(n_gb * b3_bm_words(gene_block) * (-(-cells // 4) * 4),
                      dtype=torch.int32, device=W.device)
          if mode == 2 else None)
    li, lv = ((b_li, b_val) if _tma_ready(b_li, b_val)
              else (_padded(b_li), _padded(b_val)))
    Wt = W if _tma_ready(W) else _padded(W)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = _lib().bell_spmm(
            li.data_ptr(), lv.data_ptr(), li.stride(0), n_gb, width, cells,
            gene_block, Wt.data_ptr(), Wt.stride(0), k, B.data_ptr(),
            plan.kt, plan.rounds, plan.win, plan.cs, mode, seed64,
            int(cell_offset), int(inv_density),
            None if words is None else words.data_ptr(),
            0 if words is None else words.stride(0),
            None if bm is None else bm.data_ptr(), stream)
    _raise_on(err, "bell_spmm")
    return B, 1, 0


def bell_spmm_cuda(b_li, b_val, W, seed=None, cell_offset: int = 0, *,
                   gene_block: int, inv_density: int = 20) -> torch.Tensor:
    """Kernel B3: B (cells, k) = the (keep-masked, with ``seed``) product
    of the planes with W (n_gb * gene_block, k), one launch for any k. On
    CPU tensors, the plain version."""
    if W.device.type != "cuda":
        return bell_spmm_plain(b_li, b_val, W, seed, cell_offset,
                               gene_block=gene_block,
                               inv_density=inv_density)
    global LAUNCHES_SPMM, LAUNCHES_SPMM_WIDE
    masked, seed64 = _seed_args(seed, inv_density)
    B, launches, wide = _launch_b3(b_li, b_val, W, masked, seed64,
                                   cell_offset, inv_density, None,
                                   gene_block=gene_block)
    LAUNCHES_SPMM += launches
    LAUNCHES_SPMM_WIDE += wide
    return B


def bell_spmm_bits_cuda(b_li, b_val, W, words, *,
                        gene_block: int) -> torch.Tensor:
    """Kernel B5: B3 keep-masked by the test bits of ``words`` (cells, n_t *
    gene_block) int32, the packed mask of the planes' cells: a pass that
    transposes the words into test bits by gene block, then B3's kernel in
    keep mode 2, counted as one launch. On CPU tensors, the plain
    version."""
    if W.device.type != "cuda":
        return bell_spmm_bits_plain(b_li, b_val, W, words,
                                    gene_block=gene_block)
    global LAUNCHES_SPMM_BITS, LAUNCHES_SPMM_BITS_WIDE
    B, launches, wide = _launch_b3(b_li, b_val, W, 2, 0, 0, 1, words,
                                   gene_block=gene_block)
    LAUNCHES_SPMM_BITS += launches
    LAUNCHES_SPMM_BITS_WIDE += wide
    return B


def _h_vec(H: torch.Tensor, k: int) -> int:
    """Floats per cp.async of H in B4: 4 or 2 where k and H's address
    allow, else 1."""
    for vec in (4, 2):
        if k % vec == 0 and H.data_ptr() % (4 * vec) == 0:
            return vec
    return 1


def _p_vec(b_li, b_val) -> int:
    """Cells per cp.async of the planes in B4: 4 where the row stride and
    both planes' addresses allow, else 1."""
    aligned = (b_li.stride(0) % 4 == 0 and b_li.data_ptr() % 16 == 0
               and b_val.data_ptr() % 16 == 0)
    return 4 if aligned else 1


def _launch_b4(b_li, b_val, H, mode, seed64, cell_offset, inv_density, words,
               *, gene_block: int, n_gb: int) -> tuple[torch.Tensor, int]:
    """One launch of bell_spmm.cu's ``bell_spmm_t`` (B4 with keep mode 0
    or 1, B6 with mode 2) on ``b4_plan``; returns Bw (n_gb * gene_block, k)
    and the number of launches (0 without cells or columns)."""
    cells = b_li.shape[1]
    k = H.shape[1]
    _check("H", H, (cells, k), torch.float32, H.device)
    _check_planes(b_li, b_val, n_gb, H.device)
    if words is not None:
        _check_words(words, cells, n_gb, gene_block, H.device)
    genes = n_gb * gene_block
    if cells == 0 or k == 0 or genes == 0:
        return torch.zeros((genes, k), dtype=torch.float32,
                           device=H.device), 0
    plan = b4_plan(cells, n_gb, gene_block, k)
    size = genes * k
    if plan.n_chunks == 1:
        Bw = torch.empty((genes, k), dtype=torch.float32, device=H.device)
        partials = counters = None
    else:
        # one allocation: Bw, the chunks' partial tiles, then one int32
        # counter per output tile (Bw is a view of its first genes * k)
        buf = torch.empty((1 + plan.n_chunks) * size
                          + n_gb * plan.n_rg * plan.n_kt,
                          dtype=torch.float32, device=H.device)
        Bw = buf[:size].view(genes, k)
        partials = buf.data_ptr() + 4 * size
        counters = partials + 4 * plan.n_chunks * size
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = _lib().bell_spmm_t(
            b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb,
            b_li.shape[0] // n_gb, cells, gene_block, H.data_ptr(), k,
            Bw.data_ptr(), partials, counters, plan.rows, plan.chunk_tiles,
            plan.n_chunks, _h_vec(H, k),
            _p_vec(b_li, b_val), mode,
            seed64, int(cell_offset), int(inv_density),
            None if words is None else words.data_ptr(),
            0 if words is None else words.stride(0), stream)
    _raise_on(err, "bell_spmm_t")
    return Bw, 1


def bell_spmm_t_cuda(b_li, b_val, H, seed=None, cell_offset: int = 0, *,
                     gene_block: int, n_gb: int,
                     inv_density: int = 20) -> torch.Tensor:
    """Kernel B4: Bw (n_gb * gene_block, k) = the (keep-masked) transposed
    product of the planes with H (cells, k), deterministic. On CPU tensors,
    the plain version."""
    if H.device.type != "cuda":
        return bell_spmm_t_plain(b_li, b_val, H, seed, cell_offset,
                                 gene_block=gene_block, n_gb=n_gb,
                                 inv_density=inv_density)
    global LAUNCHES_SPMM_T
    masked, seed64 = _seed_args(seed, inv_density)
    Bw, launches = _launch_b4(b_li, b_val, H, masked, seed64, cell_offset,
                              inv_density, None, gene_block=gene_block,
                              n_gb=n_gb)
    LAUNCHES_SPMM_T += launches
    return Bw


def bell_spmm_t_bits_cuda(b_li, b_val, H, words, *, gene_block: int,
                          n_gb: int) -> torch.Tensor:
    """Kernel B6: B4 keep-masked by the test bits of ``words``. On CPU
    tensors, the plain version."""
    if H.device.type != "cuda":
        return bell_spmm_t_bits_plain(b_li, b_val, H, words,
                                      gene_block=gene_block, n_gb=n_gb)
    global LAUNCHES_SPMM_T_BITS
    Bw, launches = _launch_b4(b_li, b_val, H, 2, 0, 0, 1, words,
                              gene_block=gene_block, n_gb=n_gb)
    LAUNCHES_SPMM_T_BITS += launches
    return Bw


def bell_mse_bits_cuda(b_li, b_val, words, Wd, H, *,
                       gene_block: int) -> torch.Tensor:
    """Kernel B7: (2, cells) float32, per cell the squared error summed
    over its held-out genes (row 0) and their count (row 1), the mask read
    from ``words``; Wd (n_gb * gene_block, k), H (cells, k). A pass that
    transposes the words into test bits by gene block, then the kernel on
    ``b7_plan``, counted as one launch: the tiles (k <= 512), else the wide
    route (``b7_wide_plan``: the same pass, then tiles of cells whose H
    rows sit in shared memory, Wd's rows in registers up to k = 1024 and
    streamed past it), counted in ``LAUNCHES_MSE_BITS_WIDE`` too. On CPU
    tensors, the plain version."""
    if H.device.type != "cuda":
        return bell_mse_bits_plain(b_li, b_val, words, Wd, H,
                                   gene_block=gene_block)
    global LAUNCHES_MSE_BITS, LAUNCHES_MSE_BITS_WIDE
    rows_w, k = Wd.shape
    if rows_w % gene_block:
        raise ValueError(f"Wd has {rows_w} rows, not a multiple of "
                         f"gene_block {gene_block}")
    n_gb = rows_w // gene_block
    cells = b_li.shape[1]
    dev = H.device
    _check("Wd", Wd, (rows_w, k), torch.float32, dev)
    _check("H", H, (cells, k), torch.float32, dev)
    _check_planes(b_li, b_val, n_gb, dev)
    _check_words(words, cells, n_gb, gene_block, dev)
    out = torch.empty((2, cells), dtype=torch.float32, device=dev)
    if cells == 0:
        return out
    width = b_li.shape[0] // n_gb
    plan = b7_plan(cells, n_gb, gene_block, width, k)
    lib = _mse_lib()
    head = (b_li.data_ptr(), b_val.data_ptr(), b_li.stride(0), n_gb, width,
            cells, gene_block, words.data_ptr(), words.stride(0))
    cells_pad = plan.n_ct * plan.cells
    bm = torch.empty(n_gb * cells_pad * plan.bm_pitch, dtype=torch.int32,
                     device=dev)
    if isinstance(plan, B7WidePlan):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bell_mse_bits_wide(
                *head, Wd.data_ptr(), H.data_ptr(), k, plan.npl, plan.cells,
                plan.rows, int(plan.h_shared), bm.data_ptr(), cells_pad,
                plan.bm_pitch, out.data_ptr(), stream)
        _raise_on(err, "bell_mse_bits_wide", lib.bell_mse_bits_error_string)
        LAUNCHES_MSE_BITS += 1
        LAUNCHES_MSE_BITS_WIDE += 1
        return out
    wp = b7_wd_operand(Wd, plan.npl)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bell_mse_bits(
            *head, wp.data_ptr(), H.data_ptr(), k, plan.npl, plan.cpw,
            plan.walkers, plan.rows, bm.data_ptr(), cells_pad, plan.bm_pitch,
            out.data_ptr(), stream)
    _raise_on(err, "bell_mse_bits", lib.bell_mse_bits_error_string)
    LAUNCHES_MSE_BITS += 1
    return out
