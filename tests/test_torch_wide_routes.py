"""The host side of the wide routes of kernels B1, B2, B3/B5 and B7, on the
CPU: ranks above 512 and gene blocks whose tiles do not fit in shared
memory. (The kernels themselves run on a card: tests/test_torch_wide_cuda.py.)

- ``b1_plan``, ``b2_plan`` and ``b7_plan`` take the wide route at k = 513,
  600 and 1024 and, at k <= 512, return the plans they returned before the
  wide routes existed (pinned below from that code);
- ``b7_wide_plan`` gives tiles of cells for every k, gene block and width:
  64 or 32 cells up to k = 1024, past it (Wd's rows streamed) 32, 16 or
  8 whose H rows fit, past k = 7,168 32 that read H from device memory
  (its tile and sub-block pinned below by k, its shared memory within a
  block's for every k it takes); a gene block's slots past the threads'
  registers walked in passes;
- ``b3_plan`` (plain and with the test bits) and ``b7_plan`` return a route
  at gene blocks of 7,168, 8,192 and 16,384 genes instead of raising, the
  tiled plans unchanged where they fit; B3/B5's wide-block plan sizes the
  lanes a cell to k (pinned below);
- ``nnls_wide_plan`` gives the staged kernels up to k = 6,452 for B2 and
  11,612 for B1 (8, 4, 2 or 1 columns a block of 32 to 256 threads each,
  a ring that fits shared memory; up to k = 2048 as before: 4 or 8
  columns, 32 threads, pinned below past it), a warp a column in shared
  memory past them and device scratch where one column's state does not
  fit;
- the plain versions at k = 600, 1024 and 2100, which the card's wide
  routes are held against, agree with the JAX package's ``solve_nnls``
  (shared and per-column Grams) and, at 1024 and 2100, its
  ``solve_nnls_packed_t``, at the tolerance of tests/test_pallas_nnls.py,
  with masked columns and columns that stop at different sweeps in one of
  the staged kernel's blocks; B7's plain version at k = 1100 agrees with
  the JAX kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import nnls as jnnls
from singlet_tpu.ops import pallas_bell as jpb
from singlet_tpu_torch.ops import bell, nnls
from singlet_tpu_torch.ops.bell_cuda import (MAX_K_MSE_WIDE, B3Plan,
                                             B3WidePlan, B7Plan, B7WidePlan,
                                             b3_plan, b3_wide_plan,
                                             b7_bm_pitch, b7_plan,
                                             b7_wide_plan, b7_wide_smem)
from singlet_tpu_torch.ops import linalg as tlinalg
from singlet_tpu_torch.ops import maskbits, nnls_cuda
from singlet_tpu_torch.ops.nnls_cuda import (B1Plan, WidePlan, b1_plan,
                                             b2_plan, nnls_wide_plan,
                                             quad_fits, wide_lanes,
                                             wide_quad_smem, wide_smem)
from singlet_tpu_torch.ops.rngmask import seed_pair

SMEM = 232448

# b1_plan(n, k) for k <= 512, as the code before the wide routes gave it
B1_PINNED = {
    (1, 1): (32, 1, 1, 1, True, 1, 2432),
    (100, 10): (32, 1, 1, 100, True, 1, 3584),
    (1500, 10): (32, 1, 1, 1500, True, 1, 3584),
    (8192, 50): (4, 13, 8, 1024, True, 20, 44608),
    (16384, 50): (4, 13, 8, 2048, True, 20, 44608),
    (2048, 100): (16, 7, 2, 1024, True, 12, 92800),
    (524288, 100): (8, 13, 4, 131072, True, 20, 92928),
    (300, 200): (32, 7, 1, 300, True, 7, 195328),
    (1000, 224): (32, 7, 1, 1000, True, 7, 216832),
    (1000, 225): (32, 8, 1, 1000, False, 256, 17408),
    (2048, 300): (32, 10, 1, 2048, False, 320, 21760),
    (10, 512): (32, 16, 1, 10, False, 512, 34816),
}
# b7_plan(cells, 32, gene_block, width, k) likewise
B7_PINNED = {
    (524288, 512, 32, 100): (4, 4, 16, 64, 8192, 128, 4, 16, 198176),
    (8192, 512, 32, 100): (4, 4, 16, 64, 128, 128, 4, 16, 198176),
    (8192, 512, 72, 50): (2, 4, 16, 64, 128, 128, 4, 16, 174240),
    (2049, 1720, 72, 512): (16, 2, 15, 30, 69, 32, 54, 56, 186976),
    (45, 64, 6, 300): (12, 1, 16, 16, 3, 64, 1, 8, 212608),
    (4096, 8192, 416, 100): (4, 1, 9, 9, 456, 128, 64, 256, 230496),
    (4096, 16384, 832, 100): (4, 1, 4, 4, 1024, 128, 128, 512, 220448),
}
# b7_wide_plan(8192, 32, 512, 72, k), the bench planes: (columns a lane,
# cells a tile, sub-block) by k; 64 cells a tile while their H rows fit
# beside a sub-block of 32 genes
B7_WIDE_PINNED = {
    1: (1, 64, 128), 100: (4, 64, 128), 256: (8, 64, 128),
    384: (12, 64, 128), 512: (16, 64, 128), 513: (17, 64, 128),
    600: (19, 64, 128), 640: (20, 64, 128), 672: (21, 64, 64),
    736: (23, 64, 64), 768: (24, 64, 64), 800: (25, 64, 32),
    832: (26, 64, 32),
    833: (27, 32, 128), 1000: (32, 32, 128), 1024: (32, 32, 128),
    1025: (33, 32, 128), 1100: (35, 32, 128), 1500: (47, 32, 128),
    2048: (64, 16, 128), 2560: (80, 16, 128), 4096: (128, 8, 128),
    7168: (224, 8, 32), 7169: (225, 32, 128), 30000: (938, 32, 128),
}
# nnls_wide_plan(n, k, gram) past k = 2048: (columns a block, blocks,
# shared memory, depth, threads a column); B2's packed slab, B1's Gram rows
# (the quad kernel's own ring where it fits: k = 2560, 2600)
WIDE_PINNED = {
    (2048, 2560, "packed"): (2, 1024, 174368, 4, 64),
    (2048, 2560, "shared"): (4, 512, 205456, 4, 64),
    (2048, 4096, "packed"): (2, 1024, 229664, 3, 64),
    (2048, 4096, "shared"): (4, 512, 197168, 4, 64),
    (512, 2560, "packed"): (2, 256, 174368, 4, 64),
    (512, 2560, "shared"): (4, 128, 205456, 4, 64),
    (16384, 2600, "packed"): (2, 8192, 177088, 4, 64),
    (16384, 2600, "shared"): (4, 4096, 208656, 4, 64),
    (7, 5000, "packed"): (1, 7, 220160, 4, 128),
    (7, 5000, "shared"): (2, 4, 160288, 4, 128),
    (1, 6452, "packed"): (1, 1, 232432, 3, 128),
    (1, 11612, "shared"): (1, 1, 232400, 3, 256),
}
# b3_plan(cells, 32, gene_block, width, k, bits) likewise
B3_PINNED = {
    (524288, 512, 32, 100, False): (28, 4, 2, 128, 4096, 32, 2, 196904),
    (8192, 512, 32, 100, True): (28, 4, 2, 128, 64, 32, 2, 205096),
    (8192, 1720, 72, 512, True): (8, 64, 1, 64, 128, 72, 2, 220968),
    (2048, 2048, 1000, 5, False): (4, 2, 1, 64, 32, 130, 2, 232232),
    (4096, 5632, 100, 100, True): (4, 25, 1, 64, 64, 4, 1, 231720),
    (4096, 7168, 100, 100, False): (4, 25, 1, 64, 64, 1, 1, 231208),
}
# b3_wide_plan(4096, k, bits): (columns a chunk, chunks, cells a block,
# blocks, floats a load); 256 / cells lanes a cell, each one load of 4
# columns (for B5 of 2 where k is 2 mod 4), two loads past 32 of them
B3_WIDE_PINNED = {
    (5, False): (16, 1, 64, 64, 4),
    (5, True): (16, 1, 64, 64, 4),
    (6, False): (16, 1, 64, 64, 4),
    (6, True): (8, 1, 64, 64, 2),
    (16, False): (16, 1, 64, 64, 4),
    (17, True): (32, 1, 32, 128, 4),
    (50, False): (64, 1, 16, 256, 4),
    (50, True): (64, 1, 8, 512, 2),
    (62, True): (64, 1, 8, 512, 2),
    (66, True): (128, 1, 8, 512, 2),
    (100, False): (128, 1, 8, 512, 4),
    (100, True): (128, 1, 8, 512, 4),
    (128, False): (128, 1, 8, 512, 4),
    (129, False): (256, 1, 8, 512, 4),
    (130, True): (128, 2, 8, 512, 2),
    (300, False): (256, 2, 8, 512, 4),
    (600, False): (256, 3, 8, 512, 4),
    (600, True): (256, 3, 8, 512, 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,k", sorted(B1_PINNED))
def test_b1_plan_unchanged_to_512(n, k):
    plan = b1_plan.__wrapped__(n, k)
    assert isinstance(plan, B1Plan) and tuple(plan) == B1_PINNED[n, k]


@pytest.mark.parametrize("k", [513, 600, 768, 1024, 2048, 2049, 2560, 2600,
                               4096, 4100, 5000, 6452, 6453, 11612, 11613,
                               29056, 29057])
@pytest.mark.parametrize("n", [1, 7, 512, 515, 2048, 16384])
def test_b1_b2_plans_take_the_wide_route(n, k):
    """Past k = 512 B2's plan is ``nnls_wide_plan`` on its packed slab,
    B1's on its Gram's rows, the same plan up to k = 2048. The staged
    kernels: P = the fewest of 32, 64, 128, 256 threads a column that hold
    a column's residual in 64 registers a thread; C = 4 columns a block
    where ceil(n / 4) blocks fit one wave of an H100's 132
    multiprocessors, else 8, then 2 and 1, at most 256 threads a block:
    the first C whose ring of 3 slots fits, the deepest ring (3 or 4
    slots); up to k = 2048 C = 4 or 8 and P = 32 as before; B1's quad
    kernel's own ring fits where its plan takes it (its shared memory
    then the quad kernel's). Past k = 6,452 (B2) and 11,612 (B1), where
    no ring fits, a warp a column, as many a block as their 8 k bytes
    fit; past one column's fit (k > 29,056), 8 a block in device scratch,
    at most 264 blocks. Shared memory within 232,448 bytes, every column
    in a block."""
    b2 = nnls_wide_plan(n, k)
    b1 = nnls_wide_plan(n, k, "shared")
    assert b1_plan(n, k) == b1 and b2_plan(n, k) == b2
    if k <= 2048:
        assert b1 == b2
    for plan, gram, limit in ((b2, "packed", 6452), (b1, "shared", 11612)):
        assert isinstance(plan, WidePlan) and plan.smem <= SMEM
        slab_gram = gram if k > 2048 else "packed"
        if k <= limit:
            cols, depth, lanes = plan.warps, plan.depth, plan.lanes
            assert plan.shared and plan.scratch == 0 and 3 <= depth <= 4
            assert lanes == wide_lanes(k) and -(-k // lanes) <= 64
            assert lanes == 32 or -(-k // (lanes // 2)) > 64
            assert cols in (8, 4, 2, 1) and cols * lanes <= 256
            first = (4,) if -(-n // 4) <= 132 else (8, 4)
            tried = [c for c in first + (2, 1) if c * lanes <= 256]
            fits = [c for c in tried
                    if wide_smem(k, c, 3, slab_gram) <= SMEM]
            assert cols == fits[0]
            if k <= 2048:
                assert cols in (4, 8) and lanes == 32
            assert plan.blocks == -(-n // cols) and plan.blocks * cols >= n
            assert wide_smem(k, cols, depth, slab_gram) <= SMEM
            assert depth == 4 or wide_smem(k, cols, depth + 1,
                                           slab_gram) > SMEM
            if slab_gram == "shared" and lanes <= 64 and quad_fits(k, cols):
                assert plan.smem == wide_quad_smem(k, cols) <= SMEM
            else:
                assert plan.smem == wide_smem(k, cols, depth, slab_gram)
            if gram == "packed":
                assert wide_smem(k, cols, depth, "tile") <= plan.smem
            if k <= 2048:
                assert wide_quad_smem(k, cols) <= SMEM   # B1's own ring
            if n >= 512 and k <= 2048:   # a block on (nearly) every SM
                assert plan.blocks >= 128
        elif 8 * k <= SMEM:
            assert plan.shared and plan.depth == 0
            assert plan.warps == min(8, SMEM // (8 * k))
            assert plan.smem == plan.warps * 8 * k <= SMEM
            assert plan.blocks == -(-n // plan.warps) and plan.scratch == 0
        else:
            assert not plan.shared and plan.smem == 0 and plan.warps == 8
            assert plan.depth == 0
            assert plan.blocks == max(1, min(264, -(-n // 8)))
            assert plan.scratch == plan.blocks * 8 * 8 * k


@pytest.mark.parametrize("key", sorted(WIDE_PINNED))
def test_wide_plan_pinned_past_2048(key):
    n, k, gram = key
    plan = nnls_wide_plan.__wrapped__(n, k, gram)
    assert (plan.warps, plan.blocks, plan.smem, plan.depth,
            plan.lanes) == WIDE_PINNED[key]


def test_b2_plan_leaves_the_kernel_its_modes_to_512():
    assert all(b2_plan(n, k) is None for n in (1, 512, 4096)
               for k in (1, 50, 100, 224, 300, 511, 512))


@pytest.mark.parametrize("key", sorted(B7_PINNED))
def test_b7_plan_unchanged_where_tiles_fit(key):
    cells, gene_block, width, k = key
    plan = b7_plan.__wrapped__(cells, 32, gene_block, width, k)
    assert isinstance(plan, B7Plan) and tuple(plan) == B7_PINNED[key]


@pytest.mark.parametrize("k", [513, 600, 1024, 1025, 2048])
def test_b7_plan_takes_the_wide_route_past_512(k):
    """Tiles of 64 (32 past k = 832) cells to k = 1024, one wave of them
    over the 8192 cells; past it Wd's rows streamed, tiles of 32 (16 past
    k = 1760) whose H rows sit in shared memory."""
    plan = b7_plan(8192, 32, 512, 32, k)
    assert plan == b7_wide_plan(8192, 32, 512, 32, k)
    assert isinstance(plan, B7WidePlan) and plan.h_shared
    assert plan.npl == -(-k // 32)
    assert plan.bm_pitch == 16 and plan.n_sb * plan.rows == 512
    assert plan.n_ct * plan.cells == 8192
    assert plan.n_ct in ((128, 256) if k <= MAX_K_MSE_WIDE else (256, 512))


@pytest.mark.parametrize("k", sorted(B7_WIDE_PINNED))
def test_b7_wide_plan_pinned_by_k(k):
    plan = b7_wide_plan(8192, 32, 512, 72, k)
    assert isinstance(plan, B7WidePlan)
    assert (plan.npl, plan.cells, plan.rows) == B7_WIDE_PINNED[k]
    assert plan.h_shared == (k <= 7168)
    assert plan.smem == b7_wide_smem(plan.npl, plan.cells, plan.rows,
                                     plan.h_shared)


def test_b7_wide_plan_fits_and_covers():
    """For every k up to 1100 and a spread past it, at a few cells, gene
    blocks and widths: tiles of cells (64 or 32 up to k = 1024, 32 where
    32-cell tiles make one wave over 132 SMs; past it 32, 16 or 8, the
    largest whose H rows fit, else 32 with H read from device memory)
    whose block fits 232,448 bytes, the tiles and sub-blocks cover the
    cells and genes once, the sub-blocks' bits lie in the pitch, at most
    65,535 sub-blocks a call; any width (walked in passes of 10 slots a
    thread where it passes 10 * 512 / cells)."""
    for k in list(range(1, 1100)) + list(range(1100, 40000, 331)):
        for cells, n_gb, gene_block, width in (
                (1, 1, 1, 1), (2050, 2, 8192, 40), (8192, 32, 512, 72),
                (524288, 32, 512, 32), (4096, 2, 16384, 160),
                (4225, 3, 100, 81), (100, 3000, 700, 8),
                (4096, 2, 8192, 416)):
            plan = b7_wide_plan.__wrapped__(cells, n_gb, gene_block, width,
                                            k)
            assert isinstance(plan, B7WidePlan)
            if k <= MAX_K_MSE_WIDE:
                assert plan.cells in (64, 32) and plan.h_shared
                if -(-cells // 32) <= 132:
                    assert plan.cells == 32
            else:
                assert 32 * plan.npl >= k > 32 * (plan.npl - 1)
                fit = [c for c in (32, 16, 8) if b7_wide_smem(
                    plan.npl, c, 32) <= SMEM]
                if fit:
                    assert plan.h_shared and plan.cells == fit[0]
                else:
                    assert not plan.h_shared and plan.cells == 32
            assert plan.rows in (128, 64, 32)
            assert plan.smem == b7_wide_smem(plan.npl, plan.cells,
                                             plan.rows, plan.h_shared)
            assert plan.smem <= SMEM
            assert 32 * plan.npl >= k > 32 * plan.npl - 128
            assert plan.n_ct * plan.cells >= cells > (plan.n_ct - 1) \
                * plan.cells
            assert plan.n_sb * plan.rows >= gene_block > (plan.n_sb - 1) \
                * plan.rows
            assert plan.bm_pitch == b7_bm_pitch(gene_block)
            assert 32 * plan.bm_pitch >= plan.n_sb * plan.rows
            assert n_gb * plan.n_sb < 65536


@pytest.mark.parametrize("gene_block", [7168, 8192, 16384])
@pytest.mark.parametrize("width", [72, 416, 8000])
def test_b7_plan_routes_wide_gene_blocks(gene_block, width):
    """A route for every gene block: the tiled plan where its tile fits,
    else the wide route walking the block in sub-blocks, its tiles of
    cells taking any width (a cell's slots past a thread's registers
    walked in passes)."""
    plan = b7_plan(4096, 2, gene_block, width, 100)
    assert plan.smem <= SMEM
    assert plan.n_sb * plan.rows >= gene_block
    if isinstance(plan, B7WidePlan):
        assert plan == b7_wide_plan(4096, 2, gene_block, width, 100)
    else:
        assert isinstance(plan, B7Plan) and 32 * plan.bm_pitch >= gene_block
    if width == 8000:   # the slot rows alone pass shared memory: passes
        assert isinstance(plan, B7WidePlan)
        assert width > 10 * 512 // plan.cells


@pytest.mark.parametrize("key", sorted(B3_PINNED))
def test_b3_plan_unchanged_where_tiles_fit(key):
    cells, gene_block, width, k, bits = key
    plan = b3_plan.__wrapped__(cells, 32, gene_block, width, k, bits)
    assert isinstance(plan, B3Plan) and tuple(plan) == B3_PINNED[key]


@pytest.mark.parametrize("gene_block", [7168, 8192, 16384])
@pytest.mark.parametrize("bits", [False, True])
@pytest.mark.parametrize("k", [5, 50, 100, 600])
def test_b3_plan_routes_wide_gene_blocks(gene_block, bits, k):
    """Where two slices of W do not fit (B3 past 7,168 genes, B5 past
    5,632), the wide-block route, its plan pinned."""
    plan = b3_plan(4096, 2, gene_block, 416, k, bits)
    if gene_block == 7168 and not bits:
        assert isinstance(plan, B3Plan) and plan.smem <= SMEM
    else:
        assert plan == B3WidePlan(*B3_WIDE_PINNED[k, bits])


@pytest.mark.parametrize("k,bits", sorted(B3_WIDE_PINNED))
def test_b3_wide_plan_sizes_lanes_to_k(k, bits):
    """Loads of 4 columns, for B5 of 2 where k is 2 mod 4 (a contiguous W
    then needs no padded copy); the fewest lanes a cell (4, 8, 16 or 32)
    whose loads cover k (or 32 loads of it), two loads a lane past that; a
    block of 256 threads; the chunks cover k once, and the kernel's entry
    takes (cols, cells, vw)."""
    plan = b3_wide_plan(4096, k, bits)
    assert tuple(plan) == B3_WIDE_PINNED[k, bits]
    vw = plan.vw
    assert vw == (2 if bits and k % 4 == 2 else 4)
    lanes = 256 // plan.cells
    assert lanes in (4, 8, 16, 32) and lanes * plan.cells == 256
    assert plan.cols == vw * lanes * (2 if k > 32 * vw else 1)
    assert (plan.n_kt - 1) * plan.cols < k <= plan.n_kt * plan.cols
    assert (plan.n_ct - 1) * plan.cells < 4096 <= plan.n_ct * plan.cells
    if lanes > 4:   # no fewer lanes would cover min(k, 32 vw)
        assert vw * lanes // 2 < min(k, 32 * vw)


def _problem(n, k, seed):
    rng = np.random.default_rng(seed)
    F = rng.random((2 * k, k)).astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (rng.random((n, 2 * k)) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    mask = rng.random(n) < 0.8
    return a, B, X0, mask


def test_plain_b1_at_600_matches_jax():
    a, B, X0, mask = _problem(6, 600, 1)
    kw = dict(L1=0.01, L2=0.001, max_sweeps=3)
    got = nnls.solve_nnls(torch.as_tensor(a), torch.as_tensor(B),
                          torch.as_tensor(X0),
                          update_mask=torch.as_tensor(mask), **kw)
    want = jnnls.solve_nnls(jnp.asarray(a), jnp.asarray(B), jnp.asarray(X0),
                            update_mask=jnp.asarray(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~mask], X0[~mask])


def test_plain_b2_at_600_matches_jax():
    """Per-column Grams: a shared Gram minus a column's own correction."""
    a, B, X0, mask = _problem(4, 600, 2)
    rng = np.random.default_rng(3)
    corr = rng.random((4, 40, 600)).astype(np.float32) * 0.1
    at = (a[None] - np.einsum("nri,nrj->nij", corr, corr)).astype(np.float32)
    kw = dict(L1=0.01, L2=0.0, max_sweeps=3)
    got = nnls.solve_nnls(torch.as_tensor(at), torch.as_tensor(B),
                          torch.as_tensor(X0),
                          update_mask=torch.as_tensor(mask), **kw)
    want = jnnls.solve_nnls(jnp.asarray(at), jnp.asarray(B), jnp.asarray(X0),
                            update_mask=jnp.asarray(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)


def _mixed_stops(B, X0, cols):
    """(B, X0, mask) whose columns stop at different sweeps within each
    block of ``cols``: in every block one with B = X0 = 0 (no step moves
    it: tol 0 after sweep 1), one with B = 0 and X0 = 0.005 at coordinate
    5 alone (sweep 1 clamps that coordinate to 0, the residual it leaves
    stays below the L1 of 0.01: tol 0 after sweep 2), the others as
    drawn; the first column of every other block masked out."""
    B, X0 = B.copy(), X0.copy()
    B[1::cols] = 0.0
    X0[1::cols] = 0.0
    B[2::cols] = 0.0
    X0[2::cols] = 0.0
    X0[2::cols, 5] = 0.005
    mask = np.ones(B.shape[0], dtype=bool)
    mask[::2 * cols] = False
    return B, X0, mask


def test_plain_b1_at_1024_matches_jax():
    """B1's plain version at k = 1024 (the staged kernel's C = 4, U = 32)
    against JAX's solve_nnls, masked columns and stops at sweeps 1, 2 and
    the cap within one block of 4; the card's kernel is held against this
    plain version (tests/test_torch_wide_cuda.py)."""
    k, n = 1024, 12
    cols = nnls_wide_plan(n, k).warps
    a, B, X0, mask = _problem(n, k, 11)
    B, X0, mask = _mixed_stops(B, X0, cols)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=4.0)
    got, sweeps = nnls.nnls_batch(torch.as_tensor(a), torch.as_tensor(B),
                                  torch.as_tensor(X0),
                                  update_mask=torch.as_tensor(mask),
                                  return_sweeps=True, **kw)
    assert len(set(sweeps[mask][:cols - 1].tolist())) == 3
    entry = nnls_cuda.nnls_batch_cuda(torch.as_tensor(a), torch.as_tensor(B),
                                      torch.as_tensor(X0),
                                      update_mask=torch.as_tensor(mask),
                                      **kw)
    assert torch.equal(entry, got)
    want = jnnls.solve_nnls(jnp.asarray(a), jnp.asarray(B), jnp.asarray(X0),
                            update_mask=jnp.asarray(mask),
                            sweep_cap=jnp.float32(4.0), L1=0.01, L2=0.001)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~mask], X0[~mask])


def test_plain_b2_packed_at_1024_matches_jax():
    """B2's packed entry at k = 1024 on the CPU (its plain version on the
    unpacked Grams) against JAX's solve_nnls_packed_t: a_full and each
    column's packed corrections of its 5% held-out rows, masked columns
    and stops at sweeps 1, 2 and the cap within one block of 4."""
    k, n = 1024, 12
    cols = nnls_wide_plan(n, k).warps
    rng = np.random.default_rng(12)
    F = rng.random((2 * k, k)).astype(np.float32)
    held = rng.random((n, 2 * k)) < 0.05
    iu = tlinalg.triu_pairs(k)
    packed_t = np.stack([(F[h].T @ F[h])[iu] for h in held],
                        axis=1).astype(np.float32)
    a_full = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (np.where(held, 0.0, rng.random((n, 2 * k))) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    B, X0, mask = _mixed_stops(B, X0, cols)
    kw = dict(L1=0.01, L2=0.001)
    tt = [torch.as_tensor(x) for x in (a_full, packed_t, B, X0)]
    got = nnls_cuda.nnls_batch_cuda_batched_packed_t(
        *tt[:2], iu, *tt[2:], update_mask=torch.as_tensor(mask),
        sweep_cap=4.0, **kw)
    at = tlinalg.unpack_sym_from_t(tt[1], k, iu, tt[0])
    _, sweeps = nnls.nnls_batch(at.permute(2, 1, 0), tt[2], tt[3],
                                update_mask=torch.as_tensor(mask),
                                sweep_cap=4.0, return_sweeps=True, **kw)
    assert len(set(sweeps[mask][:cols - 1].tolist())) == 3
    want = jnnls.solve_nnls_packed_t(
        jnp.asarray(a_full), jnp.asarray(packed_t), iu, jnp.asarray(B),
        jnp.asarray(X0), update_mask=jnp.asarray(mask),
        sweep_cap=jnp.float32(4.0), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~mask], X0[~mask])


def test_plain_b1_at_2100_matches_jax():
    """B1's plain version past k = 2048 (the staged kernels at 64 threads a
    column, the quad kernel's ring) against JAX's solve_nnls on a handful
    of columns, masked columns and stops at sweeps 1, 2 and the cap (3:
    JAX's CD takes about 30 s a sweep here on the CPU) among the first
    four; the card's kernel is held against this plain version
    (tests/test_torch_wide_cuda.py). JAX's CD unrolls its k steps when it
    traces: compiling 2,100 of them took about 100 s on the CPU and
    crashed the compiler in a full run of the suite, so the JAX side runs
    op by op (``jax.disable_jit``), the same operations, about 30 s."""
    k, n = 2100, 6
    a, B, X0, mask = _problem(n, k, 21)
    B, X0, mask = _mixed_stops(B, X0, 4)
    kw = dict(L1=0.01, L2=0.001, sweep_cap=3.0)
    got, sweeps = nnls.nnls_batch(torch.as_tensor(a), torch.as_tensor(B),
                                  torch.as_tensor(X0),
                                  update_mask=torch.as_tensor(mask),
                                  return_sweeps=True, **kw)
    assert len(set(sweeps[mask][:3].tolist())) == 3
    with jax.disable_jit():
        want = jnnls.solve_nnls(jnp.asarray(a), jnp.asarray(B),
                                jnp.asarray(X0),
                                update_mask=jnp.asarray(mask),
                                sweep_cap=jnp.float32(3.0), L1=0.01,
                                L2=0.001)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~mask], X0[~mask])


def test_plain_b2_packed_at_2100_matches_jax():
    """B2's packed entry past k = 2048 on the CPU (its plain version on the
    unpacked Grams) against JAX's solve_nnls_packed_t on a handful of
    columns: a_full and each column's packed corrections of its 5%
    held-out rows, masked columns and stops at sweeps 1, 2 and the cap
    (3). The JAX side op by op, as in
    ``test_plain_b1_at_2100_matches_jax``."""
    k, n = 2100, 6
    rng = np.random.default_rng(22)
    F = rng.random((2 * k, k)).astype(np.float32)
    held = rng.random((n, 2 * k)) < 0.05
    iu = tlinalg.triu_pairs(k)
    packed_t = np.stack([(F[h].T @ F[h])[iu] for h in held],
                        axis=1).astype(np.float32)
    a_full = (F.T @ F + 1e-15 * np.eye(k)).astype(np.float32)
    B = (np.where(held, 0.0, rng.random((n, 2 * k))) @ F).astype(np.float32)
    X0 = (rng.random((n, k)) * (rng.random((n, k)) < 0.5)).astype(np.float32)
    B, X0, mask = _mixed_stops(B, X0, 4)
    kw = dict(L1=0.01, L2=0.001)
    tt = [torch.as_tensor(x) for x in (a_full, packed_t, B, X0)]
    got = nnls_cuda.nnls_batch_cuda_batched_packed_t(
        *tt[:2], iu, *tt[2:], update_mask=torch.as_tensor(mask),
        sweep_cap=3.0, **kw)
    at = tlinalg.unpack_sym_from_t(tt[1], k, iu, tt[0])
    _, sweeps = nnls.nnls_batch(at.permute(2, 1, 0), tt[2], tt[3],
                                update_mask=torch.as_tensor(mask),
                                sweep_cap=3.0, return_sweeps=True, **kw)
    assert len(set(sweeps[mask][:3].tolist())) == 3
    with jax.disable_jit():
        want = jnnls.solve_nnls_packed_t(
            jnp.asarray(a_full), jnp.asarray(packed_t), iu, jnp.asarray(B),
            jnp.asarray(X0), update_mask=jnp.asarray(mask),
            sweep_cap=jnp.float32(3.0), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[~mask], X0[~mask])


def test_plain_b7_at_1100_matches_jax():
    """B7's plain version past k = 1024 (the wide route's streamed form)
    against the JAX kernel in interpret mode on random planes of two gene
    blocks: sums within rtol 2e-4, the same counts."""
    k, cells, gene_block, n_gb, width = 1100, 24, 64, 2, 6
    genes = gene_block * n_gb
    rng = np.random.default_rng(1100)
    li = np.stack([rng.choice(gene_block, width, replace=False)
                   for _ in range(n_gb * cells)]).astype(np.int32)
    li[rng.random(li.shape) < 0.3] = -1
    li = np.ascontiguousarray(li.reshape(n_gb, cells, width)
                              .transpose(0, 2, 1)).reshape(-1, cells)
    lv = np.where(li >= 0, rng.random(li.shape) + 0.1, 0.0).astype(np.float32)
    Wd = (rng.random((genes, k)) / k).astype(np.float32)
    H = rng.random((cells, k)).astype(np.float32)
    kw = dict(genes_pad=genes, gene_block=gene_block, inv_density=4,
              cells_true=cells, genes_true=genes)
    words = maskbits.pack_mask_words(seed_pair(5), torch.arange(cells), **kw)
    got = bell.bell_mse_bits_plain(torch.as_tensor(li), torch.as_tensor(lv),
                                   words, torch.as_tensor(Wd),
                                   torch.as_tensor(H), gene_block=gene_block)
    jwords = jnp.asarray(words.numpy().view(np.uint32))
    want = np.asarray(jpb.bell_mse_bits(
        jnp.asarray(li), jnp.asarray(lv), jwords.T, jnp.asarray(Wd),
        jnp.asarray(H), gene_block=gene_block, interpret=True))
    assert got[1].sum() > 0
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
